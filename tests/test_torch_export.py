"""``cli.export`` of the PyTorch port against the JAX package's.

Both exports start from one checkpoint directory written by the JAX
package and merge the same artifacts (a stage-1 projector npz, a stage-2
LoRA npz, Q-Former component files). The state dicts they write agree to
1e-6 (the LoRA delta is an f32 matmul summed in another order; everything
else is copied exactly), their ``config.json`` files are equal, and each
package loads the other's export.
"""

import argparse
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import checkpoint as jckpt
from eventgpt_tpu import config as jcfg
from eventgpt_tpu.cli import export as jexport
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import projector as jproj
from eventgpt_tpu.models import qformer as jqf
from eventgpt_tpu.train import lora as jlora
from eventgpt_tpu_torch import checkpoint as tckpt
from eventgpt_tpu_torch.cli import export as texport
from eventgpt_tpu_torch.cli import infer as tinfer
from eventgpt_tpu_torch.config import LlamaConfig
from eventgpt_tpu_torch.models.convert import llama_params_from_jax
from eventgpt_tpu_torch.train import lora as tlora

ATOL = 1e-6
JCFG = jcfg.EventChatConfig.tiny(vocab_size=259)
JQ = jcfg.QFormerConfig(num_queries=6, num_layers=2, num_heads=2, hidden_size=64, mlp_ratio=2)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_lora(seed, r=4):
    """A LoRA tree in the JAX trainer's stacked layout, both factors random
    so that the merge moves every targeted weight."""
    tree = jlora.init_lora_params(JCFG.llama, jlora.LoraConfig(r=r, alpha=8.0),
                                  jax.random.PRNGKey(seed), np.float32)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return _host(jax.tree_util.tree_unflatten(
        treedef, [0.1 * jax.random.normal(k, x.shape, x.dtype) for k, x in zip(keys, leaves)]))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_export"))
    base = os.path.join(root, "base")
    jconv.write_hf_checkpoint(_host(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(21))),
                              JCFG, base, num_shards=2)
    projector = os.path.join(root, "projector_last.npz")
    proj_tree = _host(jproj.init_projector_params(JCFG.projector, jax.random.PRNGKey(22)))
    jckpt.save_component(projector, proj_tree, prefix="model.visual_projector.")
    lora = os.path.join(root, "lora_last.npz")
    jckpt.save_component(lora, _random_lora(23), prefix="lora.")
    qp, ap = os.path.join(root, "qe.npz"), os.path.join(root, "al.npz")
    jqf.save_qformer_components(_host(jqf.init_qformer_params(JQ, jax.random.PRNGKey(24))),
                                qp, ap, num_heads=2)
    return {"root": root, "base": base, "projector": projector, "lora": lora, "qe": qp, "al": ap}


def _both(a, case, extra):
    """Run both exports of ``a['base']`` with ``extra`` flags; returns
    (port dir, JAX dir)."""
    ours = os.path.join(a["root"], f"port_{case}")
    theirs = os.path.join(a["root"], f"jax_{case}")
    args = ["--model_path", a["base"], "--num_shards", "3", *extra]
    jexport.main(args + ["--output_dir", theirs])
    texport.main(args + ["--output_dir", ours, "--device", "cpu"])
    return ours, theirs


def _assert_exports_agree(ours, theirs):
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    with open(os.path.join(ours, "config.json")) as f, \
            open(os.path.join(theirs, "config.json")) as g:
        assert json.load(f) == json.load(g)
    got, want = jconv.load_state_dict(ours), jconv.load_state_dict(theirs)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0, err_msg=k)


CASES = {
    "plain": [],
    "projector": ["--projector", "{projector}"],
    "lora": ["--lora", "{lora}", "--lora_r", "4", "--lora_alpha", "8"],
    "projector_lora": ["--projector", "{projector}", "--lora", "{lora}", "--lora_r", "4",
                       "--lora_alpha", "8"],
    "qformer": ["--query_embedder", "{qe}", "--attention_layers", "{al}"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_matches_the_jax_export(artifacts, case):
    extra = [x.format(**artifacts) for x in CASES[case]]
    ours, theirs = _both(artifacts, case, extra)
    _assert_exports_agree(ours, theirs)
    if "lora" in case:
        base = jconv.load_state_dict(artifacts["base"])
        got = jconv.load_state_dict(ours)
        assert not np.allclose(got["model.layers.0.self_attn.q_proj.weight"],
                               base["model.layers.0.self_attn.q_proj.weight"])
        np.testing.assert_array_equal(got["model.embed_tokens.weight"],
                                      base["model.embed_tokens.weight"])
    if case == "qformer":
        for name in ("query_embedder.npz", "attention_layers.npz"):
            with np.load(os.path.join(ours, name)) as f, np.load(os.path.join(theirs, name)) as g:
                assert sorted(f.files) == sorted(g.files)
                for k in g.files:
                    np.testing.assert_array_equal(f[k], g[k])


def test_exports_load_in_the_other_package(artifacts):
    extra = [x.format(**artifacts) for x in CASES["projector_lora"] + CASES["qformer"]]
    ours, theirs = _both(artifacts, "everything", extra)
    # The JAX package loads the port's export to its own export's tree.
    with open(os.path.join(ours, "config.json")) as f:
        jc = jcfg.from_hf_config(json.load(f), attn_impl="dense")
    got = jconv.eventchat_params_from_hf(jconv.load_state_dict(ours), jc)
    want = jconv.eventchat_params_from_hf(jconv.load_state_dict(theirs), jc)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    # The port loads the JAX export, Q-Former included, to the same tree
    # as its own export.
    trees = []
    for d in (ours, theirs):
        args = argparse.Namespace(model_path=d, use_event_qformer=False,
                                  pretrain_query_embedder=None, pretrain_attention_layers=None,
                                  quant="none")
        cfg, params, tok = tinfer.load_model(d, "float32", tokenizer_path="byte", device="cpu")
        cfg, params = tinfer.prepare_model(cfg, params, tok, args)
        assert cfg.use_event_qformer and cfg.qformer.num_heads == 2
        trees.append(params)
    flat = [tckpt._flatten(t) for t in trees]
    assert set(flat[0]) == set(flat[1])
    for k in flat[0]:
        np.testing.assert_allclose(flat[0][k], flat[1][k], atol=ATOL, rtol=0, err_msg=k)


def test_reexport_keeps_the_qformer_and_refuses_to_drop_it(artifacts):
    extra = [x.format(**artifacts) for x in CASES["qformer"]]
    first, _ = _both(artifacts, "qf_first", extra)
    second = os.path.join(artifacts["root"], "qf_second")
    texport.main(["--model_path", first, "--output_dir", second, "--device", "cpu"])
    with open(os.path.join(second, "config.json")) as f:
        assert json.load(f)["use_event_qformer"] is True
    stripped = os.path.join(artifacts["root"], "qf_stripped")
    os.makedirs(stripped)
    for name in os.listdir(first):
        if not name.endswith(".npz"):
            os.link(os.path.join(first, name), os.path.join(stripped, name))
    args = ["--model_path", stripped, "--output_dir", os.path.join(artifacts["root"], "never")]
    with pytest.raises(ValueError) as want:
        jexport.main(args)
    with pytest.raises(ValueError) as got:
        texport.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("r,alpha", [(4, 8.0), (2, 16.0)])
def test_merge_lora_matches_jax(r, alpha):
    lora = _random_lora(31, r=r)
    jp = _host(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(32)))["llama"]
    cfg_t = tlora.LoraConfig(r=r, alpha=alpha)
    want = _host(jlora.merge_lora(jp, lora, jlora.LoraConfig(r=r, alpha=alpha)))
    tcfg_l = LlamaConfig(**{k: v for k, v in dataclasses.asdict(JCFG.llama).items()
                            if k not in ("remat", "remat_policy")})
    base = llama_params_from_jax(jp, tcfg_l, torch.float32, "cpu")
    before = {k: v.clone() for k, v in base["layers"][0].items()}
    got = tlora.merge_lora(base, lora, cfg_t)
    expect = llama_params_from_jax(want, tcfg_l, torch.float32, "cpu")
    for i, layer in enumerate(got["layers"]):
        for name, w in layer.items():
            np.testing.assert_allclose(w.numpy(), expect["layers"][i][name].numpy(), atol=ATOL,
                                       rtol=0, err_msg=f"{i}.{name}")
    for k, v in before.items():  # the base tree is left as it was
        assert torch.equal(base["layers"][0][k], v), k
    assert cfg_t.scaling == alpha / r
