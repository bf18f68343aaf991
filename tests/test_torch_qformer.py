"""The event Q-Former of the PyTorch port against the JAX package.

The same seeded f32 weights (numpy) go through both packages:
``qformer_encode`` and the gated ``encode_events_batch`` agree to 1e-5
(f32 sums in another order), greedy chains are token-identical, the
component files round-trip across the packages exactly, the config read
off the artifacts is equal, wrong artifacts raise the same errors, and
the port's ``cli.infer`` prints the JAX CLI's answer with the Q-Former
gated by a checkpoint or by the flags.
"""

import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.cli import infer as jinfer
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.models import qformer as jqf
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import infer as tinfer
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import qformer as tqf
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

ATOL = 1e-5
JQ = jcfg.QFormerConfig(num_queries=6, num_layers=2, num_heads=2, hidden_size=64, mlp_ratio=2)
TQ = tcfg.QFormerConfig(num_queries=6, num_layers=2, num_heads=2, hidden_size=64, mlp_ratio=2)
JCFG = dataclasses.replace(jcfg.EventChatConfig.tiny(vocab_size=259), use_event_qformer=True,
                           qformer=JQ)
TCFG = dataclasses.replace(tcfg.EventChatConfig.tiny(vocab_size=259), use_event_qformer=True,
                           qformer=TQ)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_qformer(seed):
    return _host(jqf.init_qformer_params(JQ, jax.random.PRNGKey(seed)))


def _assert_same(port, jtree):
    want = tconv.qformer_params_from_jax(jtree, torch.float32, "cpu")
    assert torch.equal(port["query_embeddings"], want["query_embeddings"])
    assert len(port["attention_layers"]) == len(want["attention_layers"])
    for a, b in zip(port["attention_layers"], want["attention_layers"]):
        a, b = dict(tqf._paths(a)), dict(tqf._paths(b))
        assert set(a) == set(b)
        for path in a:
            assert a[path].dtype == b[path].dtype and torch.equal(a[path], b[path]), path


@pytest.mark.parametrize("flat", [False, True], ids=["frames", "flattened"])
def test_qformer_encode_matches_jax(flat):
    jp = _jax_qformer(0)
    # Non-trivial norms and biases, so every leaf takes part.
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype), jp)
    feats = rng.standard_normal((5, 9, 64)).astype(np.float32)
    if flat:
        feats = feats.reshape(-1, 64)
    want = np.asarray(jqf.qformer_encode(jp, JQ, feats))
    got = tqf.qformer_encode(tconv.qformer_params_from_jax(jp, torch.float32, "cpu"), TQ,
                             torch.from_numpy(feats))
    assert got.shape == (6, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_qformer_encode_keeps_bf16():
    tp = tqf.init_qformer_params(TQ, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    feats = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(1)).bfloat16()
    out = tqf.qformer_encode(tp, TQ, feats)
    assert out.dtype == torch.bfloat16 and bool(torch.isfinite(out.float()).all())


@pytest.fixture(scope="module")
def gated():
    jp = _host(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(3)))
    tp = tconv.params_from_jax(jp, TCFG, torch.float32, "cpu")
    rng = np.random.default_rng(2)
    size = JCFG.vision.image_size
    pixels = rng.standard_normal((2, JCFG.num_event_frames, 3, size, size)).astype(np.float32)
    return jp, tp, pixels


def test_gated_encode_events_batch_matches_jax(gated):
    jp, tp, pixels = gated
    want = np.asarray(jchat.encode_events_batch(jp, JCFG, pixels))
    got = tchat.encode_events_batch(tp, TCFG, torch.from_numpy(pixels))
    assert got.shape == (2, 6, 64) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_gated_greedy_chains_token_identical(gated):
    jp, tp, pixels = gated
    ids = [[1, 5, -200, 9, 9, 12], [3, -200, 7]]
    want = jchat.generate(jp, JCFG, ids, pixels, max_new_tokens=8, temperature=0.0,
                          eos_token_id=None)
    got = tchat.generate(tp, TCFG, ids, pixels, max_new_tokens=8, temperature=0.0,
                         eos_token_id=None, device="cpu")
    assert got == want


def test_init_gains_the_qformer_only_when_gated():
    g = torch.Generator().manual_seed(0)
    plain = tconv.init_eventchat_params(dataclasses.replace(TCFG, use_event_qformer=False),
                                        g, torch.float32, "cpu")
    tp = tconv.init_eventchat_params(TCFG, g, torch.float32, "cpu")
    assert "qformer" not in plain and "qformer" in tp
    jp = _host(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(0)))
    want = tconv.qformer_params_from_jax(jp["qformer"], torch.float32, "cpu")
    ours = {p: t.shape for p, t in tqf._paths(tp["qformer"]["attention_layers"][0])}
    assert ours == {p: t.shape for p, t in tqf._paths(want["attention_layers"][0])}
    assert TCFG.num_event_tokens == JCFG.num_event_tokens == 6


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_components_round_trip_across_packages(writer, tmp_path):
    jp = _jax_qformer(4)
    qp, ap = str(tmp_path / "q.npz"), str(tmp_path / "a.npz")
    if writer == "jax":
        jqf.save_qformer_components(jp, qp, ap, num_heads=2)
    else:
        tqf.save_qformer_components(tconv.qformer_params_from_jax(jp, torch.float32, "cpu"),
                                    qp, ap, num_heads=2)
    with np.load(ap) as data:
        assert int(data["qformer_meta.num_heads"]) == 2
    fresh_t = tqf.init_qformer_params(TQ, torch.Generator().manual_seed(9), torch.float32, "cpu")
    _assert_same(tqf.load_qformer_components(fresh_t, qp, ap), jp)
    back = _host(jqf.load_qformer_components(_jax_qformer(5), qp, ap))
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert tqf.qformer_config_from_artifacts(qp, ap) == tcfg.QFormerConfig(
        **dataclasses.asdict(jqf.qformer_config_from_artifacts(qp, ap)))


def test_config_from_artifacts_guesses_heads_loudly(tmp_path, caplog):
    jp = jqf.init_qformer_params(jcfg.QFormerConfig(num_queries=4, num_layers=3, num_heads=4,
                                                    hidden_size=12, mlp_ratio=3),
                                 jax.random.PRNGKey(6))
    qp, ap = str(tmp_path / "q.npz"), str(tmp_path / "a.npz")
    jqf.save_qformer_components(_host(jp), qp, ap)  # no num_heads metadata
    with caplog.at_level(logging.WARNING):
        got = tqf.qformer_config_from_artifacts(qp, ap)
    assert "GUESSING num_heads=4" in caplog.text
    assert dataclasses.asdict(got) == dataclasses.asdict(jqf.qformer_config_from_artifacts(qp, ap))
    assert got.num_layers == 3 and got.mlp_ratio == 3


def _bad_artifact(kind, tmp_path):
    """(query_embedder path, attention_layers path) with one fault."""
    jp = _jax_qformer(7)
    qp, ap = str(tmp_path / "q.npz"), str(tmp_path / "a.npz")
    jqf.save_qformer_components(jp, qp, ap, num_heads=2)
    with np.load(ap) as data:
        flat = dict(data)
    if kind == "foreign_key":
        np.savez(ap, **{"unrelated.weight": np.zeros((2, 2))})
        return None, ap
    if kind == "foreign_query_key":
        np.savez(qp, **{"unrelated.weight": np.zeros((2, 2))})
        return qp, None
    if kind == "query_without_weight":
        np.savez(qp, **{"model.query_embedder.bias": np.zeros((6, 64), np.float32)})
        return qp, None
    if kind == "query_shape":
        np.savez(qp, **{"model.query_embedder.weight": np.zeros((5, 64), np.float32)})
        return qp, None
    if kind == "missing_leaf":
        flat.pop("model.attention_layers.1.mlp.fc2_bias")
    elif kind == "layer_out_of_range":
        flat["model.attention_layers.2.attn.q"] = flat["model.attention_layers.0.attn.q"]
    elif kind == "leaf_shape":
        flat["model.attention_layers.0.attn.k"] = np.zeros((64, 32), np.float32)
        flat["model.attention_layers.1.attn.k"] = np.zeros((64, 32), np.float32)
    np.savez(ap, **flat)
    return None, ap


@pytest.mark.parametrize("kind", ["foreign_key", "foreign_query_key", "query_without_weight",
                                  "query_shape", "missing_leaf", "layer_out_of_range",
                                  "leaf_shape"])
def test_wrong_artifacts_raise_the_jax_errors(kind, tmp_path):
    qp, ap = _bad_artifact(kind, tmp_path)
    with pytest.raises(ValueError) as want:
        jqf.load_qformer_components(_jax_qformer(8), qp, ap)
    fresh = tqf.init_qformer_params(TQ, torch.Generator().manual_seed(8), torch.float32, "cpu")
    with pytest.raises(ValueError) as got:
        tqf.load_qformer_components(fresh, qp, ap)
    assert str(got.value) == str(want.value)


# -- the CLI ----------------------------------------------------------------

@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A checkpoint with a gated Q-Former (its components beside it), a
    plain one, the plain one's components apart, and an event stream."""
    root = str(tmp_path_factory.mktemp("torch_qformer"))
    jp = _host(jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(12)))
    gated_dir = os.path.join(root, "gated")
    jconv.write_hf_checkpoint(jp, JCFG, gated_dir, num_shards=2)
    plain_cfg = dataclasses.replace(JCFG, use_event_qformer=False)
    plain = {k: v for k, v in jp.items() if k != "qformer"}
    plain_dir = os.path.join(root, "plain")
    jconv.write_hf_checkpoint(plain, plain_cfg, plain_dir, num_shards=2)
    qp, ap = os.path.join(root, "qe.npz"), os.path.join(root, "al.npz")
    jqf.save_qformer_components(_host(jqf.init_qformer_params(JQ, jax.random.PRNGKey(13))),
                                qp, ap, num_heads=2)
    ev = os.path.join(root, "events.npy")
    np.save(ev, synthetic_event_stream(12, n_events=20_000))
    return gated_dir, plain_dir, qp, ap, ev


@pytest.mark.parametrize("case", ["checkpoint_gate", "flags", "flags_int4"])
def test_infer_cli_with_the_qformer_prints_the_jax_answer(dirs, case):
    gated_dir, plain_dir, qp, ap, ev = dirs
    common = ["--tokenizer_path", "byte", "--event_frame", ev, "--query", "What moves?",
              "--temperature", "0", "--max_new_tokens", "8", "--dtype", "float32"]
    if case == "checkpoint_gate":
        common += ["--model_path", gated_dir]
    else:
        common += ["--model_path", plain_dir, "--use_event_qformer",
                   "--pretrain_query_embedder", qp, "--pretrain_attention_layers", ap]
    if case == "flags_int4":
        common += ["--quant", "int4", "--kv_cache", "int8", "--fuse_params"]
    want = jinfer.main(common)
    assert want and tinfer.main(common + ["--device", "cpu"]) == want


def test_a_gate_without_components_raises_as_in_jax(dirs, tmp_path):
    gated_dir, _, _, _, ev = dirs
    stripped = str(tmp_path / "stripped")
    os.makedirs(stripped)
    for name in os.listdir(gated_dir):
        if not name.endswith(".npz"):
            os.link(os.path.join(gated_dir, name), os.path.join(stripped, name))
    args = ["--model_path", stripped, "--tokenizer_path", "byte", "--event_frame", ev,
            "--query", "q", "--dtype", "float32", "--max_new_tokens", "2"]
    with pytest.raises(ValueError) as want:
        jinfer.main(args)
    with pytest.raises(ValueError) as got:
        tinfer.main(args + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "use_event_qformer" in str(got.value)
