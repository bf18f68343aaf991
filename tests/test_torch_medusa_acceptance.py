"""The port's trained-draft acceptance study (``scripts/medusa_acceptance``)
against the JAX package's, f32 on the CPU.

Fast: the JAX ``tiny-random`` tree, converted, goes through 2 finetune
steps and 2 head steps in both packages on the same motion corpus; the
losses agree within 1e-4. Then each package serves 2 held-out requests per
draft (lookup, the trained heads, the study's random heads) through a fresh
``ContinuousBatcher`` with warmup: the chains and the tokens per iteration
equal the JAX server's, or a chain leaves JAX's only where its top-2
next-token margin is below 1e-4 (a tie), and within a package the three
drafts give one chain.

Slow: the JAX gate's bars (tests/test_medusa_acceptance.py) on the port's
own run at the gate's scale.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jconfig
from eventgpt_tpu.cli import infer as jinfer
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.data.motion_corpus import build_motion_corpus
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models import llama as tllama
from eventgpt_tpu_torch.models.convert import medusa_from_jax, params_from_jax
from eventgpt_tpu_torch.scripts import medusa_acceptance as tstudy
from eventgpt_tpu_torch.train import data as tdata

LOSS_ATOL = 1e-4
TIE = 1e-4
BUDGET = 12


def _jax_study():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    try:
        import medusa_acceptance
    finally:
        sys.path.pop(0)
    return medusa_acceptance


def _next_logits(tp, cfg, ids, pixels, prefix):
    """The port's next-token logits after ``ids`` + the committed ``prefix``."""
    padded, mask, _ = tchat.prepare_prefill(tp, cfg, [list(ids) + list(prefix)], pixels[None])
    cache = tllama.init_kv_cache(cfg.llama, 1, padded.shape[1], dtype=padded.dtype,
                                 device=padded.device)
    with torch.no_grad():
        logits, _ = tllama.prefill(tp["llama"], cfg.llama, padded, mask, cache, last_only=True)
    return logits[0]


def _same_or_tie(tp, cfg, traffic, got, want):
    for (ids, px), g, w in zip(traffic, got, want):
        if g == w:
            continue
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), min(len(g), len(w)))
        top2 = torch.topk(_next_logits(tp, cfg, ids, px, g[:i]), 2).values
        margin = float(top2[0] - top2[1])
        assert margin < TIE, (i, g, w, margin)


def test_fast_study_matches_jax(tmp_path):
    jstudy = _jax_study()
    paths = build_motion_corpus(str(tmp_path), n_train=8, n_eval=2)
    jcfg_, jparams, jtok = jinfer.load_model("tiny-random", "float32", None, None)
    jp = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = tcfg.event_chat_config_from_dict(jconfig.to_dict(jcfg_))
    tp = params_from_jax(jp, cfg, torch.float32, "cpu")
    ttok = load_tokenizer("byte")
    jds = jdata.EventChatDataset(paths["train"], jtok, jcfg_, event_folder=paths["events"],
                                 conv_version="plain")
    tds = tdata.EventChatDataset(paths["train"], ttok, cfg, event_folder=paths["events"],
                                 conv_version="plain")

    jmodel, j_ft = jstudy._finetune(jcfg_, jparams, jtok, jds, 2, 4, 3e-3, 1)
    tmodel, t_ft = tstudy._finetune(cfg, tp, ttok, tds, 2, 4, 3e-3, 1, "cpu")
    assert abs(t_ft - j_ft) <= LOSS_ATOL, (t_ft, j_ft)
    jheads, j_md = jstudy._train_heads(jcfg_, jmodel, jds, 3, 2, 4, 2e-3, 1)
    theads, t_md = tstudy._train_heads(cfg, tmodel, tds, 3, 2, 4, 2e-3, 1, "cpu")
    assert abs(t_md - j_md) <= LOSS_ATOL, (t_md, j_md)

    with open(paths["eval"]) as f:
        entries = json.load(f)
    traffic = tstudy.eval_traffic(cfg, ttok, entries, paths["events"])
    rnd = tstudy.random_heads(theads["w"].shape, "cpu")
    drafts = {"lookup": (None, None), "medusa_trained": (jheads, theads),
              "medusa_random": ({"w": jax.numpy.asarray(rnd["w"].numpy())}, rnd)}
    jmodel_np = jax.tree_util.tree_map(np.asarray, jmodel)
    chains = {}
    for name, (jd, td) in drafts.items():
        want, j_tpi, _ = jstudy._serve_traffic(jmodel, jcfg_, traffic, jd, 4, BUDGET, 1,
                                               jtok.eos_token_id)
        got, t_tpi, _ = tstudy._serve_traffic(tmodel, cfg, traffic, td, 4, BUDGET, 1,
                                              ttok.eos_token_id, "cpu")
        assert all(0 < len(c) <= BUDGET for c in got), name
        if got == want:
            assert t_tpi == j_tpi, name
        else:
            _same_or_tie(params_from_jax(jmodel_np, cfg, torch.float32, "cpu"), cfg, traffic,
                         got, want)
        chains[name] = got
    assert chains["lookup"] == chains["medusa_trained"] == chains["medusa_random"]


def test_random_heads_are_the_jax_studys():
    """The study's random stack is ``default_rng(7)`` normals times 0.5 in
    both packages (the JAX script builds it inline)."""
    rng = np.random.default_rng(7)
    want = rng.normal(size=(3, 64, 64)).astype(np.float32) * 0.5
    got = tstudy.random_heads((3, 64, 64), "cpu")["w"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert medusa_from_jax({"w": want}, torch.float32, "cpu")["w"].equal(got)


@pytest.mark.slow
def test_trained_heads_beat_random_on_held_out_traffic(tmp_path):
    """The JAX gate's bars on the port's run at the gate's scale."""
    record = tstudy.main([
        "--out_dir", str(tmp_path), "--n_train", "48", "--n_eval", "8",
        "--finetune_steps", "200", "--medusa_steps", "200", "--budget", "40",
        "--log_every", "100", "--device", "cpu"])
    trained = record["medusa_trained"]["tokens_per_iteration"]
    random_ = record["medusa_random"]["tokens_per_iteration"]
    assert random_ == pytest.approx(1.0, abs=0.15)
    assert trained > random_ + 0.5
    assert trained > 1.5
    assert record["lookup"]["tokens_per_iteration"] >= 1.0
