"""The first admission wave over HTTP (``cli/serve.ServingEngine.arriving`` and
``_gather_arrivals``), and the ledger's shared weight entries, f32 on the CPU.

- Four requests posted at once to an idle server, each handler's event
  preprocessing slowed by another amount: they are admitted as one wave of
  four rows (one ``wave`` dispatch, no single-row ``full`` one), and their
  chains equal the JAX engine's on the same requests.
- A server with a live row does not wait on an announced arrival; an idle
  one holds its admission at most ``ADMIT_GATHER_S``.
- The memory ledger's ``shared/params-<id>`` entry is held by every batcher
  over the tree and by ``prepare_model`` while the tree lives; dropping the
  last holder releases it (the JAX ledger keeps it).
"""

import base64
import gc
import http.client
import io
import json
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from eventgpt_tpu import serve as jserve
from eventgpt_tpu.cli import serve as jcli
from eventgpt_tpu.data.tokenizer import load_tokenizer as jtok
from eventgpt_tpu.models import convert as jconv
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.obs import memory as tmemory
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import ContinuousBatcher

TCFG = tcfg.EventChatConfig.tiny()
WAIT_S = 60.0
# Each request's extra preprocessing seconds, by query.
DELAYS = {"q0": 0.05, "q1": 0.3, "q2": 0.45, "q3": 0.6}
ARGS = {"max_batch": 4, "chunk": 2, "max_len": 256, "eos_token_id": None,
        "pipeline": False, "prefix_cache": False}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One tiny tree for each package, drawn by the port (the JAX one read
    back through a checkpoint)."""
    d = str(tmp_path_factory.mktemp("gather") / "ckpt")
    tp = tconv.init_eventchat_params(TCFG, torch.Generator().manual_seed(3), torch.float32, "cpu")
    tconv.write_hf_checkpoint(tp, TCFG, d)
    from eventgpt_tpu import config as jcfg

    jc = jcfg.EventChatConfig.tiny()
    return jconv.eventchat_params_from_hf(jconv.load_state_dict(d), jc), tp, jc


@pytest.fixture(scope="module")
def b64():
    buf = io.BytesIO()
    np.save(buf, synthetic_event_stream(9, n_events=8000, height=96, width=128))
    return base64.b64encode(buf.getvalue()).decode()


def _wait(cond, what, bound=WAIT_S):
    deadline = time.monotonic() + bound
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


def _post(port, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT_S)
    conn.request("POST", "/v1/generate", body=json.dumps(obj))
    res = conn.getresponse()
    return res.status, json.loads(res.read())


def test_requests_posted_together_make_one_wave(trees, b64, monkeypatch):
    decode = tcli._decode_pixels
    pixels = {}

    def slow(payload, cfg, event_root=None):
        time.sleep(DELAYS[payload["query"]])
        pixels[payload["query"]] = decode(payload, cfg, event_root)
        return pixels[payload["query"]]

    monkeypatch.setattr(tcli, "_decode_pixels", slow)
    engine = tcli.ServingEngine(ContinuousBatcher(trees[1], TCFG, device="cpu", **ARGS),
                                ttok("byte"))
    engine.ADMIT_GATHER_S = WAIT_S  # only the arrivals end the hold here
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tcli.make_handler(engine, TCFG))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    got = {}
    try:
        port = httpd.server_address[1]

        def go(q):
            got[q] = _post(port, {"query": q, "event_b64": b64, "max_new_tokens": 5,
                                  "return_ids": True})

        threads = [threading.Thread(target=go, args=(q,)) for q in DELAYS]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        dispatches = dict(engine.batcher.dispatches)
        gathers = engine.stats()["admit_gather_s"]
    finally:
        httpd.shutdown()
        engine.shutdown()
        httpd.server_close()
    assert sorted(got) == sorted(DELAYS) and all(c == 200 for c, _ in got.values())
    assert dispatches == {"wave": 1}, dispatches
    # Held from the first submit to the last arrival's.
    assert gathers["n"] >= 1 and gathers["max_s"] >= DELAYS["q3"] - DELAYS["q0"] - 0.05
    ref = jcli.ServingEngine(jserve.ContinuousBatcher(trees[0], trees[2], **ARGS), jtok("byte"))
    try:
        want = {q: ref.result(ref.submit(q, pixels[q], 5), timeout=WAIT_S) for q in DELAYS}
    finally:
        ref.shutdown()
    assert {q: got[q][1]["ids"] for q in DELAYS} == {q: list(map(int, w))
                                                     for q, w in want.items()}


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = TCFG.vision.image_size
    return rng.normal(size=(TCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _rows(engine):
    return {r.rid for r in engine.batcher.rows if r is not None}


def test_a_live_row_never_waits_and_the_idle_hold_is_bounded(trees):
    ids = [1, 7, 7, -200, 9, 10, 11]
    engine = tcli.ServingEngine(ContinuousBatcher(trees[1], TCFG, device="cpu", **ARGS),
                                ttok("byte"))
    try:
        engine.ADMIT_GATHER_S = WAIT_S
        long_rid = engine.submit_ids(ids + [1], _pv(1), 200)
        _wait(lambda: long_rid in _rows(engine), "the long request to decode")
        with engine.arriving():  # an arrival that is still preprocessing
            t0 = time.monotonic()
            rid = engine.submit_ids(ids + [2], _pv(2), 3)
            engine.result(rid, timeout=WAIT_S)
            assert time.monotonic() - t0 < WAIT_S / 4
        assert engine._gathers["n"] == 0
        assert engine.cancel(long_rid)
        engine.result(long_rid, timeout=WAIT_S)
        _wait(lambda: not _rows(engine), "the rows to drain")
        # Idle: the announced arrival holds the admission until the bound.
        engine.ADMIT_GATHER_S = 0.3
        with engine.arriving():
            t0 = time.monotonic()
            rid = engine.submit_ids(ids + [3], _pv(3), 2)
            engine.result(rid, timeout=WAIT_S)
            took = time.monotonic() - t0
        assert 0.3 <= took < WAIT_S / 4
        assert engine._gathers["n"] == 1 and 0.29 <= engine._gathers["max_s"] < WAIT_S / 4
        assert engine._arriving == 0
    finally:
        engine.shutdown()


def test_the_last_holder_releases_the_shared_weight_entry(trees):
    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model

    led = tmemory.LEDGER
    tp = dict(trees[1])  # a tree of its own: the key is the tree's identity
    key = f"shared/params-{id(tp):x}"
    nbytes = tmemory.params_bytes(tp)
    b1 = ContinuousBatcher(tp, TCFG, device="cpu", **ARGS)
    b2 = ContinuousBatcher(tp, TCFG, device="cpu", **ARGS)
    assert led._holders.get(("weights", key), 0) == 2
    assert led.snapshot()["weights"] >= nbytes
    del b1
    gc.collect()
    assert led._holders.get(("weights", key), 0) == 1 and ("weights", key) in led._entries
    del b2
    gc.collect()
    assert led._holders.get(("weights", key), 0) == 0 and ("weights", key) not in led._entries
    # A prepared tree is held while it lives, and by a batcher over it.
    import argparse

    args = argparse.Namespace(model_path="tiny-random", use_event_qformer=False,
                              pretrain_query_embedder=None, pretrain_attention_layers=None,
                              quant="none", fuse_params=False, seed=0)
    cfg, params, tok = load_model("tiny-random", "float32", None, None, "cpu")
    cfg, params = prepare_model(cfg, params, tok, args)
    key = f"shared/params-{id(params):x}"
    b3 = ContinuousBatcher(params, cfg, device="cpu", **ARGS)
    assert led._holders.get(("weights", key), 0) == 2
    del b3
    gc.collect()
    assert ("weights", key) in led._entries
    total = led.total()
    del params
    gc.collect()
    assert ("weights", key) not in led._entries and led.total() < total
