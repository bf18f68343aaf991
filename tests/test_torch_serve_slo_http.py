"""SLO classes and the both-tiers-exhausted refusal through the port's HTTP
front end (``cli/serve``), on the CPU with the tiny random model.

A preempt-armed paged server whose pool holds exactly one request, and
whose spill store is full: a second interactive request finds no free
blocks, no victim (an interactive row is never one) and no spill room, so
it finishes ``resource_exhausted``, which the handler answers 503 with a
``Retry-After`` of the port's ``retry_after_s`` for its class and the
engine's goodput ratio; a full admission queue is a 429 with the same
rule. A request that carries ``slo_class`` is scored in
``GET /stats``'s ``slo``; an unknown class is a 400. The retry rule is held
against the JAX package's ``fleet.retry_after_s``.
"""

import base64
import http.client
import json
import math
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from eventgpt_tpu import fleet as jfleet
from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
from eventgpt_tpu_torch.ops.image import process_event_file
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream
from eventgpt_tpu_torch.serve import QueueFullError
from eventgpt_tpu_torch.workload import SLO

QUERY = "What is happening?"
FIRST_BUDGET = 300
# An SLO target far beyond any run, so that a slow machine changes no score.
LONG_S = 3600.0
FLAGS = ["--model_path", "tiny-random", "--device", "cpu", "--dtype", "float32",
         "--kv_layout", "paged", "--kv_cache", "int8", "--max_batch", "2", "--chunk", "4",
         "--preempt", "--spill_capacity_mb", "1", "--port", "0"]


@pytest.mark.parametrize("cls", ["interactive", "batch", "unknown"])
@pytest.mark.parametrize("goodput", [0.0, 0.3, 1.0, 1.7])
def test_retry_after_matches_jax(cls, goodput):
    for depth, cap in ((0, 0), (5, 10), (30, 10)):
        assert cli_serve.retry_after_s(cls, goodput, depth, cap) == \
            jfleet.retry_after_s(cls, goodput, depth, cap)


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """(port, engine, the stream's b64, the first request's rid): the first
    request is admitted and decoding before the HTTP server and the
    scheduler thread start, and the spill store is full."""
    parser = cli_serve.build_parser()
    args = parser.parse_args(FLAGS)
    cfg, params, tok = load_model(args.model_path, args.dtype, None, args.tokenizer_path, "cpu")
    cfg, params = prepare_model(cfg, params, tok, args)
    ids = tokenize_with_event(prepare_event_prompt(QUERY), tok)
    probe = cli_serve.make_batcher(args, params, cfg, tok, "cpu")
    prompt_len = len(ids) - 1 + cfg.num_event_tokens
    need = probe._blocks_needed(prompt_len, FIRST_BUDGET)
    assert probe._blocks_needed(prompt_len, 8) <= need
    args = parser.parse_args(FLAGS + ["--kv_pool_blocks", str(need + 1)])
    batcher = cli_serve.make_batcher(args, params, cfg, tok, "cpu")
    engine = cli_serve.ServingEngine(batcher, tok, start=False)
    path = str(tmp_path_factory.mktemp("slo") / "ev.npy")
    np.save(path, synthetic_event_stream(3, n_events=20_000))
    _, pixels = process_event_file(path, cfg.num_event_frames, cfg.vision.image_size)
    first = engine.submit_ids(ids, np.asarray(pixels), FIRST_BUDGET,
                              slo=SLO("interactive", ttft_s=LONG_S, itl_s=LONG_S))
    with engine._lock:
        for _ in range(2):
            batcher.step()
    assert batcher.rows[0] is not None and batcher._pool.free_blocks() == 0
    store = batcher._spill_store
    store.put("pad", {}, store.capacity_bytes)  # the host tier is spent
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), cli_serve.make_handler(
        engine, cfg, slo_classes=cli_serve.default_slo_classes(args)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    yield httpd.server_address[1], engine, b64, first
    httpd.shutdown()
    engine.shutdown()
    httpd.server_close()

def _post(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=json.dumps(obj))
    res = conn.getresponse()
    return res.status, dict(res.getheaders()), json.loads(res.read())


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    return json.loads(conn.getresponse().read())


def test_unknown_slo_class_is_a_400(stack):
    port, engine, b64, _ = stack
    code, _, obj = _post(port, "/v1/generate", {"query": QUERY, "event_b64": b64,
                                                "slo_class": "platinum"})
    assert code == 400 and "unknown slo_class" in obj["error"]
    assert not engine.batcher.queue


def test_resource_exhausted_is_a_503_with_the_class_retry_after(stack):
    port, engine, b64, first = stack
    box = {}

    def post():
        box["res"] = _post(port, "/v1/generate", {
            "query": QUERY, "event_b64": b64, "max_new_tokens": 8,
            "slo_class": "interactive", "slo_ttft_s": 1e-9})

    seen = []
    ratio = engine.goodput_ratio

    def spy():
        seen.append(ratio())
        return seen[-1]

    engine.goodput_ratio = spy
    client = threading.Thread(target=post)
    client.start()
    for _ in range(2000):  # the request is queued before the scheduler runs
        if engine.batcher.queue:
            break
        time.sleep(0.005)
    assert len(engine.batcher.queue) == 1
    engine.start()
    client.join(timeout=120)
    code, headers, obj = box["res"]
    assert code == 503 and obj["status"] == obj["error"] == "resource_exhausted"
    assert obj["slo_class"] == "interactive" and obj["slo_met"] is False
    # The handler read the window once: the refused request's miss, and the
    # first request's finish if it ended in the same step.
    assert len(seen) == 1 and seen[0] in (0.0, 0.5)
    ra = cli_serve.retry_after_s("interactive", seen[0])
    assert ra == jfleet.retry_after_s("interactive", seen[0]) > 1.0
    assert obj["retry_after_s"] == round(ra, 3)
    assert headers["Retry-After"] == str(max(1, math.ceil(ra)))
    stats = _get(port, "/stats")
    assert stats["slo"]["classes"]["interactive"]["met"] <= 1
    assert stats["role"] == "colocated" and stats["spill"]["preempt"] is True
    assert stats["spill"]["records"] == 1  # the pad
    assert {"preemptions", "spills", "restores", "deferrals"} <= stats["kv_blocks"].keys()
    # The first request, also interactive, is scored when it ends.
    engine.result(first, timeout=120)
    stats = _get(port, "/stats")
    assert stats["slo"]["classes"]["interactive"]["finished"] == 2
    assert stats["slo"]["classes"]["interactive"]["met"] == 1
    assert stats["slo"]["window_n"] == 2 and stats["slo"]["window_size"] == 256
    assert stats["slo"]["goodput_ratio"] == 0.5


@pytest.mark.parametrize("slo_class", ["interactive", None])
def test_queue_full_is_a_429_with_the_class_retry_after(stack, monkeypatch, slo_class):
    port, engine, b64, _ = stack

    def full(*args, **kwargs):
        raise QueueFullError("admission queue full")

    monkeypatch.setattr(engine, "submit", full)
    monkeypatch.setattr(engine, "goodput_ratio", lambda: 0.25)
    payload = {"query": QUERY, "event_b64": b64, "max_new_tokens": 8}
    if slo_class is not None:
        payload["slo_class"] = slo_class
    code, headers, obj = _post(port, "/v1/generate", payload)
    cls = slo_class or "batch"
    ra = cli_serve.retry_after_s(cls, 0.25)
    assert ra == jfleet.retry_after_s(cls, 0.25) > 1.0
    assert code == 429 and obj["slo_class"] == cls and obj["retry_after_s"] == round(ra, 3)
    assert headers["Retry-After"] == str(max(1, math.ceil(ra)))
