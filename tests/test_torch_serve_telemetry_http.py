"""The telemetry routes of the port's HTTP front end (``cli/serve``), on the
CPU with the tiny random model, at the JAX CLI's telemetry defaults.

One server: three requests, then every route. ``GET /metrics`` counts them
(requests and TTFTs), ``GET /stats`` merges the registry, the alerts, the
ledger and the kernel launches, ``GET /trace`` holds one queued/active pair
per request (``?rid=`` filters), ``GET /requests`` and ``GET /request?rid=``
give journeys whose phases sum to their latency, ``GET /series`` and
``GET /alerts`` answer from the series store, ``GET /memory`` from the
ledger; ``POST /profile`` answers 400 on bad seconds and 409 while another
capture runs, and its trace loads. At shutdown ``--trace_out`` is written
and loads. A second server with ``--no_telemetry`` answers the same token
ids for the same queries, and its ``/trace`` is a 404.
"""

import base64
import http.client
import json
import os
import threading

import numpy as np
import pytest

from eventgpt_tpu_torch.cli import serve as cli_serve
from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import profiling as obs_profiling
from eventgpt_tpu_torch.obs import series as obs_series
from eventgpt_tpu_torch.obs import trace as obs_trace
from eventgpt_tpu_torch.ops.raster import synthetic_event_stream

QUERIES = ["What is happening?", "Describe the motion.", "What is happening?"]
FLAGS = ["--model_path", "tiny-random", "--device", "cpu", "--dtype", "float32",
         "--kv_layout", "paged", "--kv_cache", "int8", "--max_batch", "2", "--chunk", "4",
         "--max_new_tokens", "6", "--port", "0"]


def _serve(args):
    httpd, engine = cli_serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, engine


def _stop(httpd, engine):
    httpd.shutdown()
    engine.shutdown()
    httpd.server_close()


def _req(port, method, path, obj=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=None if obj is None else json.dumps(obj))
    res = conn.getresponse()
    body = res.read()
    ctype = res.getheader("Content-Type", "")
    return res.status, ctype, (json.loads(body) if "json" in ctype else body.decode())


def _generate(port, b64):
    return [_req(port, "POST", "/v1/generate", {"query": q, "event_b64": b64,
                                                "return_ids": True, "debug": True})[2]
            for q in QUERIES]


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tele") / "ev.npy")
    np.save(path, synthetic_event_stream(4, n_events=20_000))
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


@pytest.fixture(scope="module")
def served(tmp_path_factory, stream):
    """(port, engine, answers, tmp dir) of the armed server, traffic done."""
    d = tmp_path_factory.mktemp("armed")
    obs_metrics.REGISTRY.reset()
    args = cli_serve.build_parser().parse_args(
        FLAGS + ["--trace_out", str(d / "trace.json"), "--profile_dir", str(d / "prof")])
    httpd, engine = _serve(args)
    answers = _generate(httpd.server_address[1], stream)
    yield httpd.server_address[1], engine, answers, d
    _stop(httpd, engine)
    obs_profiling.configure(None)


def test_metrics_and_stats_count_the_requests(served):
    port, engine, answers, _ = served
    assert all(a["status"] == "ok" for a in answers)
    assert all(a["debug"]["rid"] == a["rid"] and len(a["ids"]) == a["tokens"] for a in answers)
    code, ctype, text = _req(port, "GET", "/metrics")
    assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
    assert 'egpt_serve_requests_total{status="ok"} 3' in text.splitlines()
    assert "egpt_serve_ttft_seconds_count 3" in text.splitlines()
    assert text == obs_metrics.REGISTRY.render_prometheus()
    _, _, st = _req(port, "GET", "/stats")
    assert st["metrics"]["egpt_serve_requests_total"] == {'{status="ok"}': 3.0}
    assert st["metrics"]["egpt_serve_ttft_seconds"]["count"] == 3
    assert st["memory"]["owner"]["kv_pool"] > 0 and "alerts" in st
    assert set(st["launches"]) == {"flash_attention.cu", "int4_matmul.cu",
                                   "decode_attention.cu", "paged_attention.cu"}


def test_trace_journeys_series_alerts_and_memory(served):
    port, engine, answers, _ = served
    rids = [a["rid"] for a in answers]
    _, _, tr = _req(port, "GET", "/trace")
    for rid in rids:
        phases = [(e["name"], e["ph"]) for e in tr["traceEvents"] if e.get("id") == rid]
        assert phases == [("queued", "b"), ("queued", "e"), ("active", "b"), ("active", "e")]
    _, _, one = _req(port, "GET", f"/trace?rid={rids[0]}")
    assert {e["id"] for e in one["traceEvents"]} == {rids[0]}
    _, _, idx = _req(port, "GET", "/requests")
    assert idx["enabled"] and sorted(r["rid"] for r in idx["requests"]) == sorted(rids)
    for rid in rids:
        code, _, j = _req(port, "GET", f"/request?rid={rid}")
        assert code == 200 and j["status"] == "ok" and j["finished"]
        assert sum(j["phases"].values()) == pytest.approx(j["e2e_s"], rel=1e-9, abs=1e-12)
        assert j["events"][0]["kind"] == "submit" and j["events"][-1]["kind"] == "finish"
    assert _req(port, "GET", "/request?rid=99999")[0] == 404
    assert _req(port, "GET", "/request")[0] == 400
    obs_series.sample_now()
    obs_series.sample_now()
    code, _, ser = _req(port, "GET", "/series?n=4")
    assert code == 200 and ser["enabled"] and ser["samples"] >= 2 and ser["points"]
    assert _req(port, "GET", "/series?n=x")[0] == 400
    code, _, al = _req(port, "GET", "/alerts")
    assert code == 200 and al["enabled"] and set(al["rules"]) == set(obs_series.ALERT_RULES)
    code, _, mem = _req(port, "GET", "/memory")
    assert code == 200 and mem["components"]["weights"] > 0
    assert mem["reconcile"]["live_bytes"] > 0 and "unavailable" in mem["compiled"]
    assert mem["estimate"]["components"]["kv_pool"] == mem["owner"]["kv_pool"]


def test_profile_route_refuses_bad_seconds_and_a_second_capture(served):
    port, _, _, d = served
    for bad in ({"seconds": -1}, {"seconds": "x"}, {"seconds": 500}, [1]):
        assert _req(port, "POST", "/profile", bad)[0] == 400
    box = {}
    first = threading.Thread(target=lambda: box.update(
        res=_req(port, "POST", "/profile", {"seconds": 0.5})))
    first.start()
    for _ in range(2000):
        if obs_profiling._prof is not None or "res" in box:
            break
        threading.Event().wait(0.005)
    code, _, err = _req(port, "POST", "/profile", {"seconds": 0.1})
    first.join(timeout=120)
    assert code == 409 and "already running" in err["error"]
    code, _, res = box["res"]
    assert code == 200 and res["profile_dir"] == str(d / "prof")
    with open(res["trace_file"]) as f:
        assert json.load(f)["traceEvents"]


def test_trace_out_and_no_telemetry_give_the_same_answers(served, stream, tmp_path):
    port, engine, answers, d = served
    engine.shutdown()
    events = obs_trace.load_trace(str(d / "trace.json"))
    assert any(e.get("name") == "queued" for e in events)
    args = cli_serve.build_parser().parse_args(FLAGS + ["--no_telemetry"])
    httpd, eng = _serve(args)
    try:
        port2 = httpd.server_address[1]
        plain = _generate(port2, stream)
        assert [a["ids"] for a in plain] == [a["ids"] for a in answers]
        assert [a["answer"] for a in plain] == [a["answer"] for a in answers]
        assert all(a["debug"] is None for a in plain)
        assert _req(port2, "GET", "/trace")[0] == 404
        assert not obs_metrics.enabled() and obs_series.active() is None
        assert _req(port2, "GET", "/requests")[2] == {"requests": [], "enabled": False}
    finally:
        _stop(httpd, eng)
        obs_metrics.configure(True)
    assert os.path.exists(d / "trace.json")
