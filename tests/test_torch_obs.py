"""The port's metrics registry, tracer and profiler hooks against the JAX
package's ``obs`` modules, on the CPU.

- The catalogue: every metric of the JAX registry exists in the port's with
  the same kind, help string, buckets and label enums, and a seeded
  sequence of inc/set/observe calls renders byte-identical Prometheus text
  and an equal ``summary()`` in both packages (common labels too).
- ``log2_buckets`` and the shared bucket families equal.
- The tracer: the same calls record the same events, ``write`` and
  ``load_trace`` round-trip, the ring keeps the newest ``capacity`` events.
- Disarmed probes do nothing: the registry stops counting, the tracer's
  probes return the null span, the recorder and the series store answer
  disarmed.
- ``profiling.capture`` on the CPU writes a Chrome trace that loads and
  names the ranges opened meanwhile, also on another thread when the
  installed PyTorch profiles every thread; a second capture while one runs
  raises ``CaptureBusyError``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from eventgpt_tpu.obs import metrics as jmetrics
from eventgpt_tpu.obs import trace as jtrace
from eventgpt_tpu_torch.obs import journey as tjourney
from eventgpt_tpu_torch.obs import metrics as tmetrics
from eventgpt_tpu_torch.obs import profiling as tprof
from eventgpt_tpu_torch.obs import series as tseries
from eventgpt_tpu_torch.obs import trace as ttrace


@pytest.fixture(autouse=True)
def _restore_global_telemetry():
    prev_enabled = tmetrics.REGISTRY.enabled
    prev_tracer = ttrace.active()
    yield
    tmetrics.configure(prev_enabled)
    ttrace._tracer = prev_tracer


def _clone(mod):
    """A private registry holding a copy of ``mod``'s catalogue, in
    registration order (the process-global one stays untouched)."""
    reg = mod.Registry()
    for m in mod.REGISTRY._metrics.values():
        if m.kind == "histogram":
            reg.histogram(m.name, m.help, m.bounds)
        elif m.kind == "gauge":
            reg.gauge(m.name, m.help)
        else:
            reg.counter(m.name, m.help)
    return reg


def test_the_catalogue_is_the_jax_packages():
    assert tmetrics.METRIC_LABELS == jmetrics.METRIC_LABELS
    jm, tm = jmetrics.REGISTRY._metrics, tmetrics.REGISTRY._metrics
    assert list(tm) == list(jm)
    for name, j in jm.items():
        t = tm[name]
        assert (t.kind, t.help) == (j.kind, j.help), name
        assert getattr(t, "bounds", None) == getattr(j, "bounds", None), name


@pytest.mark.parametrize("seed", [0, 1])
def test_the_same_events_render_the_same_bytes(seed):
    regs = {"jax": _clone(jmetrics), "torch": _clone(tmetrics)}
    rng = np.random.default_rng(seed)
    names = list(jmetrics.REGISTRY._metrics)
    ops = []
    for _ in range(400):
        name = names[rng.integers(len(names))]
        enums = jmetrics.METRIC_LABELS.get(name, {})
        labels = {k: str(v[rng.integers(len(v))]) for k, v in enums.items()}
        value = float(rng.choice([rng.exponential(0.3), rng.integers(0, 40), 2.0 ** -30, 1e9]))
        ops.append((name, labels, value, int(rng.integers(1, 4))))
    for reg in regs.values():
        if seed:
            reg.set_common_labels(process="3")
        for name, labels, value, n in ops:
            m = reg._metrics[name]
            if m.kind == "histogram":
                m.observe(value, n=n, **labels)
            elif m.kind == "gauge":
                m.set(value, **labels)
            else:
                m.inc(value, **labels)
    text = {k: r.render_prometheus() for k, r in regs.items()}
    assert text["torch"].encode() == text["jax"].encode()
    assert regs["torch"].summary() == regs["jax"].summary()
    assert regs["torch"].summary(("egpt_serve_",)) == regs["jax"].summary(("egpt_serve_",))
    # A label outside the enum raises in both.
    for mod, reg in ((jmetrics, regs["jax"]), (tmetrics, regs["torch"])):
        with pytest.raises(ValueError, match="outside"):
            reg._metrics["egpt_serve_requests_total"].inc(status="bogus")
        with pytest.raises(ValueError, match="already registered"):
            reg.counter("egpt_serve_tokens_total", "x")


def test_buckets_are_the_jax_packages():
    for lo, hi in ((2.0 ** -14, 2.0 ** 7), (0.3, 5.0), (1e-6, 1e3)):
        assert tmetrics.log2_buckets(lo, hi) == jmetrics.log2_buckets(lo, hi)
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS
    assert tmetrics.SHORT_BUCKETS == jmetrics.SHORT_BUCKETS
    assert tmetrics.ROWS_BUCKETS == jmetrics.ROWS_BUCKETS
    with pytest.raises(ValueError):
        tmetrics.log2_buckets(1.0, 0.5)
    h = _clone(tmetrics)._metrics["egpt_serve_ttft_seconds"]
    for v in (0.001, 0.002, 0.5, 3.0):
        h.observe(v)
    assert h.quantile(0.5) == 2.0 ** -8 and h.count() == 4


def _drive_tracer(mod, capacity):
    tr = mod.Tracer(capacity)
    for i in range(7):
        tr.instant("tick", cat="t", args={"i": i})
    tr.async_begin("queued", 3, args={"prompt_len": 5})
    tr.async_end("queued", 3)
    tr.complete("dispatch", 1.0, 1.5, cat="sched", args={"chunk": 4})
    return tr


def _shape(evs):
    return [{k: v for k, v in e.items() if k not in ("ts", "pid", "tid")} for e in evs]


def test_the_tracer_records_round_trips_and_stays_bounded(tmp_path):
    for cap in (64, 4):
        t, j = _drive_tracer(ttrace, cap), _drive_tracer(jtrace, cap)
        assert _shape(t.events()) == _shape(j.events())
        assert t.dropped() == j.dropped() == max(10 - cap, 0)
        assert len(t.events()) == min(cap, 10)
    path = str(tmp_path / "t.json")
    assert t.write(path) == 4
    assert ttrace.load_trace(path) == t.events() == jtrace.load_trace(path)
    assert t.events()[-1]["dur"] == 0.5 * 1e6


def test_disarmed_probes_do_nothing():
    ttrace.disable()
    assert ttrace.span("x") is ttrace._NULL and ttrace.active() is None
    ttrace.instant("x")
    ttrace.async_begin("queued", 1)
    reg = _clone(tmetrics)
    reg.configure(False)
    reg._metrics["egpt_serve_tokens_total"].inc(5)
    reg._metrics["egpt_serve_ttft_seconds"].observe(0.1)
    assert reg._metrics["egpt_serve_tokens_total"].total() == 0.0
    assert reg._metrics["egpt_serve_ttft_seconds"].count() == 0.0
    prev = tjourney.active()
    try:
        tjourney.disable()
        tjourney.begin(0, 1)
        tjourney.event(0, 1, "queue")
        assert tjourney.finish(0, 1, "ok") is None and tjourney.get(0, 1) is None
        assert tjourney.index() == []
    finally:
        tjourney._recorder = prev
    if tseries.active() is None:
        assert tseries.snapshot() == {"enabled": False}
        assert tseries.alerts() == {"enabled": False}
        assert tseries.sample_now() is None
    assert tprof.annotation("x") is tprof._NULL or tprof.armed()


def test_profiling_capture_writes_a_loadable_trace(tmp_path):
    stop = threading.Event()

    def engine():
        while not stop.is_set():
            with tprof.annotation("engine.segment"):
                torch.ones(8, 8) @ torch.ones(8, 8)
            time.sleep(0.002)

    th = threading.Thread(target=engine, daemon=True)
    th.start()
    try:
        d = str(tmp_path / "prof")
        result = {}

        def capture():
            result["dir"] = tprof.capture(0.3, d)

        cap = threading.Thread(target=capture)
        cap.start()
        time.sleep(0.05)
        with pytest.raises(tprof.CaptureBusyError):
            tprof.start_trace(d)
        cap.join(timeout=60)
    finally:
        stop.set()
        th.join(timeout=10)
    assert result["dir"] == d
    last = tprof.last_capture()
    assert os.path.dirname(last["trace_file"]) == d
    with open(last["trace_file"]) as f:
        evs = json.load(f)["traceEvents"]
    names = {e.get("name") for e in evs}
    if last["all_threads"]:
        assert "engine.segment" in names
    assert not tprof.armed() or tprof._profile_dir is not None
    assert tprof.stop_trace() is None
