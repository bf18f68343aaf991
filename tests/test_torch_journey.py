"""The flight recorder through the port's ``ContinuousBatcher`` against the
JAX batcher's, f32 on the CPU.

Both batchers step in lockstep on a clock that reads the step count
(``time.perf_counter`` patched), on the same traffic: plain (paged lanes,
and dense synchronous), preempted (spill and drop), exported, handed off
between a prefill and a decode role, and swept by an engine fault. For
every request the journeys are equal: the event kinds and their fields,
the status, the phase decomposition, the dominant cause; and the phases
sum to the request's latency exactly. The SLO miss-cause counters, the
serving registry's summary and the tracer's request lifecycle events are
equal too.
"""

import time

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.cli import serve as jcli
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.obs import journey as jjourney
from eventgpt_tpu.obs import metrics as jmetrics
from eventgpt_tpu.obs import trace as jtrace
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.obs import journey as tjourney
from eventgpt_tpu_torch.obs import metrics as tmetrics
from eventgpt_tpu_torch.obs import trace as ttrace
from eventgpt_tpu_torch.serve import ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
FIRST = [([1, 5, -200, 9, 9], 0, 12), ([1, -200, 7, 7], 1, 3)]
LATE = [([1, 5, -200, 9, 9, 4], 0, 8), ([3, -200, 11], 3, 5)]
CONFIGS = {"paged_lanes": {"kv_layout": "paged", "prefill_budget": 4},
           "dense_sync": {"pipeline": False}}
LONG_S = 3600.0


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    # One jitted init: a seeded tree at a third of the eager init's time.
    jp = jax.jit(lambda k: jchat.init_eventchat_params(JCFG, k))(jax.random.PRNGKey(5))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


@pytest.fixture
def clock(monkeypatch):
    """Both recorders armed, both registries zeroed, and a clock that
    reads the step count."""
    now = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: now[0])
    prev = (tjourney.active(), jjourney.active(), ttrace.active(), jtrace.active())
    tjourney.configure(64)
    jjourney.configure(64)
    ttrace.configure(4096)
    jtrace.configure(4096)
    tmetrics.REGISTRY.reset()
    jmetrics.REGISTRY.reset()
    yield now
    tjourney._recorder, jjourney._recorder, ttrace._tracer, jtrace._tracer = prev


def _pair(trees, **kw):
    args = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **args),
            jserve.ContinuousBatcher(trees[0], JCFG, **args))


def _slo(w, i):
    # A tight interactive TTFT on the step clock: some requests miss it.
    return (w.SLO(name="interactive", ttft_s=0.5) if i % 2 == 0
            else w.SLO(name="batch", latency_s=LONG_S))


def _submit_both(port, jsrv, reqs, i0=0):
    rids = []
    for n, (ids, s, b) in enumerate(reqs):
        rid = port.submit(ids, _pv(s), b, slo=_slo(twork, i0 + n))
        assert jsrv.submit(ids, _pv(s), b, slo=_slo(jwork, i0 + n)) == rid
        rids.append(rid)
    return rids


def _lockstep(port, jsrv, clock, steps=None):
    n = 0
    while (port.queue or any(r is not None for r in port.rows)) and (steps is None or n < steps):
        clock[0] += 1.0
        port.step()
        jsrv.step()
        n += 1
    if steps is None:
        port._drain()
        jsrv._drain()


def _assert_same_journeys(port, jsrv, rids, finished=True):
    for rid in rids:
        t, j = port.journey(rid), jsrv.journey(rid)
        assert t is not None and j is not None, rid
        t.pop("owner"), j.pop("owner")
        assert t == j, rid
        if finished:
            assert t["finished"]
            assert sum(t["phases"].values()) == t["e2e_s"] == t["t_done"] - t["t_submit"]


def _request_events(mod):
    """The tracer's request lifecycle: (name, phase, rid, args) in order."""
    return [(e["name"], e["ph"], e["id"], e.get("args")) for e in mod.active().events()
            if e["cat"] == "request"]


def _assert_same_registry(skip=()):
    assert tmetrics.SERVE_SLO_MISS_CAUSE.labeled() == jmetrics.SERVE_SLO_MISS_CAUSE.labeled()
    t, j = (reg.summary(("egpt_serve_",)) for reg in (tmetrics.REGISTRY, jmetrics.REGISTRY))
    assert {k: v for k, v in t.items() if k not in skip} == \
        {k: v for k, v in j.items() if k not in skip}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_traffic_journeys_equal_jax(trees, clock, name):
    port, jsrv = _pair(trees, **CONFIGS[name])
    rids = _submit_both(port, jsrv, FIRST)
    _lockstep(port, jsrv, clock, steps=2)
    rids += _submit_both(port, jsrv, LATE, i0=len(FIRST))
    _lockstep(port, jsrv, clock)
    assert port.finished == jsrv.finished
    _assert_same_journeys(port, jsrv, rids)
    kinds = {e["kind"] for rid in rids for e in port.journey(rid)["events"]}
    assert {"submit", "queue", "prefix", "admit", "segment", "finish"} <= kinds
    if name == "paged_lanes":
        assert {"lane_join", "lane_finish"} <= kinds
    assert [r["rid"] for r in port.journey_index()] == [r["rid"] for r in jsrv.journey_index()]
    assert sum(tmetrics.SERVE_SLO_MISS_CAUSE.labeled().values()) >= 1
    _assert_same_registry()
    assert _request_events(ttrace) == _request_events(jtrace)
    assert len(_request_events(ttrace)) == 4 * len(rids)


@pytest.mark.parametrize("price", [1.0, 1e30], ids=["spill", "drop"])
def test_preempted_journeys_equal_jax(trees, clock, price):
    port, jsrv = _pair(trees, kv_layout="paged", kv_pool_blocks=4, preempt=True,
                       spill_capacity_mb=64)
    port._recompute_flops_per_s = jsrv._recompute_flops_per_s = price
    rids = []
    for srv, w in ((port, twork), (jsrv, jwork)):
        rid = srv.submit([1, 5, -200, 9, 9], _pv(0), 40, slo=w.SLO(name="batch",
                                                                  latency_s=LONG_S))
    rids.append(rid)
    _lockstep(port, jsrv, clock, steps=6)
    for srv, w in ((port, twork), (jsrv, jwork)):
        rid = srv.submit([3, -200, 11, 4], _pv(1), 12, slo=w.SLO(name="interactive", ttft_s=1.0))
    rids.append(rid)
    _lockstep(port, jsrv, clock)
    assert port.finished == jsrv.finished and port.preemptions == jsrv.preemptions >= 1
    _assert_same_journeys(port, jsrv, rids)
    kinds = [e["kind"] for e in port.journey(rids[0])["events"]]
    assert "preempt" in kinds
    assert ("restore" in kinds and "spill" in kinds) == (price == 1.0)
    assert port.journey(rids[0])["phases"]["preempt_s"] > 0
    _assert_same_registry()
    assert _request_events(ttrace) == _request_events(jtrace)
    assert ("active", "e", rids[0], {"status": "preempted"}) in _request_events(ttrace)


def test_exported_journeys_equal_jax(trees, clock):
    port, jsrv = _pair(trees, kv_layout="paged", prefill_budget=4)
    rids = _submit_both(port, jsrv, FIRST)
    _lockstep(port, jsrv, clock, steps=2)
    rids += _submit_both(port, jsrv, LATE, i0=len(FIRST))
    clock[0] += 1.0
    port.step()
    jsrv.step()
    clock[0] += 1.0
    t_out, j_out = port.export_requests(), jsrv.export_requests()
    assert [r["rid"] for r in t_out] == [r["rid"] for r in j_out] and len(t_out) >= 2
    _assert_same_journeys(port, jsrv, rids)
    assert {port.journey(r["rid"])["status"] for r in t_out} == {"exported"}
    _assert_same_registry()
    assert _request_events(ttrace) == _request_events(jtrace)


def test_handoff_journeys_equal_jax(trees, clock):
    args = {"kv_layout": "paged", "kv_pool_blocks": 12}
    pre_t, pre_j = _pair(trees, role="prefill", **args)
    dec_t, dec_j = _pair(trees, role="decode", **args)
    rid = _submit_both(pre_t, pre_j, FIRST[:1])[0]
    for _ in range(50):
        clock[0] += 1.0
        pre_t.step()
        pre_j.step()
        if pre_t.handoff_ready:
            break
    t_rec, j_rec = pre_t.pop_handoffs()[0], pre_j.pop_handoffs()[0]
    _assert_same_journeys(pre_t, pre_j, [rid])
    assert pre_t.journey(rid)["status"] == "handoff"
    t_leg, j_leg = dict(t_rec["journey"]), dict(j_rec["journey"])
    t_leg.pop("owner"), j_leg.pop("owner")
    assert t_leg == j_leg
    clock[0] += 1.0
    kw = {"tokens": t_rec["tokens"], "prompt_len": t_rec["prompt_len"],
          "elapsed_s": t_rec["elapsed_s"]}
    d_rid = dec_t.import_handoff(t_rec["input_ids"], t_rec["max_new_tokens"], t_rec["rec"], **kw)
    jrec = jax.tree_util.tree_map(np.asarray, j_rec["rec"])
    assert dec_j.import_handoff(j_rec["input_ids"], j_rec["max_new_tokens"], jrec, **kw) == d_rid
    _lockstep(dec_t, dec_j, clock)
    assert dec_t.finished == dec_j.finished
    _assert_same_journeys(dec_t, dec_j, [d_rid])
    kinds = [e["kind"] for e in dec_t.journey(d_rid)["events"]]
    assert kinds[:3] == ["submit", "queue", "kv_handoff"] and kinds[-1] == "finish"
    _assert_same_registry()


def test_fault_swept_journeys_equal_jax(trees, clock, monkeypatch):
    """The engine's fault sweep closes the in-flight rows' journeys as
    ``engine_fault`` and, on a breaker trip, the queue's too."""
    port, jsrv = _pair(trees, max_batch=1)
    rids = _submit_both(port, jsrv, FIRST + LATE[:1])
    _lockstep(port, jsrv, clock, steps=2)
    monkeypatch.setattr(jcli.ServingEngine, "_loop", lambda self: None)
    engines = (tcli.ServingEngine(port, tokenizer=None, breaker_threshold=1, start=False),
               jcli.ServingEngine(jsrv, tokenizer=None, breaker_threshold=1))
    clock[0] += 1.0
    for eng in engines:
        eng._on_fault(RuntimeError("injected"))
    _assert_same_journeys(port, jsrv, rids)
    assert {port.journey(r)["status"] for r in rids} == {"engine_fault"}
    # The port's sweep empties the queue and the rows through export_requests
    # and abort_rows, which zero the two gauges; the JAX sweep clears them by
    # hand and leaves the gauges at their last values (ROADMAP Queue 3).
    gauges = ("egpt_serve_queue_depth", "egpt_serve_active_rows")
    assert [tmetrics.REGISTRY.summary()[g] for g in gauges] == [0.0, 0.0]
    _assert_same_registry(skip=gauges)
