"""The port's memory ledger and headroom guard against the JAX package's,
f32 on the CPU.

- The ledger's arithmetic (register, resize, release, peak, the owner
  view) equals the JAX ledger's on the same calls.
- On the same tiny servers (dense, paged, int8 KV, speculative, with lanes)
  the port's components equal the JAX ledger's, but for one named
  difference (ROADMAP Queue 3): a lane's KV rows hold ``chunk_p`` positions
  beyond the lane bucket in the port. The static estimate equals the port's
  live tensor bytes, component by component.
- The prefix cache's and the spill store's bytes move in the ledger as in
  the JAX package.
- The guard defers an admission wave while rows decode and drains once
  they finish, with the JAX guarded batcher's deferrals and chains; a
  ``serve.mem_guard`` trip admits as if the guard were off.
- In a process that holds nothing but a tiny server, the ledger accounts
  for at least 90% of the live tensor bytes (the JAX bar); the compiled
  footprint is unavailable in eager PyTorch; the engine's ``/stats`` and
  ``/memory`` payloads carry the ledger.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import faults as jfaults
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu.obs import memory as jmemory
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import faults as tfaults
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.cli import serve as tcli
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.obs import memory as tmemory
from eventgpt_tpu_torch.serve import ContinuousBatcher

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
LONG_S = 3600.0
SERVERS = {"dense": {}, "paged": {"kv_layout": "paged"},
           "int8_lanes": {"kv_quant": True, "prefill_budget": 8},
           "paged_speculative": {"kv_layout": "paged", "speculative": 3}}


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


def _ids(n_tail=2):
    return [1] + [7] * 3 + [-200] + [9] * n_tail


@pytest.fixture(scope="module")
def trees():
    jp = jax.jit(lambda k: jchat.init_eventchat_params(JCFG, k))(jax.random.PRNGKey(5))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pair(trees, **kw):
    args = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **args),
            jserve.ContinuousBatcher(trees[0], JCFG, **args))


def test_the_ledger_arithmetic_is_the_jax_ledgers():
    out = []
    for mod in (tmemory, jmemory):
        led = mod.MemoryLedger()
        led.register("kv_cache", "a/kv", 100)
        led.register("weights", "shared/w", 50)
        led.resize("kv_cache", "a/kv", 40)
        peak = led.peak_bytes
        led.reset_peak()
        led.release("kv_cache", "a/kv")
        led.release("kv_cache", "a/kv")
        led.register("kv_cache", "b1/kv_cache", 7)
        with pytest.raises(ValueError, match="unknown memory component"):
            led.register("hbm_misc", "x", 1)
        out.append((peak, led.summary(), led.snapshot(), led.snapshot(owner="b1")))
    assert out[0] == out[1]
    assert out[0][0] == 150 and out[0][1]["total_bytes"] == 57
    assert tmemory.COMPONENTS == jmemory.COMPONENTS


@pytest.mark.parametrize("name", list(SERVERS))
def test_components_equal_jax_and_the_estimate_equals_live_bytes(trees, name):
    port, jsrv = _pair(trees, **SERVERS[name])
    if port.prefill_budget:
        port._ensure_lane_buffers(64)
        jsrv._ensure_lane_buffers(64)
    t_own = tmemory.LEDGER.snapshot(port._mem_owner)
    j_own = jmemory.LEDGER.snapshot(jsrv._mem_owner)
    if port.prefill_budget:
        # The named difference: the lane KV rows carry chunk_p more slots.
        extra = port._lane_cap * port._lane_chunk * tmemory.kv_pos_bytes(TCFG, False, 4)
        assert t_own.pop("lanes") == j_own.pop("lanes") + extra
    assert t_own == j_own
    assert tmemory.params_bytes(trees[1]) == jmemory.params_bytes(trees[0])
    est = port.memory_estimate()["components"]
    live = {"weights": tmemory.params_bytes(port.params),
            "logits": tmemory.params_bytes(port.logits)}
    if port._paged:
        live["kv_pool"] = tmemory.params_bytes([port.cache["k"], port.cache["v"]])
        live["kv_block_table"] = tmemory.params_bytes([port.cache["bt"], port.cache["length"]])
    else:
        live["kv_cache"] = tmemory.params_bytes(port.cache)
    if port.speculative:
        live["ids_buf"] = tmemory.params_bytes(port.ids_buf)
        live["draft"] = tmemory.params_bytes(port.spec_drafts)
    if port.prefill_budget:
        live["lanes"] = tmemory.params_bytes([port._lane_cache, port._lane_embeds])
    live["prefix_cache"] = port._prefix_cache.budget
    assert {k: est[k] for k in live if k in est} == {k: v for k, v in live.items() if v}
    assert tmemory.abstract_params_bytes(TCFG, dtype_bytes=4) == live["weights"]
    assert port.compiled_footprint()["unavailable"]


def test_prefix_and_spill_bytes_move_as_in_jax(trees):
    """Prefix entries: inserted, then evicted under a two-entry budget.
    Spill: a batch row preempted by an interactive head, spilled and
    restored. The owner's components follow each store's own bytes."""
    seen = []
    for k, (led, w) in enumerate(((tmemory.LEDGER, twork), (jmemory.LEDGER, jwork))):
        probe = _pair(trees, max_batch=1)[k]
        probe.set_prefix(_ids()[:5], pixel_values=_pv(1))
        entry = probe._prefix_cache.entries()[0].nbytes
        srv = _pair(trees, max_batch=1, prefix_cache_bytes=2 * entry)[k]
        own = lambda: led.snapshot(srv._mem_owner)  # noqa: E731
        trace = [own().get("prefix_cache", 0)]
        for seed in (1, 2, 3):
            srv.set_prefix(_ids()[:5], pixel_values=_pv(seed))
            trace.append((own()["prefix_cache"], srv._prefix_cache.bytes))
        trace.append(srv._prefix_cache.evictions)
        srv = _pair(trees, kv_layout="paged", kv_pool_blocks=4, preempt=True,
                    spill_capacity_mb=64)[k]
        srv._recompute_flops_per_s = 1.0
        srv.submit([1, 5, -200, 9, 9], _pv(0), 40, slo=w.SLO(name="batch", latency_s=LONG_S))
        for _ in range(6):
            srv.step()
        srv.submit([3, -200, 11, 4], _pv(1), 12, slo=w.SLO(name="interactive", ttft_s=LONG_S))
        for _ in range(40):
            srv.step()
            trace.append((own().get("spill", 0), srv._spill_store.stats()["used_bytes"]))
        srv.run_until_drained()
        trace.append((own().get("spill", 0), srv.preemptions))
        seen.append(trace)
    assert seen[0] == seen[1]
    t = seen[0]
    assert t[0] == 0 and t[3][0] == t[3][1] <= 2 * t[1][0] and t[4] >= 1
    assert all(a == b for a, b in t[5:-1]) and any(a > 0 for a, _ in t[5:-1])
    assert t[-1][0] == 0 and t[-1][1] >= 1


def _guarded(trees, pkg, headroom, capacity_over):
    if pkg == "torch":
        led, cls, args = tmemory.LEDGER, ContinuousBatcher, (trees[1], TCFG)
        kw = {"device": "cpu"}
    else:
        led, cls, args = jmemory.LEDGER, jserve.ContinuousBatcher, (trees[0], JCFG)
        kw = {}
    return cls(*args, max_batch=2, max_len=256, chunk=4, eos_token_id=None, prefix_cache=False,
               mem_headroom_bytes=headroom, mem_capacity_bytes=led.total() + capacity_over,
               **kw)


def _guard_run(srv):
    pv = _pv(0)
    r1 = srv.submit(_ids(), pv, 8)
    srv.step()  # an idle server: the guard lets r1 in
    r2 = srv.submit(_ids(3), pv, 4)
    srv.step()
    queued = any(req.rid == r2 for req in srv.queue)
    out = srv.run_until_drained()
    return [out[r1], out[r2]], srv.mem_deferrals, queued


def test_the_guard_defers_then_drains_as_jax(trees):
    """A capacity that leaves no room for any wave: every guarded boundary
    defers while r1 decodes, and r2 admits once r1 is done."""
    t = _guard_run(_guarded(trees, "torch", 1, 2))
    j = _guard_run(_guarded(trees, "jax", 1, 2))
    assert t == j and t[1] >= 1 and t[2]
    # Armed with room to spare it defers nothing and serves the same chains.
    roomy = _guard_run(_guarded(trees, "torch", 1024, 64 << 20))
    assert roomy[0] == t[0] and roomy[1] == 0


def test_the_guard_fault_site_degrades_to_admission(trees):
    for mod, pkg in ((tfaults, "torch"), (jfaults, "jax")):
        mod.configure("serve.mem_guard:n=1")
        try:
            chains, deferrals, queued = _guard_run(_guarded(trees, pkg, 1, 2))
            assert mod.stats()["serve.mem_guard"]["fires"] == 1
        finally:
            mod.configure(None)
        assert deferrals == 0 and not queued
        if pkg == "torch":
            want = chains
    assert chains == want


RECONCILE = r"""
import json, numpy as np, torch
from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.models.convert import init_eventchat_params
from eventgpt_tpu_torch.obs import memory as obs_memory
from eventgpt_tpu_torch.serve import ContinuousBatcher

cfg = EventChatConfig.tiny()
params = init_eventchat_params(cfg, torch.Generator().manual_seed(5), torch.float32, "cpu")
srv = ContinuousBatcher(params, cfg, max_batch=2, max_len=256, chunk=8, prefill_budget=8,
                        device="cpu")
srv.warmup(prompt_lens=[40])
pv = np.random.default_rng(0).normal(size=(cfg.num_event_frames, 3, cfg.vision.image_size,
                                           cfg.vision.image_size)).astype(np.float32)
srv.submit([1] + [7] * 3 + [-200] + [9] * 2, pv, 6)
srv.run_until_drained()
print(json.dumps(srv.memory_stats()["reconcile"]))
"""


def test_reconciliation_accounts_90pct_in_a_clean_process():
    proc = subprocess.run([sys.executable, "-c", RECONCILE], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-2000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["live_bytes"] > 0 and rec["accounted_ratio"] >= 0.90, rec


def test_engine_stats_and_memory_route_carry_the_ledger(trees):
    srv = ContinuousBatcher(trees[1], TCFG, max_batch=1, max_len=256, chunk=8, device="cpu")
    eng = tcli.ServingEngine(srv, tokenizer=None, start=False)
    st = eng.stats()
    assert st["memory"]["total_bytes"] > 0 and st["memory"]["owner"]["kv_cache"] > 0
    assert st["memory"]["guard"] == {"headroom_bytes": 0, "capacity_bytes": 0, "deferrals": 0}
    ms = eng.memory_stats()
    assert ms["reconcile"]["live_bytes"] > 0
    assert ms["estimate"]["components"]["kv_cache"] == tmemory.params_bytes(srv.cache)
    assert "unavailable" in ms["compiled"] and "owner" in ms
    assert tmemory.device_capacity_bytes("cpu") == 0
