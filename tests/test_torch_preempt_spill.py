"""Block-tier preemption and the host-RAM KV spill store: the port's
``ContinuousBatcher`` against the JAX one, f32 on the CPU.

An interactive arrival that the undersized pool cannot cover evicts the
batch row that decodes on it. Both arms run: the victim's block run is
spilled to the host store and restored byte for byte (forced by pricing
recompute at 1 FLOP/s), or dropped and re-prefilled (no store). Stepped in
lockstep with the JAX server, plain, with the int8 cache, speculative and
with piggyback lanes (the head then joins as a lane, which does not reset
the device carry: the eviction must):
- the chains equal the JAX batcher's token for token;
- after every step the host mirror, the queue and the rows, the
  preemption and deferral counters, ``pool.stats()`` and the spill store's
  stats are equal;
- while a record sits in the store, its planes equal the JAX record's
  (int8 payloads bit-equal; f32 planes within 1e-5, the bar of the paged
  cache against the JAX one in ``tests/test_torch_paged.py``: the two
  forwards round f32 sums differently, by up to 1.8e-6 here), as do its
  length, logits row and speculative ids;
- a restored row's blocks hold its record's bytes exactly over [0, length).
Also: the victim order and the spared rows, ``resource_exhausted`` when
both tiers are spent, the ``BlockPool`` spill registry and ``SpillStore``
errors and a random walk of the pool (each run on both packages' classes),
and the F1 skip rule across a restore that follows a segment whose carry
was read all frozen.
"""

import jax
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu import serve_blocks as jblocks
from eventgpt_tpu import workload as jwork
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import serve as serve_mod
from eventgpt_tpu_torch import serve_blocks as tblocks
from eventgpt_tpu_torch import workload as twork
from eventgpt_tpu_torch.models.convert import params_from_jax
from eventgpt_tpu_torch.serve import STATUS_RESOURCE, ContinuousBatcher

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
BATCH_IDS = [1, 5, -200, 9, 9]
INTER_IDS = [3, -200, 11, 4]
BATCH_BUDGET = 40
INTER_BUDGET = 12
F32_ATOL = 1e-5
PACKAGES = {"jax": (jblocks, jwork), "torch": (tblocks, twork)}
# Deadlines and SLO targets far beyond any run, so that a slow machine
# changes no status and no score between the packages.
LONG_S = 3600.0


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pair(trees, **kw):
    args = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
            "kv_layout": "paged", "preempt": True, **kw}
    return (ContinuousBatcher(trees[1], TCFG, device="cpu", **args),
            jserve.ContinuousBatcher(trees[0], JCFG, **args))


def _planes(x):
    if isinstance(x, dict):
        return {k: _planes(v) for k, v in x.items()}
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_record(trec, jrec, where):
    for key in ("k", "v"):
        t, j = _planes(trec[key]), _planes(jrec[key])
        if isinstance(j, dict):
            np.testing.assert_array_equal(t["q"], j["q"], err_msg=where)
            np.testing.assert_allclose(t["s"], j["s"], rtol=0, atol=F32_ATOL, err_msg=where)
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=F32_ATOL, err_msg=where)
    np.testing.assert_allclose(_planes(trec["logits"]), _planes(jrec["logits"]), rtol=0,
                               atol=F32_ATOL, err_msg=where)
    assert int(trec["length"]) == int(jrec["length"]), where
    for key in ("n_blocks", "nbytes_kv", "base_pos"):
        assert trec[key] == jrec[key], (where, key)
    assert ("ids" in trec) == ("ids" in jrec), where
    if "ids" in trec:
        np.testing.assert_array_equal(_planes(trec["ids"]), _planes(jrec["ids"]), err_msg=where)


def _assert_same(port, jsrv, where):
    np.testing.assert_array_equal(port.frozen, np.asarray(jsrv.frozen), err_msg=where)
    np.testing.assert_array_equal(port.n_rem, np.asarray(jsrv.n_rem), err_msg=where)
    assert [q.rid for q in port.queue] == [q.rid for q in jsrv.queue], where
    assert ([r.rid if r else None for r in port.rows]
            == [r.rid if r else None for r in jsrv.rows]), where
    assert port.finished == jsrv.finished, where
    assert port.finish_status == jsrv.finish_status, where
    assert port.preemptions == jsrv.preemptions, where
    assert port.block_deferrals == jsrv.block_deferrals, where
    assert port._pool.stats() == jsrv._pool.stats(), where
    assert port._spill_store.stats() == jsrv._spill_store.stats(), where
    for q in port.queue:
        trec = port._spill_store.peek(q.rid)
        if trec is not None:
            _assert_same_record(trec, jsrv._spill_store.peek(q.rid), f"{where} rid {q.rid}")
    if port.speculative:
        np.testing.assert_array_equal(port.ids_buf.numpy(), np.asarray(jsrv.ids_buf),
                                      err_msg=where)
        np.testing.assert_array_equal(port.base_pos, jsrv.base_pos, err_msg=where)


def _assert_restored_bytes(port, held, where):
    """Every request whose record left the store and that holds a row now
    was restored: its blocks hold the record's planes bit for bit over the
    positions below its length (the segment since may have written past
    it)."""
    for rid, rec in list(held.items()):
        if port._spill_store.peek(rid) is not None:
            continue
        del held[rid]
        req = next((r for r in port.rows if r is not None and r.rid == rid), None)
        if req is None:
            continue
        n = int(rec["length"])
        k, v = serve_mod._gather_blocks(port.cache, req.kv_blocks_owned)
        for got, want in ((k, rec["k"]), (v, rec["v"])):
            for g, w in zip(serve_mod._leaves(got), serve_mod._leaves(want)):
                assert torch.equal(g[:, :, :n], w[:, :, :n]), where


def _assert_pool_clean(srv):
    st = srv._pool.stats()
    assert st["free_blocks"] + st["used_blocks"] == st["usable_blocks"]
    assert st["spilled_runs"] == 0
    assert srv._spill_store.stats()["records"] == 0


def _lockstep(trees, spill_mb, steps=6, inter_budget=INTER_BUDGET, **kw):
    """The JAX suite's scenario, both packages stepped together: one batch
    row decoding on a 4-block pool, then an interactive arrival it cannot
    cover without an eviction."""
    port, jsrv = _pair(trees, kv_pool_blocks=4, spill_capacity_mb=spill_mb, **kw)
    if spill_mb:
        # Recompute is the cheaper arm on a tiny model: price it out.
        port._recompute_flops_per_s = jsrv._recompute_flops_per_s = 1.0
    rb = port.submit(BATCH_IDS, _pv(0), BATCH_BUDGET,
                     slo=twork.SLO(name="batch", latency_s=LONG_S))
    assert jsrv.submit(BATCH_IDS, _pv(0), BATCH_BUDGET,
                       slo=jwork.SLO(name="batch", latency_s=LONG_S)) == rb
    n = 0
    for _ in range(steps):
        port.step()
        jsrv.step()
        n += 1
        _assert_same(port, jsrv, f"step {n}")
    ri = port.submit(INTER_IDS, _pv(1), inter_budget,
                     slo=twork.SLO(name="interactive", ttft_s=LONG_S))
    jsrv.submit(INTER_IDS, _pv(1), inter_budget, slo=jwork.SLO(name="interactive", ttft_s=LONG_S))
    held = {}
    while port.queue or any(r is not None for r in port.rows):
        port.step()
        jsrv.step()
        n += 1
        _assert_same(port, jsrv, f"step {n}")
        _assert_restored_bytes(port, held, f"step {n}")
        held.update({q.rid: port._spill_store.peek(q.rid) for q in port.queue
                     if port._spill_store.peek(q.rid) is not None})
        assert n < 200, "the scenario does not drain"
    port._drain()
    jsrv._drain()
    _assert_same(port, jsrv, "drained")
    return port, jsrv, rb, ri


@pytest.mark.parametrize("kw", [{}, {"kv_quant": True}, {"speculative": 4},
                                {"prefill_budget": 4}],
                         ids=["plain", "int8_kv", "speculative", "lanes"])
@pytest.mark.parametrize("arm", ["spill", "drop"])
def test_preempted_chains_and_counters_match_jax(trees, kw, arm):
    port, jsrv, rb, ri = _lockstep(trees, 64 if arm == "spill" else 0, **kw)
    assert port.preemptions >= 1
    st = port._pool.stats()
    if arm == "spill":
        assert st["spills"] >= 1 and st["restores"] >= 1
    else:
        assert st["spills"] == 0
    assert len(port.finished[rb]) == BATCH_BUDGET and len(port.finished[ri]) == INTER_BUDGET
    assert port.slo_stats() == jsrv.slo_stats()
    _assert_pool_clean(port)


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "sync"])
def test_restore_after_a_segment_read_all_frozen_decodes(trees, pipeline):
    """F1's skip rule across a restore: the interactive row's budget ends
    inside a segment, so that segment stops on its flag and its carry is
    known all frozen; the victim restores at the next admission and must
    decode from there (a restore that kept the stale carry would leave it
    frozen for good), to the JAX chains."""
    seen = []
    restore = ContinuousBatcher._paged_restore

    def spy(self, req, row):
        seen.append(self._dev_carry is not None and self._dev_carry_frozen())
        return restore(self, req, row)

    ContinuousBatcher._paged_restore = spy
    try:
        port, _, rb, ri = _lockstep(trees, 64, inter_budget=10, pipeline=pipeline)
    finally:
        ContinuousBatcher._paged_restore = restore
    assert True in seen, seen
    assert len(port.finished[rb]) == BATCH_BUDGET and len(port.finished[ri]) == 10
    _assert_pool_clean(port)


@pytest.mark.parametrize("head,resident", [("batch", "batch"), ("interactive", "interactive")],
                         ids=["batch_head_defers", "no_interactive_thrash"])
def test_preemption_spares_interactive_rows_and_batch_heads(trees, head, resident):
    port, jsrv = _pair(trees, kv_pool_blocks=4, spill_capacity_mb=64)
    mk = {"batch": dict(name="batch", latency_s=LONG_S),
          "interactive": dict(name="interactive", ttft_s=LONG_S)}
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit(BATCH_IDS, _pv(0), BATCH_BUDGET, slo=w.SLO(**mk[resident]))
    for i in range(4):
        port.step()
        jsrv.step()
        _assert_same(port, jsrv, f"step {i}")
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit(INTER_IDS, _pv(1), INTER_BUDGET, slo=w.SLO(**mk[head]))
    for i in range(3):
        port.step()
        jsrv.step()
        _assert_same(port, jsrv, f"late step {i}")
    assert port.preemptions == 0 and port.block_deferrals >= 1
    out = port.run_until_drained()
    assert out == jsrv.run_until_drained()
    assert port.preemptions == 0
    assert len(out[0]) == BATCH_BUDGET and len(out[1]) == INTER_BUDGET
    _assert_pool_clean(port)


def test_victim_order_worst_headroom_first(trees):
    """The row with no deadline goes before the one racing a clock, and one
    eviction that covers the head ends the scan; as in the JAX batcher."""
    port, jsrv = _pair(trees, kv_pool_blocks=7, spill_capacity_mb=0, max_batch=3)
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit(BATCH_IDS, _pv(0), BATCH_BUDGET, deadline_s=LONG_S,
                   slo=w.SLO(name="batch", latency_s=LONG_S))
        srv.submit(BATCH_IDS, _pv(1), BATCH_BUDGET, slo=w.SLO(name="batch", latency_s=LONG_S))
    for i in range(6):
        port.step()
        jsrv.step()
        _assert_same(port, jsrv, f"step {i}")
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit([3, -200, 11], _pv(2), 140, slo=w.SLO(name="interactive", ttft_s=LONG_S))
    for i in range(8):
        port.step()
        jsrv.step()
        _assert_same(port, jsrv, f"late step {i}")
        if port.preemptions:
            break
    assert port.preemptions == 1
    assert [q.rid for q in port.queue] == [1]  # the no-deadline row
    assert {r.rid for r in port.rows if r is not None} == {0, 2}
    out = port.run_until_drained()
    assert out == jsrv.run_until_drained()
    assert len(out[0]) == len(out[1]) == BATCH_BUDGET and len(out[2]) == 140
    _assert_pool_clean(port)


def test_resource_exhausted_when_pool_and_spill_budget_are_spent(trees):
    port, jsrv = _pair(trees, kv_pool_blocks=3, spill_capacity_mb=1)
    for srv, w in ((port, twork), (jsrv, jwork)):
        store = srv._spill_store
        store.put("pad", {}, store.capacity_bytes)  # the host budget is spent
        srv.submit(BATCH_IDS, _pv(0), 24, slo=w.SLO(name="interactive", ttft_s=LONG_S))
    for i in range(2):
        port.step()
        jsrv.step()
        _assert_same(port, jsrv, f"step {i}")
    for srv, w in ((port, twork), (jsrv, jwork)):
        srv.submit(INTER_IDS, _pv(1), 8, slo=w.SLO(name="interactive", ttft_s=LONG_S))
    out = port.run_until_drained()
    assert out == jsrv.run_until_drained()
    assert port.finish_status[1] == STATUS_RESOURCE == jserve.STATUS_RESOURCE
    assert out[1] == [] and port.finish_status[0] == "ok" and len(out[0]) == 24
    assert port.slo_stats() == jsrv.slo_stats()
    port._spill_store.drop("pad")
    _assert_pool_clean(port)


# -- the BlockPool spill registry and the SpillStore, on both packages -----

def _store(blocks_mod, capacity):
    if blocks_mod is jblocks:
        return jblocks.SpillStore(capacity, owner="t17")
    return tblocks.SpillStore(capacity)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_spill_while_pinned_is_refused(pkg):
    pool = PACKAGES[pkg][0].BlockPool(8, 64, 1024)
    run = pool.alloc(3)
    pool.incref([run[1]])
    with pytest.raises(PACKAGES[pkg][0].BlockPoolError, match="spill-while-pinned"):
        pool.spill_out(run)
    assert [pool.ref(b) for b in run] == [1, 2, 1]
    st = pool.stats()
    assert st["free_blocks"] + st["used_blocks"] == st["usable_blocks"]
    assert st["spills"] == 0 and st["spilled_runs"] == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_double_spill_restore_and_unknown_runs_raise(pkg):
    mod = PACKAGES[pkg][0]
    pool = mod.BlockPool(8, 64, 1024)
    run = pool.alloc(3)
    rid = pool.spill_out(list(run))
    with pytest.raises(mod.BlockPoolError):
        pool.spill_out(list(run))
    with pytest.raises(mod.BlockPoolError, match="not registered"):
        pool.restore(rid + 999, 3)
    with pytest.raises(mod.BlockPoolError, match="not registered"):
        pool.drop_spilled(rid + 999)
    back = pool.restore(rid, 3)
    assert back == [3, 2, 1] and all(pool.ref(b) == 1 for b in back)
    with pytest.raises(mod.BlockPoolError, match="not registered"):
        pool.restore(rid, 3)
    with pytest.raises(mod.BlockPoolError, match="not registered"):
        pool.drop_spilled(rid)


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_restore_shortage_keeps_the_run(pkg):
    pool = PACKAGES[pkg][0].BlockPool(6, 64, 1024)
    run = pool.alloc(4)
    rid = pool.spill_out(run)
    hog = pool.alloc(4)
    assert pool.restore(rid, 4) is None
    assert pool.stats()["spilled_runs"] == 1
    pool.decref(hog)
    assert len(pool.restore(rid, 4)) == 4
    assert pool.stats()["spilled_runs"] == 0


@pytest.mark.parametrize("seed", [16, 17])
def test_pool_random_walk_matches_jax(seed):
    """Any interleaving of alloc / decref / spill_out / restore /
    drop_spilled keeps the refcount and free-count arithmetic exact, hands
    out the JAX pool's block ids, and a full teardown returns every block."""
    rng = np.random.default_rng(seed)
    pools = {pkg: mod[0].BlockPool(24, 64, 512) for pkg, mod in PACKAGES.items()}
    live, spilled = [], {}
    for _ in range(400):
        op = int(rng.integers(0, 5))
        if op == 0:
            n = int(rng.integers(1, 5))
            runs = {p: pool.alloc(n) for p, pool in pools.items()}
            assert runs["jax"] == runs["torch"]
            if runs["torch"]:
                live.append(runs["torch"])
        elif op == 1 and live:
            run = live.pop(int(rng.integers(0, len(live))))
            for pool in pools.values():
                pool.decref(run)
        elif op == 2 and live:
            run = live.pop(int(rng.integers(0, len(live))))
            ids = {p: pool.spill_out(run) for p, pool in pools.items()}
            assert ids["jax"] == ids["torch"]
            spilled[ids["torch"]] = len(run)
        elif op == 3 and spilled:
            rid = list(spilled)[int(rng.integers(0, len(spilled)))]
            backs = {p: pool.restore(rid, spilled[rid]) for p, pool in pools.items()}
            assert backs["jax"] == backs["torch"]
            if backs["torch"] is not None:
                assert len(backs["torch"]) == spilled.pop(rid)
                live.append(backs["torch"])
        elif op == 4 and spilled:
            rid = list(spilled)[int(rng.integers(0, len(spilled)))]
            for pool in pools.values():
                pool.drop_spilled(rid)
            del spilled[rid]
        st = pools["torch"].stats()
        assert st == pools["jax"].stats()
        assert st["free_blocks"] + st["used_blocks"] == st["usable_blocks"]
        assert st["used_blocks"] == sum(len(r) for r in live)
        assert st["spilled_runs"] == len(spilled)
    for pool in pools.values():
        for run in live:
            pool.decref(run)
        for rid in spilled:
            pool.drop_spilled(rid)
        st = pool.stats()
        assert st["free_blocks"] == st["usable_blocks"] and st["spilled_runs"] == 0


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_spill_store_budget_and_errors(pkg):
    mod = PACKAGES[pkg][0]
    store = _store(mod, 1000)
    assert store.enabled and store.would_fit(1000)
    assert store.put(1, {"x": 1}, 600)
    with pytest.raises(mod.BlockPoolError, match="already holds"):
        store.put(1, {"x": 2}, 10)
    assert not store.put(2, {"y": 2}, 600)
    st = store.stats()
    assert st["used_bytes"] == 600 and st["rejects"] == 1
    assert store.peek(1) == {"x": 1, "nbytes": 600}
    assert store.take(1)["x"] == 1
    with pytest.raises(mod.BlockPoolError, match="holds no spill record"):
        store.take(1)
    store.drop(1)
    assert store.stats() == {"capacity_bytes": 1000, "used_bytes": 0, "records": 0, "puts": 1,
                             "takes": 1, "drops": 0, "rejects": 1}
    disabled = _store(mod, 0)
    assert not disabled.enabled and not disabled.would_fit(1)
    store.clear()
