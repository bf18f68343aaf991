"""The port's prefix-KV cache against the JAX package's, case by case.

Each case of tests/test_prefix_cache.py runs the same traffic through the
JAX ``ContinuousBatcher`` (the oracle) and the port's, built with the same
flags over the same tiny f32 tree (``params_from_jax``), on the dense and
the paged layout with the f32 and the int8 cache. After every scheduler
step the two must agree on the cache's counters (hits, misses, evictions,
insertions, bytes), on every entry (key, length, bucket, pins, hits), on
the paged block tables and the pool's free blocks and copy-on-write
count; the chains must equal the JAX batcher's and one-shot ``generate``.
A hypothesis test drives both ``PrefixCache`` classes with one random
sequence of inserts, lookups, hits, pins and clears.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from eventgpt_tpu import config as jcfg
from eventgpt_tpu import serve as jserve
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import serve as tserve
from eventgpt_tpu_torch.models import eventchat as tchat
from eventgpt_tpu_torch.models.convert import params_from_jax

JCFG = jcfg.EventChatConfig.tiny()
TCFG = tcfg.EventChatConfig.tiny()
CASES = [("dense", False), ("dense", True), ("paged", False), ("paged", True)]
CASE_IDS = ["dense-f32", "dense-int8", "paged-f32", "paged-int8"]


def _pv(seed):
    rng = np.random.default_rng(seed)
    size = JCFG.vision.image_size
    return rng.normal(size=(JCFG.num_event_frames, 3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def trees():
    jp = jax.tree_util.tree_map(np.asarray,
                                jchat.init_eventchat_params(JCFG, jax.random.PRNGKey(5)))
    return jp, params_from_jax(jp, TCFG, torch.float32, "cpu")


def _pair(trees, layout, quant, **kw):
    """(JAX batcher, port batcher) with the same flags."""
    jp, tp = trees
    kw = {"max_batch": 2, "max_len": 256, "chunk": 4, "eos_token_id": None,
          "kv_layout": layout, "kv_quant": quant, **kw}
    return (jserve.ContinuousBatcher(jp, JCFG, **kw),
            tserve.ContinuousBatcher(tp, TCFG, device="cpu", **kw))


def _oneshot(trees, ids, pv, budget, quant):
    return tchat.generate(trees[1], TCFG, [ids], pv[None], max_new_tokens=budget,
                          temperature=0.0, eos_token_id=None, kv_quant=quant, device="cpu")[0]


def _observe(srv):
    """The cache's counters and entries, and the paged tables and pool."""
    pc = srv._prefix_cache
    obs = {}
    if pc is not None:
        obs["stats"] = {k: getattr(pc, k) for k in ("hits", "misses", "evictions",
                                                     "insertions", "n_entries", "bytes")}
        obs["entries"] = sorted((e.ids, e.pixels_key or b"", e.has_event, e.length, e.bucket,
                                 e.pins, e.hits, e.nbytes) for e in pc.entries())
    if srv.kv_layout == "paged":
        bt = srv.cache["bt"]
        obs["bt"] = np.asarray(bt.numpy() if isinstance(bt, torch.Tensor) else bt).tolist()
        pool = srv._pool.stats()
        obs["pool"] = (pool["free_blocks"], pool["cow_copies"])
    return obs


def _drain(srv, trace):
    """run_until_drained, step by step, observing after every step."""
    while srv.queue or any(r is not None for r in srv.rows):
        srv.step()
        trace.append(_observe(srv))
    srv._drain()
    out, srv.finished = srv.finished, {}
    return out


def _both(trees, layout, quant, scenario, **kw):
    """Run ``scenario(srv, trace)`` on both batchers; the traces and the
    returned chains must agree. Returns (port chains, port batcher)."""
    results = []
    for srv in _pair(trees, layout, quant, **kw):
        trace = []
        chains = scenario(srv, trace)
        results.append((chains, trace, srv))
    (jchains, jtrace, _), (tchains, ttrace, tsrv) = results
    assert len(ttrace) == len(jtrace)
    for i, (t, j) in enumerate(zip(ttrace, jtrace)):
        assert t == j, f"step {i}: port {t} vs jax {j}"
    assert tchains == jchains
    return tchains, tsrv


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_insert_on_prefill_populates_and_hits(trees, layout, quant):
    ids, pv = [1, 5, -200, 9, 9], _pv(0)

    def scenario(srv, trace):
        a = srv.submit(ids, pv, 6)
        out_a = _drain(srv, trace)[a]
        st_ = srv.prefix_cache_stats()
        assert st_["enabled"] and st_["n_entries"] == 2  # text head + event head
        assert {(e["has_event"], e["ids_len"]) for e in st_["entries"]} == {(False, 2),
                                                                            (True, 3)}
        b = srv.submit(ids, pv, 6)
        out_b = _drain(srv, trace)[b]
        assert srv._prefix_cache.hits == 1
        return [out_a, out_b]

    chains, _ = _both(trees, layout, quant, scenario)
    want = _oneshot(trees, ids, pv, 6, quant)
    assert chains == [want, want]


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_cache_on_off_chains_identical(trees, layout, quant):
    reqs = [([1, 5, -200, 9, 9], _pv(0), 7),
            ([1, 5, -200, 9, 9], _pv(1), 7),   # same text, another stream
            ([1, 5, -200, 3], _pv(0), 6),      # session 0 again
            ([2, 6, -200, 11], _pv(2), 6),     # another system head
            ([1, 5, -200, 9, 9], _pv(1), 7)]   # session 1 again

    def scenario(srv, trace):
        rids = [srv.submit(i, p, b) for i, p, b in reqs]
        out = _drain(srv, trace)
        return [out[r] for r in rids]

    on, srv = _both(trees, layout, quant, scenario)
    assert srv._prefix_cache.hits >= 2
    off, _ = _both(trees, layout, quant, scenario, prefix_cache=False)
    assert on == off
    for got, (i, p, b) in zip(on, reqs):
        assert got == _oneshot(trees, i, p, b, quant)


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_wrong_stream_never_hits_event_entry(trees, layout, quant):
    pv_a, pv_b = _pv(4), _pv(7)
    head = [1, 5, -200, 7]
    ids = head + [9, 9]

    class Req:
        input_ids = ids
        pixel_values = pv_b

    def scenario(srv, trace):
        srv.set_prefix(head, pixel_values=pv_a)  # the event entry only
        Req.pixel_values = pv_b
        assert srv._prefix_lookup(Req) is None  # another stream, no text entry
        Req.pixel_values = pv_a
        entry, suffix = srv._prefix_lookup(Req)
        assert entry.has_event and suffix == [9, 9]
        Req.pixel_values = None                  # session traffic inherits
        assert srv._prefix_lookup(Req)[0].has_event
        same, other = srv.submit(ids, pv_a, 6), srv.submit(ids, pv_b, 6)
        out = _drain(srv, trace)
        Req.pixel_values = pv_b                  # pv_b now has its own entry
        hit = srv._prefix_lookup(Req)
        assert hit is not None and hit[0].pixels_key == tserve._pixels_key(pv_b)
        return [out[same], out[other]]

    (same, other), _ = _both(trees, layout, quant, scenario)
    assert same == _oneshot(trees, ids, pv_a, 6, quant)
    assert other == _oneshot(trees, ids, pv_b, 6, quant)
    assert same != other


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_longest_prefix_match_prefers_deeper_entry(trees, layout, quant):
    ids, pv = [1, 5, -200, 9, 9], _pv(0)

    class Req:
        input_ids = ids
        pixel_values = pv

    def scenario(srv, trace):
        srv.submit(ids, pv, 5)
        out = _drain(srv, trace)
        entry, suffix = srv._prefix_lookup(Req)
        assert entry.has_event and len(entry.ids) == 3 and suffix == [9, 9]
        return list(out.values())

    _both(trees, layout, quant, scenario)


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_lru_eviction_under_byte_budget(trees, layout, quant):
    probe = _pair(trees, layout, quant)[1]
    entry_bytes = 128 * probe._kv_pos_bytes  # one bucket-128 text entry
    assert probe._kv_pos_bytes == _pair(trees, layout, quant)[0]._kv_pos_bytes

    def scenario(srv, trace):
        srv.set_prefix([1, 5, 7])
        srv.set_prefix([2, 6, 8])
        pc = srv._prefix_cache
        assert pc.n_entries == 2 and pc.bytes == 2 * entry_bytes
        trace.append(_observe(srv))
        srv.set_prefix([3, 9, 4])  # evicts the oldest, [1, 5, 7]
        trace.append(_observe(srv))
        assert pc.n_entries == 2 and pc.evictions == 1
        assert pc.get((1, 5, 7), None) is None and pc.get((3, 9, 4), None) is not None
        return []

    _both(trees, layout, quant, scenario, prefix_cache_bytes=2 * entry_bytes)
    for srv in _pair(trees, layout, quant, prefix_cache_bytes=entry_bytes // 2):
        with pytest.raises(ValueError, match="budget"):
            srv.set_prefix([1, 5, 7])


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_pin_blocks_eviction_while_row_decodes(trees, layout, quant):
    probe = _pair(trees, layout, quant)[1]
    entry_bytes = 128 * probe._kv_pos_bytes
    head, pv = [1, 5, -200, 7], _pv(1)
    ids = head + [9, 9]

    def scenario(srv, trace):
        srv.set_prefix(head, pixel_values=pv)
        pc = srv._prefix_cache
        key = jserve._pixels_key(pv)
        rid = srv.submit(ids, pv, 10)
        srv.step()  # admit from the entry (a pin), dispatch one segment
        trace.append(_observe(srv))
        entry = pc.get(tuple(head), key)
        assert entry is not None and entry.pins == 1
        srv.set_prefix([2, 6, 8])  # over budget: the newcomer is the only victim
        trace.append(_observe(srv))
        assert pc.get(tuple(head), key) is entry and pc.evictions == 1
        out = _drain(srv, trace)
        assert entry.pins == 0
        srv.set_prefix([3, 9, 4])  # unpinned now: evicted under pressure
        trace.append(_observe(srv))
        assert pc.get(tuple(head), key) is None
        return [out[rid]]

    # One row's pool (4 blocks) cannot also hold two operator entries: a
    # paged pool of 12 blocks does.
    chains, _ = _both(trees, layout, quant, scenario, max_batch=1, chunk=2,
                      prefix_cache_bytes=entry_bytes, prefix_insert=False,
                      kv_pool_blocks=12 if layout == "paged" else 0)
    assert chains == [_oneshot(trees, ids, pv, 10, quant)]


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_wave_batched_admission_exact_and_counted(trees, layout, quant):
    reqs = [([1, 5, -200, 9, 9], _pv(0), 6), ([1, -200, 7, 7, 8, 14], _pv(1), 5),
            ([3, -200, 11], _pv(2), 7)]

    def scenario(srv, trace):
        rids = [srv.submit(i, p, b) for i, p, b in reqs]
        out = _drain(srv, trace)
        return [out[r] for r in rids]

    chains, srv = _both(trees, layout, quant, scenario)
    # The first two share one batched prefill; the third admits alone.
    assert srv.dispatches == {"wave": 1, "full": 1}
    for got, (i, p, b) in zip(chains, reqs):
        assert got == _oneshot(trees, i, p, b, quant)


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_wave_quarantines_nan_member_and_admits_siblings(trees, layout, quant):
    bad = np.full_like(_pv(0), np.nan)
    reqs = [([1, 5, -200, 9, 9], _pv(1), 6), ([1, -200, 7, 7], bad, 6),
            ([3, -200, 11], _pv(2), 5)]

    def scenario(srv, trace):
        rids = [srv.submit(i, p, b) for i, p, b in reqs]
        out = _drain(srv, trace)
        assert srv.finish_status[rids[1]] == "nan_quarantined"
        return [out[r] for r in rids]

    chains, _ = _both(trees, layout, quant, scenario)
    assert chains[1] == []
    assert chains[0] == _oneshot(trees, *reqs[0][:2], 6, quant)
    assert chains[2] == _oneshot(trees, *reqs[2][:2], 5, quant)


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_wave_mixed_prompt_buckets(trees, layout, quant):
    reqs = [([1] + [7] * 130 + [-200, 9], _pv(0), 5),  # bucket 256
            ([3, -200, 11], _pv(1), 5)]                 # bucket 128

    def scenario(srv, trace):
        rids = [srv.submit(i, p, b) for i, p, b in reqs]
        out = _drain(srv, trace)
        return [out[r] for r in rids]

    chains, _ = _both(trees, layout, quant, scenario)
    for got, (i, p, b) in zip(chains, reqs):
        assert got == _oneshot(trees, i, p, b, quant)


@pytest.mark.parametrize("layout,quant", CASES, ids=CASE_IDS)
def test_disabled_cache_and_insert_off_modes(trees, layout, quant):
    ids, pv = [1, 5, -200, 9], _pv(0)
    for srv in _pair(trees, layout, quant, prefix_cache=False):
        with pytest.raises(RuntimeError, match="disabled"):
            srv.set_prefix([1, 5, 7])

    def scenario(srv, trace):
        rid = srv.submit(ids, pv, 5)
        out = _drain(srv, trace)
        return [out[rid]]

    chains, _ = _both(trees, layout, quant, scenario, prefix_cache=False)
    assert chains == [_oneshot(trees, ids, pv, 5, quant)]
    _, srv = _both(trees, layout, quant, scenario, prefix_insert=False)
    assert srv.prefix_cache_stats()["n_entries"] == 0


@pytest.mark.parametrize("cache_mod", [jserve, tserve], ids=["jax", "port"])
def test_trie_lookup_rules_standalone(cache_mod):
    """The trie's rules with no model, in both packages: proper prefix
    only, the sentinel on the right side, the wrong-stream exclusion,
    longest match, replacement."""
    entry = cache_mod._PrefixEntry
    pc = cache_mod.PrefixCache()
    text = entry(ids=(1, 5), pixels_key=None, has_event=False, kv={}, length=2, bucket=128,
                 nbytes=10)
    ev_a = entry(ids=(1, 5, -200), pixels_key=b"A", has_event=True, kv={}, length=12,
                 bucket=128, nbytes=10)
    ev_b = entry(ids=(1, 5, -200), pixels_key=b"B", has_event=True, kv={}, length=12,
                 bucket=128, nbytes=10)
    for e in (text, ev_a, ev_b):
        assert pc.insert(e)
    ids = [1, 5, -200, 9]
    assert pc.lookup(ids, b"A") is ev_a
    assert pc.lookup(ids, b"B") is ev_b
    assert pc.lookup(ids, b"C") is text
    assert pc.lookup(ids, None) in (ev_a, ev_b)
    assert pc.lookup([1, 5, -200], b"A") is text
    assert pc.lookup([1, 5], None) is None
    assert pc.lookup([2, 5, -200, 9], b"A") is None
    assert pc.lookup([1, 5, 9, 9], None) is None
    ev_a2 = entry(ids=(1, 5, -200), pixels_key=b"A", has_event=True, kv={}, length=12,
                  bucket=128, nbytes=10)
    assert pc.insert(ev_a2)
    assert pc.n_entries == 3 and pc.lookup(ids, b"A") is ev_a2


_TOK = st.sampled_from([1, 2, 5, -200])
_KEY = st.sampled_from([None, b"A", b"B"])
_OPS = st.lists(st.one_of(
    st.tuples(st.just("insert"), st.lists(_TOK, min_size=1, max_size=4), _KEY,
              st.integers(1, 4)),
    st.tuples(st.just("lookup"), st.lists(_TOK, min_size=1, max_size=6), _KEY),
    st.tuples(st.just("hit"), st.integers(0, 30)),
    st.tuples(st.just("pin"), st.integers(0, 30), st.booleans()),
    st.tuples(st.just("clear"),),
), max_size=40)


@settings(max_examples=30, deadline=None)
@given(ops=_OPS, budget=st.sampled_from([0, 3, 6]))
def test_random_cache_operations_agree_with_the_jax_cache(ops, budget):
    """One random sequence of inserts (with LRU eviction under a budget),
    lookups, hits, pins and clears gives the same answers and the same
    stats from both ``PrefixCache`` classes."""
    caches = [m.PrefixCache(budget) for m in (jserve, tserve)]
    entries = [[], []]  # what each cache has been given, by insertion order

    def key(e):
        return None if e is None else (e.ids, e.pixels_key)

    for op in ops:
        answers = []
        for c, mod, made in zip(caches, (jserve, tserve), entries):
            if op[0] == "insert":
                _, ids, pk, nbytes = op
                has_ev = -200 in ids and pk is not None
                e = mod._PrefixEntry(ids=tuple(ids), pixels_key=pk if has_ev else None,
                                     has_event=has_ev, kv={}, length=len(ids), bucket=128,
                                     nbytes=nbytes)
                made.append(e)
                answers.append(c.insert(e))
            elif op[0] == "lookup":
                answers.append(key(c.lookup(op[1], op[2])))
            elif op[0] == "hit" and made:
                c.count_hit(made[op[1] % len(made)])
            elif op[0] == "pin" and made:
                e = made[op[1] % len(made)]
                e.pins = e.pins + 1 if op[2] else max(e.pins - 1, 0)
            elif op[0] == "clear":
                c.clear()
        if answers:
            assert answers[0] == answers[1], op
        stats = [{k: v for k, v in c.stats().items() if k not in ("entries", "blocks_held")}
                 for c in caches]
        assert stats[0] == stats[1], op
        got = [sorted((e["ids_len"], e["has_event"], e["pins"], e["hits"], e["nbytes"])
                      for e in c.stats()["entries"]) for c in caches]
        assert got[0] == got[1], op
