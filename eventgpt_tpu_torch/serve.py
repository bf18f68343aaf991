"""Continuous-batching serving loop (row-level request scheduling).

Port of ``eventgpt_tpu/serve.py``'s ``ContinuousBatcher`` for this slice of
the port: one resident KV cache of ``max_batch`` rows whose ROWS are the
resource -- requests join the running batch as rows free up, instead of
waiting for the whole batch to drain.

  * The cache is dense ((L, max_batch, max_len, KV, hd) per plane) or
    paged (one arena of SEQ_BUCKET-slot blocks plus per-row block tables,
    ``kv_layout="paged"``, allocated by ``serve_blocks.BlockPool``), in
    the compute dtype or int8 with per-vector scales (``kv_quant``).
  * Admission prefills the requests that are ready at one step as ONE
    padded batch (``_admit_wave``; a single request takes the batch-1
    path) into a dense row cache, then writes it into the shared cache
    at the free rows (dense) or scatters it into the rows' pool blocks
    and installs their tables (paged).
  * Decode runs in segments of up to ``chunk`` steps over every row
    (``_decode_segment``); between segments the host harvests tokens,
    finishes rows (EOS, budget, deadline, cancel, non-finite logits) and
    admits queued requests.
  * Frozen and free rows keep flowing through every decode step, as in
    the JAX package; their writes land at slot ``length`` (in the scratch
    block for a free paged row, inside the reservation's slack for an
    exhausted one), are masked out of every read, and their ``length`` is
    rolled back, so a row resumes exactly where it stopped.

The functions on the module update the resident cache in place under
``torch.inference_mode``: that takes the place of the JAX package's
``jit`` with donated buffers.

What the port does not have yet raises ``NotImplementedError`` when asked
for: speculative decoding and Medusa heads, the serving mesh, chunked
prefill, piggyback lanes (``prefill_budget > 0``), the prefix-KV cache,
preemption and spill, adaptive speculation buckets, prefill/decode roles,
the TTFT ramp (``first_chunk``) and the pipelined scheduler. So
``pipeline`` and ``prefix_cache`` default to False here. The JAX package
holds chains byte-identical with and without the prefix cache, lanes and
pipelining (``tests/test_serve.py``, ``tests/test_paged_blocks.py``): the
defaults change scheduling, not answers.

Greedy chains at f32 equal the JAX ``ContinuousBatcher``'s and the port's
one-shot ``generate`` (``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from eventgpt_tpu_torch.config import EventChatConfig
from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX, SEQ_BUCKET
from eventgpt_tpu_torch.data.tokenizer import split_at_event
from eventgpt_tpu_torch.device import resolve_device
from eventgpt_tpu_torch.models import eventchat
from eventgpt_tpu_torch.models import llama as llama_mod
from eventgpt_tpu_torch.ops.sampling import sample
from eventgpt_tpu_torch.serve_blocks import SCRATCH_BLOCK, BlockPool


class QueueFullError(RuntimeError):
    """submit() refused: the admission queue is at ``max_queue``. The HTTP
    layer maps this to 429 + Retry-After (backpressure, not failure)."""


# Terminal request statuses (``ContinuousBatcher.finish_status``). "ok"
# covers both EOS and budget exhaustion; the others are forced finishes
# whose row was freed without spending the rest of the budget.
STATUS_OK = "ok"
STATUS_DEADLINE = "deadline_exceeded"
STATUS_CANCELLED = "cancelled"
STATUS_NAN = "nan_quarantined"

_GRAIN = 2 * SEQ_BUCKET  # prompt buckets and max_len round to this


def _bucket(n: int, cap: int) -> int:
    return min((n + _GRAIN - 1) // _GRAIN * _GRAIN, cap)


@torch.inference_mode()
def _decode_segment(params, cfg: EventChatConfig, logits, cache, generator, frozen, n_rem,
                    chunk: int, eos_token_id: int, temperature: float = 0.0,
                    top_p: float = 1.0):
    """Up to ``chunk`` decode steps over the shared batch, the cache
    updated in place.

    ``frozen`` (B,) bool marks free rows and rows already finished;
    ``n_rem`` (B,) is each row's remaining budget. Returns (tokens
    (B, chunk), n_new (B,), done (B,), finite (B,), logits):
    ``tokens[r, :n_new[r]]`` are row r's newly committed tokens, ``done``
    marks rows that hit EOS inside this segment, ``finite`` whether each
    row's final logits are all finite. The loop stops once no row is
    live, read on the host at every step (the JAX while_loop's cond).
    """
    b = logits.shape[0]
    dev = logits.device
    tokens = torch.full((b, chunk), eos_token_id, dtype=torch.int32, device=dev)
    n_new = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    eos = torch.tensor(eos_token_id, dtype=torch.int32, device=dev)
    for t in range(chunk):
        live = ~(frozen | done) & (n_new < n_rem)
        if not bool(live.any()):
            break
        nxt = sample(logits, generator, temperature, top_p)
        commit = live
        nxt = torch.where(commit, nxt, eos)
        tokens[:, t] = torch.where(commit, nxt, tokens[:, t])
        n_new = n_new + commit.to(torch.int32)
        done = done | (commit & (nxt == eos))
        # Every row advances; frozen rows keep their logits and length.
        emb = llama_mod.embed_tokens(params["llama"], nxt[:, None].long())
        new_logits, cache = llama_mod.decode_step(params["llama"], cfg.llama, emb, cache)
        logits = torch.where(commit[:, None], new_logits, logits)
        cache["length"].copy_(torch.where(commit, cache["length"], cache["length"] - 1))
    finite = torch.isfinite(logits).all(dim=-1)
    return tokens, n_new, done, finite, logits


def _rows_in_bounds(rows: np.ndarray, limit: int):
    """Index of the entries of ``rows`` below ``limit``. The JAX scheduler
    marks pad and quarantined wave slots with row ``max_batch`` (and
    aliased or pad blocks with ``n_blocks``) and lets XLA drop those
    out-of-bounds scatter updates; torch indexing would raise, so the
    port keeps the sentinels and filters them before each scatter."""
    return np.nonzero(np.asarray(rows) < limit)[0]


def _ins(buf, src, fn):
    """Apply ``fn(plane, src_plane)`` to a cache buffer, plane by plane for
    an int8 buffer."""
    if isinstance(buf, dict):
        fn(buf["q"], src["q"])
        fn(buf["s"], src["s"])
    else:
        fn(buf, src)


@torch.inference_mode()
def _admit_row(cache, logits_buf, row: int, row_cache, row_logits) -> None:
    """Write a batch-1 prefill result into batch row ``row`` of the shared
    dense cache."""
    s1 = llama_mod._kv_max_len(row_cache)

    def put(buf, rbuf):
        buf[:, row:row + 1, :s1] = rbuf.to(buf.dtype)

    _ins(cache["k"], row_cache["k"], put)
    _ins(cache["v"], row_cache["v"], put)
    cache["length"][row] = row_cache["length"][0]
    logits_buf[row] = row_logits[0]


@torch.inference_mode()
def _admit_wave(cache, logits_buf, rows: np.ndarray, wave_k, wave_v, wave_len,
                wave_logits) -> None:
    """Write one batched admission prefill into the shared dense cache:
    wave slot i lands at row ``rows[i]``; slots with row >= max_batch (pow2
    pad, NaN quarantine) write nothing."""
    keep = _rows_in_bounds(rows, logits_buf.shape[0])
    dev = logits_buf.device
    src = torch.as_tensor(keep, dtype=torch.long, device=dev)
    dst = torch.as_tensor(np.asarray(rows)[keep], dtype=torch.long, device=dev)
    s1 = (wave_k["q"] if isinstance(wave_k, dict) else wave_k).shape[2]

    def put(buf, wbuf):
        buf[:, dst, :s1] = wbuf[:, src].to(buf.dtype)

    _ins(cache["k"], wave_k, put)
    _ins(cache["v"], wave_v, put)
    cache["length"][dst] = wave_len[src].to(cache["length"].dtype)
    logits_buf[dst] = wave_logits[src]


def _pool_scatter(buf, dst_blocks: np.ndarray, src) -> None:
    """Scatter a dense (L, n_src_rows, S, ...) cache buffer into pool
    blocks: the position axis splits into S / block_size whole blocks, and
    source block i of the flattened (row, block) order lands at pool block
    ``dst_blocks.reshape(-1)[i]``. Destinations >= n_blocks (the JAX
    package's drop sentinel: pad rows, blocks beyond a reservation) write
    nothing."""
    if isinstance(buf, dict):
        _pool_scatter(buf["q"], dst_blocks, src["q"])
        _pool_scatter(buf["s"], dst_blocks, src["s"])
        return
    n_layers, n_blocks, bs = buf.shape[0], buf.shape[1], buf.shape[2]
    n_src = (src.shape[1] * src.shape[2]) // bs
    r = src.reshape((n_layers, n_src, bs) + tuple(buf.shape[3:]))
    flat = np.asarray(dst_blocks).reshape(-1)
    keep = _rows_in_bounds(flat, n_blocks)
    dev = buf.device
    buf[:, torch.as_tensor(flat[keep], dtype=torch.long, device=dev)] = \
        r[:, torch.as_tensor(keep, dtype=torch.long, device=dev)].to(buf.dtype)


@torch.inference_mode()
def _admit_row_paged(cache, logits_buf, row: int, dst_blocks: np.ndarray, bt_row: np.ndarray,
                     row_cache, row_logits) -> None:
    """Paged form of ``_admit_row``: scatter the batch-1 row cache into the
    row's pool blocks (``dst_blocks`` per source block) and install its
    block table ``bt_row``."""
    _pool_scatter(cache["k"], dst_blocks, row_cache["k"])
    _pool_scatter(cache["v"], dst_blocks, row_cache["v"])
    dev = logits_buf.device
    cache["bt"][row] = torch.as_tensor(bt_row, dtype=torch.int32, device=dev)
    cache["length"][row] = row_cache["length"][0]
    logits_buf[row] = row_logits[0]


@torch.inference_mode()
def _admit_wave_paged(cache, logits_buf, rows: np.ndarray, dst_blocks: np.ndarray,
                      bt_rows: np.ndarray, wave_k, wave_v, wave_len, wave_logits) -> None:
    """Paged form of ``_admit_wave``: every member's row cache scatters into
    its block run (``dst_blocks`` (Nb, s1 / bs)) and its table and length
    are installed; pad and quarantined slots write nothing."""
    _pool_scatter(cache["k"], dst_blocks, wave_k)
    _pool_scatter(cache["v"], dst_blocks, wave_v)
    keep = _rows_in_bounds(rows, logits_buf.shape[0])
    dev = logits_buf.device
    src = torch.as_tensor(keep, dtype=torch.long, device=dev)
    dst = torch.as_tensor(np.asarray(rows)[keep], dtype=torch.long, device=dev)
    cache["bt"][dst] = torch.as_tensor(np.asarray(bt_rows)[keep], dtype=torch.int32,
                                       device=dev)
    cache["length"][dst] = wave_len[src].to(cache["length"].dtype)
    logits_buf[dst] = wave_logits[src]


@dataclass
class _Request:
    rid: int
    input_ids: Sequence[int]
    pixel_values: Any
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    row: int = -1
    # Cache positions the prompt occupies (text + event tokens).
    prompt_len: int = 0
    # perf_counter stamps at submit / first committed token / completion.
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # Absolute perf_counter deadline (None = none).
    deadline: Optional[float] = None
    # Paged layout: the pool blocks this request holds, and whether its
    # row's device table points at them (reset to scratch at release).
    kv_blocks_owned: List[int] = field(default_factory=list)
    kv_bt_written: bool = False


class ContinuousBatcher:
    """Row-level continuous batching over one resident KV cache.

    >>> srv = ContinuousBatcher(params, cfg, max_batch=4, max_len=1024)
    >>> rid = srv.submit(input_ids, pixel_values, max_new_tokens=64)
    >>> answers = srv.run_until_drained()   # {rid: [token ids]}

    Greedy by default (temperature 0); sampling settings apply serverwide.
    Runs on ``device`` (default ``cuda``, which raises without a card);
    ``params`` must already live there. Single-threaded: the owning
    ``cli.serve.ServingEngine`` serializes every call behind its lock;
    only ``BlockPool.stats()`` is read from other threads.
    """

    def __init__(
        self,
        params,
        cfg: EventChatConfig,
        max_batch: int = 4,
        max_len: int = 1024,
        chunk: int = 32,
        temperature: float = 0.0,
        top_p: float = 1.0,
        eos_token_id: Optional[int] = 2,
        seed: int = 0,
        kv_quant: bool = False,
        max_queue: int = 0,
        kv_layout: str = "dense",
        kv_pool_blocks: int = 0,
        device="cuda",
        speculative: int = 0,
        draft_head=None,
        mesh=None,
        prefill_chunk: int = 0,
        prefill_budget: int = 0,
        prefix_cache: bool = False,
        preempt: bool = False,
        spill_capacity_mb: int = 0,
        spec_buckets=None,
        role: str = "colocated",
        first_chunk: int = 0,
        pipeline: bool = False,
    ):
        unported = [
            (speculative, "speculative", "speculative decoding"),
            (draft_head is not None, "draft_head", "Medusa draft heads"),
            (mesh is not None, "mesh", "the serving mesh"),
            (prefill_chunk, "prefill_chunk", "chunked prefill"),
            (prefill_budget > 0, "prefill_budget", "piggyback prefill lanes"),
            (prefix_cache, "prefix_cache", "the prefix-KV cache"),
            (preempt, "preempt", "block-tier preemption"),
            (spill_capacity_mb, "spill_capacity_mb", "the KV spill store"),
            (spec_buckets, "spec_buckets", "adaptive speculation"),
            (role != "colocated", "role", "prefill/decode roles"),
            (first_chunk, "first_chunk", "the TTFT ramp"),
            (pipeline, "pipeline", "the pipelined scheduler"),
        ]
        for asked, arg, what in unported:
            if asked:
                raise NotImplementedError(
                    f"ContinuousBatcher({arg}=...): {what} is not ported to "
                    f"eventgpt_tpu_torch yet")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got {kv_layout!r}")
        self.device = resolve_device(device)
        embed = params["llama"]["embed_tokens"]
        if embed.device.type != self.device.type:
            raise ValueError(f"ContinuousBatcher on {self.device}: the parameters are on "
                             f"{embed.device}")
        self.device = embed.device
        self.params, self.cfg = params, cfg
        # A max_len off the prompt grain would let a bucketed row cache
        # outgrow the shared cache.
        max_len = (max_len + _GRAIN - 1) // _GRAIN * _GRAIN
        self.max_batch, self.max_len, self.chunk = max_batch, max_len, chunk
        self.temperature, self.top_p = float(temperature), float(top_p)
        self.eos = eos_token_id if eos_token_id is not None else -1
        self.eos_token_id = eos_token_id
        # A quantized weight tree computes in bf16, like the JAX package.
        self._dtype = embed.dtype if embed.dtype in (torch.bfloat16, torch.float32) \
            else torch.bfloat16
        self.kv_quant = bool(kv_quant)
        self.kv_layout = kv_layout
        self._paged = kv_layout == "paged"
        self._pool: Optional[BlockPool] = None
        if self._paged:
            self._kv_block_size = SEQ_BUCKET
            self._nbpr = max_len // SEQ_BUCKET  # table width (blocks per row)
            # Default pool: the dense layout's capacity plus the scratch
            # block, so the layout alone never shrinks what fits.
            n_blocks = int(kv_pool_blocks) or (max_batch * self._nbpr + 1)
            min_blocks = _GRAIN // SEQ_BUCKET + 1
            if n_blocks < min_blocks:
                raise ValueError(f"kv_pool_blocks={n_blocks} cannot hold one prompt bucket "
                                 f"({min_blocks - 1} blocks + 1 scratch)")
            self.cache = llama_mod.init_paged_kv_cache(
                cfg.llama, max_batch, max_len, n_blocks, SEQ_BUCKET, dtype=self._dtype,
                device=self.device, quant=self.kv_quant)
        else:
            self.cache = llama_mod.init_kv_cache(cfg.llama, max_batch, max_len,
                                                 dtype=self._dtype, device=self.device,
                                                 quant=self.kv_quant)
        self.kv_bytes = sum(t.numel() * t.element_size()
                            for plane in (self.cache["k"], self.cache["v"])
                            for t in (plane.values() if isinstance(plane, dict) else [plane]))
        if self._paged:
            self._pool = BlockPool(n_blocks, SEQ_BUCKET, block_bytes=self.kv_bytes // n_blocks)
            self.block_deferrals = 0
        # Vocab from the lm_head leaf: special tokens may have grown it.
        vocab = eventchat._vocab_size(params)
        self.logits = torch.zeros((max_batch, vocab), dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.frozen = np.ones((max_batch,), bool)  # all rows FREE
        self.n_rem = np.zeros((max_batch,), np.int64)
        self.rows: List[Optional[_Request]] = [None] * max_batch
        self.queue: deque = deque()
        self.finished: Dict[int, List[int]] = {}
        self.finish_status: Dict[int, str] = {}
        self.request_stats: Dict[int, Dict[str, float]] = {}
        self.max_queue = int(max_queue)
        self._n_deadlines = 0
        self._next_rid = 0
        # Counters: admission and decode host time (each ends in a read of
        # the device's results), prefill dispatches (each runs the model's
        # prefill once), decode segments and steps.
        self.admission_s = 0.0
        self.decode_s = 0.0
        self.prefill_dispatches = 0
        self.segments = 0
        self.decode_steps = 0

    # -- client surface ---------------------------------------------------

    def submit(self, input_ids: Sequence[int], pixel_values, max_new_tokens: int = 64,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; raises at once if it cannot fit, so one bad
        request never tears down the serving loop mid-drain.

        ``deadline_s``: seconds from now after which the request finishes
        with ``STATUS_DEADLINE`` and the tokens committed so far. Raises
        ``QueueFullError`` when the queue is at ``max_queue``."""
        if self.max_queue and len(self.queue) >= self.max_queue:
            raise QueueFullError(f"admission queue is full ({len(self.queue)}/"
                                 f"{self.max_queue} requests queued); retry later")
        ids = list(input_ids)
        n_ev = sum(1 for t in ids if t == EVENT_TOKEN_INDEX)
        if n_ev != 1:
            raise ValueError(f"prompt must contain exactly one {EVENT_TOKEN_INDEX} event "
                             f"sentinel, got {n_ev}")
        prompt_len = min(len(ids) - 1 + self.cfg.num_event_tokens,
                         self.cfg.llama.max_seq_len)
        # A finished row's frozen writes land one slot past its last
        # commit: that slot must stay inside the row.
        slack = 1
        if prompt_len + max_new_tokens + slack > self.max_len:
            raise ValueError(f"request does not fit: prompt {prompt_len} + budget "
                             f"{max_new_tokens} exceeds server max_len {self.max_len}")
        if self._paged:
            need = self._blocks_needed(prompt_len, max_new_tokens)
            if need > self._pool.usable:
                raise ValueError(f"request does not fit: needs {need} KV blocks, the pool "
                                 f"holds {self._pool.usable} (raise --kv_pool_blocks)")
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid, ids, pixel_values, max_new_tokens)
        req.prompt_len = prompt_len
        req.t_submit = time.perf_counter()
        if deadline_s is not None:
            req.deadline = req.t_submit + float(deadline_s)
            self._n_deadlines += 1
        self.queue.append(req)
        return rid

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request: it leaves the queue or its
        row is freed, and it finishes under ``STATUS_CANCELLED`` with the
        tokens it committed. False when the rid is unknown or finished."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                self._record_finish(req, STATUS_CANCELLED)
                return True
        for r, req in enumerate(self.rows):
            if req is not None and req.rid == rid:
                self._finish_row(r, status=STATUS_CANCELLED)
                return True
        return False

    def run_until_drained(self) -> Dict[int, List[int]]:
        while self.queue or any(r is not None for r in self.rows):
            self.step()
        out, self.finished = self.finished, {}
        return out

    def abort_rows(self) -> List[int]:
        """Free every row without finishing its request (the engine's
        fault path fails those requests itself); returns their rids. The
        rows' pool blocks return to the pool."""
        rids = []
        for r, req in enumerate(self.rows):
            if req is None:
                continue
            if self._paged:
                self._paged_release(req)
            if req.deadline is not None:
                self._n_deadlines -= 1
            self.rows[r] = None
            self.frozen[r] = True
            self.n_rem[r] = 0
            rids.append(req.rid)
        return rids

    def pool_stats(self) -> Optional[Dict[str, Any]]:
        """The block pool's snapshot with the deferral count (paged only)."""
        if not self._paged:
            return None
        return {**self._pool.stats(), "deferrals": self.block_deferrals}

    # -- scheduler core ---------------------------------------------------

    def step(self) -> None:
        """One scheduling iteration: expire deadlines, admit into free rows,
        run one decode segment, harvest it."""
        self._expire_deadlines()
        t0 = time.perf_counter()
        self._admit()
        self.admission_s += time.perf_counter() - t0
        if all(r is None for r in self.rows) or bool(self.frozen.all()):
            return
        t0 = time.perf_counter()
        self._harvest_segment(self._dispatch_segment())
        self.decode_s += time.perf_counter() - t0

    def _expire_deadlines(self) -> None:
        """Forced finish of every request past its deadline: queued ones
        leave the queue, active rows are frozen mid-decode, each with
        ``STATUS_DEADLINE`` and its committed tokens."""
        if self._n_deadlines <= 0:
            return
        now = time.perf_counter()

        def expired(req):
            return req.deadline is not None and now > req.deadline

        if any(expired(q) for q in self.queue):
            keep = deque()
            for req in self.queue:
                if expired(req):
                    self._record_finish(req, STATUS_DEADLINE)
                else:
                    keep.append(req)
            self.queue = keep
        for r, req in enumerate(self.rows):
            if req is not None and not self.frozen[r] and expired(req):
                self._finish_row(r, status=STATUS_DEADLINE)

    def _dispatch_segment(self) -> dict:
        frozen = torch.as_tensor(self.frozen, device=self.device)
        n_rem = torch.as_tensor(self.n_rem.astype(np.int32), device=self.device)
        tokens, n_new, done, finite, self.logits = _decode_segment(
            self.params, self.cfg, self.logits, self.cache, self.generator, frozen, n_rem,
            self.chunk, int(self.eos), self.temperature, self.top_p)
        self.segments += 1
        return {"tokens": tokens, "n_new": n_new, "done": done, "fin": finite,
                "frozen_in": self.frozen.copy()}

    def _harvest_segment(self, rec: dict) -> None:
        """Fetch a segment's outputs to the host and apply the row
        bookkeeping: commit tokens, stamp the first token, decrement
        budgets, finish EOS / exhausted / non-finite rows."""
        tokens = rec["tokens"].cpu().numpy()
        n_new = rec["n_new"].cpu().numpy()
        done = rec["done"].cpu().numpy()
        finite = rec["fin"].cpu().numpy()
        frozen_in = rec["frozen_in"]
        self.decode_steps += int(n_new.max(initial=0))
        now = time.perf_counter()
        for r, req in enumerate(self.rows):
            # Rows frozen at dispatch produced nothing here.
            if req is None or frozen_in[r]:
                continue
            if not finite[r]:
                # Non-finite logits poison only this row: its segment
                # tokens are discarded and the request fails.
                self._finish_row(r, status=STATUS_NAN)
                continue
            new = tokens[r, : n_new[r]]
            if len(new) and req.t_first is None:
                req.t_first = now
            req.tokens.extend(int(t) for t in new)
            self.n_rem[r] -= int(n_new[r])
            if done[r] or self.n_rem[r] <= 0:
                self._finish_row(r)

    def _finish_row(self, r: int, status: str = STATUS_OK) -> None:
        req = self.rows[r]
        self.rows[r] = None
        self.frozen[r] = True
        self.n_rem[r] = 0
        self._record_finish(req, status)

    def _record_finish(self, req: _Request, status: str) -> None:
        if self._paged:
            # The reservation returns on every terminal path.
            self._paged_release(req)
        if req.deadline is not None:
            self._n_deadlines -= 1
        ids = req.tokens
        if self.eos_token_id is not None and ids and ids[-1] == self.eos_token_id:
            ids = ids[:-1]
        req.t_done = time.perf_counter()
        # Bounded: a long-lived server must not grow host state forever.
        while len(self.request_stats) >= 8192:
            self.request_stats.pop(next(iter(self.request_stats)))
        while len(self.finish_status) >= 8192:
            self.finish_status.pop(next(iter(self.finish_status)))
        ttft = (req.t_first if req.t_first is not None else req.t_done) - req.t_submit
        self.request_stats[req.rid] = {"ttft_s": ttft, "latency_s": req.t_done - req.t_submit}
        self.finished[req.rid] = ids
        self.finish_status[req.rid] = status

    # -- paged KV block pool ----------------------------------------------

    def _blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks one request reserves at admission: its prompt bucket (the
        admission scatter writes whole blocks) and its decode horizon
        prompt + budget + slack. The whole horizon is reserved up front,
        so an admitted row can always finish."""
        bucket = _bucket(prompt_len, self.max_len)
        cover = min(max(bucket, prompt_len + max_new + 1), self.max_len)
        return self._pool.blocks_for(cover)

    def _paged_admit_gate(self) -> bool:
        """The queue head admits only when its whole reservation fits the
        free list; otherwise it stays queued, and finishing rows free the
        blocks it needs. Deferral changes timing, never a chain."""
        req = self.queue[0]
        need = self._blocks_needed(req.prompt_len, req.max_new_tokens)
        if self._pool.free_blocks() >= need:
            return True
        self.block_deferrals += 1
        return False

    def _paged_requeue(self, req: _Request, row: int) -> None:
        """Undo a pop whose reservation failed: free the row and put the
        request back at the queue front."""
        self.rows[row] = None
        req.row = -1
        self.queue.appendleft(req)
        self.block_deferrals += 1

    def _paged_reserve(self, req: _Request, s1: int) -> bool:
        """Allocate the request's reservation; False when the pool cannot
        cover it now (never a partial grant)."""
        cover = min(max(s1, req.prompt_len + req.max_new_tokens + 1), self.max_len)
        owned = self._pool.alloc(self._pool.blocks_for(cover))
        if owned is None:
            return False
        req.kv_blocks_owned = owned
        return True

    def _paged_bt_row(self, req: _Request) -> np.ndarray:
        """The row's block table: its reservation, then scratch block 0."""
        bt = np.full((self._nbpr,), SCRATCH_BLOCK, np.int32)
        bt[: len(req.kv_blocks_owned)] = req.kv_blocks_owned
        return bt

    def _paged_dst_blocks(self, req: _Request, s1: int) -> np.ndarray:
        """Scatter destinations of the row's s1-slot prefilled cache; blocks
        beyond the reservation (a wave's bucket can exceed a short
        member's) take the drop sentinel n_blocks."""
        n_src = s1 // self._kv_block_size
        dst = np.full((n_src,), self._pool.n_blocks, np.int32)
        own = req.kv_blocks_owned[:n_src]
        dst[: len(own)] = own
        return dst

    def _paged_release(self, req: _Request) -> None:
        """Return the reservation, and point the dead row's table back at
        scratch so its frozen writes never reach a recycled block."""
        if req.kv_blocks_owned:
            self._pool.decref(req.kv_blocks_owned)
            req.kv_blocks_owned = []
        if req.kv_bt_written and req.row >= 0:
            self.cache["bt"][req.row] = SCRATCH_BLOCK
            req.kv_bt_written = False

    # -- admission --------------------------------------------------------

    def _admit(self) -> bool:
        """Admit queued requests into free rows: every request ready at this
        step joins one full-prefill wave (a single request takes the
        batch-1 path). Returns True when it popped the queue."""
        wave: List[tuple] = []
        while self.queue and any(r is None for r in self.rows):
            if self._paged and not self._paged_admit_gate():
                break
            req = self.queue.popleft()
            row = next(r for r in range(self.max_batch) if self.rows[r] is None)
            # Reserve the row now; it stays frozen until activation.
            self.rows[row] = req
            req.row = row
            if self._paged and not self._paged_reserve(req, _bucket(req.prompt_len,
                                                                     self.max_len)):
                self._paged_requeue(req, row)
                break
            wave.append((req, row))
        if not wave:
            return False
        if len(wave) > 1:
            self._admit_wave(wave)
            return True
        req, row = wave[0]
        padded, mask, prompt_len = self._prep_request(req)
        row_cache = self._new_row_cache(padded.shape[1])
        with torch.inference_mode():
            row_logits, row_cache = llama_mod.prefill(
                self.params["llama"], self.cfg.llama, padded, mask, row_cache, last_only=True)
        self.prefill_dispatches += 1
        self._finish_admission(req, row, prompt_len, row_cache, row_logits)
        return True

    def _pixels(self, pixel_values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(pixel_values), device=self.device).to(self._dtype)

    @torch.inference_mode()
    def _prep_request(self, req: _Request):
        """CLIP encode, splice and pad one request to its prompt bucket:
        (padded (1, s1, D), mask (1, s1), prompt_len)."""
        ev = eventchat.encode_events_batch(self.params, self.cfg,
                                           self._pixels(req.pixel_values)[None])
        embeds = [eventchat.splice_embeddings(self.params, self.cfg,
                                              split_at_event(req.input_ids), ev[0])]
        padded, mask, lens = eventchat._pad_batch(embeds)
        prompt_len = int(lens[0])
        s1 = _bucket(prompt_len, self.max_len)
        padded = F.pad(padded, (0, 0, 0, s1 - prompt_len))
        mask = F.pad(mask, (0, s1 - prompt_len))
        return padded, mask, prompt_len

    def _new_row_cache(self, s1: int, batch: int = 1):
        return llama_mod.init_kv_cache(self.cfg.llama, batch, s1, dtype=self._dtype,
                                       device=self.device, quant=self.kv_quant)

    @torch.inference_mode()
    def _admit_wave(self, wave: List[tuple]) -> None:
        """Batched admission prefill: the members pad to the widest member's
        prompt bucket and to the next power-of-two wave size; pad slots keep
        one real position (finite garbage KV instead of an all-masked
        softmax) and scatter nowhere."""
        n = len(wave)
        nb = 1 << (n - 1).bit_length()
        pv = torch.stack([self._pixels(req.pixel_values) for req, _ in wave])
        if nb > n:
            pv = torch.cat([pv, torch.zeros((nb - n,) + tuple(pv.shape[1:]), dtype=pv.dtype,
                                            device=pv.device)])
        ev = eventchat.encode_events_batch(self.params, self.cfg, pv)
        embeds = [eventchat.splice_embeddings(self.params, self.cfg,
                                              split_at_event(req.input_ids), ev[i])
                  for i, (req, _) in enumerate(wave)]
        padded, mask, lens = eventchat._pad_batch(embeds)
        prompt_lens = [int(x) for x in lens]
        s1 = _bucket(max(prompt_lens), self.max_len)
        padded = F.pad(padded, (0, 0, 0, s1 - padded.shape[1], 0, nb - n))
        mask = F.pad(mask, (0, s1 - mask.shape[1], 0, nb - n))
        if nb > n:
            mask[n:, 0] = True
        wave_cache = self._new_row_cache(s1, batch=nb)
        wave_logits, wave_cache = llama_mod.prefill(
            self.params["llama"], self.cfg.llama, padded, mask, wave_cache, last_only=True)
        self.prefill_dispatches += 1
        self._scatter_wave(wave, wave_cache, wave_logits, prompt_lens)

    def _scatter_wave(self, members: List[tuple], wave_cache, wave_logits,
                      prompt_lens: List[int]) -> None:
        """Per-member NaN quarantine, the one scatter of every surviving
        row into the shared cache, then row activation. Quarantined and
        pad slots keep row ``max_batch`` (written nowhere)."""
        nb = wave_logits.shape[0]
        rows = np.full((nb,), self.max_batch, np.int32)
        finite = torch.isfinite(wave_logits[: len(members)]).all(dim=-1).cpu().numpy()
        good = []
        for i, (req, row) in enumerate(members):
            if not finite[i]:
                # The poisoned member never touches the shared cache.
                self.rows[row] = None
                self.frozen[row] = True
                self._record_finish(req, STATUS_NAN)
                continue
            rows[i] = row
            good.append((i, req, row))
        if self._paged:
            s1 = llama_mod._kv_max_len(wave_cache)
            dst = np.full((nb, s1 // self._kv_block_size), self._pool.n_blocks, np.int32)
            bt_rows = np.full((nb, self._nbpr), SCRATCH_BLOCK, np.int32)
            for i, req, row in good:
                dst[i] = self._paged_dst_blocks(req, s1)
                bt_rows[i] = self._paged_bt_row(req)
                req.kv_bt_written = True
            _admit_wave_paged(self.cache, self.logits, rows, dst, bt_rows, wave_cache["k"],
                              wave_cache["v"], wave_cache["length"], wave_logits)
        else:
            _admit_wave(self.cache, self.logits, rows, wave_cache["k"], wave_cache["v"],
                        wave_cache["length"], wave_logits)
        for i, req, row in good:
            self._activate_row(req, row)

    def _finish_admission(self, req: _Request, row: int, prompt_len: int, row_cache,
                          row_logits) -> None:
        """Write the prefilled row into the shared cache and activate it,
        unless its logits are not finite (then the request fails before it
        touches the shared cache)."""
        if not bool(torch.isfinite(row_logits).all()):
            self.rows[row] = None
            self.frozen[row] = True
            self._record_finish(req, STATUS_NAN)
            return
        if self._paged:
            s1 = llama_mod._kv_max_len(row_cache)
            _admit_row_paged(self.cache, self.logits, row, self._paged_dst_blocks(req, s1),
                             self._paged_bt_row(req), row_cache, row_logits)
            req.kv_bt_written = True
        else:
            _admit_row(self.cache, self.logits, row, row_cache, row_logits)
        self._activate_row(req, row)

    def _activate_row(self, req: _Request, row: int) -> None:
        self.rows[row] = req
        req.row = row
        self.frozen[row] = False
        self.n_rem[row] = req.max_new_tokens

