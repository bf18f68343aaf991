"""HTTP serving front end over the continuous batcher, on a CUDA card.

Port of ``eventgpt_tpu/cli/serve.py`` for this slice of the port: one
process owns the card and the resident decode batch
(``eventgpt_tpu_torch/serve.py``); a stdlib ThreadingHTTPServer feeds it
through a thread-safe ``ServingEngine``, whose scheduler thread steps the
batcher while work exists, restarts after a fault and opens a circuit
breaker after a streak of them. With ``--fleet N`` the handler serves a
``fleet.Fleet`` of N engines over one weight tree through the same surface;
with ``--proc_fleet N`` a ``fleet_proc.ProcFleet`` coordinator, which loads
no model and spawns N worker processes (this module with ``--worker``), each
owning an engine and its model on the card, behind the same surface.

Endpoints:
  POST /v1/generate  {"query": str,
                      "event_path": .npy path under --event_root |
                      "event_b64": base64 .npy bytes,
                      "max_new_tokens": int = --max_new_tokens,
                      "stream": true (optional: a chunked NDJSON body of
                      {"delta"} / {"restart"} events and a last {"done"}, which
                      carries the ids with "return_ids"),
                      "deadline_s": float (optional),
                      "debug": true (optional: the answer carries its journey),
                      "return_ids": true (optional: and its token ids),
                      "slo_class": "interactive" | "batch" (optional), with
                      optional per-request "slo_ttft_s" / "slo_itl_s" /
                      "slo_latency_s" overrides of the class targets}
      -> {"answer": str, "tokens": N, "rid": id, "status": "ok",
          "ttft_s": x, "latency_s": y[, "slo_class", "slo_met"]}; a forced
          finish maps to 504 (deadline), 499 (cancelled), 500 (non-finite
          logits) or 503 (resource_exhausted: no blocks, no victim and no
          spill room, with a class-aware Retry-After); a full queue or a
          fleet's shed is a 429, and an open breaker (or a fleet with no
          routable replica) a 503, each with a Retry-After (the breaker's
          remaining cooldown while it is open).
  POST /cancel       {"rid": id} -> {"rid": id, "cancelled": bool}
  POST /prefix       {"prefix_prompt": str, optional "event_path"/"event_b64"
                      when the prefix runs through the event block}
      -> {"prefix_len": N, "entries": N, "bytes": N}: inserts a prefix-KV
         cache entry on a running server
  GET  /prefix_cache -> the prefix cache's entries, budget and counters
  GET  /health       -> {"status": "ok", "active": N, "queued": N, "faults": N,
                        "restarts": N}; 503 {"status": "degraded", ...} with
                        Retry-After while the breaker is open
  GET  /fleet        -> (``--fleet``) replicas, routable, pins, shed, failovers,
                        kills, per-replica state and the policy; (``--proc_fleet``)
                        workers, routable, pins, failovers, deaths, respawns,
                        kills, crash loops, roles, handoffs, per-worker state and
                        the policy
  GET  /stats        -> engine counters, block-pool state (preemptions,
                        spills, restores, deferrals) and spill store, SLO
                        attainment, the role, recent requests, under
                        --speculative the speculation counters, the memory
                        ledger's summary (``memory``), the registry's serving
                        summary (``metrics``), the alerts and each kernel's
                        launches in this process (``launches``)
  GET  /metrics      -> the metrics registry as Prometheus text (0.0.4)
  GET  /trace[?rid=N] -> the trace ring as Chrome trace events (404 when
                        --trace_buffer 0 or --no_telemetry)
  GET  /request?rid=N -> one request's journey: events, phases, cause
  GET  /requests[?n=N] -> the last finished requests' index
  GET  /series[?window_s=S&n=N] -> the sampled time series and its windows
  GET  /alerts       -> the burn-rate alert rules' state and transition log
  GET  /memory       -> the ledger, its reconciliation with the card's
                        allocated bytes, the static estimate
  POST /profile      {"seconds": S in [0, 120]} -> a torch.profiler capture of
                        S seconds of the running server, written as a Chrome
                        trace into --profile_dir (else a temporary dir): 400 on
                        bad seconds, 409 while another capture runs
  With --fleet the journeys are stitched across a request's assignments,
  and the series, alerts and memory are the process's with each replica's
  share; with --proc_fleet the coordinator's journeys are stitched from the
  workers' phase durations, and the series, alerts and memory gather each
  worker's over RPC beside the coordinator's own. A process fleet delivers
  a streamed request at its finish (one delta), so it can fail over; the
  in-process fleet ends a streamed request on a killed replica with the
  fault.

Ported flags: --model_path (tiny-random or a checkpoint dir), --tokenizer_path
byte, --use_event_qformer, --pretrain_query_embedder,
--pretrain_attention_layers, --max_batch, --max_len, --chunk,
--temperature, --max_new_tokens, --dtype, --quant, --fuse_params,
--kv_cache, --kv_layout, --kv_pool_blocks, --max_queue,
--default_deadline_s, --max_body_mb, --drain_timeout_s, --host, --port,
--event_root, --conv_mode, --device (default cuda), --attn_impl (as in
``cli/infer``), and the scheduler's
flags with the JAX CLI's defaults and meanings: the pipelined scheduler
(``--no_pipeline`` turns it off), the prefix-KV cache (``--prefix_cache_mb``
512, 0 = unbounded; ``--no_prefix_cache``; ``--prefix_prompt`` with
``--prefix_event`` caches a head at startup), piggyback prefill lanes
(``--prefill_budget`` -1 = ``--chunk`` prompt tokens per boundary, 0 =
off), the TTFT ramp (``--first_chunk``), chunked prefill
(``--prefill_chunk``), speculative decoding (``--speculative K``: suffix
lookup drafts, or ``--draft_head heads.npz`` Medusa drafts; ``--spec_buckets
0,2,4`` chooses the window at each boundary from measured acceptance, tuned
by ``--spec_ema_alpha``, ``--spec_draft_cost``, ``--spec_row_window`` and
``--spec_head_min_yield``) and ``--warmup`` (every function a request can
reach runs once before the server listens), block-tier preemption
(``--preempt``: an interactive request the free blocks cannot cover evicts
batch rows, each spilled to a host-RAM store of ``--spill_capacity_mb`` or
dropped for re-prefill) and the SLO classes (``--slo_interactive_ttft_s``,
``--slo_interactive_itl_s``, ``--slo_batch_latency_s``, ``--slo_window``),
the engine's resilience (``--breaker_threshold``, ``--breaker_cooldown_s``,
``--heartbeat_dir``), the in-process fleet (``--fleet``,
``--fleet_shed_goodput``, ``--fleet_shed_queue``, ``--fleet_probe_interval_s``,
``--fleet_heartbeat_stale_s``, ``--fleet_restart_s``), the process fleet
(``--proc_fleet``, ``--proc_fleet_roles P:D`` with ``--kv_layout paged``,
``--procfleet_*``; a worker's ``--worker``, ``--worker_ready_file``,
``--worker_slot`` and ``--role``, set by the coordinator per slot) and
``--faults`` (or ``EGPT_FAULTS``), and telemetry at the JAX CLI's defaults:
the registry, a trace ring of ``--trace_buffer`` 65536 events
(``--trace_out`` writes it at shutdown), a flight recorder of
``--journey_keep`` 512 journeys, a series store sampling every
``--series_interval_s`` 1.0 s into ``--series_keep`` 512 samples with the
burn-rate alerts, ``--profile_dir`` for ``POST /profile`` (and the
dispatch ranges), and the memory headroom guard (``--mem_headroom_mb``,
``--mem_capacity_mb``; off by default). ``--no_telemetry`` disarms the
registry, the tracer, the recorder and the series store. ``--mesh_*``
raise ``NotImplementedError``: the serving mesh is not ported yet. Chains
are the same with every scheduler feature and telemetry on or off.

Usage:
  python -m eventgpt_tpu_torch.cli.serve --model_path tiny-random \\
      --kv_layout paged --kv_cache int8 [--device cpu] --port 8600
  curl -s localhost:8600/v1/generate -d @req.json   # {"query": ..., "event_b64": ...}
  curl -s localhost:8600/prefix -d '{"prefix_prompt": "A chat between"}'
  curl -s localhost:8600/prefix_cache
  python -m eventgpt_tpu_torch.cli.serve --model_path tiny-random --fleet 2 \\
      --faults 'fleet.replica_kill:n=40' [--device cpu] --port 8600
  curl -s localhost:8600/fleet
  python -m eventgpt_tpu_torch.cli.serve --model_path tiny-random --proc_fleet 2 \\
      [--proc_fleet_roles 1:1 --kv_layout paged] [--device cpu] --port 8600
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import itertools
import json
import math
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from eventgpt_tpu_torch import faults
from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
from eventgpt_tpu_torch.fleet import Fleet, FleetShedError, retry_after_s
from eventgpt_tpu_torch.fleet_proc import ProcFleet, kernel_launches
from eventgpt_tpu_torch.obs import journey as obs_journey
from eventgpt_tpu_torch.obs import metrics as obs_metrics
from eventgpt_tpu_torch.obs import profiling as obs_profiling
from eventgpt_tpu_torch.obs import series as obs_series
from eventgpt_tpu_torch.obs import trace as obs_trace
from eventgpt_tpu_torch.ops.image import process_event_file
from eventgpt_tpu_torch.serve import QueueFullError
from eventgpt_tpu_torch.train.resilience import Heartbeat
from eventgpt_tpu_torch.workload import SLO


class ServingEngine:
    """Thread-safe wrapper around one ``ContinuousBatcher``.

    The batcher is single-threaded by design; the engine serializes every
    call behind ``_lock`` and runs the scheduler on its own thread, which
    parks when no work exists. HTTP handler threads only prepare requests
    (event file -> pixels, tokenize) and wait on per-request events, or
    read a streamed request's queue of cumulative token lists.

    The lock is handed over fairly at the step boundary: a caller from
    outside the loop (``submit_ids``, ``cancel``, ``set_prefix``,
    ``kill``, ``revive``, ``import_handoff``, the collections) announces
    itself before it takes the lock (``_locked``), and after each step the
    loop does not take the lock again while announced callers wait, for at
    most ``HANDOFF_WAIT_S``, so that a stuck caller cannot stall it.
    Python's lock is not fair: without the hand-off the loop, which takes
    the lock again at once, kept a submit waiting through whole requests.

    A scheduler exception fails the in-flight rows, lanes and pending
    admission (their waiters get the fault), keeps the queued requests, and
    restarts the scheduler on a fresh thread after a short backoff. A
    circuit breaker counts consecutive faults: at ``breaker_threshold`` it
    trips, the queued requests fail too, ``/health`` reads ``degraded`` and
    submits are refused (503) until ``breaker_cooldown_s`` has passed; then
    it is half-open, and the first clean step closes it. ``heartbeat_dir``
    arms the trainer's liveness file (``train/resilience.Heartbeat``);
    ``trace_out`` names the Chrome trace file the trace ring is written to
    at shutdown.
    ``kill()``/``revive()`` take the engine out of service and back for a
    fleet. ``/health`` and ``/stats`` read a snapshot rebuilt after every
    step, so they answer while the scheduler holds the lock through a
    segment; the fault counters are written under the lock and read without
    it.
    """

    # The longest the loop waits at a step boundary for announced callers.
    HANDOFF_WAIT_S = 0.05

    def __init__(self, batcher, tokenizer, conv_mode: str = "eventgpt_v1",
                 breaker_threshold: int = 3, breaker_cooldown_s: float = 5.0,
                 heartbeat_dir: Optional[str] = None, heartbeat_interval_s: float = 1.0,
                 start: bool = True, trace_out: Optional[str] = None):
        self.batcher = batcher
        self.trace_out = trace_out
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self._lock = threading.Lock()
        # Callers announced for the lock, and the loop's wait for them; the
        # announced acquisitions, their seconds of waiting and the longest.
        self._turn = threading.Condition()
        self._waiting = 0
        self._lock_waits = {"n": 0, "total_s": 0.0, "max_s": 0.0}
        self._wake = threading.Event()
        self._stop = False
        self._done: Dict[int, threading.Event] = {}
        self._answers: Dict[int, list] = {}
        self._status: Dict[int, str] = {}
        # A streamed request's queue and the tokens already put on it.
        self._streams: Dict[int, queue.Queue] = {}
        self._sent: Dict[int, int] = {}
        self._abandoned: set = set()  # timed-out rids: dropped at harvest
        self.n_requests = 0
        self.t_start = time.time()
        self.fault: Optional[str] = None  # repr of the last scheduler fault
        self.n_faults = 0
        self.n_restarts = 0
        self._consec_faults = 0  # faults with no clean step between them
        self._t_fault = 0.0  # monotonic time of the last fault
        self.breaker_threshold = max(int(breaker_threshold), 1)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        # A killed engine parks its loop and refuses submits until revive().
        self._dead = False
        self._n_steps = 0
        self._heartbeat = Heartbeat(heartbeat_dir) if heartbeat_dir else None
        self._hb_interval = float(heartbeat_interval_s)
        self._last_beat = 0.0
        self._snapshot: Dict[str, Any] = self._build_snapshot_locked()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        if start:
            self._thread.start()

    def start(self) -> None:
        """Start the scheduler thread of an engine built with
        ``start=False``: a caller that queues several requests first has
        them admitted together, as one prefill wave."""
        self._thread.start()

    # -- client side ------------------------------------------------------

    @contextlib.contextmanager
    def _locked(self):
        """The engine lock for a caller from outside the loop, announced
        first, so that the loop hands it over at its next step boundary."""
        with self._turn:
            self._waiting += 1
        t0 = time.perf_counter()
        try:
            with self._lock:
                waited = time.perf_counter() - t0
                w = self._lock_waits
                w["n"] += 1
                w["total_s"] += waited
                w["max_s"] = max(w["max_s"], waited)
                yield
        finally:
            with self._turn:
                self._waiting -= 1
                self._turn.notify_all()

    def breaker_open(self) -> bool:
        """True while the breaker refuses work: the fault streak reached the
        threshold and the cooldown has not passed (after it, half-open)."""
        return (self._consec_faults >= self.breaker_threshold
                and time.monotonic() - self._t_fault < self.breaker_cooldown_s)

    def breaker_retry_after_s(self) -> Optional[float]:
        """The breaker's remaining cooldown (at least 1 s) while it is open,
        else None: the Retry-After of a breaker 503."""
        if not self.breaker_open():
            return None
        return max(self.breaker_cooldown_s - (time.monotonic() - self._t_fault), 1.0)

    def _refuse_if_down(self) -> None:
        if self.breaker_open() or self._dead:
            raise RuntimeError(f"serving engine is down: {self.fault}")

    def submit(self, query: str, pixels, max_new_tokens: int, stream: bool = False,
               deadline_s: Optional[float] = None, slo: Optional[SLO] = None) -> int:
        ids = tokenize_with_event(prepare_event_prompt(query, self.conv_mode), self.tokenizer)
        return self.submit_ids(ids, pixels, max_new_tokens, stream=stream,
                               deadline_s=deadline_s, slo=slo)

    def submit_ids(self, ids, pixels, max_new_tokens: int, stream: bool = False,
                   deadline_s: Optional[float] = None, slo: Optional[SLO] = None) -> int:
        """``submit`` for a tokenized prompt (a fleet's entry point). A
        ``stream`` request's tokens arrive on ``stream_queue(rid)``."""
        self._refuse_if_down()
        with self._locked():
            # Again under the lock: a trip or a kill meanwhile has swept the
            # waiters, and a waiter added after the sweep would wait forever.
            self._refuse_if_down()
            rid = self.batcher.submit(ids, pixels, max_new_tokens, deadline_s=deadline_s,
                                      slo=slo)
            self._done[rid] = threading.Event()
            if stream:
                self._streams[rid] = queue.Queue()
                self._sent[rid] = 0
            self.n_requests += 1
        self._wake.set()
        return rid

    def stream_queue(self, rid: int) -> queue.Queue:
        """A streamed request's queue of cumulative token-id lists, ended by
        ``None`` (finished ``ok``), ``{"status": s}`` (a forced finish) or
        ``{"fault": repr}`` (an engine fault): a consumer surfaces a dict,
        it does not decode it."""
        return self._streams[rid]

    def set_prefix(self, prefix_prompt: str, pixels=None) -> int:
        """Insert a prefix-KV cache entry (``ContinuousBatcher.set_prefix``)
        from raw prompt text, which may hold the ``<event>`` placeholder
        when ``pixels`` carries its stream. Returns the prefix length in
        cache positions. Safe on a live engine: the prefix prefills its own
        row cache."""
        ids = tokenize_with_event(prefix_prompt, self.tokenizer)
        with self._locked():
            plen = self.batcher.set_prefix(ids, pixel_values=pixels)
            self._snapshot = self._build_snapshot_locked()
        return plen

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request; its waiter is released with
        the tokens it committed, under status ``cancelled``."""
        with self._locked():
            ok = self.batcher.cancel(rid)
            if ok:
                self._harvest_locked()
                self._snapshot = self._build_snapshot_locked()
        if ok:
            self._wake.set()
        return ok

    def status(self, rid: int) -> str:
        """Terminal status of a finished request ('ok' while unknown)."""
        return self._status.get(rid, "ok")

    def result(self, rid: int, timeout: float = 600.0):
        """Block until the request finishes; returns its token ids."""
        ev = self._done[rid]
        if not ev.wait(timeout):
            with self._locked():
                # Take an answer that landed meanwhile, or have the harvest
                # drop it: nobody waits for it any more.
                self._done.pop(rid, None)
                if rid in self._answers:
                    return self._answers.pop(rid)
                self._abandoned.add(rid)
            raise TimeoutError(f"request {rid} did not finish in {timeout}s")
        with self._locked():
            self._done.pop(rid, None)
            if rid not in self._answers:
                raise RuntimeError(f"serving engine is down: "
                                   f"{self.fault or self._status.get(rid, 'unknown fault')}")
            return self._answers.pop(rid)

    def try_result(self, rid: int):
        """A fleet supervisor's non-blocking collection: ``(tokens, status)``
        once the request is over, ``(None, "engine_fault")`` when a fault
        failed it, else None. Consuming, like ``result``."""
        with self._locked():
            if rid in self._answers:
                self._done.pop(rid, None)
                return self._answers.pop(rid), self._status.get(rid, "ok")
            if self._status.get(rid) == "engine_fault":
                self._done.pop(rid, None)
                return None, "engine_fault"
        return None

    def try_status(self, rid: int) -> Optional[str]:
        """A request's terminal status once it is known and, for a streamed
        request, delivered through its queue (a fleet supervisor's
        collection of a stream); else None. Not consuming."""
        with self._locked():
            st = self._status.get(rid)
            if st is not None and rid not in self._streams:
                return st
        return None

    def kill(self) -> List[Dict[str, Any]]:
        """Take the engine out of service (a fleet's replica death): deliver
        what has finished, strip every unfinished request out of the batcher
        (``export_requests``) and return their re-admission records. The
        export settles the in-flight segment first, which can finish a
        request after the first harvest, so the engine harvests again. The
        exported requests' waiter and stream state is dropped: the fleet owns
        them. The loop parks and submits are refused until ``revive()``. The
        flag is raised before the lock is taken, and the kill announces
        itself: the loop hands the lock over at its next step boundary, sees
        the flag and parks."""
        self._dead = True
        with self._locked():
            self._push_stream_deltas_locked()
            self._harvest_locked()
            recs = self.batcher.export_requests()
            self._harvest_locked()
            for rec in recs:
                self._done.pop(rec["rid"], None)
                self._streams.pop(rec["rid"], None)
                self._sent.pop(rec["rid"], None)
                self._abandoned.discard(rec["rid"])
            self._snapshot = self._build_snapshot_locked()
        self._wake.set()
        return recs

    def revive(self) -> None:
        """Back into service after ``kill``, with a closed breaker."""
        with self._locked():
            self._dead = False
            self._consec_faults = 0
            self.fault = None
            self._snapshot = self._build_snapshot_locked()
        self._wake.set()

    @property
    def alive(self) -> bool:
        return not self._dead

    def collect_handoffs(self) -> List[Dict[str, Any]]:
        """Drain a prefill-role batcher's handoff outbox (empty otherwise)."""
        with self._locked():
            out = self.batcher.pop_handoffs()
            if out:
                self._snapshot = self._build_snapshot_locked()
            return out

    def import_handoff(self, ids, max_new_tokens: int, rec, tokens=(), prompt_len: int = 0,
                       deadline_s=None, slo=None, elapsed_s: float = 0.0, ttft_s=None) -> int:
        """Splice a prefill role's gathered record into this decode-role
        batcher (``ContinuousBatcher.import_handoff``), behind the same
        breaker and kill gate as ``submit_ids``: a degraded engine refuses,
        so that the record goes elsewhere."""
        self._refuse_if_down()
        with self._locked():
            self._refuse_if_down()
            rid = self.batcher.import_handoff(
                ids, max_new_tokens, rec, tokens=tokens, prompt_len=prompt_len,
                deadline_s=deadline_s, slo=slo, elapsed_s=elapsed_s, ttft_s=ttft_s)
            self._done[rid] = threading.Event()
            self.n_requests += 1
        self._wake.set()
        return rid

    def snapshot(self) -> Dict[str, Any]:
        """The stats snapshot (stale by at most one step)."""
        return self._snapshot

    def stats(self) -> Dict[str, Any]:
        return {"uptime_s": round(time.time() - self.t_start, 1),
                "requests": self.n_requests,
                "status": "degraded" if self.breaker_open() else "ok", **self._snapshot,
                # The registry's view of what /metrics exposes, the alerts,
                # and the kernels this process launched.
                "metrics": obs_metrics.serve_summary(), "alerts": obs_series.alert_stats(),
                # How long callers from outside the loop waited for the lock.
                "lock_wait_s": dict(self._lock_waits), **kernel_launches()}

    # The telemetry surfaces read state that guards itself (the recorder,
    # the series store, the ledger): no engine lock, so that they answer
    # while the scheduler holds it through a segment.
    def journey(self, rid: int) -> Optional[Dict[str, Any]]:
        """One request's journey (``GET /request?rid=N``)."""
        return self.batcher.journey(rid)

    def journeys(self, n: int = 64) -> List[Dict[str, Any]]:
        """Recent finished journeys (``GET /requests``)."""
        return self.batcher.journey_index(n)

    def series(self, window_s: Optional[float] = None, n: Optional[int] = None) -> Dict[str, Any]:
        """The ``GET /series`` payload."""
        return obs_series.snapshot(window_s=window_s, n=n)

    def alerts(self) -> Dict[str, Any]:
        """The ``GET /alerts`` payload."""
        return obs_series.alerts()

    def memory_stats(self) -> Dict[str, Any]:
        """The ``GET /memory`` payload (the reconciliation reads the
        allocator, or walks the CPU's live tensors, outside the lock)."""
        return self.batcher.memory_stats()

    def goodput_ratio(self) -> float:
        """The windowed SLO attainment, 1.0 while the window is empty (no
        evidence of overload): the Retry-After derivation reads it."""
        slo = self._snapshot.get("slo", {})
        if not slo.get("window_n"):
            return 1.0
        return float(slo.get("goodput_ratio", 1.0))

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        thread = self._thread
        if thread.is_alive():
            thread.join(timeout=10)
        if self._thread is not thread and self._thread.is_alive():
            self._thread.join(timeout=10)  # a restart raced the stop
        tracer = obs_trace.active()
        if self.trace_out and tracer is not None:
            n = tracer.write(self.trace_out)
            print(f"[serve] wrote {n} trace events to {self.trace_out}", flush=True)

    # -- scheduler thread -------------------------------------------------

    def _build_snapshot_locked(self) -> Dict[str, Any]:
        b = self.batcher
        snap = {
            "active_rows": sum(r is not None for r in b.rows),
            "queued": len(b.queue),
            "max_batch": b.max_batch,
            "max_len": b.max_len,
            "max_queue": b.max_queue,
            "kv_layout": b.kv_layout,
            "kv_quant": b.kv_quant,
            "faults": self.n_faults,
            "restarts": self.n_restarts,
            "admission_s": round(b.admission_s, 3),
            "decode_s": round(b.decode_s, 4),
            "decode_steps": b.decode_steps,
            "prefill_dispatches": b.prefill_dispatches,
            "dispatches": dict(b.dispatches),
            "segments": b.seg_count,
            # Steps (verifies when speculative) run, and those run with no
            # live row.
            "decode_steps_run": b.decode_steps_run,
            "idle_steps": b.idle_steps,
            "pipeline": b.pipeline,
            "overlap_ratio": round(b.overlap_ratio(), 4),
            "prefill_budget": b.prefill_budget,
            "lanes_started": dict(b.lanes_started),
            "mixed_segments": b.mixed_segments,
            "recent": {str(k): {kk: round(vv, 3) for kk, vv in b.request_stats[k].items()}
                       for k in itertools.islice(reversed(b.request_stats), 8)},
            "speculative": b.speculative,
            "slo": b.slo_stats(),
            "role": b.role,
            # The ledger's host ints (the reconciliation is GET /memory's).
            "memory": b.memory_summary(),
        }
        if b.speculative:
            snap["spec_tokens_per_iteration"] = round(b.spec_tokens_per_iteration(), 2)
            snap["spec_iterations"] = b.spec_iterations
            snap["idle_verifies"] = b.idle_verifies
            snap["spec"] = b.spec_stats()
        pool = b.pool_stats()
        if pool is not None:
            snap["kv_blocks"] = pool
            snap["spill"] = b.spill_stats()
            # A process fleet's decode placement reads the free bytes.
            snap["kv_free_blocks"] = b._pool.free_blocks()
            snap["kv_free_bytes"] = b._pool.free_bytes()
        snap["handoff"] = {"pending": len(b.handoff_ready), "gathered": b.handoffs_gathered,
                           "gathered_bytes": b.handoffs_gathered_bytes,
                           "spliced": b.handoffs_spliced,
                           "spliced_bytes": b.handoffs_spliced_bytes}
        pc = b.prefix_cache_stats()
        snap["prefix_cache"] = {k: pc[k] for k in ("enabled", "n_entries", "bytes", "hits",
                                                    "misses", "evictions") if k in pc}
        return snap

    def _loop(self) -> None:
        while not self._stop:
            try:
                faults.maybe_fail("serve.loop")
                with self._lock:
                    # A killed engine parks. An in-flight segment left after
                    # the last row finished is drained by one more step.
                    b = self.batcher
                    busy = not self._dead and bool(
                        b.queue or any(r is not None for r in b.rows) or b._inflight is not None)
                    if busy:
                        b.step()
                        self._push_stream_deltas_locked()
                        self._harvest_locked()
                        self._n_steps += 1
                        if self._consec_faults:
                            # A clean step ends the streak: the breaker closes.
                            self._consec_faults = 0
                            self.fault = None
                            obs_metrics.SERVE_BREAKER_OPEN.set(0)
                        self._snapshot = self._build_snapshot_locked()
            except Exception as e:  # a scheduler fault must be loud
                self._on_fault(e)
                if not self._stop:
                    # Restart on a fresh thread after a backoff that grows
                    # with the streak, so that a hard fault loop cannot spin.
                    time.sleep(min(0.05 * self._consec_faults, 0.5))
                    with self._lock:
                        self.n_restarts += 1
                    obs_metrics.SERVE_SCHED_RESTARTS.inc()
                    self._thread = threading.Thread(target=self._loop, daemon=True)
                    self._thread.start()
                return
            self._maybe_beat()
            if busy:
                # The fair hand-off: announced callers take the lock first.
                with self._turn:
                    self._turn.wait_for(lambda: not self._waiting, timeout=self.HANDOFF_WAIT_S)
            else:
                self._wake.wait(timeout=0.1)
                self._wake.clear()

    def _maybe_beat(self) -> None:
        """The serving heartbeat: the trainer's file format and staleness
        rule, with the step count, queue depth and breaker state."""
        if self._heartbeat is None:
            return
        now = time.monotonic()
        if now - self._last_beat < self._hb_interval:
            return
        self._last_beat = now
        s = self._snapshot
        try:
            self._heartbeat.beat(self._n_steps,
                                 status="degraded" if self.breaker_open() else "ok",
                                 active=s.get("active_rows", 0), queued=s.get("queued", 0),
                                 faults=self.n_faults, restarts=self.n_restarts)
        except OSError:
            pass  # liveness reporting must never kill the scheduler

    def _on_fault(self, e: Exception) -> None:
        """One scheduler fault: fail the in-flight rows, lanes and pending
        admission (their blocks and prefix pins return, and the in-flight
        segment and the device carry are dropped); the queued requests stay
        for the restarted scheduler, unless this fault trips the breaker,
        which fails them too."""
        with self._lock:
            self.fault = repr(e)
            self.n_faults += 1
            self._consec_faults += 1
            self._t_fault = time.monotonic()
            tripped = self._consec_faults >= self.breaker_threshold
        obs_metrics.SERVE_SCHED_FAULTS.inc()
        obs_trace.instant("scheduler_fault", cat="engine", error=repr(e))
        if tripped:
            obs_metrics.SERVE_BREAKER_OPEN.set(1)
            obs_trace.instant("breaker_trip", cat="engine")
        with self._lock:
            failed = self.batcher.abort_rows()
            if tripped:
                failed += [rec["rid"] for rec in
                           self.batcher.export_requests(journey_status="engine_fault")]
            for rid in failed:
                self._status[rid] = "engine_fault"
                if rid in self._streams:
                    # A dict sentinel, not None: the stream's reader surfaces
                    # the fault instead of ending the body as done.
                    self._streams.pop(rid).put({"fault": self.fault})
                    self._sent.pop(rid, None)
                    self._done.pop(rid, None)
                elif rid in self._done:
                    self._done[rid].set()  # result() finds no answer: raises
                self._abandoned.discard(rid)
            self._snapshot = self._build_snapshot_locked()

    def _push_stream_deltas_locked(self) -> None:
        """Put each live streamed row's tokens on its queue when it grew."""
        for req in self.batcher.rows:
            if req is None or req.rid not in self._streams:
                continue
            n = len(req.tokens)
            if n > self._sent[req.rid]:
                self._streams[req.rid].put(list(req.tokens[:n]))
                self._sent[req.rid] = n

    def _harvest_locked(self) -> None:
        if not self.batcher.finished:
            return
        done, self.batcher.finished = self.batcher.finished, {}
        for rid, toks in done.items():
            status = self.batcher.finish_status.pop(rid, "ok")
            if rid in self._abandoned:
                self._abandoned.discard(rid)
                continue
            while len(self._status) >= 8192:
                self._status.pop(next(iter(self._status)))
            self._status[rid] = status
            if rid in self._streams:
                # The reader holds its own reference to the queue: all engine
                # state of a streamed request goes here (it never calls
                # result()). None ends a finish ``ok``; a status dict a
                # forced finish, which the reader surfaces.
                q = self._streams.pop(rid)
                q.put(list(toks))
                q.put(None if status == "ok" else {"status": status})
                self._sent.pop(rid, None)
                self._done.pop(rid, None)
                continue
            self._answers[rid] = toks
            if rid in self._done:
                self._done[rid].set()


def _resolve_event_path(event_root: Optional[str], requested: str) -> str:
    """``requested`` resolved strictly inside ``event_root`` (symlinks and
    ``..`` resolved first); without a root, server-local paths are
    refused and clients upload the stream inline."""
    if event_root is None:
        raise ValueError("event paths are disabled (configure --event_root DIR to allow "
                         "files under DIR, or send the stream inline via event_b64)")
    root = os.path.realpath(event_root)
    path = os.path.realpath(os.path.join(root, str(requested).lstrip("/")))
    if path != root and not path.startswith(root + os.sep):
        raise ValueError("event path escapes --event_root")
    return path


def _decode_pixels(payload: Dict[str, Any], cfg, event_root=None):
    """event_path (confined under --event_root) or event_b64 (inline .npy
    bytes) -> the request's (T, 3, H, W) pixel frames."""
    if "event_path" in payload:
        path = _resolve_event_path(event_root, payload["event_path"])
        try:
            _, pixels = process_event_file(path, cfg.num_event_frames, cfg.vision.image_size)
        except FileNotFoundError:
            raise ValueError(f"no such event file under --event_root: {payload['event_path']}")
        return pixels
    if "event_b64" in payload:
        raw = base64.b64decode(payload["event_b64"])
        # Through a real file, so one loader (and its restricted
        # unpickler) serves both forms.
        with tempfile.NamedTemporaryFile(suffix=".npy") as f:
            f.write(raw)
            f.flush()
            _, pixels = process_event_file(f.name, cfg.num_event_frames,
                                           cfg.vision.image_size)
        return pixels
    raise ValueError("request needs event_path or event_b64")


_STATUS_CODES = {"ok": 200, "deadline_exceeded": 504, "cancelled": 499,
                 "resource_exhausted": 503, "nan_quarantined": 500}


def default_slo_classes(args=None) -> Dict[str, SLO]:
    """The server's SLO class targets: the ``--slo_*`` flags (0 disarms a
    target), or the JAX CLI's defaults without ``args``."""
    ttft = 1.0 if args is None else args.slo_interactive_ttft_s
    itl = 0.25 if args is None else args.slo_interactive_itl_s
    latency = 30.0 if args is None else args.slo_batch_latency_s
    return {"interactive": SLO("interactive", ttft_s=ttft or None, itl_s=itl or None),
            "batch": SLO("batch", latency_s=latency or None)}


def make_handler(engine, cfg, event_root=None, default_budget: int = 64,
                 max_body_bytes: int = 32 * 1024 * 1024,
                 default_deadline_s: Optional[float] = None,
                 slo_classes: Optional[Dict[str, SLO]] = None):
    if slo_classes is None:
        slo_classes = default_slo_classes()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _retry_after(self, cls_name: str) -> float:
            """A 503's backoff: the breaker's remaining cooldown while it is
            open, else the class-aware hint from the windowed goodput."""
            ra = engine.breaker_retry_after_s() if hasattr(engine, "breaker_retry_after_s") \
                else None
            return ra if ra is not None else retry_after_s(cls_name, engine.goodput_ratio())

        def _telemetry_get(self, route, query) -> bool:
            """The telemetry routes; False when ``route`` is none of them."""
            if route == "/request":
                try:
                    rid = int(query["rid"][0])
                except (KeyError, ValueError, IndexError):
                    self._json(400, {"error": "need ?rid=N"})
                    return True
                rec = engine.journey(rid)
                if rec is None:
                    self._json(404, {"error": f"no journey for rid {rid} (unknown, evicted from "
                                              f"the retention ring, or the recorder is "
                                              f"disarmed: --journey_keep)"})
                else:
                    self._json(200, rec)
            elif route == "/requests":
                try:
                    n = int(query.get("n", ["64"])[0])
                except ValueError:
                    self._json(400, {"error": "bad ?n="})
                    return True
                self._json(200, {"requests": engine.journeys(n),
                                 "enabled": obs_journey.enabled()})
            elif route == "/series":
                try:
                    window_s = float(query["window_s"][0]) if "window_s" in query else None
                    n = int(query["n"][0]) if "n" in query else None
                except (ValueError, IndexError):
                    self._json(400, {"error": "bad ?window_s= or ?n="})
                    return True
                self._json(200, engine.series(window_s=window_s, n=n))
            elif route in ("/alerts", "/memory"):
                self._json(200, engine.alerts() if route == "/alerts" else engine.memory_stats())
            elif route == "/trace":
                tracer = obs_trace.active()
                if tracer is None:
                    self._json(404, {"error": "tracing disarmed (--trace_buffer 0)"})
                    return True
                evs = tracer.events()
                if "rid" in query:
                    try:
                        rid = int(query["rid"][0])
                    except (ValueError, IndexError):
                        self._json(400, {"error": "bad ?rid="})
                        return True
                    evs = [e for e in evs
                           if e.get("id") == rid or (e.get("args") or {}).get("rid") == rid]
                self._json(200, {"traceEvents": evs, "droppedEvents": tracer.dropped()})
            elif route == "/metrics":
                # Rendered outside the engine lock: it answers mid-segment.
                body = obs_metrics.REGISTRY.render_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                return False
            return True

        def do_GET(self):
            from urllib.parse import parse_qs, urlsplit

            split = urlsplit(self.path)
            if self._telemetry_get(split.path, parse_qs(split.query)):
                return
            if self.path == "/health":
                if engine.breaker_open():
                    # The balancer drains this server until the half-open
                    # probe; probes and clients share one backoff.
                    ra = self._retry_after("batch")
                    self._json(503, {"status": "degraded", "error": engine.fault,
                                     "faults": engine.n_faults, "restarts": engine.n_restarts,
                                     "retry_after_s": round(ra, 3)},
                               headers={"Retry-After": str(max(1, math.ceil(ra)))})
                    return
                s = engine.stats()
                self._json(200, {"status": "ok", "active": s["active_rows"],
                                 "queued": s["queued"], "faults": engine.n_faults,
                                 "restarts": engine.n_restarts})
            elif self.path == "/stats":
                self._json(200, engine.stats())
            elif self.path == "/fleet" and hasattr(engine, "fleet_stats"):
                # Topology, policy and per-replica health; fleets only.
                self._json(200, engine.fleet_stats())
            elif self.path == "/prefix_cache":
                # The cache guards its own host state: no engine lock.
                self._json(200, engine.batcher.prefix_cache_stats())
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def _read_payload(self):
            """The JSON body, or None after answering 400/413. A body that
            is not read closes the connection, or its bytes would be
            parsed as the next request."""
            try:
                cl = self.headers.get("Content-Length")
                if cl is None:
                    raise ValueError
                n = int(cl)
                if n < 0:
                    raise ValueError
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return None
            if n > max_body_bytes:
                self.close_connection = True
                self._json(413, {"error": f"body {n} bytes exceeds the {max_body_bytes}-byte "
                                          f"limit (--max_body_mb)"})
                return None
            try:
                return json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:
                self._json(400, {"error": f"bad JSON: {e}"})
                return None

        def do_POST(self):
            if self.path not in ("/v1/generate", "/cancel", "/prefix", "/profile"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            payload = self._read_payload()
            if payload is None:
                return
            if self.path == "/profile":
                # A torch.profiler window over the running server: this
                # handler thread waits it out while the scheduler serves.
                try:
                    seconds = float(payload.get("seconds", 2.0))
                    if not 0.0 <= seconds <= 120.0:
                        raise ValueError(f"seconds must be in [0, 120], got {seconds}")
                except (TypeError, ValueError, AttributeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                try:
                    d = obs_profiling.capture(seconds)
                except obs_profiling.CaptureBusyError as e:
                    self._json(409, {"error": str(e)})
                    return
                except Exception as e:
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, {"profile_dir": d, "seconds": seconds,
                                 **obs_profiling.last_capture()})
                return
            if self.path == "/cancel":
                try:
                    rid = int(payload["rid"])
                except Exception as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, {"rid": rid, "cancelled": engine.cancel(rid)})
                return
            if self.path == "/prefix":
                try:
                    prompt = payload["prefix_prompt"]
                    pixels = None
                    if "event_path" in payload or "event_b64" in payload:
                        pixels = _decode_pixels(payload, cfg, event_root)
                    plen = engine.set_prefix(prompt, pixels)
                except (KeyError, ValueError, RuntimeError) as e:  # a bad request
                    self._json(400, {"error": str(e)})
                    return
                st = engine.batcher.prefix_cache_stats()
                self._json(200, {"prefix_len": plen, "entries": st.get("n_entries", 0),
                                 "bytes": st.get("bytes", 0)})
                return
            try:
                query = payload["query"]
                budget = int(payload.get("max_new_tokens", default_budget))
                deadline = payload.get("deadline_s", default_deadline_s)
                deadline = float(deadline) if deadline else None
                slo = None
                if "slo_class" in payload:
                    # The class set is closed: an unknown name is the
                    # client's fault.
                    name = str(payload["slo_class"])
                    if name not in slo_classes:
                        raise ValueError(f"unknown slo_class {name!r}: one of "
                                         f"{sorted(slo_classes)}")
                    slo = slo_classes[name]
                    overrides = {k[4:]: float(payload[k])
                                 for k in ("slo_ttft_s", "slo_itl_s", "slo_latency_s")
                                 if k in payload}
                    if overrides:
                        slo = dataclasses.replace(slo, **overrides)
                pixels = _decode_pixels(payload, cfg, event_root)
            except Exception as e:  # a bad request, not a server fault
                self._json(400, {"error": str(e)})
                return
            stream = bool(payload.get("stream", False))
            t0 = time.perf_counter()
            try:
                rid = engine.submit(query, pixels, budget, stream=stream, deadline_s=deadline,
                                    slo=slo)
            except (QueueFullError, FleetShedError) as e:
                # Backpressure: the client backs off by its class and the
                # windowed attainment (a shed carries its own hint).
                cls_name = slo.name if slo is not None else "batch"
                ra = getattr(e, "retry_after_s", None)
                if ra is None:
                    ra = retry_after_s(cls_name, engine.goodput_ratio())
                self._json(429, {"error": str(e), "slo_class": cls_name,
                                 "retry_after_s": round(ra, 3)},
                           headers={"Retry-After": str(max(1, math.ceil(ra)))})
                return
            except ValueError as e:  # the request does not fit the server
                self._json(400, {"error": str(e)})
                return
            except RuntimeError as e:
                # The engine is down (the breaker is open, or no replica is
                # routable): the 503 that /health advertises.
                ra = self._retry_after(slo.name if slo is not None else "batch")
                self._json(503, {"error": str(e), "retry_after_s": round(ra, 3)},
                           headers={"Retry-After": str(max(1, math.ceil(ra)))})
                return
            if stream:
                try:
                    self._stream_response(rid, bool(payload.get("return_ids")))
                except OSError:
                    # The client went away mid-stream: no second status line
                    # goes into a started chunked body; the engine drops the
                    # orphaned queue at the harvest.
                    pass
                return
            try:
                toks = engine.result(rid)
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
                return
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            text = engine.tokenizer.batch_decode([toks], skip_special_tokens=True)[0].strip()
            status = engine.status(rid)
            stats = engine.batcher.request_stats.get(rid, {})
            obj = {"answer": text, "tokens": len(toks), "rid": rid, "status": status,
                   "ttft_s": round(stats.get("ttft_s", 0.0), 3),
                   "latency_s": round(stats.get("latency_s", time.perf_counter() - t0), 3)}
            if slo is not None:
                obj["slo_class"] = slo.name
                if "slo_met" in stats:
                    obj["slo_met"] = bool(stats["slo_met"])
            if payload.get("debug"):
                # The request's journey rides its answer (GET /request?rid=N);
                # a fleet's is stitched across its assignments.
                obj["debug"] = engine.journey(rid)
            if payload.get("return_ids"):
                obj["ids"] = [int(t) for t in toks]
            code = _STATUS_CODES.get(status, 500)
            if code != 200:
                obj["error"] = status
            if code == 503:
                # Both tiers spent: the client backs off by its class and
                # the engine's windowed attainment.
                ra = retry_after_s(slo.name if slo is not None else "batch",
                                   engine.goodput_ratio())
                obj["retry_after_s"] = round(ra, 3)
                self._json(code, obj, headers={"Retry-After": str(max(1, math.ceil(ra)))})
                return
            self._json(code, obj)

        def _stream_response(self, rid: int, return_ids: bool = False) -> None:
            """A chunked NDJSON body, one event a line: ``{"delta": text}``
            for new text, ``{"restart": text}`` when a longer decode rewrites
            earlier text (the cumulative decode is not prefix-stable), and a
            last ``{"done": true, "answer": ...}`` with the status, or with
            the fault as ``error``. Trailing U+FFFD is held back: a multibyte
            character split across segments decodes as one first, and a
            chunked body cannot take bytes back; a tail that never resolves
            goes out with the last delta. Applying the deltas and restarts in
            order gives the answer. ``return_ids`` adds the token ids to the
            last record."""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj) -> None:
                line = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(line):x}\r\n".encode())
                self.wfile.write(line + b"\r\n")

            sent = ""

            def emit(new_text: str) -> None:
                nonlocal sent
                if new_text == sent:
                    return
                if new_text.startswith(sent):
                    chunk({"delta": new_text[len(sent):], "rid": rid})
                else:
                    chunk({"restart": new_text, "rid": rid})
                sent = new_text

            q = engine.stream_queue(rid)
            text, ids = "", []
            while True:
                toks = q.get()
                if toks is None:
                    break
                if isinstance(toks, dict):
                    if "status" in toks:  # a forced finish: terminal
                        break
                    chunk({"done": True, "rid": rid, "error": toks["fault"],
                           "answer": sent.strip()})
                    self.wfile.write(b"0\r\n\r\n")
                    return
                ids = toks
                text = engine.tokenizer.batch_decode([toks], skip_special_tokens=True)[0]
                emit(text.rstrip("\ufffd"))
            emit(text)  # the held-back tail, rewritten or not
            status = engine.status(rid)
            final = {"done": True, "rid": rid, "answer": sent.strip(), "status": status}
            if status != "ok":
                final["error"] = status
            if return_ids:
                final["ids"] = [int(t) for t in ids]
            chunk(final)
            self.wfile.write(b"0\r\n\r\n")

    return Handler


# The serving mesh's flags: accepted, and refused unless 1 (not ported yet).
_MESH_FLAGS = ("--mesh_data", "--mesh_fsdp", "--mesh_model")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="EventGPT serving (PyTorch, CUDA)")
    p.add_argument("--model_path", default="tiny-random",
                   help="HF-layout checkpoint dir, or tiny-random (tiny random weights)")
    p.add_argument("--tokenizer_path", default=None,
                   help="'byte' (the offline byte tokenizer); the HF tokenizer is not "
                        "ported, so a checkpoint dir needs --tokenizer_path byte")
    p.add_argument("--use_event_qformer", action="store_true",
                   help="gate the Q-Former on (fresh weights unless component files load)")
    p.add_argument("--pretrain_query_embedder", default=None,
                   help="Q-Former query artifact (model.query_embedder.* npz)")
    p.add_argument("--pretrain_attention_layers", default=None,
                   help="Q-Former layer artifact (model.attention_layers.* npz)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--event_root", default=None,
                   help="directory event_path requests resolve under; unset = server-local "
                        "paths disabled (event_b64 only)")
    p.add_argument("--conv_mode", default="eventgpt_v1")
    p.add_argument("--max_body_mb", type=float, default=32.0,
                   help="largest accepted POST body (413 above this)")
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--max_len", type=int, default=1024)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--quant", default="none", choices=["none", "int8", "int4"])
    p.add_argument("--fuse_params", action="store_true",
                   help="fuse q|k|v and gate|up before quantization")
    p.add_argument("--kv_cache", default="bf16", choices=["bf16", "int8"])
    p.add_argument("--kv_layout", default="dense", choices=["dense", "paged"],
                   help="resident KV layout: 'paged' replaces the dense (batch, max_len) "
                        "cache with one pool of 64-slot blocks and per-row block tables; "
                        "admission is gated by free blocks. Chains equal 'dense'")
    p.add_argument("--kv_pool_blocks", type=int, default=0,
                   help="paged pool size in blocks, the scratch block included (0 = the "
                        "dense capacity: max_batch * max_len / 64 + 1)")
    p.add_argument("--max_queue", type=int, default=256,
                   help="admission-queue bound: submits beyond it get 429 (0 = unbounded)")
    p.add_argument("--default_deadline_s", type=float, default=0.0,
                   help="deadline of a request whose payload has none (0 = none); expiry "
                        "returns 504 with the tokens committed so far")
    p.add_argument("--drain_timeout_s", type=float, default=30.0,
                   help="on SIGTERM/SIGINT, seconds to wait for in-flight requests")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu only when asked)")
    p.add_argument("--attn_impl", default=None, choices=["dense", "flash"],
                   help="prefill attention, as in cli/infer (default: flash, K1, on the card; "
                        "dense on the CPU)")
    p.add_argument("--prefill_chunk", type=int, default=0,
                   help="chunked prefill: with rows decoding, a full admission advances "
                        "this many prompt positions per step (must divide 128; 0 = off)")
    p.add_argument("--prefill_budget", type=int, default=-1,
                   help="piggyback prefill lanes: prompt tokens folded into each decode "
                        "dispatch while rows decode (-1 = --chunk, 0 = off: exclusive "
                        "admission waves)")
    p.add_argument("--first_chunk", type=int, default=0,
                   help="TTFT ramp: segments of this many steps while a fresh row owes "
                        "its first token (0 = off)")
    p.add_argument("--no_pipeline", action="store_true",
                   help="synchronous scheduler: harvest every segment before the next "
                        "dispatch (the same chains)")
    p.add_argument("--prefix_prompt", default=None,
                   help="cache this prompt head's KV at startup (may hold the <event> "
                        "placeholder when --prefix_event gives the stream)")
    p.add_argument("--prefix_event", default=None,
                   help="event stream (.npy) of a --prefix_prompt through the event block")
    p.add_argument("--prefix_cache_mb", type=float, default=512.0,
                   help="prefix-KV cache budget in MiB (LRU eviction; 0 = unbounded)")
    p.add_argument("--no_prefix_cache", action="store_true",
                   help="turn the prefix-KV cache off: every admission prefills in full "
                        "(the same chains)")
    p.add_argument("--no_telemetry", action="store_true",
                   help="disarm the metrics registry, the span tracer, the flight recorder "
                        "and the series store (the same chains; the registry stops counting)")
    p.add_argument("--mem_headroom_mb", type=float, default=0.0,
                   help="admission headroom guard: defer an admission wave while the memory "
                        "ledger predicts it would leave less than this many MiB of the card "
                        "free (0 = off; GET /memory shows the ledger)")
    p.add_argument("--mem_capacity_mb", type=float, default=0.0,
                   help="the capacity the guard budgets against (0 = the card's total; the "
                        "CPU reports none, so set it there)")
    p.add_argument("--journey_keep", type=int, default=512,
                   help="flight recorder: keep the last N finished request journeys (GET "
                        "/requests, GET /request?rid=N; 0 disarms)")
    p.add_argument("--series_interval_s", type=float, default=1.0,
                   help="time-series store cadence: one registry sample and alert evaluation "
                        "per interval (GET /series, GET /alerts; 0 disarms)")
    p.add_argument("--series_keep", type=int, default=512,
                   help="time-series ring length in samples (0 disarms)")
    p.add_argument("--trace_buffer", type=int, default=65536,
                   help="trace ring capacity in events (GET /trace; 0 disarms tracing)")
    p.add_argument("--trace_out", default=None,
                   help="write the trace ring as Chrome trace events (Perfetto, "
                        "chrome://tracing) to this file at shutdown")
    p.add_argument("--profile_dir", default=None,
                   help="where POST /profile writes its torch.profiler traces; setting it also "
                        "arms the per-dispatch profiler ranges (unset: a temporary dir)")
    p.add_argument("--speculative", type=int, default=0,
                   help="speculative decoding: a K-token verify window over suffix-lookup "
                        "drafts (or --draft_head's); 0 = off")
    p.add_argument("--spec_buckets", default="",
                   help="adaptive speculation: comma-separated draft-window buckets, e.g. "
                        "'0,2,4' (0 = the draft-free window 1); each boundary picks one from "
                        "the measured acceptance and masks low-acceptance rows' drafts; "
                        "--speculative becomes the default window (the largest when 0). "
                        "Empty = fixed-K serving")
    p.add_argument("--spec_ema_alpha", type=float, default=0.3,
                   help="acceptance-EMA step per harvested segment")
    p.add_argument("--spec_draft_cost", type=float, default=0.05,
                   help="relative verify cost of one draft position (the controller's cost "
                        "model)")
    p.add_argument("--spec_row_window", type=int, default=4,
                   help="segments in each row's acceptance window (the per-row depth mask)")
    p.add_argument("--spec_head_min_yield", type=float, default=0.05,
                   help="prune draft heads / lookup levels whose yield EMA falls below this")
    p.add_argument("--draft_head", default=None,
                   help="Medusa head stack (.npz of either package) drafting instead of the "
                        "lookup (needs --speculative > 0 or --spec_buckets)")
    p.add_argument("--preempt", action="store_true",
                   help="block-tier preemption (paged layout): when the free blocks cannot "
                        "cover an interactive request, evict batch rows (worst deadline "
                        "headroom first); each victim spills its KV run to host RAM "
                        "(--spill_capacity_mb) or drops and re-prefills, whichever the "
                        "bytes-against-FLOPs price says is cheaper. The same chains")
    p.add_argument("--spill_capacity_mb", type=int, default=0,
                   help="host-RAM budget for preempted KV runs (0 = no store: every "
                        "preemption drops and re-prefills)")
    p.add_argument("--slo_interactive_ttft_s", type=float, default=1.0,
                   help="interactive-class TTFT target, scored at finish (0 disarms)")
    p.add_argument("--slo_interactive_itl_s", type=float, default=0.25,
                   help="interactive-class mean inter-token gap target (0 disarms)")
    p.add_argument("--slo_batch_latency_s", type=float, default=30.0,
                   help="batch-class end-to-end latency target (0 disarms)")
    p.add_argument("--slo_window", type=int, default=256,
                   help="scored finishes in the windowed goodput ratio")
    p.add_argument("--breaker_threshold", type=int, default=3,
                   help="consecutive scheduler faults that trip the circuit breaker (health "
                        "-> degraded, POSTs 503)")
    p.add_argument("--breaker_cooldown_s", type=float, default=5.0,
                   help="seconds the tripped breaker refuses work before the half-open probe "
                        "admits traffic again")
    p.add_argument("--heartbeat_dir", default=None,
                   help="directory of the serving heartbeat.json (the trainer's format; with "
                        "--fleet one replicaN/ per replica; unset = off)")
    p.add_argument("--fleet", type=int, default=0,
                   help="N ServingEngine replicas behind the prefix-affinity router (0/1 = one "
                        "engine); they share the weight tree, each owns its KV pool, "
                        "generator and scheduler thread")
    p.add_argument("--fleet_shed_goodput", type=float, default=0.5,
                   help="shed batch-class requests while the fleet's windowed goodput ratio is "
                        "below this (0 disarms)")
    p.add_argument("--fleet_shed_queue", type=int, default=0,
                   help="shed batch-class requests while the queued requests are at or above "
                        "this (0 disarms)")
    p.add_argument("--fleet_probe_interval_s", type=float, default=0.05,
                   help="the supervisor's probe and collection period")
    p.add_argument("--fleet_heartbeat_stale_s", type=float, default=5.0,
                   help="heartbeat age that makes a replica unroutable")
    p.add_argument("--fleet_restart_s", type=float, default=0.0,
                   help="revive a killed replica after this many seconds (0 = only by the "
                        "operator)")
    p.add_argument("--proc_fleet", type=int, default=0,
                   help="N worker processes behind the RPC coordinator (0/1 = no process "
                        "fleet); each loads its own model and owns an engine; the coordinator "
                        "loads only the config and the tokenizer")
    p.add_argument("--proc_fleet_roles", default=None,
                   help="'P:D' splits the process fleet into P prefill and D decode workers "
                        "(needs --kv_layout paged: the handoff ships paged KV block runs)")
    p.add_argument("--procfleet_rpc_deadline_s", type=float, default=15.0,
                   help="the deadline of one coordinator-to-worker RPC (connect, send, answer)")
    p.add_argument("--procfleet_rpc_retries", type=int, default=3,
                   help="transport retries per RPC (backoff with jitter under the deadline; "
                        "mutating ops never retry once sent)")
    p.add_argument("--procfleet_spawn_timeout_s", type=float, default=180.0,
                   help="seconds a spawned worker may take to become ready before its slot "
                        "books a crash")
    p.add_argument("--procfleet_respawn_backoff_s", type=float, default=0.25,
                   help="first respawn backoff of a slot after a worker death (doubles per "
                        "consecutive crash)")
    p.add_argument("--procfleet_crash_window_s", type=float, default=60.0,
                   help="crashes older than this stop counting toward the crash-loop breaker")
    p.add_argument("--procfleet_crash_limit", type=int, default=3,
                   help="crashes inside the window that give a slot up (the fleet serves on "
                        "with the others)")
    p.add_argument("--procfleet_handoff_retries", type=int, default=3,
                   help="decode workers a handoff record is tried on before its request "
                        "redoes from its prefill")
    p.add_argument("--role", default="colocated", choices=["colocated", "prefill", "decode"],
                   help="this engine's serving role (set per slot by a --proc_fleet_roles "
                        "coordinator)")
    p.add_argument("--worker", action="store_true",
                   help="run as one process-fleet worker: one engine served over the RPC "
                        "ops instead of HTTP (spawned by the --proc_fleet coordinator; needs "
                        "--worker_ready_file)")
    p.add_argument("--worker_ready_file", default=None,
                   help="where the worker writes its {port, pid} readiness handshake")
    p.add_argument("--worker_slot", type=int, default=0,
                   help="the coordinator's slot index of this worker (informational)")
    p.add_argument("--faults", default=None,
                   help="arm fault injection (faults.py grammar, e.g. 'serve.dispatch:n=3'); "
                        "EGPT_FAULTS works too")
    p.add_argument("--warmup", action="store_true",
                   help="run every function a request can reach once before listening (kernel "
                        "builds, cuBLAS handles, the allocator's first growth)")
    for flag in _MESH_FLAGS:
        p.add_argument(flag, type=int, default=1,
                       help="the serving mesh: not ported yet, raises unless 1")
    return p


def _refuse_unported(args) -> None:
    if any(getattr(args, f[2:]) != 1 for f in _MESH_FLAGS):
        raise NotImplementedError("--mesh_*: the serving mesh (ROADMAP Queue 1 item 8) is not "
                                  "ported to eventgpt_tpu_torch yet")


# Every flag that shapes a worker's model, batcher or engine crosses to the
# --worker processes (they load their own model and share no state). The
# forwarding is declared here so that tests can check that every entry
# round-trips and that every parser flag is classified: forwarded,
# coordinator-only, set per slot, or still refused. Kinds: "value" is always
# forwarded as --dest str(value), "opt" only when set, "flag" (store_true)
# only when true. The port forwards its own --device and --attn_impl, and the
# Q-Former flags, which the JAX declaration leaves with the coordinator
# (ROADMAP Queue 3).
WORKER_FORWARDED_FLAGS = (
    ("model_path", "value", "tiny-random"),
    ("conv_mode", "value", "eventgpt_v1"),
    ("dtype", "value", "bfloat16"),
    ("device", "value", "cuda"),
    ("attn_impl", "opt", None),
    ("quant", "value", "none"),
    ("kv_cache", "value", "bf16"),
    ("kv_layout", "value", "dense"),
    ("kv_pool_blocks", "value", 0),
    ("spill_capacity_mb", "value", 0),
    ("max_batch", "value", 4),
    ("max_len", "value", 1024),
    ("chunk", "value", 128),
    ("temperature", "value", 0.0),
    ("speculative", "value", 0),
    ("prefill_chunk", "value", 0),
    ("prefill_budget", "value", -1),
    ("first_chunk", "value", 0),
    ("max_queue", "value", 256),
    ("prefix_cache_mb", "value", 512.0),
    ("mem_headroom_mb", "value", 0.0),
    ("mem_capacity_mb", "value", 0.0),
    ("breaker_threshold", "value", 3),
    ("breaker_cooldown_s", "value", 5.0),
    ("slo_window", "value", 256),
    ("journey_keep", "value", 512),
    ("series_interval_s", "value", 1.0),
    ("series_keep", "value", 512),
    ("spec_ema_alpha", "value", 0.3),
    ("spec_draft_cost", "value", 0.05),
    ("spec_row_window", "value", 4),
    ("spec_head_min_yield", "value", 0.05),
    ("spec_buckets", "opt", ""),
    ("tokenizer_path", "opt", None),
    ("draft_head", "opt", None),
    ("pretrain_query_embedder", "opt", None),
    ("pretrain_attention_layers", "opt", None),
    ("use_event_qformer", "flag", False),
    ("preempt", "flag", False),
    ("fuse_params", "flag", False),
    ("no_pipeline", "flag", False),
    ("no_prefix_cache", "flag", False),
    ("no_telemetry", "flag", False),
    ("warmup", "flag", False),
)

# Flags that stay with the coordinator: the HTTP front end, the fleet's
# topology and policy, the SLO targets (they travel inside each submit's
# SLO), the coordinator's telemetry sinks (the trace ring, its file and the
# profile destination), --faults (EGPT_FAULTS crosses in the environment),
# the startup prefix (installed through the set_prefix op) and the mesh (a
# worker owns one card).
WORKER_COORDINATOR_ONLY = frozenset({
    "host", "port", "event_root", "max_body_mb", "max_new_tokens", "default_deadline_s",
    "prefix_prompt", "prefix_event",
    "heartbeat_dir",  # per slot: the coordinator appends the slot's own directory
    "fleet", "proc_fleet", "proc_fleet_roles", "drain_timeout_s", "fleet_shed_goodput",
    "fleet_shed_queue", "fleet_probe_interval_s", "fleet_heartbeat_stale_s", "fleet_restart_s",
    "procfleet_rpc_deadline_s", "procfleet_rpc_retries", "procfleet_spawn_timeout_s",
    "procfleet_respawn_backoff_s", "procfleet_crash_window_s", "procfleet_crash_limit",
    "procfleet_handoff_retries", "slo_interactive_ttft_s", "slo_interactive_itl_s",
    "slo_batch_latency_s", "trace_buffer", "trace_out", "profile_dir", "faults", "mesh_data",
    "mesh_fsdp", "mesh_model",
})

# Flags the coordinator appends per slot (``ProcFleet._spawn``).
WORKER_PER_SLOT = frozenset({"worker", "worker_ready_file", "worker_slot", "role"})


def _worker_argv(args) -> list:
    """A worker's command line: the coordinator's model and engine flags
    behind ``--worker``, from ``WORKER_FORWARDED_FLAGS``. A worker of a
    ``--device cpu`` coordinator runs on the CPU, any other on the card."""
    import sys

    argv = [sys.executable, "-m", "eventgpt_tpu_torch.cli.serve", "--worker"]
    for dest, kind, default in WORKER_FORWARDED_FLAGS:
        val = getattr(args, dest, default)
        if kind == "flag":
            if val:
                argv.append(f"--{dest}")
        elif kind == "opt":
            if val:
                argv += [f"--{dest}", str(val)]
        else:
            argv += [f"--{dest}", str(val)]
    return argv


def make_batcher(args, params, cfg, tokenizer, device, role: Optional[str] = None):
    """The ``ContinuousBatcher`` the flags describe, over a prepared tree
    on ``device``: the JAX CLI's defaults (pipelined, the prefix cache at
    ``--prefix_cache_mb``, ``--prefill_budget`` -1 = ``--chunk``). ``role``
    (default ``--role``) makes a prefill or decode batcher."""
    from eventgpt_tpu_torch.models.medusa import load_medusa
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    _refuse_unported(args)
    draft_head = None
    if args.draft_head:
        embed = params["llama"]["embed_tokens"]
        draft_head = load_medusa(args.draft_head, dtype=embed.dtype, device=embed.device)
    return ContinuousBatcher(
        params, cfg, max_batch=args.max_batch, max_len=args.max_len, chunk=args.chunk,
        temperature=args.temperature, eos_token_id=tokenizer.eos_token_id,
        kv_quant=args.kv_cache == "int8", max_queue=args.max_queue,
        kv_layout=args.kv_layout, kv_pool_blocks=args.kv_pool_blocks, device=device,
        prefill_chunk=args.prefill_chunk, first_chunk=args.first_chunk,
        pipeline=not args.no_pipeline, prefix_cache=not args.no_prefix_cache,
        prefix_cache_bytes=int(args.prefix_cache_mb * 1024 * 1024),
        prefill_budget=args.chunk if args.prefill_budget < 0 else args.prefill_budget,
        speculative=args.speculative, draft_head=draft_head,
        spec_buckets=args.spec_buckets or None, spec_ema_alpha=args.spec_ema_alpha,
        spec_draft_cost=args.spec_draft_cost, spec_row_window=args.spec_row_window,
        spec_head_min_yield=args.spec_head_min_yield, preempt=args.preempt,
        spill_capacity_mb=args.spill_capacity_mb, slo_window=args.slo_window,
        mem_headroom_bytes=int(args.mem_headroom_mb * (1 << 20)),
        mem_capacity_bytes=int(args.mem_capacity_mb * (1 << 20)),
        role=args.role if role is None else role)


def arm_telemetry(args) -> None:
    """Telemetry at the JAX CLI's defaults: the registry counts, a trace
    ring of ``--trace_buffer`` events, a flight recorder of
    ``--journey_keep`` journeys, a series store sampling every
    ``--series_interval_s`` into ``--series_keep`` samples with the alert
    rules (the ``mem_shrink`` rule judges ``--mem_capacity_mb``), each
    disarmed by a 0; ``--no_telemetry`` disarms all four. ``--profile_dir``
    sets the capture destination and arms the profiler ranges."""
    if args.no_telemetry:
        obs_metrics.configure(False)
        obs_trace.disable()
        obs_journey.disable()
        obs_series.disable()
    else:
        obs_metrics.configure(True)
        if args.trace_buffer > 0:
            obs_trace.configure(args.trace_buffer)
        if args.journey_keep > 0:
            obs_journey.configure(args.journey_keep)
        if args.series_interval_s > 0 and args.series_keep > 0:
            obs_series.configure(
                interval_s=args.series_interval_s, keep=args.series_keep,
                mem_capacity_bytes=(int(args.mem_capacity_mb * (1 << 20))
                                    if args.mem_capacity_mb > 0 else None))
    if args.profile_dir:
        obs_profiling.configure(args.profile_dir)


def build_engine(args, force_single: bool = False):
    """(cfg, engine): the model loaded and prepared on ``--device`` as
    ``cli/infer`` does it (``load_model``, ``prepare_model``), then the
    engine of ``make_engine`` over it; with ``--proc_fleet N`` a
    ``ProcFleet`` coordinator, which loads only the config and the
    tokenizer. ``force_single`` (a worker) builds one engine whatever the
    fleet flags say: a worker never spawns a fleet of its own."""
    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.device import resolve_device

    _refuse_unported(args)
    arm_telemetry(args)
    if args.faults:
        faults.configure(args.faults)
    if args.proc_fleet > 1 and not force_single:
        cfg, engine = make_proc_fleet(args)
    else:
        device = resolve_device(args.device)
        cfg, params, tokenizer = load_model(args.model_path, args.dtype, args.attn_impl,
                                            args.tokenizer_path, device)
        cfg, params = prepare_model(cfg, params, tokenizer, args)
        engine = make_engine(args, params, cfg, tokenizer, device, force_single=force_single)
    if args.prefix_prompt:
        # The startup form of POST /prefix.
        pixels = None
        if args.prefix_event:
            _, pixels = process_event_file(args.prefix_event, cfg.num_event_frames,
                                           cfg.vision.image_size)
        plen = engine.set_prefix(args.prefix_prompt, pixels)
        print(f"[serve] shared prefix cached: {plen} positions", flush=True)
    return cfg, engine


def make_proc_fleet(args):
    """(cfg, ProcFleet) of ``--proc_fleet N``: the coordinator loads no
    model, only the config (the handler's pixel preprocessing) and the
    tokenizer (submits and the routing key); each worker runs
    ``_worker_argv(args)``. Roles without the paged layout fail here, not
    as a crash loop of workers that cannot boot."""
    from eventgpt_tpu_torch.config import EventChatConfig, from_hf_config
    from eventgpt_tpu_torch.data.tokenizer import load_tokenizer

    if args.proc_fleet_roles and args.kv_layout != "paged":
        raise ValueError("--proc_fleet_roles requires --kv_layout paged (the prefill->decode "
                         "handoff ships paged KV block runs)")
    if args.model_path == "tiny-random":
        cfg = EventChatConfig.tiny()
        tokenizer = load_tokenizer("byte")
    else:
        tokenizer = load_tokenizer(args.tokenizer_path or args.model_path)
        with open(os.path.join(args.model_path, "config.json")) as f:
            cfg = from_hf_config(json.load(f), device="cpu")
    fleet = ProcFleet(
        _worker_argv(args), args.proc_fleet, tokenizer=tokenizer, conv_mode=args.conv_mode,
        roles=args.proc_fleet_roles or None, handoff_retries=args.procfleet_handoff_retries,
        heartbeat_dir=args.heartbeat_dir, probe_interval_s=args.fleet_probe_interval_s,
        heartbeat_stale_s=args.fleet_heartbeat_stale_s,
        rpc_deadline_s=args.procfleet_rpc_deadline_s, rpc_retries=args.procfleet_rpc_retries,
        spawn_timeout_s=args.procfleet_spawn_timeout_s,
        respawn_backoff_s=args.procfleet_respawn_backoff_s,
        crash_window_s=args.procfleet_crash_window_s, crash_limit=args.procfleet_crash_limit,
        shutdown_drain_s=args.drain_timeout_s)
    return cfg, fleet


def make_engine(args, params, cfg, tokenizer, device, force_single: bool = False):
    """The engine the flags describe over a prepared tree on ``device``:
    one ``ServingEngine``, or with ``--fleet N`` (unless ``force_single``)
    a ``Fleet`` of N engines, each over its own batcher (KV pool, generator,
    scheduler thread) and heartbeat directory ``--heartbeat_dir/replicaI``."""
    n_fleet = args.fleet if args.fleet > 1 and not force_single else 1
    batchers = [make_batcher(args, params, cfg, tokenizer, device) for _ in range(n_fleet)]
    if args.warmup:
        t0 = time.perf_counter()
        n = sum(b.warmup() for b in batchers)
        print(f"[serve] warmup: {n} functions in {time.perf_counter() - t0:.1f}s", flush=True)

    def engine_of(batcher, hb_dir):
        return ServingEngine(batcher, tokenizer, args.conv_mode,
                             breaker_threshold=args.breaker_threshold,
                             breaker_cooldown_s=args.breaker_cooldown_s, heartbeat_dir=hb_dir,
                             trace_out=args.trace_out if n_fleet == 1 else None)

    if n_fleet == 1:
        return engine_of(batchers[0], args.heartbeat_dir)
    hb = args.heartbeat_dir
    return Fleet([engine_of(b, os.path.join(hb, f"replica{i}") if hb else None)
                  for i, b in enumerate(batchers)], tokenizer, args.conv_mode,
                 probe_interval_s=args.fleet_probe_interval_s,
                 heartbeat_stale_s=args.fleet_heartbeat_stale_s,
                 shed_goodput_ratio=args.fleet_shed_goodput,
                 shed_queue_depth=args.fleet_shed_queue,
                 replica_restart_s=args.fleet_restart_s or None)


def build_server(args):
    """(ThreadingHTTPServer, engine), the real stack without ``main``'s
    serve loop, so that tests can run it on an ephemeral port."""
    cfg, engine = build_engine(args)
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(engine, cfg, args.event_root, default_budget=args.max_new_tokens,
                     max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                     default_deadline_s=args.default_deadline_s or None,
                     slo_classes=default_slo_classes(args)))
    return httpd, engine


def main(argv=None):
    import signal

    parser = build_parser()
    args = parser.parse_args(argv)
    if args.worker:
        # A process-fleet worker: one engine, the RPC ops instead of HTTP.
        # serve_worker installs its own SIGTERM/SIGINT handlers.
        from eventgpt_tpu_torch.fleet_proc import serve_worker

        if not args.worker_ready_file:
            parser.error("--worker requires --worker_ready_file")
        _, engine = build_engine(args, force_single=True)
        return serve_worker(engine, args.worker_ready_file)
    httpd, engine = build_server(args)
    host, port = httpd.server_address[:2]
    if isinstance(engine, ProcFleet):
        print(f"[serve] listening on http://{host}:{port} (proc_fleet={args.proc_fleet}, "
              f"roles={args.proc_fleet_roles}, max_batch={args.max_batch}, chunk={args.chunk}, "
              f"kv_layout={args.kv_layout}, kv_cache={args.kv_cache}, device={args.device})",
              flush=True)
    else:
        b = engine.replicas[0].engine.batcher if isinstance(engine, Fleet) else engine.batcher
        print(f"[serve] listening on http://{host}:{port} (max_batch={args.max_batch}, "
              f"chunk={args.chunk}, kv_layout={args.kv_layout}, kv_cache={args.kv_cache}, "
              f"pipeline={b.pipeline}, prefix_cache={b._prefix_cache is not None}, "
              f"prefill_budget={b.prefill_budget}, speculative={b.speculative}, "
              f"preempt={b.preempt}, fleet={max(args.fleet, 1)}, device={b.device})",
              flush=True)
    got_signal = threading.Event()

    def on_signal(signum, frame):
        # Stop accepting; httpd.shutdown joins serve_forever, so not here.
        got_signal.set()
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    try:
        httpd.serve_forever()
    finally:
        if got_signal.is_set():
            deadline = time.monotonic() + args.drain_timeout_s
            while time.monotonic() < deadline:
                s = engine.stats()
                if not (s["active_rows"] or s["queued"]):
                    break
                time.sleep(0.05)
            time.sleep(0.25)  # handler threads write their responses
        engine.shutdown()
        tracer = obs_trace.active()
        if args.trace_out and tracer is not None and not isinstance(engine, ServingEngine):
            # A fleet's coordinator: its own ring (a single engine writes
            # its ring in its shutdown).
            n = tracer.write(args.trace_out)
            print(f"[serve] wrote {n} trace events to {args.trace_out}", flush=True)
        httpd.server_close()


if __name__ == "__main__":
    import sys

    sys.exit(main())
