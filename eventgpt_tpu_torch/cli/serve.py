"""HTTP serving front end over the continuous batcher, on a CUDA card.

Port of ``eventgpt_tpu/cli/serve.py`` for this slice of the port: one
process owns the card and the resident decode batch
(``eventgpt_tpu_torch/serve.py``); a stdlib ThreadingHTTPServer feeds it
through a thread-safe ``ServingEngine``, whose scheduler thread steps the
batcher while work exists.

Endpoints:
  POST /v1/generate  {"query": str,
                      "event_path": .npy path under --event_root |
                      "event_b64": base64 .npy bytes,
                      "max_new_tokens": int = --max_new_tokens,
                      "deadline_s": float (optional),
                      "slo_class": "interactive" | "batch" (optional), with
                      optional per-request "slo_ttft_s" / "slo_itl_s" /
                      "slo_latency_s" overrides of the class targets}
      -> {"answer": str, "tokens": N, "rid": id, "status": "ok",
          "ttft_s": x, "latency_s": y[, "slo_class", "slo_met"]}; a forced
          finish maps to 504 (deadline), 499 (cancelled), 500 (non-finite
          logits) or 503 (resource_exhausted: no blocks, no victim and no
          spill room, with a class-aware Retry-After).
  POST /cancel       {"rid": id} -> {"rid": id, "cancelled": bool}
  POST /prefix       {"prefix_prompt": str, optional "event_path"/"event_b64"
                      when the prefix runs through the event block}
      -> {"prefix_len": N, "entries": N, "bytes": N}: inserts a prefix-KV
         cache entry on a running server
  GET  /prefix_cache -> the prefix cache's entries, budget and counters
  GET  /health       -> {"status": "ok", "active": N, "queued": N}
  GET  /stats        -> engine counters, block-pool state (preemptions,
                        spills, restores, deferrals) and spill store, SLO
                        attainment, the role, recent requests, and under
                        --speculative the speculation counters

Ported flags: --model_path (tiny-random or a checkpoint dir), --tokenizer_path
byte, --use_event_qformer, --pretrain_query_embedder,
--pretrain_attention_layers, --max_batch, --max_len, --chunk,
--temperature, --max_new_tokens, --dtype, --quant, --fuse_params,
--kv_cache, --kv_layout, --kv_pool_blocks, --max_queue,
--default_deadline_s, --max_body_mb, --drain_timeout_s, --host, --port,
--event_root, --conv_mode, --device (default cuda), and the scheduler's
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
``--slo_interactive_itl_s``, ``--slo_batch_latency_s``, ``--slo_window``).
Every other flag of the JAX CLI is accepted and raises
``NotImplementedError`` when set: its path is not ported yet (``--role``
comes with process fleets, the memory flags with telemetry). Chains are
the same with every scheduler feature on or off.

Usage:
  python -m eventgpt_tpu_torch.cli.serve --model_path tiny-random \\
      --kv_layout paged --kv_cache int8 [--device cpu] --port 8600
  curl -s localhost:8600/v1/generate -d @req.json   # {"query": ..., "event_b64": ...}
  curl -s localhost:8600/prefix -d '{"prefix_prompt": "A chat between"}'
  curl -s localhost:8600/prefix_cache
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import itertools
import json
import math
import os
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event
from eventgpt_tpu_torch.ops.image import process_event_file
from eventgpt_tpu_torch.serve import QueueFullError
from eventgpt_tpu_torch.workload import SLO

# The class-aware Retry-After of a refused request: the port's copy of the
# JAX package's ``fleet.retry_after_s`` and its constants.
_RETRY_BASE_S = {"interactive": 1.0, "batch": 4.0}
_RETRY_MAX_S = 60.0


def retry_after_s(slo_class: str, goodput_ratio: float = 1.0, queue_depth: int = 0,
                  max_queue: int = 0) -> float:
    """Seconds a refused client should wait: the class's base (batch backs
    off harder than interactive), scaled linearly up to 4x as the windowed
    SLO attainment falls below 1, and again by the relative queue pressure
    when known; at most ``_RETRY_MAX_S``."""
    base = _RETRY_BASE_S.get(slo_class, _RETRY_BASE_S["batch"])
    g = min(max(float(goodput_ratio), 0.0), 1.0)
    scale = 1.0 + 3.0 * (1.0 - g)
    if max_queue > 0 and queue_depth > 0:
        scale *= 1.0 + min(queue_depth / float(max_queue), 1.0)
    return min(base * scale, _RETRY_MAX_S)


class ServingEngine:
    """Thread-safe wrapper around one ``ContinuousBatcher``.

    The batcher is single-threaded by design; the engine serializes every
    call behind ``_lock`` and runs the scheduler on its own thread, which
    parks when no work exists. HTTP handler threads only prepare requests
    (event file -> pixels, tokenize) and wait on per-request events.

    A scheduler exception fails the in-flight rows (their waiters get the
    fault), keeps the queued requests for the next step, and the loop goes
    on. ``/health`` and ``/stats`` read a snapshot rebuilt after every
    step, so they answer while the scheduler holds the lock through a
    decode segment.
    """

    def __init__(self, batcher, tokenizer, conv_mode: str = "eventgpt_v1",
                 start: bool = True):
        self.batcher = batcher
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._done: Dict[int, threading.Event] = {}
        self._answers: Dict[int, list] = {}
        self._status: Dict[int, str] = {}
        self._abandoned: set = set()  # timed-out rids: dropped at harvest
        self.n_requests = 0
        self.t_start = time.time()
        self.fault: Optional[str] = None  # repr of the last scheduler fault
        self.n_faults = 0
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

    def submit(self, query: str, pixels, max_new_tokens: int,
               deadline_s: Optional[float] = None, slo: Optional[SLO] = None) -> int:
        ids = tokenize_with_event(prepare_event_prompt(query, self.conv_mode), self.tokenizer)
        return self.submit_ids(ids, pixels, max_new_tokens, deadline_s=deadline_s, slo=slo)

    def submit_ids(self, ids, pixels, max_new_tokens: int,
                   deadline_s: Optional[float] = None, slo: Optional[SLO] = None) -> int:
        """``submit`` for a tokenized prompt."""
        with self._lock:
            rid = self.batcher.submit(ids, pixels, max_new_tokens, deadline_s=deadline_s,
                                      slo=slo)
            self._done[rid] = threading.Event()
            self.n_requests += 1
        self._wake.set()
        return rid

    def set_prefix(self, prefix_prompt: str, pixels=None) -> int:
        """Insert a prefix-KV cache entry (``ContinuousBatcher.set_prefix``)
        from raw prompt text, which may hold the ``<event>`` placeholder
        when ``pixels`` carries its stream. Returns the prefix length in
        cache positions. Safe on a live engine: the prefix prefills its own
        row cache."""
        ids = tokenize_with_event(prefix_prompt, self.tokenizer)
        with self._lock:
            plen = self.batcher.set_prefix(ids, pixel_values=pixels)
            self._snapshot = self._build_snapshot_locked()
        return plen

    def cancel(self, rid: int) -> bool:
        """Cancel a queued or in-flight request; its waiter is released with
        the tokens it committed, under status ``cancelled``."""
        with self._lock:
            ok = self.batcher.cancel(rid)
            if ok:
                self._harvest_locked()
                self._snapshot = self._build_snapshot_locked()
        return ok

    def status(self, rid: int) -> str:
        """Terminal status of a finished request ('ok' while unknown)."""
        return self._status.get(rid, "ok")

    def result(self, rid: int, timeout: float = 600.0):
        """Block until the request finishes; returns its token ids."""
        ev = self._done[rid]
        if not ev.wait(timeout):
            with self._lock:
                # Take an answer that landed meanwhile, or have the harvest
                # drop it: nobody waits for it any more.
                self._done.pop(rid, None)
                if rid in self._answers:
                    return self._answers.pop(rid)
                self._abandoned.add(rid)
            raise TimeoutError(f"request {rid} did not finish in {timeout}s")
        with self._lock:
            self._done.pop(rid, None)
            if rid not in self._answers:
                raise RuntimeError(f"serving engine fault: "
                                   f"{self.fault or self._status.get(rid, 'unknown fault')}")
            return self._answers.pop(rid)

    def stats(self) -> Dict[str, Any]:
        return {"uptime_s": round(time.time() - self.t_start, 1),
                "requests": self.n_requests, **self._snapshot}

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
        if self._thread.is_alive():
            self._thread.join(timeout=10)

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
            "admission_s": round(b.admission_s, 3),
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
        pc = b.prefix_cache_stats()
        snap["prefix_cache"] = {k: pc[k] for k in ("enabled", "n_entries", "bytes", "hits",
                                                    "misses", "evictions") if k in pc}
        return snap

    def _loop(self) -> None:
        while not self._stop:
            try:
                with self._lock:
                    # An in-flight segment left after the last row finished
                    # is drained by one more step.
                    busy = bool(self.batcher.queue
                                or any(r is not None for r in self.batcher.rows)
                                or self.batcher._inflight is not None)
                    if busy:
                        self.batcher.step()
                        self._harvest_locked()
                        self._snapshot = self._build_snapshot_locked()
            except Exception as e:  # a scheduler fault must be loud
                self._on_fault(e)
                time.sleep(0.05)
                continue
            if not busy:
                self._wake.wait(timeout=0.1)
                self._wake.clear()

    def _on_fault(self, e: Exception) -> None:
        """Fail the in-flight rows, lanes and pending admission (their blocks
        and prefix pins return, and the pipeline's in-flight segment and
        device carry are dropped); the queued requests stay for the next
        step."""
        with self._lock:
            self.fault = repr(e)
            self.n_faults += 1
            for rid in self.batcher.abort_rows():
                self._status[rid] = "engine_fault"
                if rid in self._done:
                    self._done[rid].set()  # result() finds no answer: raises
                self._abandoned.discard(rid)
            self._snapshot = self._build_snapshot_locked()

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


def make_handler(engine: ServingEngine, cfg, event_root=None, default_budget: int = 64,
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

        def do_GET(self):
            if self.path == "/health":
                s = engine.stats()
                self._json(200, {"status": "ok", "active": s["active_rows"],
                                 "queued": s["queued"], "faults": s["faults"]})
            elif self.path == "/stats":
                self._json(200, engine.stats())
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
            if self.path not in ("/v1/generate", "/cancel", "/prefix"):
                self._json(404, {"error": f"no route {self.path}"})
                return
            payload = self._read_payload()
            if payload is None:
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
                if payload.get("stream"):
                    raise ValueError("streaming responses are not ported yet")
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
            t0 = time.perf_counter()
            try:
                rid = engine.submit(query, pixels, budget, deadline_s=deadline, slo=slo)
            except QueueFullError as e:
                # Backpressure: the client backs off by its class and the
                # engine's windowed attainment, as on a 503 below.
                cls_name = slo.name if slo is not None else "batch"
                ra = retry_after_s(cls_name, engine.goodput_ratio())
                self._json(429, {"error": str(e), "slo_class": cls_name,
                                 "retry_after_s": round(ra, 3)},
                           headers={"Retry-After": str(max(1, math.ceil(ra)))})
                return
            except ValueError as e:  # the request does not fit the server
                self._json(400, {"error": str(e)})
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

    return Handler


# Flags of the JAX CLI whose paths are not ported yet: (flag, argparse
# keywords, what). Each defaults to "off" and raises when set.
_UNPORTED = [
    ("--mem_headroom_mb", dict(type=float),
     "the memory headroom guard (ROADMAP Queue 1 item 6, telemetry)"),
    ("--mem_capacity_mb", dict(type=float),
     "the memory headroom guard (ROADMAP Queue 1 item 6, telemetry)"),
    ("--breaker_threshold", dict(type=int), "the circuit breaker"),
    ("--breaker_cooldown_s", dict(type=float), "the circuit breaker"),
    ("--heartbeat_dir", dict(), "the serving heartbeat"),
    ("--fleet", dict(type=int), "fleet serving"),
    ("--fleet_shed_goodput", dict(type=float), "fleet serving"),
    ("--fleet_shed_queue", dict(type=int), "fleet serving"),
    ("--fleet_probe_interval_s", dict(type=float), "fleet serving"),
    ("--fleet_heartbeat_stale_s", dict(type=float), "fleet serving"),
    ("--fleet_restart_s", dict(type=float), "fleet serving"),
    ("--proc_fleet", dict(type=int), "process fleets"),
    ("--proc_fleet_roles", dict(), "prefill/decode disaggregation"),
    ("--procfleet_handoff_retries", dict(type=int), "process fleets"),
    ("--procfleet_rpc_deadline_s", dict(type=float), "process fleets"),
    ("--procfleet_rpc_retries", dict(type=int), "process fleets"),
    ("--procfleet_spawn_timeout_s", dict(type=float), "process fleets"),
    ("--procfleet_respawn_backoff_s", dict(type=float), "process fleets"),
    ("--procfleet_crash_window_s", dict(type=float), "process fleets"),
    ("--procfleet_crash_limit", dict(type=int), "process fleets"),
    ("--role", dict(),
     "the per-slot worker role (ROADMAP Queue 1 item 4, with process fleets)"),
    ("--worker", dict(action="store_true"), "process-fleet workers"),
    ("--worker_ready_file", dict(), "process-fleet workers"),
    ("--worker_slot", dict(type=int), "process-fleet workers"),
    ("--journey_keep", dict(type=int), "the flight recorder"),
    ("--series_interval_s", dict(type=float), "the time-series store"),
    ("--series_keep", dict(type=int), "the time-series store"),
    ("--trace_buffer", dict(type=int), "span tracing"),
    ("--trace_out", dict(), "span tracing"),
    ("--profile_dir", dict(), "POST /profile"),
    ("--faults", dict(), "fault injection"),
]
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
                   help="accepted and already the port's state: telemetry is not ported")
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
    p.add_argument("--warmup", action="store_true",
                   help="run every function a request can reach once before listening (kernel "
                        "builds, cuBLAS handles, the allocator's first growth)")
    for flag, kw, what in _UNPORTED:
        p.add_argument(flag, default=None, help=f"{what}: not ported yet, raises when set",
                       **kw)
    for flag in _MESH_FLAGS:
        p.add_argument(flag, type=int, default=1,
                       help="the serving mesh: not ported yet, raises unless 1")
    return p


def _refuse_unported(args) -> None:
    for flag, kw, what in _UNPORTED:
        val = getattr(args, flag[2:])
        if val is not None and val is not False:
            raise NotImplementedError(f"{flag}: {what} is not ported to eventgpt_tpu_torch yet")
    if any(getattr(args, f[2:]) != 1 for f in _MESH_FLAGS):
        raise NotImplementedError("--mesh_*: the serving mesh (ROADMAP Queue 1 item 8) is not "
                                  "ported to eventgpt_tpu_torch yet")


def make_batcher(args, params, cfg, tokenizer, device, role: str = "colocated"):
    """The ``ContinuousBatcher`` the flags describe, over a prepared tree
    on ``device``: the JAX CLI's defaults (pipelined, the prefix cache at
    ``--prefix_cache_mb``, ``--prefill_budget`` -1 = ``--chunk``). ``role``
    makes a prefill or decode batcher for an in-process handoff (the
    ``--role`` flag waits for process fleets)."""
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
        spill_capacity_mb=args.spill_capacity_mb, slo_window=args.slo_window, role=role)


def build_engine(args):
    """(cfg, engine): the model loaded and prepared on ``--device`` as
    ``cli/infer`` does it (``load_model``, ``prepare_model``), and one
    batcher under one engine."""
    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.device import resolve_device

    _refuse_unported(args)
    device = resolve_device(args.device)
    cfg, params, tokenizer = load_model(args.model_path, args.dtype, None, args.tokenizer_path,
                                        device)
    cfg, params = prepare_model(cfg, params, tokenizer, args)
    batcher = make_batcher(args, params, cfg, tokenizer, device)
    if args.warmup:
        t0 = time.perf_counter()
        n = batcher.warmup()
        print(f"[serve] warmup: {n} functions in {time.perf_counter() - t0:.1f}s", flush=True)
    engine = ServingEngine(batcher, tokenizer, args.conv_mode)
    if args.prefix_prompt:
        # The startup form of POST /prefix.
        pixels = None
        if args.prefix_event:
            _, pixels = process_event_file(args.prefix_event, cfg.num_event_frames,
                                           cfg.vision.image_size)
        plen = engine.set_prefix(args.prefix_prompt, pixels)
        print(f"[serve] shared prefix cached: {plen} positions", flush=True)
    return cfg, engine


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

    args = build_parser().parse_args(argv)
    httpd, engine = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (max_batch={args.max_batch}, "
          f"chunk={args.chunk}, kv_layout={args.kv_layout}, kv_cache={args.kv_cache}, "
          f"pipeline={engine.batcher.pipeline}, prefix_cache="
          f"{engine.batcher._prefix_cache is not None}, prefill_budget="
          f"{engine.batcher.prefill_budget}, speculative={engine.batcher.speculative}, "
          f"preempt={engine.batcher.preempt}, device={engine.batcher.device})", flush=True)
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
        httpd.server_close()


if __name__ == "__main__":
    main()
