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
                      "deadline_s": float (optional)}
      -> {"answer": str, "tokens": N, "rid": id, "status": "ok",
          "ttft_s": x, "latency_s": y}; a forced finish maps to 504
          (deadline), 499 (cancelled) or 500 (non-finite logits).
  POST /cancel       {"rid": id} -> {"rid": id, "cancelled": bool}
  GET  /health       -> {"status": "ok", "active": N, "queued": N}
  GET  /stats        -> engine counters, block-pool state, recent requests

Ported flags: --model_path (tiny-random or a checkpoint dir), --tokenizer_path
byte, --use_event_qformer, --pretrain_query_embedder,
--pretrain_attention_layers, --max_batch, --max_len, --chunk,
--temperature, --max_new_tokens, --dtype, --quant, --fuse_params,
--kv_cache, --kv_layout, --kv_pool_blocks, --max_queue,
--default_deadline_s, --max_body_mb, --drain_timeout_s, --host, --port,
--event_root, --conv_mode and --device (default cuda). Every other flag of
the JAX CLI is accepted and raises ``NotImplementedError`` when set: its
path is not ported yet. The JAX CLI turns the prefix-KV cache and
piggyback lanes on by default; here both are off, because neither is
ported. Chains are the same either way (the JAX package's contract).

Usage:
  python -m eventgpt_tpu_torch.cli.serve --model_path tiny-random \\
      --kv_layout paged --kv_cache int8 [--device cpu] --port 8600
  curl -s localhost:8600/v1/generate -d @req.json   # {"query": ..., "event_b64": ...}
"""

from __future__ import annotations

import argparse
import base64
import itertools
import json
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
               deadline_s: Optional[float] = None) -> int:
        ids = tokenize_with_event(prepare_event_prompt(query, self.conv_mode), self.tokenizer)
        return self.submit_ids(ids, pixels, max_new_tokens, deadline_s=deadline_s)

    def submit_ids(self, ids, pixels, max_new_tokens: int,
                   deadline_s: Optional[float] = None) -> int:
        """``submit`` for a tokenized prompt."""
        with self._lock:
            rid = self.batcher.submit(ids, pixels, max_new_tokens, deadline_s=deadline_s)
            self._done[rid] = threading.Event()
            self.n_requests += 1
        self._wake.set()
        return rid

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
            "segments": b.segments,
            "recent": {str(k): {kk: round(vv, 3) for kk, vv in b.request_stats[k].items()}
                       for k in itertools.islice(reversed(b.request_stats), 8)},
        }
        pool = b.pool_stats()
        if pool is not None:
            snap["kv_blocks"] = pool
        return snap

    def _loop(self) -> None:
        while not self._stop:
            try:
                with self._lock:
                    busy = bool(self.batcher.queue
                                or any(r is not None for r in self.batcher.rows))
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
        """Fail the in-flight rows (their blocks return to the pool); the
        queued requests stay for the next step."""
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
                 "nan_quarantined": 500}


def make_handler(engine: ServingEngine, cfg, event_root=None, default_budget: int = 64,
                 max_body_bytes: int = 32 * 1024 * 1024,
                 default_deadline_s: Optional[float] = None):

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
            if self.path not in ("/v1/generate", "/cancel"):
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
            try:
                query = payload["query"]
                budget = int(payload.get("max_new_tokens", default_budget))
                deadline = payload.get("deadline_s", default_deadline_s)
                deadline = float(deadline) if deadline else None
                if payload.get("stream"):
                    raise ValueError("streaming responses are not ported yet")
                pixels = _decode_pixels(payload, cfg, event_root)
            except Exception as e:  # a bad request, not a server fault
                self._json(400, {"error": str(e)})
                return
            t0 = time.perf_counter()
            try:
                rid = engine.submit(query, pixels, budget, deadline_s=deadline)
            except QueueFullError as e:
                self._json(429, {"error": str(e)}, headers={"Retry-After": "1"})
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
            code = _STATUS_CODES.get(status, 500)
            if code != 200:
                obj["error"] = status
            self._json(code, obj)

    return Handler


# Flags of the JAX CLI whose paths are not ported yet: (flag, argparse
# keywords, what). Each defaults to "off" and raises when set.
_UNPORTED = [
    ("--speculative", dict(type=int), "speculative decoding"),
    ("--spec_buckets", dict(), "adaptive speculation"),
    ("--spec_ema_alpha", dict(type=float), "adaptive speculation"),
    ("--spec_draft_cost", dict(type=float), "adaptive speculation"),
    ("--spec_row_window", dict(type=int), "adaptive speculation"),
    ("--spec_head_min_yield", dict(type=float), "adaptive speculation"),
    ("--draft_head", dict(), "Medusa draft heads"),
    ("--prefill_chunk", dict(type=int), "chunked prefill"),
    ("--first_chunk", dict(type=int), "the TTFT ramp"),
    ("--warmup", dict(action="store_true"), "warmup (the port compiles nothing ahead)"),
    ("--prefix_prompt", dict(), "the prefix-KV cache"),
    ("--prefix_event", dict(), "the prefix-KV cache"),
    ("--prefix_cache_mb", dict(type=float), "the prefix-KV cache"),
    ("--preempt", dict(action="store_true"), "block-tier preemption"),
    ("--spill_capacity_mb", dict(type=int), "the KV spill store"),
    ("--mem_headroom_mb", dict(type=float), "the memory headroom guard"),
    ("--mem_capacity_mb", dict(type=float), "the memory headroom guard"),
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
    ("--role", dict(), "prefill/decode roles"),
    ("--worker", dict(action="store_true"), "process-fleet workers"),
    ("--worker_ready_file", dict(), "process-fleet workers"),
    ("--worker_slot", dict(type=int), "process-fleet workers"),
    ("--slo_interactive_ttft_s", dict(type=float), "SLO classes"),
    ("--slo_interactive_itl_s", dict(type=float), "SLO classes"),
    ("--slo_batch_latency_s", dict(type=float), "SLO classes"),
    ("--slo_window", dict(type=int), "SLO classes"),
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
    p.add_argument("--prefill_budget", type=int, default=0,
                   help="piggyback prefill lanes: not ported, so 0 (off) here, where the "
                        "JAX CLI defaults to -1 (auto); every admission runs the batched "
                        "prefill wave, and chains are the same either way. Any other "
                        "value raises")
    p.add_argument("--no_prefix_cache", action="store_true",
                   help="accepted and already the port's state: the prefix-KV cache, on "
                        "by default in the JAX CLI, is not ported, so every admission "
                        "prefills in full (the same chains)")
    p.add_argument("--no_pipeline", action="store_true",
                   help="accepted and already the port's state: it has only the "
                        "synchronous scheduler (the same chains)")
    p.add_argument("--no_telemetry", action="store_true",
                   help="accepted and already the port's state: telemetry is not ported")
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
        raise NotImplementedError("--mesh_*: the serving mesh is not ported to "
                                  "eventgpt_tpu_torch yet")
    if args.prefill_budget != 0:
        raise NotImplementedError(f"--prefill_budget {args.prefill_budget}: piggyback "
                                  f"prefill lanes are not ported to eventgpt_tpu_torch yet")


def build_engine(args):
    """(cfg, engine): the model loaded and prepared on ``--device`` as
    ``cli/infer`` does it (``load_model``, ``prepare_model``), and one
    batcher under one engine."""
    from eventgpt_tpu_torch.cli.infer import load_model, prepare_model
    from eventgpt_tpu_torch.device import resolve_device
    from eventgpt_tpu_torch.serve import ContinuousBatcher

    _refuse_unported(args)
    device = resolve_device(args.device)
    cfg, params, tokenizer = load_model(args.model_path, args.dtype, None, args.tokenizer_path,
                                        device)
    cfg, params = prepare_model(cfg, params, tokenizer, args)
    batcher = ContinuousBatcher(
        params, cfg, max_batch=args.max_batch, max_len=args.max_len, chunk=args.chunk,
        temperature=args.temperature, eos_token_id=tokenizer.eos_token_id,
        kv_quant=args.kv_cache == "int8", max_queue=args.max_queue,
        kv_layout=args.kv_layout, kv_pool_blocks=args.kv_pool_blocks, device=device)
    return cfg, ServingEngine(batcher, tokenizer, args.conv_mode)


def build_server(args):
    """(ThreadingHTTPServer, engine), the real stack without ``main``'s
    serve loop, so that tests can run it on an ephemeral port."""
    cfg, engine = build_engine(args)
    httpd = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(engine, cfg, args.event_root, default_budget=args.max_new_tokens,
                     max_body_bytes=int(args.max_body_mb * 1024 * 1024),
                     default_deadline_s=args.default_deadline_s or None))
    return httpd, engine


def main(argv=None):
    import signal

    args = build_parser().parse_args(argv)
    httpd, engine = build_server(args)
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (max_batch={args.max_batch}, "
          f"chunk={args.chunk}, kv_layout={args.kv_layout}, kv_cache={args.kv_cache}, "
          f"device={engine.batcher.device})", flush=True)
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
