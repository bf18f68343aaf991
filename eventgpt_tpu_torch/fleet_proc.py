"""Process-fleet serving: worker processes behind an RPC coordinator.

Port of ``eventgpt_tpu/fleet_proc.py``. ``fleet.Fleet`` runs N replicas as
threads of one process: one weight tree, one interpreter, one failure
domain. A ``ProcFleet`` coordinator has the same client surface (so that
``cli/serve.make_handler`` serves it as it is) and spawns N worker
processes instead, each running ``python -m eventgpt_tpu_torch.cli.serve
--worker``, each owning a full ``ServingEngine`` and its model on the card,
and talks to them over ``rpc.py``. Workers are started with
``subprocess.Popen`` (never by ``fork`` after CUDA has started), with the
repository root on their ``PYTHONPATH``.

Robustness, in four layers:

1. **Every RPC edge is bounded**: per-op deadlines, bounded backoff with
   jitter, mutating ops never retried blindly (``rpc.call``). Fault sites:
   ``procfleet.rpc`` (in ``rpc.call``), ``procfleet.spawn`` (a trip fails
   that spawn attempt, booked as a crash) and ``procfleet.worker_kill``
   (the trip is the SIGKILL of the busiest worker).
2. **Liveness is observed three ways**: heartbeat files (the trainer's
   format under ``--heartbeat_dir/replicaN``), RPC probes of the lock-free
   ``snapshot`` op, and ``Popen.poll()``. A stale or unreachable worker is
   drained while it still answers (``export_requests`` over RPC: its queued
   and in-flight requests re-route, committed tokens dropped, so a greedy
   chain is the one an uninterrupted engine gives); a dead one (SIGKILL)
   takes the redo path: the coordinator re-submits from its own records.
3. **Respawn with a crash-loop breaker**: a dead slot respawns after a
   per-slot exponential backoff; ``crash_limit`` crashes inside
   ``crash_window_s`` give the slot up, and the fleet serves on with less
   capacity (``/health`` stays green while a worker is routable).
4. **Shutdown drains**: the coordinator waits (bounded) for live requests,
   then asks each worker to stop before it terminates or kills it.

Prefix-affinity routing keys on ``fleet.affinity_key``, so a session keeps
landing on the worker whose prefix cache holds its head.

Prefill/decode disaggregation: ``roles="P:D"`` makes the first P slots
prefill workers (their batchers admit, gather each request's paged block
run into a handoff record and never decode) and the rest decode workers.
New requests route to the prefill pool; the supervisor pumps each prefill
worker's outbox (``collect_handoffs``, the records' planes as raw bytes on
the wire), ships every record (``import_handoff``) to the decode worker
with the most free pool bytes, and acks it at the source once it landed.
A ship attempt probes ``procfleet.handoff``; a failed one retries on
another decode worker (``handoff_retries``) and then falls back to the redo
path. Never a double splice: the decode side dedups imports on the
coordinator's ``hid`` token. A 7B record (225-242 MB) is larger than one
socket frame and crosses as a run of capped frames (``rpc.send_frames``);
``collect_handoffs`` answers with the unacked records up to
``rpc.MAX_RUN_BYTES`` and leaves the rest for the next collect.

The JAX coordinator also keeps flight-recorder journeys (stitched across
processes), time series, alerts, per-worker memory ledgers and Prometheus
gauges: the fleets' half of telemetry, not ported yet (ROADMAP Queue 1
item 6b; each worker's engine arms its own): ``journey``, ``journeys``, ``series``,
``alerts`` and ``memory_stats`` raise ``NotImplementedError``, the workers'
``journey``/``series``/``alerts``/``memory`` ops answer with that remote
error, and ``stats`` leaves those parts out. Streaming is not ported
(``stream_queue`` raises). A worker's ``stats`` op carries each kernel's
launch count, so the coordinator can show which worker launched what.

A torch-light stub worker (``python -m eventgpt_tpu_torch.fleet_proc
--stub_worker``) serves the same RPC surface over a deterministic fake
engine with the JAX stub's numbers, so that the coordinator's decisions can
be held against the JAX coordinator's over the JAX stub.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from eventgpt_tpu_torch import faults, rpc
from eventgpt_tpu_torch.fleet import _TELEMETRY, affinity_key

# The repository root, put on a worker's PYTHONPATH so that ``-m
# eventgpt_tpu_torch...`` resolves wherever the coordinator runs from.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _map_remote(e: rpc.RpcRemoteError) -> Exception:
    """A remote exception as the local one the serving stack's callers
    already handle."""
    if e.type_name == "QueueFullError":
        from eventgpt_tpu_torch.serve import QueueFullError

        return QueueFullError(e.remote_msg)
    if e.type_name == "ValueError":
        return ValueError(e.remote_msg)
    return RuntimeError(f"worker error: {e}")


def kernel_launches() -> Dict[str, Any]:
    """This process's kernel launch counts: each kernel's by its source
    file, and K4's by (path, M)."""
    from eventgpt_tpu_torch.ops.decode_attention import DECODE_INT8_KERNEL, PAGED_INT8_KERNEL
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL, LAUNCHES_BY_M

    kernels = (FLASH_KERNEL, INT4_KERNEL, DECODE_INT8_KERNEL, PAGED_INT8_KERNEL)
    return {"launches": {k.source: k.launches for k in kernels},
            "int4_launches_by_m": {f"{p} M={m}": n for (p, m), n in sorted(LAUNCHES_BY_M.items())}}


def _reset_kernel_launches() -> None:
    from eventgpt_tpu_torch.ops.decode_attention import DECODE_INT8_KERNEL, PAGED_INT8_KERNEL
    from eventgpt_tpu_torch.ops.flash_attention import FLASH_KERNEL
    from eventgpt_tpu_torch.ops.int4_matmul import INT4_KERNEL, LAUNCHES_BY_M, LAUNCHES_BY_SHAPE

    for k in (FLASH_KERNEL, INT4_KERNEL, DECODE_INT8_KERNEL, PAGED_INT8_KERNEL):
        k.launches = 0
        k.launches_by_thread.clear()
    LAUNCHES_BY_M.clear()
    LAUNCHES_BY_SHAPE.clear()


# Where a worker's batcher time went, for its ``stats`` op.
_SCHEDULER_KEYS = ("admission_s", "decode_s", "decode_steps", "decode_steps_run",
                   "device_segment_s", "host_gap_s", "seg_count", "prefill_dispatches")


def _wire_nbytes(o: Any) -> int:
    """The array bytes a record puts on the wire (its planes)."""
    if isinstance(o, np.ndarray):
        return o.nbytes
    if hasattr(o, "element_size") and hasattr(o, "numel"):
        return o.element_size() * o.numel()
    if isinstance(o, dict):
        return sum(_wire_nbytes(v) for v in o.values())
    if isinstance(o, (list, tuple)):
        return sum(_wire_nbytes(v) for v in o)
    return 0


# -- worker side -----------------------------------------------------------

class WorkerHandler:
    """The RPC op table over one ``ServingEngine`` (or the stub).

    Ops: ping, submit_ids, try_result, try_results, try_status, cancel,
    export_requests, snapshot, stats, set_prefix, reset_stats, shutdown,
    collect_handoffs, ack_handoffs, import_handoff; journey, series, alerts
    and memory answer with a ``NotImplementedError`` (telemetry).

    ``try_result`` is idempotent here: the engine pops a delivered answer,
    so a retried poll whose first response was lost would find nothing.
    Delivered records stay in a bounded replay cache. ``collect_handoffs``
    parks popped records until ``ack_handoffs`` (a collect response lost in
    transit replays), and ``import_handoff`` dedups on the coordinator's
    ``hid`` (a retried ship whose first response was lost returns the
    first rid instead of splicing twice). The caches are written from
    concurrent connection threads, under ``_lock``.
    """

    REPLAY_CAP = 4096

    def __init__(self, engine):
        self.engine = engine
        self.stop_event = threading.Event()
        self._lock = threading.Lock()
        self._delivered: Dict[int, dict] = {}
        self._handoff_unacked: Dict[int, dict] = {}
        self._imported: Dict[str, int] = {}

    def _result_record(self, rid: int) -> Optional[dict]:
        with self._lock:
            if rid in self._delivered:
                return self._delivered[rid]
        got = self.engine.try_result(rid)
        if got is None:
            return None
        tokens, status = got
        rec = {"tokens": tokens, "status": status,
               "stats": dict(self.engine.batcher.request_stats.get(rid, {})),
               "journey": None}  # the flight recorder waits for telemetry
        with self._lock:
            self._delivered[rid] = rec
            while len(self._delivered) > self.REPLAY_CAP:
                self._delivered.pop(next(iter(self._delivered)))
        return rec

    def _collect_handoffs(self) -> List[dict]:
        """Drain the engine's outbox into the replay dict, then serve the
        unacked records (each with ``elapsed_s`` refreshed by its outbox
        wait, the worker-local stamp kept off the wire) up to
        ``rpc.MAX_RUN_BYTES`` of planes less a frame for the rest; the next
        collect serves what is left."""
        eng = self.engine
        fresh = eng.collect_handoffs() if hasattr(eng, "collect_handoffs") else []
        now = time.perf_counter()
        budget = rpc.MAX_RUN_BYTES - rpc.MAX_MSG_BYTES
        with self._lock:
            for rec in fresh:
                self._handoff_unacked[int(rec["rid"])] = rec
            out, used = [], 0
            for rec in self._handoff_unacked.values():
                n = _wire_nbytes(rec.get("rec"))
                if out and used + n > budget:
                    break
                used += n
                wire = {k: v for k, v in rec.items() if k != "t_gather"}
                if rec.get("t_gather") is not None:
                    wire["elapsed_s"] = (rec.get("elapsed_s") or 0.0) + (now - rec["t_gather"])
                out.append(wire)
            return out

    def __call__(self, op: str, p: dict) -> Any:
        eng = self.engine
        if op == "ping":
            return {"pid": os.getpid(), "alive": eng.alive}
        if op == "submit_ids":
            return eng.submit_ids(list(p["input_ids"]), p["pixel_values"],
                                  int(p["max_new_tokens"]), deadline_s=p.get("deadline_s"),
                                  slo=p.get("slo"))
        if op == "try_result":
            return self._result_record(int(p["rid"]))
        if op == "try_results":
            return {str(rid): self._result_record(int(rid)) for rid in p["rids"]}
        if op == "try_status":
            return eng.try_status(int(p["rid"]))
        if op == "cancel":
            return eng.cancel(int(p["rid"]))
        if op == "export_requests":
            # The graceful half of failover: deliver what finished, park the
            # scheduler, strip and return every unfinished request. The
            # process stays up so that finished answers can be collected.
            return eng.kill()
        if op == "snapshot":
            s = dict(eng.snapshot())
            s["breaker_open"] = eng.breaker_open()
            s["alive"] = eng.alive
            s["goodput_ratio"] = eng.goodput_ratio()
            s["n_faults"] = eng.n_faults
            s["n_restarts"] = eng.n_restarts
            pc = dict(eng.batcher.prefix_cache_stats())
            pc.pop("entries", None)  # per-entry dumps do not add up
            s["prefix_cache"] = pc
            return s
        if op == "stats":
            b = eng.batcher
            out = {**eng.stats(), **kernel_launches(),
                   "scheduler": {k: getattr(b, k) for k in _SCHEDULER_KEYS if hasattr(b, k)}}
            dev = getattr(getattr(b, "device", None), "type", None)
            if dev == "cuda":
                import torch

                out["cuda_memory"] = {"allocated": torch.cuda.memory_allocated(),
                                      "max_allocated": torch.cuda.max_memory_allocated(),
                                      "reserved": torch.cuda.memory_reserved(),
                                      "max_reserved": torch.cuda.max_memory_reserved()}
            return out
        if op in ("journey", "series", "alerts", "memory"):
            raise NotImplementedError(f"the worker's {op} op: {_TELEMETRY}")
        if op == "set_prefix":
            return eng.set_prefix(p["prefix_prompt"], p.get("pixel_values"))
        if op == "reset_stats":
            b = eng.batcher
            if hasattr(b, "reset_serving_stats"):
                b.reset_serving_stats()
            _reset_kernel_launches()
            return True
        if op == "collect_handoffs":
            return self._collect_handoffs()
        if op == "ack_handoffs":
            with self._lock:
                for rid in p["rids"]:
                    self._handoff_unacked.pop(int(rid), None)
            return True
        if op == "import_handoff":
            hid = str(p["hid"])
            with self._lock:
                if hid in self._imported:
                    return self._imported[hid]
            rid = eng.import_handoff(
                list(p["input_ids"]), int(p["max_new_tokens"]), p["rec"],
                tokens=list(p.get("tokens") or ()), prompt_len=int(p.get("prompt_len", 0)),
                deadline_s=p.get("deadline_s"), slo=p.get("slo"),
                elapsed_s=float(p.get("elapsed_s") or 0.0), ttft_s=p.get("ttft_s"))
            with self._lock:
                self._imported[hid] = rid
                while len(self._imported) > self.REPLAY_CAP:
                    self._imported.pop(next(iter(self._imported)))
            return rid
        if op == "shutdown":
            self.stop_event.set()
            return True
        raise ValueError(f"unknown rpc op {op!r}")


def _write_ready_file(path: str, port: int) -> None:
    """The readiness handshake: the coordinator polls for this file and
    reads the worker's port from it (written to a temporary name and
    renamed, so a half-written file is never seen)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"port": port, "pid": os.getpid()}, f)
    os.replace(tmp, path)


def serve_worker(engine, ready_file: str) -> int:
    """Run one worker's RPC server until a ``shutdown`` op, SIGTERM or
    SIGINT; returns the exit code. The engine's heartbeat
    (``--heartbeat_dir``) beats all along: the coordinator reads it."""
    handler = WorkerHandler(engine)
    server = rpc.RpcServer(handler)

    def _on_signal(signum, frame):
        handler.stop_event.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    _write_ready_file(ready_file, server.port)
    handler.stop_event.wait()
    # Settle the engine (its in-flight segment) before the server goes, so
    # a drain-then-shutdown coordinator never races the parked scheduler.
    try:
        engine.shutdown()
    finally:
        server.stop()
    return 0


# -- the stub worker -------------------------------------------------------

class _StubBatcher:
    """The ``engine.batcher`` surface ``WorkerHandler`` reads."""

    def __init__(self):
        self.request_stats: Dict[int, dict] = {}

    def prefix_cache_stats(self) -> dict:
        return {"enabled": False}

    def reset_serving_stats(self) -> None:
        self.request_stats.clear()


class _StubEngine:
    """A deterministic fake ``ServingEngine`` (the JAX stub's numbers): a
    request ``(ids, budget)`` decodes to ``[(sum(ids) + k) % 251 for k in
    range(budget)]`` after ``token_delay_s`` a token, in every process, so
    that failover tests can hold chains without a model.

    A ``prefill`` stub moves a request to its handoff outbox after one
    ``token_delay_s``, with the ids as an int32 "KV" plane (it crosses the
    raw frame; the decode stub refuses a plane that changed in transit); a
    ``decode`` stub's ``import_handoff`` queues it like a submit and
    finishes it with the same chain as a colocated stub. The live and done
    maps and the outbox move under ``_lock``."""

    def __init__(self, token_delay_s: float = 0.005, role: str = "colocated"):
        self.token_delay_s = float(token_delay_s)
        self.role = role
        self.batcher = _StubBatcher()
        self.alive = True
        self.n_faults = 0
        self.n_restarts = 0
        self._lock = threading.Lock()
        self._next_rid = 0
        self._reqs: Dict[int, dict] = {}
        self._done: Dict[int, tuple] = {}
        self._handoffs: List[dict] = []
        self.handoffs_gathered = 0
        self.handoffs_spliced = 0
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit_ids(self, ids, pixels, max_new_tokens, deadline_s=None, slo=None) -> int:
        if not self.alive:
            raise RuntimeError("stub engine is down (killed)")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._reqs[rid] = {"rid": rid, "ids": list(ids), "pixels": pixels,
                               "budget": int(max_new_tokens), "t0": time.perf_counter(),
                               "deadline_s": deadline_s, "slo": slo}
        return rid

    @staticmethod
    def _chain(ids, budget) -> List[int]:
        s = sum(int(t) for t in ids)
        return [(s + k) % 251 for k in range(budget)]

    def _loop(self) -> None:
        while True:
            time.sleep(self.token_delay_s)
            now = time.perf_counter()
            with self._lock:
                if not self.alive:
                    continue
                for rid, r in list(self._reqs.items()):
                    if self.role == "prefill":
                        if now - r["t0"] < self.token_delay_s:
                            continue
                        self._reqs.pop(rid)
                        self.handoffs_gathered += 1
                        self._handoffs.append({
                            "rid": rid, "input_ids": list(r["ids"]), "tokens": [],
                            "max_new_tokens": r["budget"], "prompt_len": len(r["ids"]),
                            "deadline_s": r["deadline_s"], "slo": r["slo"], "preempts": 0,
                            "journey": None,
                            "rec": {"n_blocks": 1, "n_total": 1, "length": len(r["ids"]),
                                    "nbytes_kv": 4 * len(r["ids"]),
                                    "kv": np.asarray(r["ids"], np.int32)}})
                        continue
                    if now - r["t0"] >= self.token_delay_s * r["budget"]:
                        self._reqs.pop(rid)
                        self._done[rid] = (self._chain(r["ids"], r["budget"]), "ok")
                        self.batcher.request_stats[rid] = {"latency_s": now - r["t0"],
                                                           "slo_met": True}

    def collect_handoffs(self) -> List[dict]:
        with self._lock:
            out, self._handoffs = self._handoffs, []
            return out

    def import_handoff(self, input_ids, max_new_tokens, rec, tokens=(), prompt_len=0,
                       deadline_s=None, slo=None, elapsed_s=0.0, ttft_s=None) -> int:
        if not self.alive:
            raise RuntimeError("stub engine is down (killed)")
        kv = rec.get("kv")
        if kv is not None and np.asarray(kv).tolist() != [int(t) for t in input_ids]:
            raise ValueError("stub handoff KV plane corrupted in transit")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self.handoffs_spliced += 1
            self._reqs[rid] = {"rid": rid, "ids": list(input_ids), "pixels": None,
                               "budget": int(max_new_tokens), "t0": time.perf_counter(),
                               "deadline_s": deadline_s, "slo": slo}
        return rid

    def try_result(self, rid):
        with self._lock:
            return self._done.pop(rid, None)

    def try_status(self, rid):
        return None

    def cancel(self, rid) -> bool:
        with self._lock:
            return self._reqs.pop(rid, None) is not None

    def kill(self) -> list:
        with self._lock:
            self.alive = False
            recs = [{"rid": r["rid"], "input_ids": r["ids"], "pixel_values": r["pixels"],
                     "max_new_tokens": r["budget"], "deadline_s": r["deadline_s"],
                     "slo": r["slo"]}
                    for r in self._reqs.values()]
            self._reqs.clear()
            return recs

    def breaker_open(self) -> bool:
        return not self.alive

    def goodput_ratio(self) -> float:
        return 1.0

    def snapshot(self) -> dict:
        with self._lock:
            # Pool headroom that shrinks with load, so that decode placement
            # is exercised at stub speed.
            return {"active_rows": len(self._reqs), "queued": 0, "slo": {}, "role": self.role,
                    "kv_free_bytes": (1 << 20) - 4096 * len(self._reqs),
                    "kv_free_blocks": 256 - len(self._reqs),
                    "handoff": {"pending": len(self._handoffs),
                                "gathered": self.handoffs_gathered, "gathered_bytes": 0,
                                "spliced": self.handoffs_spliced, "spliced_bytes": 0}}

    def stats(self) -> dict:
        return {"stub": True, **self.snapshot()}

    def set_prefix(self, prompt, pixels=None) -> int:
        return 0

    def shutdown(self) -> None:
        self.alive = False


def _stub_main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--stub_worker", action="store_true")
    p.add_argument("--worker_ready_file", required=True)
    p.add_argument("--worker_slot", type=int, default=0)
    p.add_argument("--heartbeat_dir", default=None)
    p.add_argument("--token_delay_s", type=float, default=0.005)
    p.add_argument("--role", default="colocated", choices=("colocated", "prefill", "decode"))
    args = p.parse_args(argv)
    engine = _StubEngine(token_delay_s=args.token_delay_s, role=args.role)
    if args.heartbeat_dir:
        from eventgpt_tpu_torch.train.resilience import Heartbeat

        hb = Heartbeat(args.heartbeat_dir)

        def _beat():
            n = 0
            while True:
                try:
                    hb.beat(n, status="ok")
                except OSError:
                    pass
                n += 1
                time.sleep(0.2)

        threading.Thread(target=_beat, daemon=True).start()
    return serve_worker(engine, args.worker_ready_file)


def stub_worker_cmd(token_delay_s: float = 0.005) -> List[str]:
    """The stub worker's command (coordinator tests)."""
    return [sys.executable, "-m", "eventgpt_tpu_torch.fleet_proc", "--stub_worker",
            "--token_delay_s", str(token_delay_s)]


# -- coordinator -----------------------------------------------------------

@dataclass
class _ProcRequest:
    """One request the coordinator owns to its end. ``worker``/``rid`` are
    the current assignment; ``t_assign`` is its coordinator-clock stamp
    (worker clocks do not compare across processes). ``handoff_s`` is the
    coordinator-measured collect-to-import wall of its handoffs, reset on a
    redo, which restarts the chain."""
    frid: int
    input_ids: List[int]
    pixel_values: Any
    max_new_tokens: int
    deadline: Optional[float]  # absolute coordinator perf_counter, or None
    slo: Any
    key: tuple
    worker: int
    rid: int
    t_assign: float
    failovers: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    tokens: Optional[List[int]] = None
    status: str = "ok"
    stats: Dict[str, float] = field(default_factory=dict)
    handoff_s: float = 0.0


@dataclass
class WorkerSlot:
    """One supervised worker-process slot. Only ``ok`` slots take work.
    Written by the supervisor thread, and by the operator's kill and drain
    (idempotent transitions)."""
    idx: int
    proc: Optional[subprocess.Popen] = None
    addr: Optional[Tuple[str, int]] = None
    role: str = "colocated"  # colocated | prefill | decode, fixed at construction
    state: str = "starting"  # starting | ok | suspect | draining | dead | failed
    generation: int = 0  # spawn attempts (the ready file's key)
    t_spawn: float = 0.0  # monotonic
    t_ready: float = 0.0  # monotonic
    t_respawn: float = 0.0  # monotonic: a respawn is allowed after this
    crashes: List[float] = field(default_factory=list)  # monotonic stamps
    consec_crashes: int = 0
    kills: int = 0  # operator and chaos kills, and drains
    inflight: int = 0  # the coordinator's count of assigned requests
    snapshot: Dict[str, Any] = field(default_factory=dict)
    ready_file: str = ""
    hb_dir: Optional[str] = None
    log_path: str = ""

    @property
    def routable(self) -> bool:
        return self.state == "ok"


class _ProcRequestStats:
    """``.get(frid)`` over finished requests: the shape ``make_handler``
    reads from ``engine.batcher.request_stats``."""

    def __init__(self, fleet: "ProcFleet"):
        self._fleet = fleet

    def get(self, frid: int, default=None):
        freq = self._fleet._requests.get(frid)
        if freq is None or not freq.done.is_set():
            return default if default is not None else {}
        return freq.stats


class _ProcBatcherView:
    """The ``engine.batcher`` surface the HTTP handler reads, from the
    workers' last probe snapshots (no RPC)."""

    def __init__(self, fleet: "ProcFleet"):
        self._fleet = fleet
        self.request_stats = _ProcRequestStats(fleet)

    def prefix_cache_stats(self) -> Dict[str, Any]:
        per = []
        hits = misses = 0
        for slot in self._fleet.slots:
            st = dict(slot.snapshot.get("prefix_cache", {}))
            per.append({"worker": slot.idx, **st})
            hits += st.get("hits", 0)
            misses += st.get("misses", 0)
        return {"enabled": any(p.get("enabled") for p in per), "hits": hits, "misses": misses,
                "hit_ratio": hits / (hits + misses) if (hits + misses) else 0.0,
                "workers": per}

    def slo_stats(self) -> Dict[str, Any]:
        return self._fleet.slo_stats()


class ProcFleet:
    """Coordinator over N worker processes with the client surface of a
    ``ServingEngine`` (submit, result, status, cancel, stats, breaker_open,
    set_prefix). The routing table and the request map's writes move under
    ``_lock``; ``result`` waits without it. Submits make their RPC under
    the lock (workers never call back, so the order cannot invert);
    collection and probes make theirs outside it."""

    def __init__(self, worker_cmd: Sequence[str], n_workers: int, tokenizer=None,
                 conv_mode: str = "eventgpt_v1", workdir: Optional[str] = None,
                 heartbeat_dir: Optional[str] = None, probe_interval_s: float = 0.05,
                 heartbeat_stale_s: float = 5.0, rpc_deadline_s: float = 15.0,
                 rpc_retries: int = 3, drain_deadline_s: float = 30.0,
                 spawn_timeout_s: float = 120.0, respawn_backoff_s: float = 0.25,
                 respawn_backoff_max_s: float = 10.0, crash_window_s: float = 60.0,
                 crash_limit: int = 3, max_failovers: int = 3, shutdown_drain_s: float = 30.0,
                 roles: Optional[str] = None, handoff_retries: int = 3):
        if n_workers < 1:
            raise ValueError("a process fleet needs at least one worker")
        # "P:D": the first P slots prefill, the rest decode; None keeps every
        # slot colocated.
        self.roles: Optional[Tuple[int, int]] = None
        if roles:
            p_str, sep, d_str = str(roles).partition(":")
            try:
                if not sep:
                    raise ValueError(roles)
                n_p, n_d = int(p_str), int(d_str)
            except ValueError:
                raise ValueError(f"bad proc_fleet_roles {roles!r} (want P:D, e.g. 1:1)")
            if n_p < 1 or n_d < 1:
                raise ValueError(f"proc_fleet_roles {roles!r}: a disaggregated fleet needs at "
                                 f"least one prefill AND one decode worker")
            if n_p + n_d != n_workers:
                raise ValueError(f"proc_fleet_roles {roles!r}: {n_p}+{n_d} workers != fleet "
                                 f"size {n_workers}")
            self.roles = (n_p, n_d)
        self.handoff_retries = int(handoff_retries)
        self.worker_cmd = list(worker_cmd)
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.probe_interval_s = float(probe_interval_s)
        self.heartbeat_stale_s = float(heartbeat_stale_s)
        self.rpc_deadline_s = float(rpc_deadline_s)
        self.rpc_retries = int(rpc_retries)
        self.drain_deadline_s = float(drain_deadline_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.respawn_backoff_s = float(respawn_backoff_s)
        self.respawn_backoff_max_s = float(respawn_backoff_max_s)
        self.crash_window_s = float(crash_window_s)
        self.crash_limit = int(crash_limit)
        self.max_failovers = int(max_failovers)
        self.shutdown_drain_s = float(shutdown_drain_s)
        if workdir is None:
            import tempfile

            self._tmpdir = tempfile.TemporaryDirectory(prefix="egpt_procfleet_")
            workdir = self._tmpdir.name
        else:
            self._tmpdir = None
            os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.heartbeat_root = heartbeat_dir
        self._lock = threading.Lock()
        self._requests: Dict[int, _ProcRequest] = {}
        self._pins: Dict[tuple, int] = {}
        self._next_frid = 0
        self._stop = False
        self.t_start = time.time()
        self.n_requests = 0
        self.n_failovers = 0
        self.n_deaths = 0
        self.n_respawns = 0
        self.n_kills = 0
        self.n_crash_looped = 0
        self.n_handoffs = 0
        self.n_handoff_bytes = 0
        self.n_handoff_retries = 0
        self.n_handoff_redos = 0
        # One collect -> ship -> ack pass at a time: the supervisor's pump
        # and a drain's flush must not ship one replayed record together.
        self._pump_lock = threading.Lock()
        self.fault: Any = None
        self.slots = [self._make_slot(i) for i in range(n_workers)]
        for slot in self.slots:
            self._spawn(slot)
        self._wait_boot()
        self._thread = threading.Thread(target=self._supervise, daemon=True)
        self._thread.start()

    # -- spawning ---------------------------------------------------------

    def _make_slot(self, idx: int) -> WorkerSlot:
        hb = os.path.join(self.heartbeat_root, f"replica{idx}") if self.heartbeat_root else None
        role = "colocated"
        if self.roles is not None:
            role = "prefill" if idx < self.roles[0] else "decode"
        return WorkerSlot(idx=idx, hb_dir=hb, role=role,
                          log_path=os.path.join(self.workdir, f"worker{idx}.log"))

    def _spawn(self, slot: WorkerSlot) -> bool:
        """Launch one worker into ``slot`` (state ``starting``; the
        supervisor polls its readiness). A ``procfleet.spawn`` trip fails
        this attempt and is booked as a crash, as a failed exec is."""
        slot.generation += 1
        slot.ready_file = os.path.join(self.workdir, f"worker{slot.idx}.g{slot.generation}.ready")
        cmd = self.worker_cmd + ["--worker_ready_file", slot.ready_file,
                                 "--worker_slot", str(slot.idx)]
        if slot.role != "colocated":
            cmd += ["--role", slot.role]
        if slot.hb_dir:
            cmd += ["--heartbeat_dir", slot.hb_dir]
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, PYTHONPATH=_ROOT + (os.pathsep + path if path else ""))
        try:
            faults.maybe_fail("procfleet.spawn")
            faults.maybe_delay("procfleet.spawn")
            log = open(slot.log_path, "ab")
            try:
                slot.proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                             cwd=os.getcwd(), env=env)
            finally:
                log.close()
        except (faults.InjectedFault, OSError) as e:
            slot.proc = None
            self._book_crash(slot, f"spawn failed: {e!r}")
            return False
        slot.state = "starting"
        slot.t_spawn = time.monotonic()
        slot.addr = None
        return True

    def _wait_boot(self) -> None:
        """Block until every slot left ``starting`` (ready, crashed or timed
        out); at least one must be routable."""
        deadline = time.monotonic() + self.spawn_timeout_s
        while time.monotonic() < deadline:
            for slot in self.slots:
                if slot.state == "starting":
                    self._check_ready(slot)
                elif slot.state == "dead" and time.monotonic() >= slot.t_respawn:
                    self._maybe_respawn(slot)
            if all(s.state in ("ok", "failed") for s in self.slots):
                break
            time.sleep(0.02)
        if not any(s.routable for s in self.slots):
            states = {s.idx: s.state for s in self.slots}
            self.shutdown()
            raise RuntimeError(f"no worker became routable within {self.spawn_timeout_s}s "
                               f"(states: {states}; logs under {self.workdir}): {self.fault}")

    def _check_ready(self, slot: WorkerSlot) -> None:
        """Advance a ``starting`` slot: ready file, address, ping, ``ok``; a
        dead process or an expired spawn deadline books a crash."""
        if slot.proc is not None and slot.proc.poll() is not None:
            self._book_crash(slot, f"worker {slot.idx} exited rc={slot.proc.returncode} "
                                   f"during startup (log: {slot.log_path})")
            return
        if os.path.exists(slot.ready_file):
            try:
                with open(slot.ready_file) as f:
                    info = json.load(f)
                slot.addr = ("127.0.0.1", int(info["port"]))
                self._rpc(slot, "ping", deadline_s=5.0)
            except (OSError, ValueError, KeyError, rpc.RpcError):
                return  # not answering yet: keep polling
            slot.state = "ok"
            slot.t_ready = time.monotonic()
            slot.consec_crashes = 0
            return
        if time.monotonic() - slot.t_spawn > self.spawn_timeout_s:
            self._kill_proc(slot)
            self._book_crash(slot, f"worker {slot.idx} never became ready within "
                                   f"{self.spawn_timeout_s}s")

    def _book_crash(self, slot: WorkerSlot, why: str) -> None:
        """Book a crash, and trip the slot's crash-loop breaker at
        ``crash_limit`` crashes inside the window: the slot is given up and
        the fleet serves on with the others."""
        now = time.monotonic()
        slot.proc = None
        slot.addr = None
        slot.crashes.append(now)
        slot.crashes = [t for t in slot.crashes if now - t <= self.crash_window_s]
        slot.consec_crashes += 1
        with self._lock:
            self.fault = why
        if len(slot.crashes) >= self.crash_limit:
            slot.state = "failed"
            with self._lock:
                self.n_crash_looped += 1
        else:
            slot.state = "dead"
            backoff = min(self.respawn_backoff_s * (2.0 ** max(slot.consec_crashes - 1, 0)),
                          self.respawn_backoff_max_s)
            slot.t_respawn = now + backoff

    def _maybe_respawn(self, slot: WorkerSlot) -> None:
        if slot.state != "dead" or time.monotonic() < slot.t_respawn:
            return
        if self._spawn(slot):
            with self._lock:
                self.n_respawns += 1

    def _kill_proc(self, slot: WorkerSlot) -> None:
        if slot.proc is None:
            return
        try:
            slot.proc.kill()
            slot.proc.wait(timeout=5)
        except (OSError, subprocess.TimeoutExpired):
            pass

    # -- rpc --------------------------------------------------------------

    def _rpc(self, slot: WorkerSlot, op: str, payload: Optional[dict] = None, *,
             deadline_s: Optional[float] = None, retry_sent: bool = True) -> Any:
        if slot.addr is None:
            raise rpc.RpcError(f"worker {slot.idx} has no address (state {slot.state})")
        return rpc.call(slot.addr, op, payload,
                        deadline_s=self.rpc_deadline_s if deadline_s is None else deadline_s,
                        retries=self.rpc_retries, retry_sent=retry_sent)

    # -- client surface ---------------------------------------------------

    @property
    def batcher(self) -> _ProcBatcherView:
        return _ProcBatcherView(self)

    @property
    def n_faults(self) -> int:
        return sum(s.snapshot.get("n_faults", 0) for s in self.slots)

    @property
    def n_restarts(self) -> int:
        return sum(s.snapshot.get("n_restarts", 0) for s in self.slots)

    def breaker_open(self) -> bool:
        """The fleet refuses work only when no worker is routable; a
        disaggregated one when either role has none."""
        if self.roles is not None:
            return not (any(s.routable and s.role == "prefill" for s in self.slots)
                        and any(s.routable and s.role == "decode" for s in self.slots))
        return not any(s.routable for s in self.slots)

    def goodput_ratio(self) -> float:
        met = 0.0
        n = 0
        for slot in self.slots:
            st = slot.snapshot.get("slo", {})
            w = st.get("window_n", 0)
            met += st.get("goodput_ratio", 0.0) * w
            n += w
        return met / n if n else 1.0

    def queue_depth(self) -> int:
        return sum(s.snapshot.get("queued", 0) for s in self.slots)

    def submit(self, query: str, pixels, max_new_tokens: int,
               deadline_s: Optional[float] = None, slo=None) -> int:
        from eventgpt_tpu_torch.data.conversation import prepare_event_prompt
        from eventgpt_tpu_torch.data.tokenizer import tokenize_with_event

        ids = tokenize_with_event(prepare_event_prompt(query, self.conv_mode), self.tokenizer)
        return self.submit_ids(ids, pixels, max_new_tokens, deadline_s=deadline_s, slo=slo)

    def submit_ids(self, input_ids: Sequence[int], pixels, max_new_tokens: int,
                   deadline_s: Optional[float] = None, slo=None) -> int:
        """Route one request (affinity, else the least in flight) and submit
        it over RPC. A submit is never retried once its bytes left: an
        unreachable worker is marked suspect and the next candidate tried,
        so transport trouble costs locality, not service."""
        key = affinity_key(input_ids, pixels)
        with self._lock:
            tried: set = set()
            while True:
                slot, _ = self._route_locked(key, exclude=tried)
                try:
                    rid = self._rpc(slot, "submit_ids",
                                    {"input_ids": list(input_ids), "pixel_values": pixels,
                                     "max_new_tokens": int(max_new_tokens),
                                     "deadline_s": deadline_s, "slo": slo},
                                    retry_sent=False)
                    break
                except rpc.RpcRemoteError as e:
                    raise _map_remote(e) from e
                except rpc.RpcError as e:
                    tried.add(slot.idx)
                    slot.state = "suspect"
                    if not any(s.routable for s in self.slots):
                        raise RuntimeError(f"no routable worker accepted the submit: "
                                           f"{e!r}") from e
            t = time.perf_counter()
            frid = self._next_frid
            self._next_frid += 1
            self._requests[frid] = _ProcRequest(
                frid=frid, input_ids=list(input_ids), pixel_values=pixels,
                max_new_tokens=int(max_new_tokens),
                deadline=t + deadline_s if deadline_s is not None else None, slo=slo, key=key,
                worker=slot.idx, rid=rid, t_assign=t)
            self._pins[key] = slot.idx
            self.n_requests += 1
            slot.inflight += 1
        return frid

    def result(self, frid: int, timeout: float = 600.0) -> List[int]:
        freq = self._requests[frid]
        if not freq.done.wait(timeout):
            raise TimeoutError(f"procfleet request {frid} did not finish in {timeout}s")
        if freq.tokens is None:
            raise RuntimeError(f"procfleet request {frid} failed after {freq.failovers} "
                               f"failover(s): {freq.status} ({self.fault})")
        return freq.tokens

    def status(self, frid: int) -> str:
        freq = self._requests.get(frid)
        return freq.status if freq is not None else "ok"

    def worker_of(self, frid: int) -> int:
        return self._requests[frid].worker

    def cancel(self, frid: int) -> bool:
        with self._lock:
            freq = self._requests.get(frid)
            if freq is None or freq.done.is_set():
                return False
            slot = self.slots[freq.worker]
        try:
            return bool(self._rpc(slot, "cancel", {"rid": freq.rid}, deadline_s=5.0))
        except rpc.RpcError:
            return False

    def stream_queue(self, frid: int):
        raise NotImplementedError("streaming responses are not ported to eventgpt_tpu_torch yet")

    def set_prefix(self, prefix_prompt: str, pixels=None) -> int:
        """An operator's prefix insert, on every routable worker."""
        plen = 0
        for slot in self.slots:
            if not slot.routable:
                continue
            try:
                plen = int(self._rpc(slot, "set_prefix",
                                     {"prefix_prompt": prefix_prompt, "pixel_values": pixels}))
            except rpc.RpcError:
                continue
        return plen

    def slo_stats(self) -> Dict[str, Any]:
        classes: Dict[str, Dict[str, Any]] = {}
        for slot in self.slots:
            for name, c in slot.snapshot.get("slo", {}).get("classes", {}).items():
                agg = classes.setdefault(name, {"finished": 0, "met": 0})
                agg["finished"] += c["finished"]
                agg["met"] += c["met"]
        for c in classes.values():
            c["attainment"] = c["met"] / c["finished"] if c["finished"] else 0.0
        return {"classes": classes, "goodput_ratio": self.goodput_ratio()}

    def stats(self) -> Dict[str, Any]:
        per = []
        for slot in self.slots:
            s = slot.snapshot
            per.append({
                "worker": slot.idx, "state": slot.state, "role": slot.role,
                "pid": slot.proc.pid if slot.proc else None,
                "active_rows": s.get("active_rows", 0), "queued": s.get("queued", 0),
                "inflight": slot.inflight,
                # Pool headroom (the decode-placement signal) and the
                # worker's handoff counters, from the last probe.
                "kv_free_blocks": s.get("kv_free_blocks"), "kv_free_bytes": s.get("kv_free_bytes"),
                "handoff": s.get("handoff") or {},
                "faults": s.get("n_faults", 0), "restarts": s.get("n_restarts", 0),
                "crashes": len(slot.crashes), "kills": slot.kills,
                "goodput_ratio": s.get("slo", {}).get("goodput_ratio", 0.0),
                "prefix_cache_hit_ratio": s.get("prefix_cache", {}).get("hit_ratio", 0.0),
            })
        with self._lock:
            n_pins = len(self._pins)
        return {
            "uptime_s": round(time.time() - self.t_start, 1),
            "requests": self.n_requests,
            "status": "degraded" if self.breaker_open() else "ok",
            "active_rows": sum(p["active_rows"] for p in per),
            "queued": sum(p["queued"] for p in per),
            "fleet": {
                "proc_fleet": True, "workers": len(self.slots),
                "routable": sum(s.routable for s in self.slots), "pins": n_pins,
                "goodput_ratio": round(self.goodput_ratio(), 4),
                "failovers": self.n_failovers, "deaths": self.n_deaths,
                "respawns": self.n_respawns, "kills": self.n_kills,
                "crash_looped": self.n_crash_looped,
                "roles": f"{self.roles[0]}:{self.roles[1]}" if self.roles is not None else None,
                "handoffs": {
                    "shipped": self.n_handoffs, "bytes": self.n_handoff_bytes,
                    "retries": self.n_handoff_retries, "redos": self.n_handoff_redos,
                    "gathered": sum(p["handoff"].get("gathered", 0) for p in per),
                    "spliced": sum(p["handoff"].get("spliced", 0) for p in per),
                    "pending": sum(p["handoff"].get("pending", 0) for p in per),
                },
                "per_worker": per,
            },
        }

    def fleet_stats(self) -> Dict[str, Any]:
        """The ``GET /fleet`` body: topology, policy and live state."""
        return {**self.stats()["fleet"], "policy": {
            "probe_interval_s": self.probe_interval_s,
            "heartbeat_stale_s": self.heartbeat_stale_s,
            "rpc_deadline_s": self.rpc_deadline_s, "rpc_retries": self.rpc_retries,
            "respawn_backoff_s": self.respawn_backoff_s,
            "respawn_backoff_max_s": self.respawn_backoff_max_s,
            "crash_window_s": self.crash_window_s, "crash_limit": self.crash_limit,
            "max_failovers": self.max_failovers, "handoff_retries": self.handoff_retries,
        }}

    def worker_stats(self, idx: int) -> Dict[str, Any]:
        """One worker's ``stats`` op: its engine's counters, its kernel
        launches and, on the card, its device memory."""
        return self._rpc(self.slots[idx], "stats", deadline_s=10.0)

    def journey(self, frid: int):
        raise NotImplementedError(f"process-fleet journeys: {_TELEMETRY}")

    def journeys(self, n: int = 64):
        raise NotImplementedError(f"process-fleet journeys: {_TELEMETRY}")

    def series(self, window_s: Optional[float] = None, n: Optional[int] = None):
        raise NotImplementedError(f"process-fleet series: {_TELEMETRY}")

    def alerts(self):
        raise NotImplementedError(f"process-fleet alerts: {_TELEMETRY}")

    def memory_stats(self):
        raise NotImplementedError(f"the workers' memory ledgers: {_TELEMETRY}")

    def reset_stats(self, clear_prefix_cache: bool = False) -> None:
        """Zero the coordinator's counters and each routable worker's
        serving stats and kernel launch counts."""
        with self._lock:
            self.n_failovers = 0
            self.n_deaths = 0
            self.n_respawns = 0
            self.n_kills = 0
            self.n_handoffs = 0
            self.n_handoff_bytes = 0
            self.n_handoff_retries = 0
            self.n_handoff_redos = 0
        for slot in self.slots:
            if not slot.routable:
                continue
            try:
                self._rpc(slot, "reset_stats", {"clear_prefix_cache": clear_prefix_cache},
                          deadline_s=10.0)
            except rpc.RpcError:
                continue

    # -- routing ----------------------------------------------------------

    def _route_locked(self, key: tuple, exclude=()) -> tuple:
        """(slot, reason): the key's pinned worker while routable, else the
        least coordinator-tracked in flight (snapshots lag a probe tick).
        A disaggregated fleet routes new requests to its prefill pool,
        where the prefix caches serve prompt heads."""
        pool = [s for s in self.slots
                if s.routable and s.idx not in exclude
                and (self.roles is None or s.role == "prefill")]
        if not pool:
            raise RuntimeError(f"no routable{' prefill' if self.roles else ''} worker "
                               f"({len(self.slots)} slot(s)): {self.fault}")
        pinned = self._pins.get(key)
        if (pinned is not None and pinned not in exclude and self.slots[pinned].routable
                and (self.roles is None or self.slots[pinned].role == "prefill")):
            return self.slots[pinned], "affinity"
        return min(pool, key=lambda s: (s.inflight, s.idx)), "least_queue"

    def _route_decode_locked(self, exclude=()) -> Optional[WorkerSlot]:
        """The decode worker with the most free pool bytes at its last probe
        (the splice allocates the request's whole reservation; in-flight
        counts break ties), or None when no decode worker is routable (the
        caller keeps the record replayable)."""
        pool = [s for s in self.slots
                if s.routable and s.role == "decode" and s.idx not in exclude]
        if not pool:
            return None

        def headroom(s: WorkerSlot):
            snap = s.snapshot or {}
            return snap.get("kv_free_bytes") or snap.get("kv_free_blocks") or 0

        return min(pool, key=lambda s: (-headroom(s), s.inflight, s.idx))

    # -- supervision ------------------------------------------------------

    def kill_worker(self, idx: int) -> None:
        """SIGKILL a worker now (the operator's and the chaos kill). The
        supervisor's next pass sees the exit and runs the redo failover."""
        slot = self.slots[idx]
        if slot.proc is None:
            return
        slot.kills += 1
        with self._lock:
            self.n_kills += 1
        try:
            slot.proc.kill()
        except OSError:
            pass

    def drain_worker(self, idx: int) -> int:
        """Graceful drain: export the worker's unfinished requests over RPC
        and re-route them (committed tokens dropped: the same chains),
        collect what it finished, then shut it down. Returns the number of
        re-routed requests. The slot respawns after the backoff (a drain is
        a kill, not a crash)."""
        slot = self.slots[idx]
        if slot.state in ("dead", "failed") or slot.addr is None:
            return 0
        slot.state = "draining"
        slot.kills += 1
        with self._lock:
            self.n_kills += 1
        if slot.role == "prefill":
            # Gathered records are neither queued nor in flight on the
            # worker any more: ship them before the export misses them.
            self._pump_slot_handoffs(slot)
        try:
            exported = self._rpc(slot, "export_requests", deadline_s=self.drain_deadline_s)
        except rpc.RpcError:
            self._kill_proc(slot)
            self._on_worker_lost(slot, f"worker {idx} unreachable during drain", graceful=False)
            return 0
        if slot.role == "prefill":
            # Once more after the export parked the scheduler (a row
            # gathered between the first flush and the park); what still
            # cannot ship (no decode worker routable) dies with the
            # process, so its owners redo from the coordinator's record.
            self._pump_slot_handoffs(slot)
            try:
                left = self._rpc(slot, "collect_handoffs", deadline_s=10.0)
            except rpc.RpcError:
                left = []
            with self._lock:
                for out in left or []:
                    freq = next((f for f in self._requests.values()
                                 if f.worker == slot.idx and f.rid == int(out["rid"])
                                 and not f.done.is_set()), None)
                    if freq is None:
                        continue
                    remaining = (freq.deadline - time.perf_counter()
                                 if freq.deadline is not None else None)
                    self._failover_locked(freq, remaining, "redo")
        moved = self._on_worker_lost(slot, f"worker {idx} drained", graceful=True,
                                     exported=exported or [])
        # Collect finished answers while the parked worker answers, then
        # take the process down.
        self._collect()
        try:
            self._rpc(slot, "shutdown", deadline_s=5.0)
        except rpc.RpcError:
            pass
        if slot.proc is not None:
            try:
                slot.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._kill_proc(slot)
        now = time.monotonic()
        slot.proc = None
        slot.addr = None
        slot.state = "dead"
        slot.t_respawn = now + self.respawn_backoff_s
        return moved

    def _on_worker_lost(self, slot: WorkerSlot, why: str, graceful: bool,
                        exported=None) -> int:
        """Fail over a lost worker's live requests: exported records with
        their remaining deadline (path ``drain``), or the coordinator's own
        records (path ``redo``). Returns the number moved."""
        path = "drain" if graceful else "redo"
        with self._lock:
            self.n_deaths += 1
            self.fault = why
        by_rid = {rec["rid"]: rec for rec in (exported or [])}
        moved = 0
        with self._lock:
            victims = [f for f in self._requests.values()
                       if f.worker == slot.idx and not f.done.is_set()]
            for freq in victims:
                if graceful and freq.rid not in by_rid:
                    # Finished at the worker, not collected yet: the drain's
                    # collect pass delivers it.
                    continue
                rec = by_rid.get(freq.rid)
                deadline_s = (rec.get("deadline_s") if rec is not None
                              else (freq.deadline - time.perf_counter()
                                    if freq.deadline is not None else None))
                if self._failover_locked(freq, deadline_s, path):
                    moved += 1
        return moved

    def _failover_locked(self, freq: _ProcRequest, deadline_s: Optional[float], path: str,
                         avoid_current: bool = True) -> bool:
        """Re-route one request to a surviving worker (the caller holds the
        lock); its pin moves with it. True when it found a home. A
        disaggregated fleet redoes on its prefill side wherever the request
        died: a lost decode worker took the spliced KV with it.
        ``avoid_current=False`` keeps the current worker a candidate: a
        failed ship redoes from a healthy prefill worker."""
        freq.failovers += 1
        if freq.failovers > self.max_failovers:
            self._finish_locked(freq, None, "engine_fault")
            return False
        tried = {freq.worker} if avoid_current else set()
        while True:
            pool = [s for s in self.slots
                    if s.routable and s.idx not in tried
                    and (self.roles is None or s.role == "prefill")]
            if not pool:
                self._finish_locked(freq, None, "engine_fault")
                return False
            slot = min(pool, key=lambda s: (s.inflight, s.idx))
            try:
                rid = self._rpc(slot, "submit_ids",
                                {"input_ids": freq.input_ids, "pixel_values": freq.pixel_values,
                                 "max_new_tokens": freq.max_new_tokens,
                                 "deadline_s": deadline_s, "slo": freq.slo},
                                retry_sent=False)
                break
            except (rpc.RpcError, rpc.RpcRemoteError) as e:
                tried.add(slot.idx)
                if isinstance(e, rpc.RpcError):
                    slot.state = "suspect"
                self.fault = repr(e)
        old = freq.worker
        self.slots[old].inflight = max(self.slots[old].inflight - 1, 0)
        freq.worker = slot.idx
        freq.rid = rid
        freq.t_assign = time.perf_counter()
        freq.handoff_s = 0.0  # the abandoned chain's handoffs are redo time
        slot.inflight += 1
        self._pins[freq.key] = slot.idx
        self.n_failovers += 1
        return True

    def _finish_locked(self, freq: _ProcRequest, tokens, status: str) -> None:
        freq.tokens = tokens
        freq.status = status
        if 0 <= freq.worker < len(self.slots):
            s = self.slots[freq.worker]
            s.inflight = max(s.inflight - 1, 0)
        freq.done.set()
        while len(self._requests) >= 8192:
            oldest = next(iter(self._requests))
            if not self._requests[oldest].done.is_set():
                break  # never evict a live request
            self._requests.pop(oldest)

    def _supervise(self) -> None:
        """The supervisor loop (it must never die): readiness, liveness,
        the scripted chaos kill, respawns, handoffs and collection."""
        while not self._stop:
            try:
                for slot in self.slots:
                    self._probe(slot)
                try:
                    faults.maybe_fail("procfleet.worker_kill")
                except faults.InjectedFault:
                    # The trip is the SIGKILL of the busiest routable worker
                    # (the worst case: its decodes must be redone).
                    pool = [s for s in self.slots if s.routable]
                    if pool:
                        self.kill_worker(max(pool, key=lambda s: (s.inflight, -s.idx)).idx)
                self._pump_handoffs()
                self._collect()
            except Exception as e:  # supervision must survive
                with self._lock:
                    self.fault = repr(e)
            time.sleep(self.probe_interval_s)

    def _probe(self, slot: WorkerSlot) -> None:
        if slot.state == "failed":
            return
        if slot.state == "starting":
            self._check_ready(slot)
            return
        if slot.state == "dead":
            self._maybe_respawn(slot)
            return
        if slot.state == "draining":
            # drain_worker owns this slot; the exit its shutdown op asks for
            # is not a crash (the JAX probe books one when it sees the exit
            # first: ROADMAP Queue 3).
            return
        # ok or suspect: the process must still exist.
        if slot.proc is not None and slot.proc.poll() is not None:
            rc = slot.proc.returncode
            slot.proc = None
            slot.addr = None
            prev = slot.state
            self._book_crash(slot, f"worker {slot.idx} exited rc={rc} (state was {prev})")
            self._on_worker_lost(slot, f"worker {slot.idx} died (rc={rc})", graceful=False)
            return
        # A stale heartbeat (process alive, loop wedged): drain while the
        # RPC server still answers.
        if slot.hb_dir is not None:
            from eventgpt_tpu_torch.train.resilience import Heartbeat

            hb_path = os.path.join(slot.hb_dir, Heartbeat.FILENAME)
            if os.path.exists(hb_path) and Heartbeat.is_stale(hb_path, self.heartbeat_stale_s):
                self.drain_worker(slot.idx)
                return
        # Probe the lock-free snapshot op: a worker busy in a long step is
        # slow, not dead.
        try:
            slot.snapshot = self._rpc(slot, "snapshot", deadline_s=5.0) or {}
            if slot.state == "suspect":
                slot.state = "ok"
        except rpc.RpcError:
            if slot.state == "suspect":
                # Second strike: drain it (a failed drain escalates to redo).
                self.drain_worker(slot.idx)
            else:
                slot.state = "suspect"

    def _collect(self) -> None:
        """Harvest finished requests, one ``try_results`` per worker holding
        live assignments; an ``engine_fault`` request fails over (redo)."""
        with self._lock:
            live = [f for f in self._requests.values() if not f.done.is_set()]
        by_slot: Dict[int, List[_ProcRequest]] = {}
        for freq in live:
            by_slot.setdefault(freq.worker, []).append(freq)
        for idx, freqs in by_slot.items():
            slot = self.slots[idx]
            if slot.addr is None:
                continue
            try:
                got = self._rpc(slot, "try_results", {"rids": [f.rid for f in freqs]},
                                deadline_s=self.rpc_deadline_s)
            except rpc.RpcError:
                continue  # the probe handles the slot's health
            for freq in freqs:
                rec = (got or {}).get(str(freq.rid))
                if rec is None:
                    continue
                with self._lock:
                    if freq.done.is_set() or freq.worker != idx:
                        continue  # failed over meanwhile
                    if rec["status"] == "engine_fault":
                        remaining = (freq.deadline - time.perf_counter()
                                     if freq.deadline is not None else None)
                        self._failover_locked(freq, remaining, "redo")
                        continue
                    freq.stats = dict(rec.get("stats") or {})
                    self._finish_locked(freq, rec["tokens"], rec["status"])

    # -- the prefill/decode handoff pump ----------------------------------

    def _pump_handoffs(self) -> None:
        """Move gathered block runs from prefill outboxes to decode arenas
        (each supervisor tick). At least once end to end: unacked records
        replay from the prefill worker, and the decode worker's ``hid``
        dedup absorbs the duplicates."""
        if self.roles is None:
            return
        for slot in self.slots:
            if slot.role != "prefill" or slot.addr is None:
                continue
            if slot.state not in ("ok", "draining"):
                continue
            self._pump_slot_handoffs(slot)

    def _pump_slot_handoffs(self, slot: WorkerSlot) -> None:
        """One collect -> ship* -> ack pass over ``slot``'s outbox."""
        with self._pump_lock:
            try:
                recs = self._rpc(slot, "collect_handoffs", deadline_s=self.rpc_deadline_s)
            except rpc.RpcError:
                return  # the probe handles the slot; the records replay
            acked: List[int] = []
            for out in recs or []:
                try:
                    if self._ship_handoff(slot, out):
                        acked.append(int(out["rid"]))
                except Exception as e:  # one bad record must not wedge the outbox
                    acked.append(int(out["rid"]))
                    with self._lock:
                        self.fault = f"handoff ship failed: {e!r}"
            if acked:
                try:
                    self._rpc(slot, "ack_handoffs", {"rids": acked}, deadline_s=10.0)
                except rpc.RpcError:
                    pass  # served again at the next collect; the dedup absorbs it

    def _ship_handoff(self, src: WorkerSlot, out: dict) -> bool:
        """Ship one gathered record to a decode worker. True when the record
        is settled at the source (shipped, stale, or fallen back to redo)
        and can be acked; False keeps it replayable (no decode worker is
        routable now). Each attempt probes ``procfleet.handoff``."""
        src_rid = int(out["rid"])
        with self._lock:
            freq = next((f for f in self._requests.values()
                         if f.worker == src.idx and f.rid == src_rid and not f.done.is_set()),
                        None)
        if freq is None:
            return True  # a stale replay: the request moved on
        # The spawn generation is part of the identity: a respawned worker's
        # rids restart at 0, and a bare slot:rid would dedup onto a stranger.
        hid = f"{src.idx}.{src.generation}:{src_rid}"
        rec = out.get("rec") or {}
        nbytes = int(rec.get("nbytes_kv", 0))
        t0 = time.perf_counter()
        tried: set = set()
        attempts = 0
        rid2 = None
        dslot = None
        while attempts < max(self.handoff_retries, 1):
            with self._lock:
                dslot = self._route_decode_locked(exclude=tried)
            if dslot is None:
                break
            attempts += 1
            try:
                faults.maybe_fail("procfleet.handoff")
                faults.maybe_delay("procfleet.handoff")
                rid2 = self._rpc(
                    dslot, "import_handoff",
                    {"hid": hid, "input_ids": out["input_ids"], "tokens": out.get("tokens") or [],
                     "max_new_tokens": out["max_new_tokens"],
                     "prompt_len": out.get("prompt_len", 0), "deadline_s": out.get("deadline_s"),
                     "slo": out.get("slo"), "elapsed_s": out.get("elapsed_s"),
                     "ttft_s": out.get("ttft_s"), "rec": rec},
                    retry_sent=False)
                break
            except (faults.InjectedFault, rpc.RpcError, rpc.RpcRemoteError) as e:
                rid2 = None
                tried.add(dslot.idx)
                with self._lock:
                    self.n_handoff_retries += 1
                    self.fault = f"handoff {hid} -> worker {dslot.idx}: {e!r}"
                if isinstance(e, rpc.RpcError):
                    dslot.state = "suspect"
        if rid2 is None:
            if attempts == 0:
                return False  # no decode worker up: keep it replayable
            # Retries spent: redo from the coordinator's record. No import
            # landed, so the shipped KV reached no arena.
            with self._lock:
                if freq.done.is_set() or freq.worker != src.idx:
                    return True
                self.n_handoff_redos += 1
                deadline_s = (freq.deadline - time.perf_counter()
                              if freq.deadline is not None else None)
                # The source is healthy (the failure was on the decode
                # side): it stays in the redo pool.
                self._failover_locked(freq, deadline_s, "redo", avoid_current=False)
            return True
        dt = time.perf_counter() - t0
        with self._lock:
            already = freq.worker == dslot.idx and freq.rid == rid2
            moved = freq.done.is_set() or freq.worker != src.idx
            if not moved:
                src.inflight = max(src.inflight - 1, 0)
                freq.worker = dslot.idx
                freq.rid = int(rid2)
                freq.handoff_s += dt
                dslot.inflight += 1
                self.n_handoffs += 1
                self.n_handoff_bytes += nbytes
        if moved and not already:
            # The request finished or failed over while it shipped: cancel
            # the orphan import (a missed cancel decodes into the replay
            # cache and ages out; it never double-delivers).
            try:
                self._rpc(dslot, "cancel", {"rid": int(rid2)}, deadline_s=5.0)
            except rpc.RpcError:
                pass
        return True

    # -- shutdown ---------------------------------------------------------

    def shutdown(self) -> None:
        """Drain, then stop: wait (bounded) for live requests, ask every
        worker to stop, then terminate or kill what is left. A worker still
        starting has no RPC address and is terminated at once."""
        if self._stop:
            return
        deadline = time.monotonic() + self.shutdown_drain_s
        while time.monotonic() < deadline:
            with self._lock:
                live = any(not f.done.is_set() for f in self._requests.values())
            if not live:
                break
            time.sleep(0.05)
        self._stop = True
        if getattr(self, "_thread", None) is not None:
            self._thread.join(timeout=10)
        for slot in self.slots:
            if slot.addr is not None:
                try:
                    self._rpc(slot, "shutdown", deadline_s=5.0)
                except rpc.RpcError:
                    pass
            elif slot.proc is not None:
                try:
                    slot.proc.terminate()
                except OSError:
                    pass
        for slot in self.slots:
            if slot.proc is None:
                continue
            try:
                slot.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    slot.proc.terminate()
                    slot.proc.wait(timeout=5)
                except (OSError, subprocess.TimeoutExpired):
                    self._kill_proc(slot)
            slot.proc = None
        if self._tmpdir is not None:
            try:
                self._tmpdir.cleanup()
            except OSError:
                pass


if __name__ == "__main__":
    sys.exit(_stub_main())
