"""Ring-buffered request/step tracing in Chrome trace-event format.

The port of ``eventgpt_tpu/obs/trace.py``. A span is one host-observed
interval (``perf_counter`` at enter/exit); the tracer keeps the newest
``capacity`` events in a ring, which ``GET /trace`` snapshots and
``--trace_out`` dumps at shutdown. Events load in Perfetto or
chrome://tracing:

  * ``X`` complete events -- scheduler phases (dispatch, harvest,
    admission);
  * ``b``/``e`` async events keyed by request id -- each request's
    lifecycle (``queued`` -> ``active`` -> end with a ``status`` arg);
  * ``i`` instants -- point happenings (deferrals, faults, alerts).

Disarmed (the default) every probe is one module-global ``is None``
check. Armed, a span is two ``perf_counter`` calls plus one list write
under a lock. Tracing reads clocks only, never a device tensor, so
chains are byte-identical armed or disarmed.

File format (``write()``): the Chrome JSON Array Format, one event per
line -- a ``[`` line, then ``{event},`` lines (the closing ``]`` is
optional in that format). ``load_trace()`` reads it back.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

_US = 1e6


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tr.complete(self._name, self._t0, t1, cat=self._cat,
                          args=self._args)
        return False


class Tracer:
    """Bounded ring of Chrome trace events. All mutation under one lock
    (scheduler + handler + trainer threads)."""

    def __init__(self, capacity: int = 65536):
        self.capacity = max(int(capacity), 1)
        self._buf: List[Optional[dict]] = [None] * self.capacity
        self._head = 0   # next write slot
        self._n = 0      # events ever added
        self._lock = threading.Lock()
        self._pid = os.getpid()

    # -- recording --------------------------------------------------------

    def _add(self, ev: dict) -> None:
        with self._lock:
            self._buf[self._head] = ev
            self._head = (self._head + 1) % self.capacity
            self._n += 1

    def complete(self, name: str, t0: float, t1: float, cat: str = "serve",
                 args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "X", "cat": cat,
              "ts": t0 * _US, "dur": max(t1 - t0, 0.0) * _US,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._add(ev)

    def instant(self, name: str, cat: str = "serve",
                args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "cat": cat,
              "ts": time.perf_counter() * _US,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._add(ev)

    def async_begin(self, name: str, id: int, cat: str = "request",
                    args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "b", "cat": cat, "id": int(id),
              "ts": time.perf_counter() * _US,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._add(ev)

    def async_end(self, name: str, id: int, cat: str = "request",
                  args: Optional[Dict[str, Any]] = None) -> None:
        ev = {"name": name, "ph": "e", "cat": cat, "id": int(id),
              "ts": time.perf_counter() * _US,
              "pid": self._pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._add(ev)

    # -- export -----------------------------------------------------------

    def events(self) -> List[dict]:
        """Snapshot of the ring, oldest first. Chrome trace viewers sort
        by ts anyway; the order here just keeps dumps readable."""
        with self._lock:
            if self._n < self.capacity:
                out = [e for e in self._buf[: self._head]]
            else:
                out = self._buf[self._head:] + self._buf[: self._head]
            return [dict(e) for e in out if e is not None]

    def dropped(self) -> int:
        """Events the ring has overwritten (0 until it wraps)."""
        with self._lock:
            return max(self._n - self.capacity, 0)

    def write(self, path: str) -> int:
        """Dump the ring as a Chrome JSON Array Format file, one event
        per line (the trailing ``]`` is optional per the spec, so the
        file is valid even if a later append crashes). Returns the
        number of events written."""
        evs = self.events()
        with open(path, "w") as f:
            f.write("[\n")
            for ev in evs:
                f.write(json.dumps(ev) + ",\n")
        return len(evs)


def load_trace(path: str) -> List[dict]:
    """Read a ``write()``/Chrome-array trace back into a list of events
    (tolerates the optional trailing ``]`` and per-line commas)."""
    with open(path) as f:
        text = f.read().strip()
    if text.startswith("["):
        text = text[1:]
    if text.endswith("]"):
        text = text[:-1]
    out = []
    for line in text.splitlines():
        line = line.strip().rstrip(",")
        if line:
            out.append(json.loads(line))
    return out


_tracer: Optional[Tracer] = None


def configure(capacity: int = 65536) -> Tracer:
    """Arm tracing with a ring of ``capacity`` events; returns the
    tracer. ``capacity <= 0`` disarms."""
    global _tracer
    if capacity <= 0:
        _tracer = None
        return None  # type: ignore[return-value]
    _tracer = Tracer(capacity)
    return _tracer


def disable() -> None:
    global _tracer
    _tracer = None


def active() -> Optional[Tracer]:
    return _tracer


def enabled() -> bool:
    return _tracer is not None


# -- armed-checked probe helpers (the call-site surface) -------------------
# Each is a single module-global load + None check when disarmed.

def span(name: str, cat: str = "serve", **args):
    t = _tracer
    if t is None:
        return _NULL
    return _Span(t, name, cat, args or None)


def instant(name: str, cat: str = "serve", **args) -> None:
    t = _tracer
    if t is not None:
        t.instant(name, cat=cat, args=args or None)


def async_begin(name: str, id: int, cat: str = "request", **args) -> None:
    t = _tracer
    if t is not None:
        t.async_begin(name, id, cat=cat, args=args or None)


def async_end(name: str, id: int, cat: str = "request", **args) -> None:
    t = _tracer
    if t is not None:
        t.async_end(name, id, cat=cat, args=args or None)
