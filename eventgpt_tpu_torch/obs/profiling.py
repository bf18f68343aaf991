"""``torch.profiler`` hooks: named ranges and an on-demand capture window.

The port of ``eventgpt_tpu/obs/profiling.py``, the armed-gated layer the
runtime wires through, so that unprofiled serving and training pay one
module-global check per step:

  * ``step_annotation(n)`` / ``annotation(name)`` -- a
    ``torch.profiler.record_function`` range when profiling is armed, else
    a null context. The trainer wraps each micro-step, the serving
    scheduler each segment dispatch, so that a capture shows host ranges
    beside the kernels they launched.
  * ``capture(seconds, logdir)`` -- the ``POST /profile {"seconds": N}``
    window: start a profiler, arm the ranges for the window, sleep, stop,
    and write a Chrome trace (``trace_<pid>_<n>.json``) into the
    directory. One capture at a time per process (``CaptureBusyError``).
  * ``start_trace``/``stop_trace`` -- the manual bracket of the trainer's
    ``--profile_dir`` step window.

A capture records CPU ranges and, on a card, every CUDA kernel (CUPTI
sees the whole process). The profiler is started with ``profile_all_threads``
where the installed PyTorch knows it, so that the ranges the scheduler
thread opens appear in a capture an HTTP handler thread started; without it
only the capturing thread's ranges are recorded. ``last_capture()`` says
which it was.

``torch`` is imported inside the functions, never at module import.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional


class CaptureBusyError(RuntimeError):
    """A profile capture is already running (the profiler is process-wide;
    the HTTP layer maps this to 409)."""


_lock = threading.Lock()
_profile_dir: Optional[str] = None   # configured destination (arms the ranges)
_armed_depth = 0                     # capture() arms the ranges for its window
_prof = None                         # the running torch.profiler.profile
_prof_dir: Optional[str] = None
_n_traces = 0
_last: Dict[str, Any] = {}


def configure(profile_dir: Optional[str]) -> None:
    """Set the default capture destination; a non-empty directory arms the
    ranges for good (the ``--profile_dir`` flags)."""
    global _profile_dir
    _profile_dir = profile_dir or None


def armed() -> bool:
    return _profile_dir is not None or _armed_depth > 0


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def step_annotation(step_num: int, name: str = "step"):
    """A ``record_function`` range named ``<name>#<step_num>`` when armed,
    else a null context."""
    if not armed():
        return _NULL
    import torch

    return torch.profiler.record_function(f"{name}#{int(step_num)}")


def annotation(name: str):
    """A ``record_function`` range when armed, else a null context."""
    if not armed():
        return _NULL
    import torch

    return torch.profiler.record_function(name)


def _new_profiler():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    all_threads = False
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
        all_threads = True
    except (ImportError, TypeError):
        pass
    return torch.profiler.profile(activities=acts, **kw), all_threads


def start_trace(logdir: Optional[str] = None) -> str:
    """Start the profiler (one at a time per process). Returns the
    directory its trace will be written to."""
    global _prof, _prof_dir
    with _lock:
        if _prof is not None:
            raise CaptureBusyError("a profile capture is already running")
        d = logdir or _profile_dir
        if not d:
            import tempfile

            d = tempfile.mkdtemp(prefix="egpt_profile_")
        os.makedirs(d, exist_ok=True)
        prof, all_threads = _new_profiler()
        prof.start()
        _prof, _prof_dir = prof, d
        _last.clear()
        _last.update({"profile_dir": d, "all_threads": all_threads})
        return d


def stop_trace() -> Optional[str]:
    """Stop the running profiler and write its Chrome trace; returns the
    file's path (None when nothing ran)."""
    global _prof, _prof_dir, _n_traces
    with _lock:
        if _prof is None:
            return None
        prof, d = _prof, _prof_dir
        _prof = _prof_dir = None
        prof.stop()
        _n_traces += 1
        path = os.path.join(d, f"trace_{os.getpid()}_{_n_traces}.json")
        prof.export_chrome_trace(path)
        _last["trace_file"] = path
        return path


def capture(seconds: float, logdir: Optional[str] = None) -> str:
    """Capture ``seconds`` of the running process (blocking the calling
    thread; the scheduler keeps serving: that is the traffic profiled),
    with the ranges armed for the window. Returns the trace directory;
    ``last_capture()`` names the file."""
    global _armed_depth
    d = start_trace(logdir)
    _armed_depth += 1
    try:
        time.sleep(max(float(seconds), 0.0))
    finally:
        _armed_depth -= 1
        stop_trace()
    return d


def last_capture() -> Dict[str, Any]:
    """The last capture: ``profile_dir``, ``trace_file`` and whether the
    profiler was asked for every thread's ranges (``all_threads``)."""
    with _lock:
        return dict(_last)
