"""ctypes bindings to the native host toolchain (``native/``), built by the port.

The C ABI in ``native/src/capi.cpp`` (pybind11 is not installed on either
machine) is compiled into ``libegpt_native.so`` with the host C++ compiler
(``$CXX``, else ``g++``; ``-std=c++17 -O2 -fPIC -shared -pthread -include
cstdint``), no cmake: every ``native/src/*.cpp`` but the feature tracker's
``main``, with ``native/include``. The ``egpt_feature_track`` executable is
built beside it, from ``native/src/feature_track_main.cpp`` and the same
sources. Both go into ``eventgpt_tpu_torch/csrc/build/native-<hash>/``
(ignored by git), named by a hash of the sources, the headers, the
compiler and the flags, on first use by ``EventStream``,
``rasterize_events_native`` or ``build``: one compiler per source, all at
once, then two links, under a file lock, so that concurrent processes
build once. A failed build raises with the compiler's output.
``native/build*`` (the JAX package's cmake tree) is neither read nor
written.

  * ``rasterize_events_native`` -- the last-write-wins polarity raster in
    one C pass, equal to ``ops.raster.rasterize_events``'s numpy scatter;
  * ``EventStream`` -- the consumer handle over the native threaded event
    reader: a producer thread replays a txt ("t x y p") or structured-npy
    file, optionally paced at wall-clock rate, and ``pop_until(horizon)``
    returns every event with t <= horizon, splitting a straddling packet.

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import weakref
from typing import Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(_ROOT, "native")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "build")
# ``native/src/rgbd.cpp`` uses uint8_t and uint16_t without including
# <cstdint>, which older libstdc++ headers brought in through <vector> and
# newer ones do not: the header is included first in every source.
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-pthread", "-include", "cstdint"]
LIB_NAME = "libegpt_native.so"
TOOL_NAME = "egpt_feature_track"
TOOL_MAIN = "feature_track_main.cpp"

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_DIR: Optional[str] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: building the native library needs $CXX or g++")
    return cxx


def _sources():
    """(library sources, executable sources, headers)."""
    src = sorted(glob.glob(os.path.join(NATIVE, "src", "*.cpp")))
    core = [p for p in src if os.path.basename(p) not in ("capi.cpp", TOOL_MAIN)]
    lib = [os.path.join(NATIVE, "src", "capi.cpp"), *core]
    tool = [os.path.join(NATIVE, "src", TOOL_MAIN), *core]
    headers = sorted(glob.glob(os.path.join(NATIVE, "include", "egpt", "*.hpp")))
    return lib, tool, headers


def build_dir() -> str:
    """The build directory of these sources, compiler and flags."""
    global _BUILD_DIR
    if _BUILD_DIR is None:
        lib, tool, headers = _sources()
        h = hashlib.sha256()
        for path in sorted(set(lib + tool + headers)):
            h.update(os.path.relpath(path, NATIVE).encode())
            with open(path, "rb") as f:
                h.update(f.read())
        cxx = os.path.basename(os.environ.get("CXX") or "g++")
        h.update(" ".join([cxx, *CXX_FLAGS]).encode())
        _BUILD_DIR = os.path.join(BUILD_ROOT, f"native-{h.hexdigest()[:16]}")
    return _BUILD_DIR


def library_path() -> str:
    return os.path.join(build_dir(), LIB_NAME)


def feature_track_path() -> str:
    return os.path.join(build_dir(), TOOL_NAME)


def built() -> bool:
    """True when the library is loaded or built already; never builds."""
    return _LIB is not None or os.path.exists(library_path())


def _run_all(cmds, what: str) -> None:
    """Run the commands at once; raise with every failed one's output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
    if failed:
        raise RuntimeError(f"building the native toolchain failed ({what}):\n" + "\n".join(failed))


def build() -> str:
    """Build the library and the feature tracker unless both exist: one
    compiler per source, all at once, then the two links, each output
    written to a temporary name and moved into place. Returns the build
    directory."""
    out_dir = build_dir()
    targets = [os.path.join(out_dir, LIB_NAME), os.path.join(out_dir, TOOL_NAME)]
    if all(os.path.exists(t) for t in targets):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    lib_src, tool_src, _ = _sources()
    include = ["-I", os.path.join(NATIVE, "include")]
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # another process may be building
        try:
            if all(os.path.exists(t) for t in targets):
                return out_dir
            with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
                obj = {src: os.path.join(tmp, os.path.basename(src) + ".o")
                       for src in sorted(set(lib_src + tool_src))}
                _run_all([[_cxx(), *CXX_FLAGS, *include, "-c", src, "-o", o]
                          for src, o in obj.items()], "compile")
                links = [(targets[0], ["-shared"], lib_src), (targets[1], [], tool_src)]
                outs = [os.path.join(tmp, os.path.basename(t)) for t, _, _ in links]
                _run_all([[_cxx(), *CXX_FLAGS, *extra, "-o", out, *(obj[x] for x in src)]
                          for (_, extra, src), out in zip(links, outs)], "link")
                for (target, _, _), out in zip(links, outs):
                    os.chmod(out, 0o755)
                    os.replace(out, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out_dir


_SIGNATURES = {
    "egpt_rasterize": (None, [ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
                              ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]),
    "egpt_stream_open": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_double, ctypes.c_int]),
    "egpt_stream_pop_until": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_double]),
    "egpt_stream_fetch": (None, [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
                                 ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_uint8)]),
    "egpt_stream_running": (ctypes.c_int, [ctypes.c_void_p]),
    "egpt_stream_close": (None, [ctypes.c_void_p]),
}


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once, whichever thread
    asks first)."""
    global _LIB
    if _LIB is None:
        with _lock:
            if _LIB is None:
                build()
                lib = ctypes.CDLL(library_path())
                for name, (restype, argtypes) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rasterize_events_native(x: np.ndarray, y: np.ndarray, p: np.ndarray, height: int,
                            width: int) -> np.ndarray:
    """Native last-write-wins polarity raster -> (H, W, 3) uint8; the
    semantics of ``ops.raster.rasterize_events`` (the C pass drops events
    outside the frame). Coordinates must fit uint16."""
    if not (0 < height <= 65536 and 0 < width <= 65536):
        raise ValueError(f"frame {height}x{width} does not fit the native uint16 coordinates")
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.uint16)
    y = np.ascontiguousarray(y, dtype=np.uint16)
    p = np.ascontiguousarray(p, dtype=np.uint8)
    if not len(x) == len(y) == len(p):
        raise ValueError(f"x, y, p lengths differ: {len(x)}, {len(y)}, {len(p)}")
    out = np.empty(height * width * 3, dtype=np.uint8)
    lib.egpt_rasterize(_ptr(x, ctypes.c_uint16), _ptr(y, ctypes.c_uint16),
                       _ptr(p, ctypes.c_uint8), len(x), height, width, _ptr(out, ctypes.c_uint8))
    return out.reshape(height, width, 3)


class EventStream:
    """Consumer handle over the native threaded event reader.

    ``time_unit``: the txt timestamps' unit -- "auto" reads a largest value
    above 1e5 as microseconds; a microsecond recording shorter than 0.1 s is
    ambiguous under auto and passes "microseconds". ``pops`` and ``popped``
    count the ``pop_until`` calls and the events they returned. A handle
    that is never closed is closed when it is collected."""

    _UNITS = {"auto": 0, "seconds": 1, "microseconds": 2}

    def __init__(self, path: str, paced: bool = False, pace_factor: float = 1.0,
                 time_unit: str = "auto"):
        if time_unit not in self._UNITS:
            raise ValueError(f"time_unit must be one of {sorted(self._UNITS)}")
        self._lib = load_library()
        self._handle = self._lib.egpt_stream_open(
            path.encode(), 1 if path.endswith(".npy") else 0, 1 if paced else 0,
            float(pace_factor), self._UNITS[time_unit])
        if not self._handle:
            raise FileNotFoundError(f"could not open event stream {path}")
        self.pops = 0
        self.popped = 0
        # The native producer thread and queue must not outlive a handle
        # that is dropped without close(); close() detaches this.
        self._finalizer = weakref.finalize(self, self._lib.egpt_stream_close, self._handle)

    def pop_until(self, horizon_s: float):
        """Events with t <= horizon (seconds) -> {x: u16, y: u16, t: f64
        seconds, p: u8} numpy arrays. Non-blocking."""
        if not self._handle:
            raise RuntimeError("pop on a closed stream")
        n = self._lib.egpt_stream_pop_until(self._handle, float(horizon_s))
        if n < 0:
            raise RuntimeError("pop on a closed stream")
        x, y = np.empty(n, np.uint16), np.empty(n, np.uint16)
        t, p = np.empty(n, np.float64), np.empty(n, np.uint8)
        if n:
            self._lib.egpt_stream_fetch(self._handle, _ptr(x, ctypes.c_uint16),
                                        _ptr(y, ctypes.c_uint16), _ptr(t, ctypes.c_double),
                                        _ptr(p, ctypes.c_uint8))
        self.pops += 1
        self.popped += int(n)
        return {"x": x, "y": y, "t": t, "p": p}

    def running(self) -> bool:
        """True while the producer thread is alive or events remain queued."""
        return bool(self._handle) and bool(self._lib.egpt_stream_running(self._handle))

    def close(self) -> None:
        if self._handle:
            self._finalizer.detach()
            self._lib.egpt_stream_close(self._handle)
            self._handle = None

    def __enter__(self) -> "EventStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
