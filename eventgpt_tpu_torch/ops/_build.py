"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``eventgpt_tpu_torch/csrc/`` exposes a plain C
interface, including ``egpt_cuda_error_string``. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library in ``csrc/build/`` (ignored
by git) on first use, named by a hash of its source, the headers in
``csrc/`` and the flags, so an edited source or header rebuilds, and
loaded with ``ctypes``. Nothing is built or imported when this module is
imported.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


class CudaKernel:
    """One kernel source: its built library and a count of its launches.

    ``launches`` is an integer that the kernel's wrapper raises by one at
    each launch and nowhere else (``count_launch``), so a run can show that
    its main path went through the kernel; ``launches_by_thread`` splits the
    same count by the launching thread (a fleet replica's scheduler). The
    counts and the library load each take a lock: fleet replicas launch
    from several threads.
    """

    def __init__(self, source: str, signatures: Dict[str, tuple]):
        self.source = source
        # C entry point name -> (restype, [argtypes])
        self.signatures = {**signatures,
                           "egpt_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int])}
        self.launches = 0
        self.launches_by_thread: Counter = Counter()
        self._lib: Optional[ctypes.CDLL] = None
        self._load_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.build_log = ""
        self.build_seconds = 0.0

    @property
    def path(self) -> str:
        return os.path.join(CSRC, self.source)

    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in [self.path, *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
            with open(path, "rb") as f:
                h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(self.source)[0]
        return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, str]]:
        """Start ``nvcc`` for this source unless its library exists. The
        library is written to a temporary name, which ``finish_build``
        moves into place."""
        if os.path.exists(self.library_path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def finish_build(self, started: Optional[Tuple[subprocess.Popen, str]]) -> None:
        if started is None:
            return
        proc, tmp = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, self.library_path())

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed (once, whichever thread
        asks first)."""
        if self._lib is None:
            with self._load_lock:
                if self._lib is None:
                    if not os.path.exists(self.library_path()):
                        build_all([self])
                    lib = ctypes.CDLL(self.library_path())
                    for name, (restype, argtypes) in self.signatures.items():
                        fn = getattr(lib, name)
                        fn.restype = restype
                        fn.argtypes = argtypes
                    self._lib = lib
        return self._lib

    def count_launch(self, *tallies) -> None:
        """One launch: ``launches`` and each ``(counter, key)`` of ``tallies``
        go up by one together, under the kernel's lock, so that launches from
        several threads are all counted."""
        with self._count_lock:
            self.launches += 1
            self.launches_by_thread[threading.get_ident()] += 1
            for counter, key in tallies:
                counter[key] += 1

    def check(self, err: int) -> None:
        """Raise if a C entry point returned a CUDA error."""
        if err != 0:
            msg = self.lib().egpt_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.source}: CUDA error {err}: {msg}")


def build_all(kernels: Sequence[CudaKernel]) -> List[float]:
    """Build every kernel that is not built yet, one ``nvcc`` per source,
    all started together. Returns each kernel's wall seconds."""
    t0 = time.perf_counter()
    started = [k.start_build() for k in kernels]
    seconds = []
    for k, st in zip(kernels, started):
        k.finish_build(st)
        k.build_seconds = time.perf_counter() - t0
        seconds.append(k.build_seconds)
    return seconds

