"""Event-stream rasterization: raw ``{x, y, t, p}`` -> polarity RGB frames.

Host-side numpy, the same semantics as ``eventgpt_tpu/ops/raster.py``:
white (255,255,255) background; the *last* event at a pixel wins;
polarity 0 -> blue (0,0,255), polarity 1 -> red (255,0,0); per-frame dims
are ``(y.max()+1, x.max()+1)`` of that frame's own events. Streams split
into equal event-count slices.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventgpt_tpu_torch.constants import MAX_EVENT_STREAM_US

EventDict = Dict[str, np.ndarray]

_RED = np.array([255, 0, 0], dtype=np.uint8)
_BLUE = np.array([0, 0, 255], dtype=np.uint8)

# On-disk layout of a structured event stream: one struct per event.
STREAM_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"),
                         ("t", "<u8"), ("p", "u1")])


class EventStreamTooLongError(ValueError):
    """Stream span exceeds the supported envelope (100 ms)."""


def check_event_stream_length(start_time_us: int, end_time_us: int,
                              max_span_us: int = MAX_EVENT_STREAM_US) -> None:
    if end_time_us - start_time_us >= max_span_us:
        raise EventStreamTooLongError(
            f"Event stream spans {end_time_us - start_time_us} us; "
            f"streams must be shorter than {max_span_us} us."
        )


class _NumpyOnlyUnpickler(pickle.Unpickler):
    """Restricted unpickler for legacy event files: only the globals numpy
    needs to rebuild ``{str: ndarray}`` dicts resolve; anything else (the
    arbitrary-code-execution surface of ``allow_pickle=True``) raises."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"blocked pickle global {module}.{name} in event file "
            f"(only numpy array payloads are allowed)"
        )


def _load_legacy_pickled_events(path: str) -> EventDict:
    """Read a legacy object-array .npy through the restricted unpickler."""
    from numpy.lib import format as npf

    with open(path, "rb") as f:
        version = npf.read_magic(f)
        npf._check_version(version)
        _shape, _fortran, dtype = npf._read_array_header(f, version)
        if not dtype.hasobject:
            raise ValueError(f"{path}: not an object-array npy")
        obj = _NumpyOnlyUnpickler(f).load()
    d = np.array(obj).item() if isinstance(obj, np.ndarray) else obj
    if not isinstance(d, dict):
        raise ValueError(f"{path}: expected an event dict, got {type(d)}")
    return {str(k): np.asarray(v) for k, v in d.items()}


def load_event_npy(path: str) -> EventDict:
    """Load a ``{x,y,t,p}`` dict from an .npy file: a structured array loads
    without pickle; a legacy pickled dict goes through the restricted
    unpickler, never ``allow_pickle=True``."""
    try:
        raw = np.load(path)  # no pickle: safe structured-array path
    except ValueError:
        return _load_legacy_pickled_events(path)
    if raw.dtype.names:
        return {n: np.ascontiguousarray(raw[n]) for n in raw.dtype.names}
    raise ValueError(
        f"{path}: unsupported event npy layout (expected a structured "
        f"array with named fields or a legacy pickled dict)"
    )


def rasterize_events(
    x: np.ndarray,
    y: np.ndarray,
    p: np.ndarray,
    height: Optional[int] = None,
    width: Optional[int] = None,
) -> np.ndarray:
    """Rasterize one event slice into an (H, W, 3) uint8 RGB frame.

    Vectorized last-write-wins: for each pixel, the polarity of the last
    event landing there decides the color.
    """
    inferred_dims = height is None and width is None
    if height is None:
        height = int(y.max()) + 1
    if width is None:
        width = int(x.max()) + 1

    # Out-of-frame events are dropped. Skipped when the coordinates are
    # unsigned and the dims come from their maxima: in bounds by construction.
    unsigned = (np.issubdtype(np.asarray(x).dtype, np.unsignedinteger)
                and np.issubdtype(np.asarray(y).dtype, np.unsignedinteger))
    if not (inferred_dims and unsigned):
        xi = np.asarray(x).astype(np.int64)
        yi = np.asarray(y).astype(np.int64)
        inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        if not inb.all():
            x, y, p = np.asarray(x)[inb], np.asarray(y)[inb], np.asarray(p)[inb]

    lin = y.astype(np.int64) * width + x.astype(np.int64)
    last = np.full(height * width, -1, dtype=np.int64)
    np.maximum.at(last, lin, np.arange(lin.size, dtype=np.int64))

    frame = np.full((height * width, 3), 255, dtype=np.uint8)
    hit = last >= 0
    pol = np.asarray(p)[last[hit]]
    frame[hit] = np.where(pol[:, None] != 0, _RED, _BLUE)
    return frame.reshape(height, width, 3)


def split_events_by_count(events: EventDict, n: int) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Split a stream into ``n`` equal-event-count slices (the last takes
    the remainder). Returns (x, y, p) triples."""
    x, y, p, t = events["x"], events["y"], events["p"], events["t"]
    total = len(t)
    per = total // n
    out = []
    for i in range(n):
        lo = i * per
        hi = (i + 1) * per if i < n - 1 else total
        out.append((x[lo:hi], y[lo:hi], p[lo:hi]))
    return out


def events_to_frames(
    events: EventDict,
    n_frames: int = 5,
    max_span_us: int = MAX_EVENT_STREAM_US,
) -> List[np.ndarray]:
    """Guard the span, split by count, rasterize each slice."""
    t = events["t"]
    if len(t) < n_frames:
        raise ValueError(
            f"event stream has {len(t)} events; at least {n_frames} are needed "
            f"to rasterize {n_frames} frames"
        )
    check_event_stream_length(int(t.min()), int(t.max()), max_span_us)
    return [rasterize_events(x, y, p) for x, y, p in split_events_by_count(events, n_frames)]


def synthetic_event_stream(seed: int, n_events: int = 130_000,
                           height: int = 480, width: int = 640,
                           span_us: int = 50_000) -> np.ndarray:
    """A seeded synthetic stream in ``STREAM_DTYPE`` layout: events spread
    over an (height, width) sensor, time-sorted within ``span_us``. Corner
    events pin the frame dims of every equal-count slice to the full
    sensor size."""
    rng = np.random.default_rng(seed)
    arr = np.zeros(n_events, dtype=STREAM_DTYPE)
    arr["x"] = rng.integers(0, width, n_events)
    arr["y"] = rng.integers(0, height, n_events)
    arr["t"] = np.sort(rng.integers(0, span_us, n_events))
    arr["p"] = rng.integers(0, 2, n_events)
    # One bottom-right corner event at the end of every fifth of the
    # stream, so each of the default 5 slices spans the whole sensor.
    for i in range(1, 6):
        j = i * (n_events // 5) - 1
        arr["x"][j], arr["y"][j] = width - 1, height - 1
    return arr
