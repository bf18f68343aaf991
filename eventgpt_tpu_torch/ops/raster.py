"""Event-stream rasterization: raw ``{x, y, t, p}`` -> polarity RGB frames.

The same semantics as ``eventgpt_tpu/ops/raster.py``: white
(255,255,255) background; the *last* event at a pixel wins; polarity 0 ->
blue (0,0,255), polarity 1 -> red (255,0,0); per-frame dims are
``(y.max()+1, x.max()+1)`` of that frame's own events. Streams split into
equal event-count slices, or into fixed-width time bins.

  * ``rasterize_events``       -- the host path: the native library's single
    C pass (``eventgpt_tpu_torch/native.py``) when it is already built, else
    a numpy scatter; ``RASTER_PATHS`` counts which ran;
  * ``rasterize_events_torch`` -- the device path for events already on a
    device: a scatter-max of event ordinals, then a gather of the winner's
    polarity (the JAX package's ``rasterize_events_jax``).
"""

from __future__ import annotations

import pickle
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

from eventgpt_tpu_torch.constants import MAX_EVENT_STREAM_US

EventDict = Dict[str, np.ndarray]

_RED = np.array([255, 0, 0], dtype=np.uint8)
_BLUE = np.array([0, 0, 255], dtype=np.uint8)

# On-disk layout of a structured event stream: one struct per event (the
# native reader's, shared with the C++ SaveEventsNpy writer).
STREAM_DTYPE = np.dtype([("x", "<u2"), ("y", "<u2"),
                         ("t", "<u8"), ("p", "u1")])

# Frames rasterized by ``rasterize_events`` on each host path.
RASTER_PATHS: Counter = Counter()


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


def events_to_structured_stream(events: EventDict) -> np.ndarray:
    """{x,y,t,p} dict -> the native reader's structured-array layout, how a
    streaming harness replays a stream through ``native.EventStream``."""
    n = len(events["t"])
    arr = np.zeros(n, dtype=STREAM_DTYPE)
    for k in ("x", "y", "t", "p"):
        arr[k] = events[k]
    return arr


def events_window_us(buf: Dict[str, np.ndarray], sel: np.ndarray) -> EventDict:
    """Select a window from a float-seconds event dict (what
    ``native.EventStream.pop_until`` returns), ``t`` converted to int64
    microseconds (truncated, as the JAX package converts it): the
    ``events_to_frames`` contract."""
    return {k: (buf[k][sel] if k != "t"
                else (buf["t"][sel] * 1e6).astype(np.int64))
            for k in buf}


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

    from eventgpt_tpu_torch import native

    # Only a library built already: a build is never started from here. The
    # C ABI takes uint16 coordinates, so larger frames take numpy.
    if native.built() and height <= 65536 and width <= 65536:
        RASTER_PATHS["native"] += 1
        return native.rasterize_events_native(x, y, p, height, width)
    RASTER_PATHS["numpy"] += 1
    lin = y.astype(np.int64) * width + x.astype(np.int64)
    last = np.full(height * width, -1, dtype=np.int64)
    np.maximum.at(last, lin, np.arange(lin.size, dtype=np.int64))

    frame = np.full((height * width, 3), 255, dtype=np.uint8)
    hit = last >= 0
    pol = np.asarray(p)[last[hit]]
    frame[hit] = np.where(pol[:, None] != 0, _RED, _BLUE)
    return frame.reshape(height, width, 3)


def rasterize_events_torch(x, y, p, height: int, width: int, device=None):
    """The device rasterizer: (H, W, 3) uint8 on ``device`` (default: the
    events' own), last write wins, equal to ``rasterize_events`` bit for
    bit. A ``scatter_reduce_`` ("amax") of int64 event ordinals picks each
    pixel's last event, a gather takes its polarity. Events outside the
    frame are dropped, as on the host path. (The JAX version scatters on
    the linear index: it drops events below the frame's last row, and an
    event past the right edge lands on the next row there.) Numpy inputs
    go to the device as int32 coordinates and uint8 polarities."""
    import torch

    def on_device(v, dtype):
        if torch.is_tensor(v):
            return v.to(device=device if device is not None else v.device)
        return torch.as_tensor(np.asarray(v).astype(dtype), device=device)

    x, y, p = on_device(x, np.int32), on_device(y, np.int32), on_device(p, np.uint8)
    dev = x.device
    xi, yi = x.to(torch.int64), y.to(device=dev, dtype=torch.int64)
    inb = (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
    lin = torch.where(inb, yi * width + xi, height * width)
    last = torch.full((height * width + 1,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, lin, torch.arange(lin.numel(), dtype=torch.int64, device=dev),
                         reduce="amax")
    last = last[:-1]  # the dropped events' sink
    hit = last >= 0
    pol = p.to(dev)[last.clamp(min=0)] != 0
    red = torch.tensor([255, 0, 0], dtype=torch.uint8, device=dev)
    blue = torch.tensor([0, 0, 255], dtype=torch.uint8, device=dev)
    white = torch.full((3,), 255, dtype=torch.uint8, device=dev)
    frame = torch.where(hit[:, None], torch.where(pol[:, None], red, blue), white)
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


def split_events_by_time(events: EventDict, time_interval_us: int = 50_000) -> List[EventDict]:
    """Split a stream into fixed-width time bins."""
    t = events["t"]
    bins = (t // time_interval_us) * time_interval_us
    out = []
    for b in np.unique(bins):
        sel = bins == b
        out.append({k: events[k][sel] for k in ("p", "t", "x", "y")})
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
