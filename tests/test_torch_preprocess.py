"""Host preprocessing of the PyTorch port against the JAX package: raster
frames and CLIP pixels must be byte-equal (the port's numpy bicubic
resampler against the JAX package's Pillow path)."""

import pickle

import numpy as np
import pytest

from eventgpt_tpu.ops import image as jimage
from eventgpt_tpu.ops import raster as jraster
from eventgpt_tpu_torch.ops import image as timage
from eventgpt_tpu_torch.ops import raster as traster


def _structured_stream(seed, n=20_000, height=480, width=640, span_us=60_000):
    rng = np.random.default_rng(seed)
    arr = np.zeros(n, dtype=traster.STREAM_DTYPE)
    arr["x"] = rng.integers(0, width, n)
    arr["y"] = rng.integers(0, height, n)
    arr["t"] = np.sort(rng.integers(0, span_us, n))
    arr["p"] = rng.integers(0, 2, n)
    return arr


def _legacy_pickled(path, seed):
    """A legacy object-array .npy holding a {x, y, t, p} dict of arrays."""
    rng = np.random.default_rng(seed)
    n = 5_000
    events = {"x": rng.integers(0, 346, n).astype(np.int64),
              "y": rng.integers(0, 260, n).astype(np.int64),
              "t": np.sort(rng.integers(0, 40_000, n)).astype(np.float64),
              "p": rng.integers(0, 2, n).astype(np.int64)}
    np.save(path, np.array(events, dtype=object), allow_pickle=True)


@pytest.mark.parametrize("kind", ["structured", "legacy", "synthetic"])
def test_frames_and_pixels_byte_equal(tmp_path, kind):
    path = str(tmp_path / f"{kind}.npy")
    if kind == "structured":
        np.save(path, _structured_stream(1))
    elif kind == "legacy":
        _legacy_pickled(path, 2)
    else:
        np.save(path, traster.synthetic_event_stream(3, n_events=40_000))

    ev_j = jraster.load_event_npy(path)
    ev_t = traster.load_event_npy(path)
    assert sorted(ev_j) == sorted(ev_t)
    for k in ev_j:
        np.testing.assert_array_equal(ev_j[k], ev_t[k])

    frames_j = jraster.events_to_frames(ev_j)
    frames_t = traster.events_to_frames(ev_t)
    assert len(frames_t) == 5
    for fj, ft in zip(frames_j, frames_t):
        assert ft.dtype == np.uint8
        np.testing.assert_array_equal(fj, ft)

    pix_j = jimage.clip_preprocess_batch(frames_j, 336)
    pix_t = timage.clip_preprocess_batch(frames_t, 336)
    assert pix_t.dtype == np.float32 and pix_t.shape == (5, 3, 336, 336)
    np.testing.assert_array_equal(pix_j, pix_t)

    size_j, px_j = jimage.process_event_file(path)
    size_t, px_t = timage.process_event_file(path)
    assert size_j == size_t
    np.testing.assert_array_equal(px_j, px_t)


@pytest.mark.parametrize("shape,size", [((37, 53), 28), ((500, 300), 336),
                                        ((20, 20), 7), ((336, 336), 336)])
def test_resize_byte_equal_to_pillow(shape, size):
    """Odd shapes, upscales and the identity against Pillow's own resize."""
    rng = np.random.default_rng(sum(shape))
    frame = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(jimage.clip_preprocess(frame, size),
                                  timage.clip_preprocess(frame, size))


def test_out_of_bounds_events_dropped_like_reference():
    x = np.array([0, 5, 9, -1, 12])
    y = np.array([0, 3, 7, 2, 1])
    p = np.array([1, 0, 1, 1, 0])
    np.testing.assert_array_equal(
        jraster.rasterize_events(x, y, p, height=8, width=10),
        traster.rasterize_events(x, y, p, height=8, width=10))


def test_too_long_and_short_streams_raise(tmp_path):
    long = _structured_stream(4, n=1_000, span_us=150_000)
    long["t"][-1] = 150_000
    ev = {k: long[k] for k in long.dtype.names}
    with pytest.raises(jraster.EventStreamTooLongError):
        jraster.events_to_frames(ev)
    with pytest.raises(traster.EventStreamTooLongError):
        traster.events_to_frames(ev)
    short = {k: v[:3] for k, v in ev.items()}
    with pytest.raises(ValueError, match="at least 5"):
        traster.events_to_frames(short)


def test_legacy_unpickler_blocks_foreign_globals(tmp_path):
    path = str(tmp_path / "evil.npy")

    class Evil:
        def __reduce__(self):
            return (print, ("side effect",))

    np.save(path, np.array({"x": Evil()}, dtype=object), allow_pickle=True)
    with pytest.raises(pickle.UnpicklingError, match="blocked"):
        traster.load_event_npy(path)
