"""The port's streaming-raster extras and still-image preprocessing against the
JAX package's, on the CPU.

- ``events_to_structured_stream``, ``events_window_us`` and
  ``split_events_by_time`` give JAX's arrays exactly.
- ``rasterize_events_torch`` equals ``rasterize_events_jax`` and the numpy
  rasterizer bit for bit, duplicate pixels and events below the frame
  included; an event past the right edge is dropped, as on the host path
  (the JAX device version scatters it onto the next row).
- ``clip_normalize`` is within 1e-6 of ``clip_normalize_jax``;
  ``expand2square`` equals JAX's exactly.
- ``image`` entries of the training set give JAX's pixels (byte-equal, the
  bar ``tests/test_torch_preprocess.py`` holds ``clip_preprocess`` to);
  with Pillow hidden the entry raises an error that names Pillow.
"""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgpt_tpu import config as jcfg
from eventgpt_tpu.data.tokenizer import load_tokenizer as jtok
from eventgpt_tpu.ops import image as jimage
from eventgpt_tpu.ops import raster as jraster
from eventgpt_tpu.train import data as jdata
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch.data.tokenizer import load_tokenizer as ttok
from eventgpt_tpu_torch.ops import image as timage
from eventgpt_tpu_torch.ops import raster as traster
from eventgpt_tpu_torch.train import data as tdata


def _numpy_raster(x, y, p, h, w):
    """The numpy scatter, in-frame events only (the host path's)."""
    x, y, p = (np.asarray(v).astype(np.int64) for v in (x, y, p))
    inb = (x < w) & (y < h)
    x, y, p = x[inb], y[inb], p[inb]
    lin = y * w + x
    last = np.full(h * w, -1, dtype=np.int64)
    np.maximum.at(last, lin, np.arange(lin.size, dtype=np.int64))
    frame = np.full((h * w, 3), 255, dtype=np.uint8)
    hit = last >= 0
    frame[hit] = np.where(p[last[hit]][:, None] != 0, np.array([255, 0, 0], np.uint8),
                          np.array([0, 0, 255], np.uint8))
    return frame.reshape(h, w, 3)


def _events(seed, n=4000, h=24, w=32):
    rng = np.random.default_rng(seed)
    # Few pixels for many events: most pixels are hit several times.
    return {"x": rng.integers(0, w, n).astype(np.uint16),
            "y": rng.integers(0, h, n).astype(np.uint16),
            "t": np.sort(rng.integers(0, 90_000, n)).astype(np.int64),
            "p": rng.integers(0, 2, n).astype(np.uint8)}


def test_structured_stream_window_and_time_split_equal_jax():
    ev = _events(0)
    np.testing.assert_array_equal(traster.events_to_structured_stream(ev),
                                  jraster.events_to_structured_stream(ev))
    assert traster.events_to_structured_stream(ev).dtype == jraster.STREAM_DTYPE
    buf = {"x": ev["x"], "y": ev["y"], "t": ev["t"] / 1e6, "p": ev["p"]}
    sel = (buf["t"] >= 0.01) & (buf["t"] < 0.06)
    got, want = traster.events_window_us(buf, sel), jraster.events_window_us(buf, sel)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype
    for width in (50_000, 20_000, 7_000):
        got, want = (traster.split_events_by_time(ev, width),
                     jraster.split_events_by_time(ev, width))
        assert len(got) == len(want) > 1
        for g, w_ in zip(got, want):
            assert sorted(g) == sorted(w_)
            for k in w_:
                np.testing.assert_array_equal(g[k], w_[k])


@pytest.mark.parametrize("seed", [1, 2])
def test_device_rasterizer_equals_jax_and_numpy(seed):
    h, w = 24, 32
    ev = _events(seed, h=h, w=w)
    # Events below the frame's last row: every path drops them.
    ev["y"][::37] = h + 3
    want = _numpy_raster(ev["x"], ev["y"], ev["p"], h, w)
    got = traster.rasterize_events_torch(ev["x"], ev["y"], ev["p"], h, w, device="cpu")
    jgot = np.asarray(jraster.rasterize_events_jax(jnp.asarray(ev["x"]), jnp.asarray(ev["y"]),
                                                   jnp.asarray(ev["p"]), h, w))
    assert got.dtype == torch.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(jgot, want)
    np.testing.assert_array_equal(traster.rasterize_events(ev["x"], ev["y"], ev["p"], h, w),
                                  want)
    # Tensors in, on their own device.
    tt = traster.rasterize_events_torch(*(torch.from_numpy(ev[k].astype(np.int64))
                                          for k in ("x", "y", "p")), h, w)
    np.testing.assert_array_equal(tt.numpy(), want)


def test_event_past_the_right_edge_is_dropped_as_on_the_host():
    x = np.array([1, 4, 2], np.uint16)  # width 4: the second event is off the frame
    y = np.array([0, 0, 1], np.uint16)
    p = np.array([0, 1, 1], np.uint8)
    got = traster.rasterize_events_torch(x, y, p, 2, 4).numpy()
    np.testing.assert_array_equal(got, traster.rasterize_events(x, y, p, 2, 4))
    assert (got[1, 0] == 255).all()
    jgot = np.asarray(jraster.rasterize_events_jax(jnp.asarray(x), jnp.asarray(y),
                                                   jnp.asarray(p), 2, 4))
    assert (jgot[1, 0] == [255, 0, 0]).all()  # JAX's linear index wraps it to (1, 0)


def test_clip_normalize_and_expand2square_equal_jax():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (3, 16, 16, 3)).astype(np.uint8)
    got = timage.clip_normalize(torch.from_numpy(frames))
    want = np.asarray(jimage.clip_normalize_jax(jnp.asarray(frames)))
    assert got.shape == want.shape == (3, 3, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    for shape in ((20, 30, 3), (30, 20, 3), (17, 17, 3), (5, 40, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(timage.expand2square(img), jimage.expand2square(img))


def _image_set(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    entries = []
    for i, (h, w) in enumerate(((40, 64), (64, 40), (50, 50))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).save(
            tmp_path / f"im{i}.png")
        entries.append({"id": i, "image": f"im{i}.png", "conversations": [
            {"from": "human", "value": "<event>\nWhat is shown?"},
            {"from": "gpt", "value": f"Picture {i}."}]})
    path = tmp_path / "qa.json"
    path.write_text(json.dumps(entries))
    return str(path)


@pytest.mark.parametrize("aspect", ["square", "pad_none"])
def test_image_entries_give_jax_pixels(tmp_path, aspect):
    path = _image_set(tmp_path)
    jc = jcfg.EventChatConfig.tiny()
    tc = tcfg.EventChatConfig.tiny()
    jds = jdata.EventChatDataset(path, jtok("byte"), jc, event_folder=str(tmp_path),
                                 image_aspect_ratio=aspect)
    tds = tdata.EventChatDataset(path, ttok("byte"), tc, event_folder=str(tmp_path),
                                 image_aspect_ratio=aspect)
    for i in range(len(jds)):
        js, ts = jds[i], tds[i]
        assert ts.input_ids == js.input_ids and ts.labels == js.labels
        assert ts.pixel_values.shape == (tc.num_event_frames, 3, tc.vision.image_size,
                                         tc.vision.image_size)
        np.testing.assert_array_equal(ts.pixel_values, js.pixel_values)


def test_image_entry_without_pillow_names_pillow(tmp_path, monkeypatch):
    path = _image_set(tmp_path)
    ds = tdata.EventChatDataset(path, ttok("byte"), tcfg.EventChatConfig.tiny(),
                                event_folder=str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        ds[0]
