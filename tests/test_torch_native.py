"""The port's native toolchain: its own build of ``native/`` (no cmake), the
ctypes bindings, the streaming event-QA script and the feature-track seam,
against the JAX package on the CPU. The only test file that builds the
library (once, in the module fixture; ~12 s).

- The native raster equals the numpy scatter; ``rasterize_events`` takes it
  once the library is built and counts the path.
- ``EventStream`` semantics as the JAX bridge's tests hold them: horizon
  pops across a straddling packet, structured npy and a missing file, the
  txt microsecond override.
- ``scripts/stream_demo.py`` at tiny size over one structured stream gives
  the JAX ``scripts/stream_demo.py``'s window chains on the same checkpoint
  (the JAX package loads the port-built library through ``EGPT_NATIVE_LIB``);
  windows counted in integer microseconds put an event at a window's end in
  the next window.
- ``egpt_feature_track`` runs on a synthetic PPM/PGM rig, and its CSV and
  windows go through both packages' ``tracks_to_dataset`` to equal JSON.
"""

import json
import os
import subprocess
import time

import numpy as np
import pytest
import torch

from eventgpt_tpu import native as jnative
from eventgpt_tpu.data import feature_track as jtrack
from eventgpt_tpu.models import eventchat as jchat
from eventgpt_tpu_torch import config as tcfg
from eventgpt_tpu_torch import native
from eventgpt_tpu_torch.data import feature_track as ttrack
from eventgpt_tpu_torch.models import convert as tconv
from eventgpt_tpu_torch.ops import raster as traster
from eventgpt_tpu_torch.scripts import stream_demo as tdemo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 10.0


@pytest.fixture(scope="module")
def built():
    return native.build()


def _numpy_raster(x, y, p, h, w):
    lin = y.astype(np.int64) * w + x.astype(np.int64)
    last = np.full(h * w, -1, dtype=np.int64)
    np.maximum.at(last, lin, np.arange(lin.size, dtype=np.int64))
    frame = np.full((h * w, 3), 255, dtype=np.uint8)
    hit = last >= 0
    frame[hit] = np.where(np.asarray(p)[last[hit]][:, None] != 0,
                          np.array([255, 0, 0], np.uint8), np.array([0, 0, 255], np.uint8))
    return frame.reshape(h, w, 3)


def test_native_raster_equals_numpy_and_is_counted(built):
    assert os.path.exists(native.library_path()) and os.path.exists(native.feature_track_path())
    rng = np.random.default_rng(0)
    n, h, w = 50_000, 240, 320
    x = rng.integers(0, w, n).astype(np.uint16)
    y = rng.integers(0, h, n).astype(np.uint16)
    p = rng.integers(0, 2, n).astype(np.uint8)
    want = _numpy_raster(x, y, p, h, w)
    np.testing.assert_array_equal(native.rasterize_events_native(x, y, p, h, w), want)
    before = traster.RASTER_PATHS["native"]
    np.testing.assert_array_equal(traster.rasterize_events(x, y, p), want)
    assert traster.RASTER_PATHS["native"] == before + 1
    # Out-of-frame events are dropped before the C pass, as numpy drops them.
    xo = x.astype(np.int64)
    xo[::11] = w + 5
    np.testing.assert_array_equal(traster.rasterize_events(xo, y, p, h, w),
                                  _numpy_raster(x[xo < w], y[xo < w], p[xo < w], h, w))


def _drain(stream, n, horizon=10.0):
    got = []
    deadline = time.time() + WAIT_S
    while len(got) < n and time.time() < deadline:
        got.extend(stream.pop_until(horizon)["t"].tolist())
        time.sleep(0.002)
    return got


def test_event_stream_pop_until_across_a_straddling_packet(built, tmp_path):
    # 3 ms of events, one each 100 us: packets of ~1 ms straddle the horizon.
    lines = [f"{i * 100e-6:.6f} {i % 7} {i % 5} {i % 2}" for i in range(30)]
    path = tmp_path / "events.txt"
    path.write_text("\n".join(lines) + "\n")
    with native.EventStream(str(path)) as stream:
        got = []
        deadline = time.time() + WAIT_S
        while not got and time.time() < deadline:
            got.extend(stream.pop_until(0.0015)["t"].tolist())
            time.sleep(0.005)
        assert got and max(got) <= 0.0015 + 1e-9
        first = len(got)
        got += _drain(stream, 30 - first)
        assert len(got) == 30 and got == sorted(got) and first < 30
        assert stream.popped == 30 and stream.pops >= 2
    with pytest.raises(RuntimeError, match="closed"):
        stream.pop_until(1.0)


def test_event_stream_npy_and_missing_file(built, tmp_path):
    n = 500
    arr = np.zeros(n, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<u2"), ("p", "u1")])
    arr["x"], arr["y"] = np.arange(n) % 320, np.arange(n) % 240
    arr["t"], arr["p"] = np.arange(n) * 100, np.arange(n) % 2
    path = tmp_path / "events.npy"
    np.save(path, arr)
    with native.EventStream(str(path)) as stream:
        got = _drain(stream, n, 1e9)
    assert len(got) == n
    with pytest.raises(FileNotFoundError):
        native.EventStream(str(tmp_path / "missing.txt"))


def test_event_stream_txt_microsecond_override(built, tmp_path):
    lines = [f"{i * 1000} {i % 7} {i % 5} {i % 2}" for i in range(80)]  # 80 ms in us
    path = tmp_path / "short_us.txt"
    path.write_text("\n".join(lines) + "\n")
    with native.EventStream(str(path), time_unit="microseconds") as stream:
        got = _drain(stream, 80)
    assert len(got) == 80 and max(got) <= 0.080 + 1e-9
    with pytest.raises(ValueError, match="time_unit"):
        native.EventStream(str(path), time_unit="bogus")


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream_ckpt")
    cfg = tcfg.EventChatConfig.tiny()
    params = tconv.init_eventchat_params(cfg, torch.Generator().manual_seed(5),
                                         torch.float32, "cpu")
    tconv.write_hf_checkpoint(params, cfg, str(root / "ckpt"), num_shards=1)
    return str(root / "ckpt"), root


def _window_stream(path, window_us=10_000, n_windows=3):
    """A structured stream over ``n_windows`` windows, no event on a window
    boundary but the first (where the two packages' cursors differ)."""
    arr = np.concatenate([traster.synthetic_event_stream(40 + i, n_events=600, height=48,
                                                         width=64, span_us=window_us)
                          for i in range(n_windows)])
    arr["t"] += np.repeat(np.arange(n_windows, dtype=np.uint64) * window_us, 600)
    arr = arr[np.argsort(arr["t"], kind="stable")]
    t0 = int(arr["t"][0])
    keep = ((arr["t"].astype(np.int64) - t0) % window_us != 0)
    keep[0] = True
    np.save(path, arr[keep])
    return arr[keep]


def test_stream_script_window_chains_equal_the_jax_script(built, tiny_checkpoint, monkeypatch):
    ckpt, root = tiny_checkpoint
    events = str(root / "stream.npy")
    _window_stream(events)
    argv = ["--events", events, "--model_path", ckpt, "--tokenizer_path", "byte",
            "--dtype", "float32", "--window_ms", "10", "--max_windows", "3",
            "--max_new_tokens", "3"]
    got = tdemo.main(argv + ["--device", "cpu"])
    assert [w["start_us"] for w in got["windows"]] == [got["windows"][0]["start_us"]
                                                       + 10_000 * k for k in range(3)]
    assert got["popped"] == sum(w["events"] for w in got["windows"]) and got["pops"] >= 1

    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_stream_demo", os.path.join(ROOT, "scripts", "stream_demo.py"))
    jdemo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jdemo)
    chains = []
    generate = jchat.generate

    def recording(*a, **kw):
        out = generate(*a, **kw)
        chains.append([int(t) for t in out[0]])
        return out

    monkeypatch.setattr(jchat, "generate", recording)
    monkeypatch.setenv("EVENTGPT_COMPILE_CACHE", "off")
    monkeypatch.setenv("EGPT_NATIVE_LIB", native.library_path())
    saved = (jnative._LIB, jnative._SEARCHED)
    jnative._LIB, jnative._SEARCHED = None, False
    try:
        answered = jdemo.main(argv)
    finally:
        jnative._LIB, jnative._SEARCHED = saved
    assert answered == 3
    assert [w["ids"] for w in got["windows"]] == chains


def test_an_event_at_a_window_end_opens_the_next_window(built, tmp_path):
    """Four streams shifted by 0, 50, 100 and 150 ms from t = 0: each 50 ms
    window holds exactly one stream, the one event at 150 ms included (a
    float cursor, 0.05 + 0.05 + 0.05, lies past 0.15 and keeps it in the
    third window)."""
    assert 0.05 + 0.05 + 0.05 > 0.15
    parts = [traster.synthetic_event_stream(60 + i, n_events=400, height=48, width=64)
             for i in range(4)]
    for i, a in enumerate(parts):
        a["t"] += np.uint64(50_000 * i)
    parts[0]["t"][0], parts[3]["t"][0] = 0, 150_000
    arr = np.concatenate(parts)
    path = str(tmp_path / "four.npy")
    np.save(path, arr)
    from eventgpt_tpu_torch.cli.infer import load_model

    cfg, params, tok = load_model("tiny-random", "float32", None, None, "cpu")
    out = tdemo.stream_answers(cfg, params, tok, path, window_ms=50, max_windows=4,
                               max_new_tokens=1, device="cpu")
    assert [w["start_us"] for w in out["windows"]] == [0, 50_000, 100_000, 150_000]
    assert [w["events"] for w in out["windows"]] == [400] * 4


def _rig(d, w=160, h=120, frame_dt=0.033):
    rng = np.random.default_rng(1)
    base = (120 + 60 * np.sin(np.arange(w)[None, :] * 0.12) * np.cos(np.arange(h)[:, None] * 0.09)
            + rng.normal(0, 2, (h, w))).clip(0, 255).astype(np.uint8)
    for i, shift in enumerate([0, 3]):
        rgb = np.repeat(np.roll(base, shift, axis=1)[:, :, None], 3, axis=2)
        with open(os.path.join(d, f"frame_{i:06d}.ppm"), "wb") as f:
            f.write(f"P6\n{w} {h}\n255\n".encode() + rgb.tobytes())
        with open(os.path.join(d, f"depth_{i:06d}.pgm"), "wb") as f:
            f.write(f"P5\n{w} {h}\n65535\n".encode()
                    + np.full((h, w), 2000, np.uint16).byteswap().tobytes())
    ev = np.zeros(4000, dtype=[("x", "<u2"), ("y", "<u2"), ("t", "<f8"), ("p", "<u1")])
    ev["x"], ev["y"] = rng.integers(0, w, 4000), rng.integers(0, h, 4000)
    ev["t"] = np.sort(rng.uniform(0, 2 * frame_dt * 1e6, 4000))
    ev["p"] = rng.integers(0, 2, 4000)
    np.save(os.path.join(d, "events.npy"), ev)
    cfg = os.path.join(d, "rig.yaml")
    with open(cfg, "w") as f:
        f.write(f"data_path: {d}\nnum_frames: 2\nframe_dt: {frame_dt}\n"
                "rgb_intrinsics: [200, 200, 80, 60]\nrgb_resolution: [160, 120]\n"
                "event_intrinsics: [200, 200, 80, 60]\nevent_resolution: [160, 120]\n"
                "event_T_base_cam: 0 0 0 1 0.02 0 0\n")
    return cfg


def test_feature_tracker_csv_to_dataset_equals_jax(built, tmp_path):
    d = str(tmp_path)
    cfg = _rig(d)
    out_csv, win = os.path.join(d, "tracks.csv"), os.path.join(d, "win")
    os.makedirs(win)
    res = subprocess.run([native.feature_track_path(), cfg, out_csv, win], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    lines = open(out_csv).read().strip().splitlines()
    assert lines[0].startswith("frame,id") and len(lines) > 5
    assert ttrack.load_tracks_csv(out_csv) == jtrack.load_tracks_csv(out_csv)
    for kw in ({}, {"still_speed": 10.0}, {"min_tracks": 10_000}):
        n_t = ttrack.tracks_to_dataset(out_csv, win, os.path.join(d, "t.json"), **kw)
        n_j = jtrack.tracks_to_dataset(out_csv, win, os.path.join(d, "j.json"), **kw)
        assert n_t == n_j
        assert open(os.path.join(d, "t.json")).read() == open(os.path.join(d, "j.json")).read()
    assert n_t == 0 and ttrack.main([out_csv, win, os.path.join(d, "m.json")]) >= 1
    entries = json.load(open(os.path.join(d, "m.json")))
    assert all(os.path.exists(os.path.join(win, e["event"])) for e in entries)
    rows = ttrack.load_tracks_csv(out_csv)
    assert ttrack.dominant_motion(rows) == jtrack.dominant_motion(rows)


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile: ``build`` raises with the compiler's
    message and leaves no library behind."""
    for d in ("src", "include/egpt"):
        (tmp_path / "native" / d).mkdir(parents=True)
    for name in ("capi.cpp", "feature_track_main.cpp", "raster.cpp"):
        (tmp_path / "native" / "src" / name).write_text("int main() { return 0; }\n")
    (tmp_path / "native" / "src" / "raster.cpp").write_text("this is not C++;\n")
    monkeypatch.setattr(native, "NATIVE", str(tmp_path / "native"))
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_BUILD_DIR", None)
    with pytest.raises(RuntimeError, match="raster.cpp") as exc:
        native.build()
    assert "error" in str(exc.value)
    assert not os.path.exists(native.library_path())
