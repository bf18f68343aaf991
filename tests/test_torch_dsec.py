"""The port's DSEC IO (``data/dsec.py``) against the JAX package's, on the
synthetic sequence of ``tests/test_dsec.py``: 10k events over 100 ms with
an ``ms_to_idx`` table and a ``t_offset``; every reader gives equal arrays.
Without ``h5py`` (the card machine) a reader raises naming the package."""

import json
import os
import sys

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from eventgpt_tpu.data import dsec as jdsec  # noqa: E402
from eventgpt_tpu_torch.data import dsec as tdsec  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec_seq")
    ev_dir = root / "events" / "left"
    ev_dir.mkdir(parents=True)
    n, t_offset = 10_000, 5_000_000
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(0, 100_000, n)).astype(np.int64)
    with h5py.File(ev_dir / "events.h5", "w") as f:
        g = f.create_group("events")
        g["x"] = rng.integers(0, 640, n).astype(np.uint16)
        g["y"] = rng.integers(0, 480, n).astype(np.uint16)
        g["t"] = t
        g["p"] = rng.integers(0, 2, n).astype(np.uint8)
        f["t_offset"] = t_offset
        f["ms_to_idx"] = np.searchsorted(t, np.arange(101) * 1000, side="left")
    (root / "images").mkdir()
    np.savetxt(root / "images" / "timestamps.txt", np.arange(5) * 20_000 + t_offset, fmt="%d")
    det = root / "object_detections" / "left"
    det.mkdir(parents=True)
    np.save(det / "tracks.npy", np.arange(12.0).reshape(3, 4))
    (root / "QADataset.json").write_text(json.dumps([{"id": 0, "q": "?"}]))
    # A file whose ms table ends before its last events.
    tail = root / "tail.h5"
    tt = np.concatenate([np.arange(50), 1500 + np.arange(5)]).astype(np.int64)
    with h5py.File(tail, "w") as f:
        g = f.create_group("events")
        g["x"], g["y"] = np.arange(55, dtype=np.uint16), np.zeros(55, np.uint16)
        g["t"], g["p"] = tt, np.ones(55, np.uint8)
        f["t_offset"] = 0
        f["ms_to_idx"] = np.searchsorted(tt, np.array([0, 1000]))
    return str(root), t_offset


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_readers_equal_jax(root):
    d, t0 = root
    h5 = os.path.join(d, "events", "left", "events.h5")
    assert tdsec.get_num_events(h5) == jdsec.get_num_events(h5) == 10_000
    for lo, hi in ((0, 10), (100, 200), (9990, 10_000), (5, 5)):
        _equal(tdsec.extract_from_h5_by_index(h5, lo, hi), jdsec.extract_from_h5_by_index(h5, lo, hi))
    for a, b in ((10_000, 20_000), (0, 200_000), (200_000, 300_000), (-5_000, 999),
                 (99_500, 150_000), (3_333, 3_334)):
        got = tdsec.extract_from_h5_by_timewindow(h5, t0 + a, t0 + b)
        _equal(got, jdsec.extract_from_h5_by_timewindow(h5, t0 + a, t0 + b))
    tail = os.path.join(d, "tail.h5")
    got = tdsec.extract_from_h5_by_timewindow(tail, 0, 2000)
    _equal(got, jdsec.extract_from_h5_by_timewindow(tail, 0, 2000))
    assert len(got["t"]) == 55
    _equal(tdsec.h5_file_to_dict(h5), jdsec.h5_file_to_dict(h5))


def test_accessors_yaml_and_compare_dirs_equal_jax(root, tmp_path):
    d, _ = root
    td, jd = tdsec.DSECDirectory(d), jdsec.DSECDirectory(d)
    np.testing.assert_array_equal(td.images.timestamps, jd.images.timestamps)
    assert td.images.image_files == jd.images.image_files
    assert td.events.num_events() == jd.events.num_events()
    _equal(td.events.by_index(7, 70), jd.events.by_index(7, 70))
    t0 = int(td.images.timestamps[0])
    _equal(td.events.by_timewindow(t0 + 1, t0 + 40_000), jd.events.by_timewindow(t0 + 1, t0 + 40_000))
    np.testing.assert_array_equal(td.tracks.tracks, jd.tracks.tracks)
    assert td.labels.qa == jd.labels.qa
    y = tmp_path / "rig.yaml"
    y.write_text("a: 1\nb: [2, 3]\nc: {d: x}\n")
    assert tdsec.yaml_file_to_dict(str(y)) == jdsec.yaml_file_to_dict(str(y))
    a, b = tmp_path / "a", tmp_path / "b"
    for x in (a, b):
        (x / "sub").mkdir(parents=True)
        (x / "sub" / "f.txt").write_text("same")
    assert tdsec.compare_dirs(str(a), str(b)) == jdsec.compare_dirs(str(a), str(b)) is True
    (b / "sub" / "f.txt").write_text("diff")
    assert tdsec.compare_dirs(str(a), str(b)) == jdsec.compare_dirs(str(a), str(b)) is False


def test_missing_h5py_and_yaml_are_named(root, monkeypatch):
    d, _ = root
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="h5py"):
        tdsec.DSECDirectory(d).events.num_events()
    with pytest.raises(ImportError, match="yaml"):
        tdsec.yaml_file_to_dict(os.path.join(d, "QADataset.json"))
