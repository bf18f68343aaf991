"""DSEC-format dataset IO: HDF5 event extraction and the directory layout.

The port of ``eventgpt_tpu/data/dsec.py``: event extraction by index or by
time window through the ``ms_to_idx`` millisecond table with the
``t_offset`` correction, the generic h5/yaml dict loaders, the
content-level directory comparison, and the lazily cached DSEC directory
accessors (images / events / tracks / QA labels). ``h5py`` and ``yaml``
are imported inside the functions that need them; where one is missing
(the card machine has neither) the call raises an ``ImportError`` naming
the package.
"""

from __future__ import annotations

import filecmp
import json
import os
from functools import cached_property
from typing import Dict, List

import numpy as np

EventDict = Dict[str, np.ndarray]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading DSEC events.h5 needs the h5py package, which is not "
                          "installed") from e
    return h5py


# ---------------------------------------------------------------------------
# HDF5 event extraction


def get_num_events(h5_path: str) -> int:
    """Total event count."""
    h5py = _h5py()
    with h5py.File(h5_path, "r") as f:
        return int(f["events"]["t"].shape[0])


def extract_from_h5_by_index(h5_path: str, lo: int, hi: int) -> EventDict:
    """Events in [lo, hi) by index.

    Timestamps are returned with ``t_offset`` applied, in microseconds.
    """
    h5py = _h5py()
    with h5py.File(h5_path, "r") as f:
        ev = f["events"]
        t_offset = int(np.asarray(f["t_offset"])) if "t_offset" in f else 0
        return {
            "x": np.asarray(ev["x"][lo:hi]),
            "y": np.asarray(ev["y"][lo:hi]),
            "t": np.asarray(ev["t"][lo:hi], dtype=np.int64) + t_offset,
            "p": np.asarray(ev["p"][lo:hi]),
        }


def extract_from_h5_by_timewindow(
    h5_path: str, t_min_us: int, t_max_us: int
) -> EventDict:
    """Events with t in [t_min_us, t_max_us) through the ``ms_to_idx``
    lookup: the table maps millisecond -> first event index, bounding the
    fine binary search to a 1 ms slab.
    """
    h5py = _h5py()
    with h5py.File(h5_path, "r") as f:
        ev = f["events"]
        t_offset = int(np.asarray(f["t_offset"])) if "t_offset" in f else 0
        rel_min = t_min_us - t_offset
        rel_max = t_max_us - t_offset

        ms_to_idx = np.asarray(f["ms_to_idx"]) if "ms_to_idx" in f else None
        n = ev["t"].shape[0]
        if ms_to_idx is not None:
            ms_lo = max(min(rel_min // 1000, len(ms_to_idx) - 1), 0)
            lo_bound = int(ms_to_idx[ms_lo])
            ms_hi = rel_max // 1000 + 1
            if ms_hi >= len(ms_to_idx):
                # Window extends past the lookup table: events after the last
                # millisecond tick still belong to it — scan to the end.
                hi_bound = n
            else:
                hi_bound = int(ms_to_idx[max(ms_hi, 0)])
        else:
            lo_bound, hi_bound = 0, n
        t_slab = np.asarray(ev["t"][lo_bound:hi_bound], dtype=np.int64)
        lo = lo_bound + int(np.searchsorted(t_slab, rel_min, side="left"))
        hi = lo_bound + int(np.searchsorted(t_slab, rel_max, side="left"))
        return {
            "x": np.asarray(ev["x"][lo:hi]),
            "y": np.asarray(ev["y"][lo:hi]),
            "t": np.asarray(ev["t"][lo:hi], dtype=np.int64) + t_offset,
            "p": np.asarray(ev["p"][lo:hi]),
        }


def h5_file_to_dict(h5_path: str) -> Dict[str, np.ndarray]:
    """Whole-file flatten."""
    h5py = _h5py()
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(h5_path, "r") as f:
        f.visititems(visit)
    return out


def yaml_file_to_dict(path: str) -> dict:
    """YAML loader."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a YAML file needs the PyYAML package (yaml), which is "
                          "not installed") from e

    with open(path) as f:
        return yaml.safe_load(f)


def compare_dirs(dir1: str, dir2: str) -> bool:
    """Recursive content-level directory equality."""
    cmp = filecmp.dircmp(dir1, dir2)
    if cmp.left_only or cmp.right_only or cmp.funny_files:
        return False
    _, mismatch, errors = filecmp.cmpfiles(dir1, dir2, cmp.common_files, shallow=False)
    if mismatch or errors:
        return False
    return all(
        compare_dirs(os.path.join(dir1, d), os.path.join(dir2, d))
        for d in cmp.common_dirs
    )


# ---------------------------------------------------------------------------
# DSEC directory layout


class ImageDirectory:
    def __init__(self, root: str):
        self.root = root

    @cached_property
    def timestamps(self) -> np.ndarray:
        return np.loadtxt(os.path.join(self.root, "timestamps.txt"), dtype=np.int64)

    @cached_property
    def image_files(self) -> List[str]:
        d = os.path.join(self.root, "left")
        if not os.path.isdir(d):
            d = self.root
        return sorted(
            os.path.join(d, f) for f in os.listdir(d)
            if f.endswith((".png", ".jpg", ".ppm"))
        )


class EventDirectory:
    def __init__(self, root: str):
        self.root = root

    @property
    def event_file(self) -> str:
        return os.path.join(self.root, "left", "events.h5")

    def num_events(self) -> int:
        return get_num_events(self.event_file)

    def by_index(self, lo: int, hi: int) -> EventDict:
        return extract_from_h5_by_index(self.event_file, lo, hi)

    def by_timewindow(self, t_min_us: int, t_max_us: int) -> EventDict:
        return extract_from_h5_by_timewindow(self.event_file, t_min_us, t_max_us)


class TracksDirectory:
    def __init__(self, root: str):
        self.root = root

    @cached_property
    def tracks(self) -> np.ndarray:
        return np.load(os.path.join(self.root, "left", "tracks.npy"))


class LabelDirectory:
    def __init__(self, root: str):
        self.root = root

    @cached_property
    def qa(self) -> list:
        with open(os.path.join(self.root, "QADataset.json")) as f:
            return json.load(f)


class DSECDirectory:
    """Lazy accessors over a DSEC sequence directory: images/, events/,
    object_detections/, and the QA label file."""

    def __init__(self, root: str):
        self.root = root
        self.images = ImageDirectory(os.path.join(root, "images"))
        self.events = EventDirectory(os.path.join(root, "events"))
        self.tracks = TracksDirectory(os.path.join(root, "object_detections"))
        self.labels = LabelDirectory(root)
