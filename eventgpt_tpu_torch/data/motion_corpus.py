"""Deterministic synthetic motion-QA corpus: the reproducible in-tree
distribution of the trained-draft acceptance study
(``scripts/medusa_acceptance.py``).

The port's own numpy copy of ``eventgpt_tpu/data/motion_corpus.py``: the
same seeds and the same arithmetic, so a build by either package is
byte-identical (every ``events/*.npy``, ``train.json`` and ``eval.json``).

Each sample is a point cloud drifting in one of 8 compass directions at a
class-determined speed; the event stream is written in the framework's
native structured ``{x,y,t,p}`` npy layout (``ops/raster.STREAM_DTYPE``,
which ``ops/raster.load_event_npy`` reads), and the caption states the direction and speed plus a per-sample track count:

    "moving down-left at 4.0 px per frame over 17 tracks."

Why this shape: the direction/speed mapping is *learnable from pixels* (a
finetuned model becomes deterministic on it), while the track count varies
per sample — so a drafting rule that can only echo previously served text
(``_suffix_vote_drafts``) faces genuine branch points, and trained Medusa
heads, which condition on the model's own hidden state, can be measured
against it fairly on identical traffic.

"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from eventgpt_tpu_torch.ops.raster import STREAM_DTYPE

# 8-way compass in image coordinates (+y down), the JAX package's
# data/feature_track vocabulary.
DIRECTIONS: Tuple[str, ...] = (
    "right", "down-right", "down", "down-left",
    "left", "up-left", "up", "up-right",
)

MOTION_QUESTION = "What is the dominant motion direction in this clip?"

_CANVAS = 64          # event-camera resolution of the synthetic scene
_WINDOW_US = 50_000   # one 50 ms stream per sample (the reference's window)


def _class_speed(direction_idx: int) -> float:
    """Speed is a deterministic function of the class so the pixel->caption
    mapping is fully learnable (1.0, 1.5, ... 4.5 px/frame)."""
    return 1.0 + 0.5 * direction_idx


def synth_event_stream(
    direction_idx: int, n_tracks: int, seed: int,
    n_frames: int = 5,
) -> np.ndarray:
    """Structured {x,y,t,p} stream: ``n_tracks`` points drifting along the
    class direction across ``n_frames`` equal-count windows."""
    rng = np.random.default_rng(seed)
    ang = direction_idx * (np.pi / 4.0)
    dx, dy = np.cos(ang), np.sin(ang)  # +y down is implicit in raster
    speed = _class_speed(direction_idx)
    margin = speed * n_frames + 2
    px = rng.uniform(margin, _CANVAS - margin, size=n_tracks)
    py = rng.uniform(margin, _CANVAS - margin, size=n_tracks)
    pol = rng.integers(0, 2, size=n_tracks)

    xs, ys, ts, ps = [], [], [], []
    events_per_frame = 12  # events per track per frame: a visible dot trail
    for f in range(n_frames):
        fx = px + dx * speed * f
        fy = py + dy * speed * f
        jitter = rng.normal(scale=0.4, size=(events_per_frame, n_tracks, 2))
        t0 = f * (_WINDOW_US // n_frames)
        t1 = (f + 1) * (_WINDOW_US // n_frames)
        for e in range(events_per_frame):
            xs.append(fx + jitter[e, :, 0])
            ys.append(fy + jitter[e, :, 1])
            ts.append(rng.integers(t0, t1, size=n_tracks))
            ps.append(pol)
    x = np.clip(np.concatenate(xs), 0, _CANVAS - 1)
    y = np.clip(np.concatenate(ys), 0, _CANVAS - 1)
    t = np.concatenate(ts)
    p = np.concatenate(ps)
    order = np.argsort(t, kind="stable")
    out = np.empty(x.shape[0], dtype=STREAM_DTYPE)  # the ONE shared layout
    out["x"], out["y"] = x[order].astype(np.uint16), y[order].astype(np.uint16)
    out["t"], out["p"] = t[order], p[order].astype(np.uint8)
    return out


def caption(direction_idx: int, n_tracks: int) -> str:
    return (f"moving {DIRECTIONS[direction_idx]} at "
            f"{_class_speed(direction_idx):.1f} px per frame over "
            f"{n_tracks} tracks.")


def build_motion_corpus(
    out_dir: str, n_train: int = 96, n_eval: int = 16, seed: int = 0,
) -> Dict[str, str]:
    """Write events/*.npy + train.json + eval.json under ``out_dir``.

    Returns {"train": ..., "eval": ..., "events": ...} paths. Train and
    eval draw from the same class structure but disjoint seeds, so eval
    streams (and their track counts) are unseen.
    """
    ev_dir = os.path.join(out_dir, "events")
    os.makedirs(ev_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    def make_split(name: str, n: int, seed_base: int) -> str:
        entries: List[dict] = []
        for i in range(n):
            d = i % len(DIRECTIONS)
            n_tracks = int(rng.integers(5, 40))
            stream = synth_event_stream(d, n_tracks, seed_base + i)
            npy = f"{name}_{i:04d}.npy"
            np.save(os.path.join(ev_dir, npy), stream)
            entries.append({
                "id": f"motion_{name}_{i:04d}",
                "event": npy,
                "conversations": [
                    {"from": "human", "value": f"<event>\n{MOTION_QUESTION}"},
                    {"from": "gpt", "value": caption(d, n_tracks)},
                ],
            })
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(entries, f, indent=1)
        return path

    train = make_split("train", n_train, seed_base=10_000)
    evalp = make_split("eval", n_eval, seed_base=20_000)
    return {"train": train, "eval": evalp, "events": ev_dir}
