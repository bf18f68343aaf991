"""Feature-track -> training-data adapter: the consumer of the native
offline generator, the port of ``eventgpt_tpu/data/feature_track.py``.

``egpt_feature_track <rig.yaml> tracks.csv <npy_dir>`` (built by
``eventgpt_tpu_torch.native.build`` from ``native/src/feature_track_main.cpp``)
detects and KLT-tracks features on RGB frames, projects them into the event
camera, and writes per-interval event windows as structured {x,y,t,p} .npy
(the layout ``ops/raster.load_event_npy`` reads). This module turns that
output into auto-labelled motion-QA samples in the dataset-JSON schema
``train/data.EventChatDataset`` reads.

Labels are derived, not annotated: the per-interval median track
displacement gives a dominant motion direction (8-way compass in IMAGE
coordinates: +x = right, +y = down) and a pixel speed.
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

# 8-way compass by displacement angle; image coords (+y is DOWN).
_DIRS = ["right", "down-right", "down", "down-left",
         "left", "up-left", "up", "up-right"]

MOTION_QUESTION = "What is the dominant motion direction in this clip?"


def load_tracks_csv(path: str) -> List[Dict[str, float]]:
    """Rows of egpt_feature_track's tracks.csv as typed dicts."""
    out: List[Dict[str, float]] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out.append({k: float(v) for k, v in row.items()})
    return out


def dominant_motion(rows: Sequence[Dict[str, float]]):
    """Median displacement over one frame's tracks -> (direction word,
    speed px/frame, n_tracks). Median (not mean) so a few RANSAC
    stragglers cannot flip the direction."""
    dx = float(np.median([r["cur_x"] - r["prev_x"] for r in rows]))
    dy = float(np.median([r["cur_y"] - r["prev_y"] for r in rows]))
    speed = math.hypot(dx, dy)
    ang = math.atan2(dy, dx)  # image coords: +y down
    sector = int(round(ang / (math.pi / 4))) % 8
    return _DIRS[sector], speed, len(rows)


def tracks_to_dataset(
    csv_path: str,
    events_dir: str,
    out_json: str,
    min_tracks: int = 3,
    min_speed: float = 0.5,
    still_speed: Optional[float] = None,
) -> int:
    """tracks.csv + events_%06d.npy windows -> EventChatDataset JSON.

    One sample per tracked frame interval with >= ``min_tracks``
    surviving tracks: the interval's event window is the visual input,
    the question asks for the dominant motion, the answer states the
    compass direction. The two speed knobs are independent:
    ``still_speed``, when given, labels
    intervals below it "mostly still" (a trainable negative class);
    ``min_speed`` then DROPS intervals below it that were not claimed as
    still — too slow for a direction label, too fast for a still one.
    With the default ``still_speed=None`` slow intervals are simply
    filtered. Returns the number of samples written.
    """
    rows = load_tracks_csv(csv_path)
    by_frame: Dict[int, List[Dict[str, float]]] = {}
    for r in rows:
        by_frame.setdefault(int(r["frame"]), []).append(r)

    entries = []
    for frame in sorted(by_frame):
        rows_f = by_frame[frame]
        if len(rows_f) < min_tracks:
            continue
        npy = f"events_{frame:06d}.npy"
        if not os.path.exists(os.path.join(events_dir, npy)):
            continue
        direction, speed, n = dominant_motion(rows_f)
        if still_speed is not None and speed < still_speed:
            answer = ("The scene is mostly still; the tracked features "
                      "barely move between frames.")
        elif speed < min_speed:
            continue
        else:
            answer = (f"The dominant motion is toward the {direction}, "
                      f"at about {speed:.1f} pixels per frame across "
                      f"{n} tracked features.")
        entries.append({
            "id": f"feature_track_{frame:06d}",
            "event": npy,
            "conversations": [
                {"from": "human", "value": f"<event>\n{MOTION_QUESTION}"},
                {"from": "gpt", "value": answer},
            ],
        })
    with open(out_json, "w") as f:
        json.dump(entries, f, indent=1)
    return len(entries)


def main(argv=None):
    """CLI: egpt_feature_track output -> dataset JSON.

    python -m eventgpt_tpu_torch.data.feature_track tracks.csv win/ qa.json
    then train on it: python -m eventgpt_tpu_torch.cli.train --data_path qa.json
    --event_folder win/
    """
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("tracks_csv")
    p.add_argument("events_dir")
    p.add_argument("out_json")
    p.add_argument("--min_tracks", type=int, default=3)
    p.add_argument("--min_speed", type=float, default=0.5,
                   help="drop intervals slower than this (px/frame)")
    p.add_argument("--still_speed", type=float, default=None,
                   help="label intervals below this 'mostly still' "
                        "instead of dropping them")
    args = p.parse_args(argv)
    n = tracks_to_dataset(args.tracks_csv, args.events_dir, args.out_json,
                          min_tracks=args.min_tracks,
                          min_speed=args.min_speed,
                          still_speed=args.still_speed)
    print(f"wrote {n} samples to {args.out_json}")
    return n


if __name__ == "__main__":
    main()
