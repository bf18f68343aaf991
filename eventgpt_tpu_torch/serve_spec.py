"""Adaptive speculation controller: acceptance-driven draft depth.

The port's own copy of ``eventgpt_tpu/serve_spec.py`` (the port imports
nothing of the JAX package), with the same rules and numbers:
``parse_spec_buckets``, ``expected_commits`` and ``SpecController``.

Greedy verification commits the target chain at any draft depth, so the
window is a latency knob, chosen at each dispatch boundary from measured
acceptance:

  * **bucket selection** -- the verify window W from the ``spec_buckets``
    set (K = 0 maps to the draft-free window 1). With per-draft
    acceptance a, a depth-d window commits E(d) = (1 - a^(d+1)) / (1 - a)
    tokens a verify, which costs ~(1 + c d) plain steps (c =
    ``draft_cost``); the bucket maximizing E(d) / (1 + c d) wins, ties to
    the smaller, and ``hysteresis`` keeps the incumbent unless the winner
    beats it by that margin.
  * **per-row depth masking** -- rows whose windowed acceptance
    undershoots the bucket get their drafts from position ``depth`` on
    replaced by the never-accepted ``-1`` filler
    (``models/eventchat._spec_draft_verify``). Fresh rows start at full
    depth.
  * **head pruning** -- per-position accept/offer counts give each
    Medusa head's (or lookup level's) yield; a position whose yield EMA
    falls below ``head_min_yield`` caps every row's depth. Under a mixed
    boundary, live_rows * depth drafts may not exceed ``draft_budget``
    (the piggyback lanes' prefill budget).

Host policy only: deterministic in the harvested acceptance, so the same
traffic gives the same choices. The server consults it at the dispatch
boundary and feeds it at the harvest.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

__all__ = ["SpecController", "parse_spec_buckets", "expected_commits"]


def parse_spec_buckets(spec: Optional[str]) -> Optional[Tuple[int, ...]]:
    """``--spec_buckets`` grammar: comma-separated K values ("0,2,4,8").
    K=0 (and K=1) mean the draft-free window-1 segment.  Returns a
    sorted de-duplicated tuple of WINDOW widths, or None for an
    empty/missing spec (fixed-K serving)."""
    if not spec:
        return None
    out = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        k = int(part)
        if k < 0:
            raise ValueError(f"spec bucket must be >= 0, got {k}")
        out.add(max(k, 1))  # K=0 -> the draft-free window-1 segment
    if not out:
        return None
    return tuple(sorted(out))


def expected_commits(accept: float, depth: int) -> float:
    """E[tokens committed per verify] at ``depth`` drafts under i.i.d.
    per-draft acceptance probability ``accept`` — the Leviathan et al.
    geometric-series expectation: 1 + a + a^2 + ... + a^depth."""
    a = min(max(accept, 0.0), 1.0)
    if a >= 1.0:
        return float(depth + 1)
    return (1.0 - a ** (depth + 1)) / (1.0 - a)


class SpecController:
    """Acceptance-driven draft-depth policy.  Owned by one
    ``ContinuousBatcher`` and called only under the serving engine's
    lock -- it must never grow a thread or lock of its own."""

    def __init__(
        self,
        windows: Sequence[int],
        default_window: int,
        ema_alpha: float = 0.3,
        draft_cost: float = 0.05,
        hysteresis: float = 0.05,
        row_window: int = 4,
        head_min_yield: float = 0.05,
        draft_budget: int = 0,
    ):
        ws = tuple(sorted({max(int(w), 1) for w in windows}))
        if not ws:
            raise ValueError("spec controller needs at least one window")
        self.windows = ws
        self.default_window = max(int(default_window), 1)
        if self.default_window not in ws:
            # The fault-degradation bucket must itself be a primed
            # executable — warmup() warms self.windows, so membership
            # is the cheap static guarantee.
            self.windows = tuple(sorted(ws + (self.default_window,)))
        self.max_window = max(self.windows)
        self.ema_alpha = float(ema_alpha)
        self.draft_cost = max(float(draft_cost), 0.0)
        self.hysteresis = max(float(hysteresis), 0.0)
        self.row_window = max(int(row_window), 1)
        self.head_min_yield = min(max(float(head_min_yield), 0.0), 1.0)
        self.draft_budget = max(int(draft_budget), 0)
        # Acceptance state.  ``accept_ema`` is the per-draft-position
        # acceptance probability (accepted drafts / offered drafts),
        # None until the first drafted verify lands — selection is
        # optimistic (largest bucket) until the traffic says otherwise.
        self.accept_ema: Optional[float] = None
        # Per-position (= per Medusa head / lookup level) yield EMAs,
        # sized to the largest window's draft count; None = no data yet.
        self.pos_yield: List[Optional[float]] = \
            [None] * max(self.max_window - 1, 0)
        # Per-request windowed acceptance: rid -> deque of
        # (accepted, offered) per harvested segment.
        self._rows: Dict[int, Deque[Tuple[int, int]]] = {}
        self.current_window = min(self.default_window, self.max_window)
        # Counters (host-side, surfaced via serving stats + bench).
        self.boundaries = 0
        self.switches = 0
        self.masked_row_boundaries = 0
        self.accepted_total = 0
        self.offered_total = 0

    # -- harvest side -----------------------------------------------------

    def observe(self, per_row: Sequence[Tuple[int, int, int]],
                pos_acc: Sequence[int], pos_off: Sequence[int]) -> None:
        """Feed one harvested segment.  ``per_row``: (rid, accepted,
        offered) per live row; ``pos_acc``/``pos_off``: per-draft-
        position accept/offer counts over the whole segment (length =
        segment window - 1; shorter than max_window is fine)."""
        seg_acc = 0
        seg_off = 0
        for rid, acc, off in per_row:
            if off <= 0:
                continue
            seg_acc += acc
            seg_off += off
            hist = self._rows.get(rid)
            if hist is None:
                hist = self._rows[rid] = deque(maxlen=self.row_window)
            hist.append((acc, off))
        if seg_off > 0:
            self.accepted_total += seg_acc
            self.offered_total += seg_off
            ratio = seg_acc / seg_off
            if self.accept_ema is None:
                self.accept_ema = ratio
            else:
                self.accept_ema += self.ema_alpha * (ratio - self.accept_ema)
        for i, (pa, po) in enumerate(zip(pos_acc, pos_off)):
            if po <= 0 or i >= len(self.pos_yield):
                continue
            y = pa / po
            cur = self.pos_yield[i]
            self.pos_yield[i] = y if cur is None else \
                cur + self.ema_alpha * (y - cur)

    def forget(self, rid: int) -> None:
        """Drop a finished/exported request's window (terminal paths)."""
        self._rows.pop(rid, None)

    # -- dispatch side ----------------------------------------------------

    def _value(self, window: int, accept: float) -> float:
        d = window - 1
        return expected_commits(accept, d) / (1.0 + self.draft_cost * d)

    def select_window(self, live_rows: int = 0,
                      mixed: bool = False) -> int:
        """Pick this boundary's bucket.  Deterministic in the observed
        acceptance history; optimistic (largest bucket) before any
        drafted verify has landed."""
        self.boundaries += 1
        if self.accept_ema is None:
            choice = self.max_window
        else:
            a = self.accept_ema
            best, best_v = None, -1.0
            for w in self.windows:
                v = self._value(w, a)
                if v > best_v + 1e-12:  # ties -> smaller bucket
                    best, best_v = w, v
            cur_v = self._value(self.current_window, a)
            # Hysteresis: keep the incumbent unless the winner clears it
            # by the margin — EMA jitter must not thrash buckets.
            choice = best if best_v > cur_v * (1.0 + self.hysteresis) \
                else self.current_window
        if mixed and self.draft_budget and live_rows > 0:
            # The mixed-boundary draft budget: live_rows * (W-1) draft
            # positions per verify must fit the same per-boundary token
            # budget the lane admission enforces. Degrade to the largest
            # bucket that fits (window 1 always does: zero drafts).
            fitting = [w for w in self.windows
                       if live_rows * (w - 1) <= self.draft_budget]
            cap = max(fitting) if fitting else min(self.windows)
            choice = min(choice, cap)
        if choice != self.current_window:
            self.switches += 1
            self.current_window = choice
        return choice

    def head_cap(self, window: int) -> int:
        """Depth cap from per-position yields (Medusa head pruning /
        lookup-level pruning): the first position whose yield EMA is
        known and below ``head_min_yield`` prunes itself and everything
        deeper (a chain draft's level i is unreachable when level i-1
        dies, so pruning a level prunes the branch)."""
        cap = window - 1
        for i in range(min(cap, len(self.pos_yield))):
            y = self.pos_yield[i]
            if y is not None and y < self.head_min_yield:
                return i
        return cap

    def row_depth(self, rid: int, window: int) -> int:
        """Per-row effective depth in [0, window-1]: the depth whose
        expected value is best under the ROW's windowed acceptance.
        Rows without history run at full depth (optimistic start)."""
        full = window - 1
        hist = self._rows.get(rid)
        if not hist:
            return full
        acc = sum(a for a, _ in hist)
        off = sum(o for _, o in hist)
        if off <= 0:
            return full
        a = acc / off
        best_d, best_v = 0, -1.0
        for d in range(full + 1):
            v = expected_commits(a, d) / (1.0 + self.draft_cost * d)
            if v > best_v + 1e-12:
                best_d, best_v = d, v
        return best_d

    def depths(self, rids: Sequence[Optional[int]],
               window: int) -> Tuple[List[int], int]:
        """Per-row depth vector for one boundary (None rid = free/frozen
        slot, full depth — it commits nothing anyway) and the count of
        rows masked below full depth, after the head-pruning cap."""
        full = window - 1
        cap = min(full, self.head_cap(window))
        out: List[int] = []
        masked = 0
        for rid in rids:
            d = full if rid is None else min(self.row_depth(rid, window), cap)
            if rid is not None and d < full:
                masked += 1
            out.append(d)
        self.masked_row_boundaries += masked
        return out, masked

    # -- observability ----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {
            "windows": list(self.windows),
            "current_window": self.current_window,
            "accept_ema": (round(self.accept_ema, 4)
                           if self.accept_ema is not None else None),
            "accept_ratio_total": (
                round(self.accepted_total / self.offered_total, 4)
                if self.offered_total else None),
            "boundaries": self.boundaries,
            "switches": self.switches,
            "masked_row_boundaries": self.masked_row_boundaries,
            "pos_yield": [round(y, 4) if y is not None else None
                          for y in self.pos_yield],
            "tracked_rows": len(self._rows),
        }
