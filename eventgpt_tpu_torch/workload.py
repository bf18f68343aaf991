"""Trace-driven serving workloads: generation, replay, SLO scoring.

The port's own copy of ``eventgpt_tpu/workload.py`` (numpy and the
standard library only), with the same names, draw order and file format,
so that one spec gives byte-identical traces in both packages
(``tests/test_torch_workload.py``):

  * ``WorkloadSpec`` + ``generate_trace``: a seeded, deterministic request
    trace: Poisson, heavy-tailed bursty (Gamma shape < 1) or on-off
    arrivals, capped lognormal prompt and output lengths, and a session
    mix of one-shot event QA, multi-turn chat (turns of one session share
    their prompt heads, so the prefix cache is exercised) and streaming
    re-submits.
  * ``save_trace`` / ``load_trace``: JSONL. The same spec always writes
    the byte-identical file (sorted keys, rounded arrival stamps).
  * ``SLO`` / ``SLO_CLASSES``: per-request service-level objectives.
    ``interactive`` requests carry TTFT/ITL targets, ``batch`` requests an
    end-to-end latency target; ``SLO.met`` is the attainment predicate
    (inclusive: a request exactly on target has met it), used by the
    batcher's finish-time scoring.
  * ``replay``: open-loop replay of a trace against a
    ``serve.ContinuousBatcher``: request i is submitted at its arrival
    time (scaled by ``rate_mult``) whether or not the server keeps up.
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from eventgpt_tpu_torch.constants import EVENT_TOKEN_INDEX

# The closed set of SLO class names: submit() validates against this
# tuple, so an unknown class fails loudly at the edge (the names are
# metric labels in the JAX package).
SLO_CLASSES = ("interactive", "batch")

ARRIVALS = ("poisson", "gamma", "onoff")
KINDS = ("oneshot", "chat", "stream")


@dataclass(frozen=True)
class SLO:
    """One request's service-level objective. ``None`` targets are
    unarmed; ``met`` requires every ARMED target to hold, inclusively —
    a request exactly on its target has met it."""

    name: str = "interactive"
    ttft_s: Optional[float] = None      # submit -> first committed token
    itl_s: Optional[float] = None       # mean inter-token gap
    latency_s: Optional[float] = None   # submit -> terminal status

    def met(self, ttft_s: float, itl_s: float, latency_s: float) -> bool:
        if self.ttft_s is not None and ttft_s > self.ttft_s:
            return False
        if self.itl_s is not None and itl_s > self.itl_s:
            return False
        if self.latency_s is not None and latency_s > self.latency_s:
            return False
        return True


@dataclass(frozen=True)
class WorkloadSpec:
    """Everything that determines a trace. Two specs that compare equal
    generate byte-identical JSONL — the replayability contract."""

    seed: int = 0
    n_requests: int = 32
    rate_rps: float = 4.0          # mean offered arrival rate
    arrival: str = "poisson"       # poisson | gamma | onoff
    # gamma: inter-arrivals ~ Gamma(shape, 1/(rate*shape)) — same mean
    # rate, CV = 1/sqrt(shape); shape < 1 is burstier than Poisson.
    gamma_shape: float = 0.25
    # onoff: Poisson bursts at rate*(on+off)/on during ON windows,
    # silence during OFF — same mean rate, maximally clumped.
    on_s: float = 1.0
    off_s: float = 3.0
    # Session mix (normalized): one-shot event QA / multi-turn chat /
    # streaming re-submits.
    p_oneshot: float = 0.25
    p_chat: float = 0.5
    p_stream: float = 0.25
    sessions: int = 4              # persistent chat/stream sessions
    head_len: int = 12             # shared system-text head (tokens, incl BOS)
    # Heavy-tailed TEXT tail lengths: lognormal(mu, sigma), capped.
    prompt_mu: float = 2.3
    prompt_sigma: float = 0.8
    prompt_min: int = 4
    prompt_max: int = 48
    output_mu: float = 2.6
    output_sigma: float = 0.9
    output_min: int = 4
    output_max: int = 32
    stream_output: int = 6         # streaming re-submits: short budgets
    # Per-class SLO targets (None/0 disables that target).
    interactive_ttft_s: float = 1.0
    interactive_itl_s: float = 0.25
    batch_latency_s: float = 30.0
    # Token-id range for generated text (kept clear of special ids).
    vocab_lo: int = 5
    vocab_hi: int = 97

    def slo_for(self, slo_class: str) -> SLO:
        """The class's SLO object (the targets the batcher scores)."""
        if slo_class == "interactive":
            return SLO("interactive",
                       ttft_s=self.interactive_ttft_s or None,
                       itl_s=self.interactive_itl_s or None)
        if slo_class == "batch":
            return SLO("batch", latency_s=self.batch_latency_s or None)
        raise ValueError(f"unknown SLO class {slo_class!r}: "
                         f"one of {SLO_CLASSES}")


@dataclass
class TraceRequest:
    """One request of a trace. ``input_ids`` carries exactly one event
    sentinel; ``pixels_seed`` derives the event stream deterministically
    at replay time (``stream_pixels``) instead of storing frames in the
    JSONL — same stream seed = same stream, which is what keys the
    prefix cache's wrong-stream guard."""

    idx: int
    t_arrival: float               # seconds from trace start
    session: int
    kind: str                      # oneshot | chat | stream
    slo_class: str                 # interactive | batch
    input_ids: List[int] = field(default_factory=list)
    pixels_seed: int = 0
    max_new_tokens: int = 8
    turn: int = 0                  # chat turn index within the session


def _inter_arrivals(spec: WorkloadSpec, rng: np.random.Generator
                    ) -> np.ndarray:
    n, rate = spec.n_requests, float(spec.rate_rps)
    if spec.arrival == "poisson":
        return rng.exponential(1.0 / rate, n)
    if spec.arrival == "gamma":
        shape = float(spec.gamma_shape)
        return rng.gamma(shape, 1.0 / (rate * shape), n)
    if spec.arrival == "onoff":
        # Exponential gaps at the boosted ON rate; a gap that crosses an
        # ON-window boundary carries the OFF silence with it.
        period = spec.on_s + spec.off_s
        boosted = rate * period / spec.on_s
        gaps = rng.exponential(1.0 / boosted, n)
        out = np.empty(n)
        t = 0.0
        for i, g in enumerate(gaps):
            t += g
            while (t % period) >= spec.on_s:
                t += spec.off_s - ((t % period) - spec.on_s)
            out[i] = t
        return np.diff(out, prepend=0.0)
    raise ValueError(f"unknown arrival process {spec.arrival!r}: "
                     f"one of {ARRIVALS}")


def _capped_lognormal(rng: np.random.Generator, mu: float, sigma: float,
                      lo: int, hi: int) -> int:
    return int(np.clip(round(float(rng.lognormal(mu, sigma))), lo, hi))


def generate_trace(spec: WorkloadSpec) -> List[TraceRequest]:
    """Deterministic trace from ``spec`` (one rng, fixed draw order —
    the same spec always yields the same requests)."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.cumsum(_inter_arrivals(spec, rng))
    probs = np.asarray([spec.p_oneshot, spec.p_chat, spec.p_stream], float)
    probs = probs / probs.sum()
    # Shared system head: identical TEXT across every stream (the
    # cross-session radix hit); BOS + a fixed filler token, the
    # tests/bench prompt idiom.
    head = [1] + [7] * max(spec.head_len - 1, 0)

    def tail(n: int) -> List[int]:
        return [int(t) for t in
                rng.integers(spec.vocab_lo, spec.vocab_hi, n)]

    # Per-session state: chat dialogs accumulate turns (shared
    # through-event heads grow), streams repeat one fixed short query.
    dialogs: Dict[int, List[int]] = {s: [] for s in range(spec.sessions)}
    turns: Dict[int, int] = {s: 0 for s in range(spec.sessions)}
    stream_query: Dict[int, List[int]] = {}
    out: List[TraceRequest] = []
    n_oneshot = 0
    for i in range(spec.n_requests):
        kind = KINDS[int(rng.choice(3, p=probs))]
        budget = _capped_lognormal(rng, spec.output_mu, spec.output_sigma,
                                   spec.output_min, spec.output_max)
        if kind == "oneshot":
            # Fresh stream, fresh query: only the TEXT head repeats.
            session = spec.sessions + n_oneshot
            n_oneshot += 1
            pixels_seed = 5000 + session
            body = tail(_capped_lognormal(
                rng, spec.prompt_mu, spec.prompt_sigma,
                spec.prompt_min, spec.prompt_max))
            turn = 0
            slo_class = "batch"
        else:
            session = int(rng.integers(0, spec.sessions))
            pixels_seed = 1000 + session
            if kind == "stream":
                # The SAME short query resubmitted against a live
                # stream — a full-prompt repeat, the deepest radix hit.
                if session not in stream_query:
                    stream_query[session] = tail(spec.prompt_min)
                body = list(stream_query[session])
                budget = min(budget, spec.stream_output)
                turn = 0
            else:  # chat: the dialog grows, sharing its head with
                   # every earlier turn of the session
                new = tail(_capped_lognormal(
                    rng, spec.prompt_mu, spec.prompt_sigma,
                    spec.prompt_min, spec.prompt_max))
                if len(dialogs[session]) + len(new) > spec.prompt_max:
                    dialogs[session] = []     # conversation rolls over
                    turns[session] = 0
                dialogs[session] = dialogs[session] + new
                body = list(dialogs[session])
                turns[session] += 1
                turn = turns[session]
            slo_class = "interactive"
        out.append(TraceRequest(
            idx=i,
            t_arrival=round(float(arrivals[i]), 6),
            session=session,
            kind=kind,
            slo_class=slo_class,
            input_ids=head + [EVENT_TOKEN_INDEX] + body,
            pixels_seed=pixels_seed,
            max_new_tokens=budget,
        ))
    return out


def cache_positions(req: TraceRequest, num_event_tokens: int) -> int:
    """Prompt length in KV-cache positions (text tokens + the event
    block's expansion) — the server-sizing arithmetic."""
    n_text = sum(1 for t in req.input_ids if t != EVENT_TOKEN_INDEX)
    return n_text + num_event_tokens


def stream_pixels(shape: Tuple[int, ...], seed: int) -> np.ndarray:
    """The event stream behind ``pixels_seed``: deterministic f32 frames
    (same seed = byte-identical stream, so traces replay byte-for-byte
    without storing pixels)."""
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- JSONL persistence -----------------------------------------------------

def save_trace(path: str, spec: WorkloadSpec,
               trace: List[TraceRequest]) -> None:
    """Header line (version + spec) then one line per request. Sorted
    keys + the generator's rounded arrival stamps make the file a pure
    function of ``spec``: regenerating writes the byte-identical file."""
    with open(path, "w") as f:
        f.write(json.dumps({"version": 1, "spec": asdict(spec)},
                           sort_keys=True) + "\n")
        for r in trace:
            f.write(json.dumps(asdict(r), sort_keys=True) + "\n")


def load_trace(path: str) -> Tuple[WorkloadSpec, List[TraceRequest]]:
    with open(path) as f:
        header = json.loads(f.readline())
        if header.get("version") != 1:
            raise ValueError(f"unknown trace version in {path}: "
                             f"{header.get('version')!r}")
        spec = WorkloadSpec(**header["spec"])
        trace = [TraceRequest(**json.loads(line))
                 for line in f if line.strip()]
    return spec, trace


# -- open-loop replay ------------------------------------------------------

def replay(batcher, trace: List[TraceRequest], *,
           pixels_for: Callable[[TraceRequest], Any],
           rate_mult: float = 1.0, paced: bool = True,
           slo_for: Optional[Callable[[TraceRequest], Optional[SLO]]] = None,
           ) -> Dict[str, Any]:
    """Replay ``trace`` against a live ``ContinuousBatcher``.

    OPEN loop: request i is submitted at ``t_arrival / rate_mult`` on
    the wall clock whether or not the server has room — backlog grows
    when the server falls behind, which is exactly what the goodput
    curve must see (``rate_mult`` is the offered-load dial). ``paced=
    False`` submits in arrival order as fast as the loop runs (the
    throughput/A-B form — per-row greedy chains are scheduling-
    independent, so chains match the paced replay byte-for-byte).

    ``slo_for`` maps a trace request to the SLO object submitted with it
    (None = plain submit, the disarmed A/B arm). Returns ``finished``
    keyed by TRACE idx (not rid), the rid map, and the wall duration.
    """
    rid_of: Dict[int, int] = {}
    i, n = 0, len(trace)

    def busy() -> bool:
        return bool(batcher.queue) or any(
            r is not None for r in batcher.rows)

    t0 = time.perf_counter()
    while i < n or busy():
        now = time.perf_counter() - t0
        while i < n and (not paced
                         or trace[i].t_arrival / rate_mult <= now):
            r = trace[i]
            rid_of[r.idx] = batcher.submit(
                r.input_ids, pixels_for(r), r.max_new_tokens,
                slo=slo_for(r) if slo_for is not None else None,
            )
            i += 1
        if busy():
            batcher.step()
        elif i < n:
            # Idle server, next arrival in the future: sleep toward it
            # in short hops so a submit never lands very late.
            now = time.perf_counter() - t0
            time.sleep(min(max(
                trace[i].t_arrival / rate_mult - now, 0.0), 0.005))
    # Queue and rows are drained; collect the accumulated finishes (and
    # any trailing in-flight segment) through the normal drain path.
    finished_by_rid = batcher.run_until_drained()
    duration = time.perf_counter() - t0
    return {
        "rids": rid_of,
        "finished": {idx: finished_by_rid[rid]
                     for idx, rid in rid_of.items()},
        "duration_s": duration,
    }
