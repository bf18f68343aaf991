"""Deterministic, site-keyed fault injection for the serving and training stack.

Port of ``eventgpt_tpu/faults.py``. Every failure path the runtime claims to
survive (a scheduler death, a dispatch fault with a segment in flight, a
replica kill, a transport failure) must be reachable from a test, or the
handling code is dead weight. Call sites name themselves
(``faults.maybe_fail("serve.step")``) and a test or an operator chooses which
sites fire, when and how; with nothing armed a probe is one module-global
``is None`` check.

Spec grammar (the ``EGPT_FAULTS`` variable, ``cli/serve --faults`` or
``faults.configure()``)::

    site:key=value[,key=value];site2:...

  * ``n=K``        fire on the K-th call to the site (1-based), once;
  * ``every=K``    fire on every K-th call;
  * ``p=X``        fire with probability X per call, drawn from a per-site
                   ``random.Random`` seeded by (seed, site): the same call
                   sequence fires the same calls in every run, and in both
                   packages;
  * ``times=K``    cap the fires at K (default: unlimited for ``p`` and
                   ``every``, one for ``n``);
  * ``delay=S``    ``maybe_delay`` sleeps S seconds per matching call (the
                   same n/every/p gating; by default every call).

``EGPT_FAULTS_SEED`` seeds ``p`` when ``configure`` gets no seed.

Sites wired in the port (a test arms each one, ``tests/test_torch_import_hygiene.py``
checks it, and each is a site of the JAX package): ``serve.step``,
``serve.admit``, ``serve.dispatch`` (the segment-dispatch boundary, possibly
with a segment in flight), ``serve.mixed_dispatch`` (the lane boundary of a
mixed segment: the boundary degrades to a plain decode dispatch and every
admitting lane re-queues), ``serve.prefix_copy`` (the prefix entry copy at
admission), ``serve.spec_adapt`` (the adaptive window choice: the boundary
takes the fixed default window at full depth), ``serve.preempt`` (that
admission defers instead, no victim touched), ``serve.spill`` (inside the
gather-to-host boundary, before any pool change: the victim drops and
re-prefills), ``serve.mem_guard`` (the memory headroom guard's decision:
the boundary admits as if the guard were off), ``serve.loop`` (``cli/serve.ServingEngine``'s scheduler
thread), ``fleet.route`` / ``fleet.probe`` / ``fleet.replica_kill``
(``fleet.Fleet``), ``procfleet.rpc`` (``rpc.call``, per attempt) and
``train.step`` (the trainer's micro-batch boundary).

Injected failures raise ``InjectedFault`` (a ``RuntimeError``): the handling
layers treat it exactly like a real fault. Every fire also counts in the
Prometheus counter ``egpt_fault_trips_total{site,kind}`` (``obs/metrics.py``),
so a chaos drill shows on ``/metrics`` beside the breaker and restart
counters it provokes; a site outside the counter's enum counts as ``other``.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

from eventgpt_tpu_torch.obs import metrics as obs_metrics


class InjectedFault(RuntimeError):
    """A deterministic injected failure (raised only when a plan is armed)."""


class _Site:
    __slots__ = ("name", "nth", "every", "p", "times", "delay_s", "calls", "fires", "_rng")

    def __init__(self, name: str, nth: int = 0, every: int = 0, p: float = 0.0,
                 times: int = 0, delay_s: float = 0.0, seed: int = 0):
        self.name = name
        self.nth = nth
        self.every = every
        self.p = p
        # n=K without a cap fires once (the K-th call); 0 = unlimited.
        self.times = times if times else (1 if nth else 0)
        self.delay_s = delay_s
        self.calls = 0
        self.fires = 0
        # Seeded per (seed, site): the same draws in every run for the same
        # call order, decorrelated between sites.
        self._rng = random.Random(f"{seed}:{name}")

    def should_fire(self) -> bool:
        self.calls += 1
        if self.times and self.fires >= self.times:
            return False
        hit = False
        if self.nth:
            hit = self.calls == self.nth
        elif self.every:
            hit = self.calls % self.every == 0
        elif self.p:
            hit = self._rng.random() < self.p
        elif self.delay_s:
            hit = True  # a delay-only clause gates every call
        if hit:
            self.fires += 1
        return hit


class FaultRegistry:
    """A parsed fault plan: site name -> firing rule. Thread-safe: the
    engine's scheduler, the HTTP handlers and a fleet's supervisor probe
    sites from several threads, so the site map and its counters move only
    under ``_lock``."""

    def __init__(self, spec: str, seed: int = 0):
        self.spec = spec
        self.seed = seed
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {}
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            if ":" not in clause:
                raise ValueError(f"bad fault clause {clause!r} (want site:key=value,...)")
            name, _, kvs = clause.partition(":")
            kw: Dict[str, float] = {}
            for kv in kvs.split(","):
                k, _, v = kv.strip().partition("=")
                if k not in ("n", "every", "p", "times", "delay"):
                    raise ValueError(f"unknown fault key {k!r} in {clause!r} "
                                     f"(known: n, every, p, times, delay)")
                kw[k] = float(v)
            self._sites[name.strip()] = _Site(
                name.strip(), nth=int(kw.get("n", 0)), every=int(kw.get("every", 0)),
                p=kw.get("p", 0.0), times=int(kw.get("times", 0)),
                delay_s=kw.get("delay", 0.0), seed=seed)

    def check(self, site: str, want_delay: bool) -> Optional[_Site]:
        """Advance the site's call counter; the site when it fires, else None.
        A ``delay=`` clause is a delay rule that only ``maybe_delay`` drives;
        every other clause is a failure rule that only ``maybe_fail`` drives,
        so a site wired with both probes advances its rule once a pass."""
        with self._lock:
            s = self._sites.get(site)
            if s is None or bool(s.delay_s) is not want_delay:
                return None
            return s if s.should_fire() else None

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {n: {"calls": s.calls, "fires": s.fires} for n, s in self._sites.items()}


_registry: Optional[FaultRegistry] = None


def configure(spec: Optional[str] = None, seed: Optional[int] = None) -> None:
    """Arm fault injection from ``spec`` (``EGPT_FAULTS`` when None); an empty
    spec disarms."""
    global _registry
    if spec is None:
        spec = os.environ.get("EGPT_FAULTS", "")
    if seed is None:
        seed = int(os.environ.get("EGPT_FAULTS_SEED", "0"))
    _registry = FaultRegistry(spec, seed) if spec.strip() else None


def disable() -> None:
    global _registry
    _registry = None


def enabled() -> bool:
    return _registry is not None


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site {calls, fires} of the armed plan ({} when disarmed)."""
    return _registry.stats() if _registry is not None else {}


def _site_label(site: str) -> str:
    """The bounded metric label of a fault site: a site of the counter's
    enum labels truthfully, anything else (a test's synthetic site) folds
    into ``other``."""
    enum = obs_metrics.METRIC_LABELS["egpt_fault_trips_total"]["site"]
    return site if site in enum else "other"


def maybe_fail(site: str) -> None:
    """Raise ``InjectedFault`` when the armed plan fires this call of
    ``site``."""
    if _registry is None:
        return
    s = _registry.check(site, want_delay=False)
    if s is not None:
        obs_metrics.FAULT_TRIPS.inc(site=_site_label(site), kind="fail")
        raise InjectedFault(f"injected fault at {site} (call #{s.calls}, fire #{s.fires})")


def maybe_delay(site: str) -> float:
    """Sleep the site's delay when its ``delay=`` rule fires; returns the
    seconds slept."""
    if _registry is None:
        return 0.0
    s = _registry.check(site, want_delay=True)
    if s is None:
        return 0.0
    obs_metrics.FAULT_TRIPS.inc(site=_site_label(site), kind="delay")
    time.sleep(s.delay_s)
    return s.delay_s


# Armed from the environment at import, as in the JAX package: child
# processes inherit the operator's plan without plumbing.
if os.environ.get("EGPT_FAULTS"):
    configure()
