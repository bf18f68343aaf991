"""Failure detection and recovery for long training runs.

A copy of ``eventgpt_tpu/train/resilience.py`` for one process:

``GracefulShutdown``
    Converts SIGTERM/SIGINT into a flag the training loop polls at
    micro-batch boundaries. The trainer saves a full-state checkpoint
    (``ckpt_preempt_step{n}``) and returns cleanly; relaunching the same
    command with ``--resume_from auto`` continues from it.

``Heartbeat``
    Atomic (tmp+rename) liveness file ``heartbeat.json`` with the last
    optimizer step, loss and wall time. ``Heartbeat.is_stale(path, timeout)``
    is the check an external watchdog runs to decide a worker is dead.

Divergence rewind (policy in ``Trainer.train``)
    ``TrainingArguments.on_divergence = "rewind"`` reloads the latest
    checkpoint when the loss goes non-finite and continues with a reshuffled
    batch order, up to ``max_divergence_rewinds`` times; after that it
    raises like the default ``"raise"`` policy.
"""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Optional


class GracefulShutdown:
    """Latch SIGTERM/SIGINT into a pollable flag.

    Usable as a context manager; restores previous handlers on exit. Safe to
    construct in non-main threads or where signals are unavailable
    (``install()`` becomes a no-op and ``request()`` remains the programmatic
    trigger — also what fault-injection tests use).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._previous: dict = {}
        self.requested = False
        self.reason: Optional[str] = None

    def request(self, reason: str = "programmatic") -> None:
        self.requested = True
        self.reason = reason

    def _handler(self, signum, frame):
        if self.requested:
            # Second signal escalates: a hung step never reaches the poll,
            # so restore the previous disposition and re-deliver — the
            # operator's second Ctrl-C (or the scheduler's follow-up
            # SIGTERM) must be able to kill a stuck run.
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self.request(signal.Signals(signum).name)

    def install(self) -> "GracefulShutdown":
        for s in self._signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not in main thread
                pass
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()

    def globally_requested(self, mesh=None) -> bool:
        """The shutdown flag the loop acts on, agreed by every rank: a
        signal lands on each rank at its own time, and a rank that entered
        the checkpoint's collectives while another ran a step's would
        deadlock them. On a ``mesh`` of ranks the flags meet in its gloo
        control group (``Mesh.host_max``), as the JAX trainer's allgather;
        one process reads its local flag (no collective)."""
        if mesh is None or mesh.control is None:
            return self.requested
        agreed = mesh.host_max(int(self.requested)) > 0
        if agreed and self.reason is None:
            self.reason = "peer"
        return agreed

    def __enter__(self) -> "GracefulShutdown":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


class Heartbeat:
    """Atomic liveness file for external watchdogs."""

    FILENAME = "heartbeat.json"

    def __init__(self, output_dir: str):
        self.path = os.path.join(output_dir, self.FILENAME)

    def beat(self, step: int, **extra) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        record = {"step": step, "time": time.time(), **extra}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.path)  # atomic on POSIX

    @classmethod
    def read(cls, output_dir_or_path: str) -> Optional[dict]:
        path = output_dir_or_path
        if not path.endswith(".json"):
            path = os.path.join(path, cls.FILENAME)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    @classmethod
    def is_stale(cls, output_dir_or_path: str, timeout_s: float,
                 now: Optional[float] = None) -> bool:
        """True when no heartbeat exists or the last one is older than
        ``timeout_s`` — the "worker is dead, take over" predicate."""
        record = cls.read(output_dir_or_path)
        if record is None:
            return True
        return ((now if now is not None else time.time())
                - record.get("time", 0)) > timeout_s
