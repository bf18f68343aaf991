"""Multi-process bootstrap over ``torch.distributed``.

Port of ``eventgpt_tpu/parallel/dist.py``. The JAX package starts one
controller per host with ``jax.distributed.initialize``; the port runs one
process (rank) per device and joins them with
``torch.distributed.init_process_group``. The backend is an explicit
argument: ``nccl`` on the card, ``gloo`` on the CPU (and, on the card,
where NCCL refuses two ranks of one device).

Environment contract, the JAX package's:

  EGPT_COORDINATOR   coordinator address host:port
  EGPT_NUM_PROCESSES total process count
  EGPT_PROCESS_ID    this process's rank

The variables that ``python -m torch.distributed.run`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LAUNCHER_VARS``) are
the counterpart of the JAX package's ``POD_AUTODETECT_VARS``: present,
they configure the group with no ``EGPT_*`` variable.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger("eventgpt_tpu_torch.dist")

# Set by ``torch.distributed.run`` (and any launcher of its contract).
LAUNCHER_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

# A collective that waits longer than this fails the rank instead of
# hanging it.
DEFAULT_TIMEOUT_S = 600.0


def default_backend(device_type: str) -> str:
    """``nccl`` for ``cuda``, ``gloo`` otherwise."""
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's index on its host: ``LOCAL_RANK`` when a launcher set
    it, else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str) -> torch.device:
    """The device of this rank: ``cuda:<local rank mod the card count>`` (two
    ranks of one host may share a card), or the CPU."""
    if device_type != "cuda":
        return torch.device(device_type)
    return torch.device("cuda", local_rank() % max(torch.cuda.device_count(), 1))


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    init_method: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the process group. Returns True if a multi-process group is up
    (now or before), False for the single-process fast path.

    The group is configured by, in order: ``init_method`` (any URL that
    ``init_process_group`` takes, ``file://`` in tests) with
    ``num_processes`` and ``process_id``; the ``EGPT_*`` contract; the
    launcher's ``LAUNCHER_VARS``. With none of them it is a no-op, and a
    half-configured launch (a process count or id without a coordinator)
    raises rather than run N independent single-process servers. Under
    ``nccl`` the rank's card is made current first.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("EGPT_COORDINATOR")
    if num_processes is None and "EGPT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["EGPT_NUM_PROCESSES"])
    if process_id is None and "EGPT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["EGPT_PROCESS_ID"])

    explicit = coordinator_address is not None or init_method is not None
    launched = all(v in os.environ for v in LAUNCHER_VARS)
    if not explicit and not launched:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "EGPT_NUM_PROCESSES/EGPT_PROCESS_ID are set but EGPT_COORDINATOR is not; "
                "refusing to fall back to a single-process run")
        log.info("single-process run; skipping init_process_group")
        return False
    if explicit:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs EGPT_NUM_PROCESSES and EGPT_PROCESS_ID "
                             "(num_processes and process_id)")
        init_method = init_method or f"tcp://{coordinator_address}"
        world, rank = int(num_processes), int(process_id)
    else:
        init_method = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    if backend == "nccl":
        # The rank's card; ranks past the host's card count share them.
        index = local_rank() if "LOCAL_RANK" in os.environ else rank
        torch.cuda.set_device(index % max(torch.cuda.device_count(), 1))
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    log.info("process group up: rank %d/%d over %s", rank, world, backend)
    return True


def is_primary() -> bool:
    """True on the process that writes checkpoints and prints: rank 0, or
    the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (a no-op for one process)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    log.debug("barrier %s", name)
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
