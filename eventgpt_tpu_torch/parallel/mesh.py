"""Logical device mesh and its collectives.

Port of ``eventgpt_tpu/parallel/mesh.py``. Axes:

  * ``data``    -- pure data parallelism;
  * ``fsdp``    -- ZeRO-style parameter sharding, gathered at use;
  * ``context`` -- sequence parallelism (1 for serving);
  * ``model``   -- tensor parallelism over heads and MLP columns.

The JAX mesh is single-controller: one process drives every device and
GSPMD inserts the collectives. The port's is multi-controller: one process
(rank) per device, each holding plain local tensors (its shard of every
leaf), and the model code calls the collectives of ``Mesh`` where GSPMD
puts them (``parallel/sharding.py``). A ``Mesh`` wraps a
``torch.distributed.device_mesh.DeviceMesh`` over ``AXES`` with one process
group per axis, plus a ``gloo`` group over every rank for the host's small
agreements (stop flags, a batch's answers), whatever the compute backend.
A mesh smaller than the world splits it into consecutive blocks of ranks,
each block a mesh of its own that runs the same program (the JAX package
takes the first N devices of a larger host).

Training adds the collectives the JAX program gets from ``lax`` inside its
shard_maps: ``all_to_all`` (Ulysses), ``ppermute`` (the ring) and
``reduce_scatter``. They carry no gradient; ``parallel/autograd.py`` wraps
``all_to_all``, ``ppermute``, ``all_reduce`` and ``all_gather`` as autograd
Functions. ``reduce_scatter`` is the backward of a gather over ``fsdp`` at
use, which no trainable needs while the trainables replicate over
``fsdp``.

Under ``gloo`` a collective on CUDA tensors stages them through pinned
host memory (one wait for the card, on the copy out; the copy back is
queued); under ``nccl`` it runs on the card. ``COLLECTIVES`` counts the
collectives a process ran on an axis of size > 1, their payload bytes and
their host-clock seconds (under ``gloo`` the wait included; under ``nccl``
the enqueue only).

The ranks' schedulers run on each rank's own host state. A decision that
reads state of one process alone (its clock, a measured copy rate, its
memory ledger, a fault drawn) is taken once and shared over ``control``:
``agree`` gives every rank rank 0's value, ``agree_max`` the largest of
theirs. ``AGREEMENTS`` counts them apart from ``COLLECTIVES``. ``replica``
makes a mesh of the same ranks over process groups of its own, one per
replica of a fleet, so that two replicas' collectives never share a group.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from eventgpt_tpu_torch.config import MeshConfig
from eventgpt_tpu_torch.parallel.dist import rank_device

AXES = ("data", "fsdp", "context", "model")

COLLECTIVES: Dict[str, float] = {"count": 0, "bytes": 0, "seconds": 0.0}
# The decisions agreed over ``control`` (``agree``, ``agree_max``) and their
# host-clock seconds.
AGREEMENTS: Dict[str, float] = {"count": 0, "seconds": 0.0}


class Mesh:
    """One rank's view of the mesh: ``shape`` ({axis: size}), this rank's
    ``coord`` on each axis, its ``device``, the compute ``backend`` (None
    for a one-device mesh, which has no process group), and the axis
    groups."""

    def __init__(self, cfg: MeshConfig, device: torch.device, backend: Optional[str] = None,
                 device_mesh=None, control=None):
        self.shape: Dict[str, int] = {"data": cfg.data, "fsdp": cfg.fsdp,
                                      "context": cfg.context, "model": cfg.model}
        self.device = torch.device(device)
        self.backend = backend
        self.device_mesh = device_mesh
        self._groups: Dict[str, Any] = {}
        self.control = None
        self.coord = {ax: 0 for ax in AXES}
        if device_mesh is not None:
            names = device_mesh.mesh_dim_names
            coord = dict(zip(names, device_mesh.get_coordinate()))
            self.coord = {ax: coord[ax] for ax in AXES}
            self._groups = {ax: device_mesh.get_group(ax) for ax in AXES if self.shape[ax] > 1}
            self.control = control if control is not None else dist.new_group(backend="gloo")

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else 0

    def parts(self, axes: Sequence[str]) -> int:
        """The product of the sizes of ``axes``."""
        n = 1
        for ax in axes:
            n *= self.shape[ax]
        return n

    def index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (its shard of a
        dimension split over them)."""
        i = 0
        for ax in axes:
            i = i * self.shape[ax] + self.coord[ax]
        return i

    # -- collectives on an axis (tensors) -------------------------------

    def _staged(self, x: torch.Tensor) -> bool:
        return self.backend == "gloo" and x.device.type == "cuda"

    def _count(self, x: torch.Tensor, t0: float) -> None:
        COLLECTIVES["count"] += 1
        COLLECTIVES["bytes"] += x.numel() * x.element_size()
        COLLECTIVES["seconds"] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, on every rank of it (the same bits
        on each). ``x`` is a temporary: it may be reduced in place."""
        if self.shape[axis] == 1:
            return x
        t0 = time.perf_counter()
        group = self._groups[axis]
        if self._staged(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            dist.all_reduce(h, group=group)
            out = h.to(x.device, non_blocking=True)
        else:
            out = x.contiguous()
            dist.all_reduce(out, group=group)
        self._count(x, t0)
        return out

    def all_reduce_axes(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """The sum of ``x`` over every rank of ``axes`` (one all-reduce an
        axis of size > 1)."""
        for ax in axes:
            x = self.all_reduce(x, ax)
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The shards of ``x`` over ``axis`` concatenated along ``dim``, in
        axis order."""
        n = self.shape[axis]
        if n == 1:
            return x
        t0 = time.perf_counter()
        group = self._groups[axis]
        src = x.contiguous()
        if self._staged(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(src)
            parts = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(parts, h, group=group)
            out = torch.cat(parts, dim=dim).pin_memory().to(x.device, non_blocking=True)
        else:
            parts = [torch.empty_like(src) for _ in range(n)]
            dist.all_gather(parts, src, group=group)
            out = torch.cat(parts, dim=dim)
        self._count(x, t0)
        return out

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the tensor the backend takes: a pinned host copy of a
        CUDA tensor under ``gloo``, else ``x`` made contiguous."""
        if self._staged(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            return h
        return x.contiguous()

    def _back(self, out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return out.to(like.device, non_blocking=True) if self._staged(like) else out

    def _chunks(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``x`` split into ``shape[axis]`` equal blocks along ``dim``,
        stacked on a new leading dim."""
        n = self.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis} "
                             f"({n} parts)")
        return torch.stack(x.chunk(n, dim=dim))

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
        ``x`` split into ``shape[axis]`` blocks along ``split_dim``, block j
        sent to the rank at coordinate j, and the blocks received
        concatenated along ``concat_dim`` in coordinate order."""
        n = self.shape[axis]
        if n == 1:
            return x
        t0 = time.perf_counter()
        send = self._host(self._chunks(x, axis, split_dim))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self._groups[axis])
        out = torch.cat(self._back(recv, x).unbind(0), dim=concat_dim)
        self._count(x, t0)
        return out

    def ppermute(self, x: torch.Tensor, axis: str, shift: int = 1) -> torch.Tensor:
        """``lax.ppermute`` over ``axis`` with the ring permutation
        ``j -> j + shift``: each rank sends ``x`` to the rank ``shift``
        coordinates on and returns what the rank ``shift`` coordinates back
        sent it."""
        n = self.shape[axis]
        if n == 1 or shift % n == 0:
            return x
        t0 = time.perf_counter()
        group = self._groups[axis]
        ranks = dist.get_process_group_ranks(group)
        c = self.coord[axis]
        send = self._host(x)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, ranks[(c + shift) % n], group),
               dist.P2POp(dist.irecv, recv, ranks[(c - shift) % n], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = self._back(recv, x)
        self._count(x, t0)
        return out

    def reduce_scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The sum of ``x`` over ``axis``, of which each rank keeps its block
        along ``dim`` (block ``coord[axis]`` of ``shape[axis]``)."""
        n = self.shape[axis]
        if n == 1:
            return x
        t0 = time.perf_counter()
        send = self._host(self._chunks(x, axis, dim))
        recv = torch.empty_like(send[:1])
        dist.reduce_scatter_tensor(recv, send, group=self._groups[axis])
        out = self._back(recv[0], x)
        self._count(x, t0)
        return out

    # -- host agreements over every rank --------------------------------

    def _host_reduce(self, value: int, op) -> int:
        if self.control is None:
            return int(value)
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=op, group=self.control)
        return int(t.item())

    def host_all(self, flag: bool) -> bool:
        """True when ``flag`` holds on every rank."""
        return bool(self._host_reduce(bool(flag), dist.ReduceOp.MIN))

    def host_max(self, value: int) -> int:
        return self._host_reduce(value, dist.ReduceOp.MAX)

    def agree(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank: a decision that reads state of one
        process alone is taken there and shared. A number or a bool crosses
        as one f64 broadcast, anything else pickled. A one-device mesh
        returns ``obj`` and runs no collective."""
        if self.control is None:
            return obj
        t0 = time.perf_counter()
        src = dist.get_global_rank(self.control, 0)
        if isinstance(obj, (bool, int, float)):
            t = torch.tensor([float(obj)], dtype=torch.float64)
            dist.broadcast(t, src=src, group=self.control)
            out = type(obj)(t.item())
        else:
            box = [obj]
            dist.broadcast_object_list(box, src=src, group=self.control)
            out = box[0]
        AGREEMENTS["count"] += 1
        AGREEMENTS["seconds"] += time.perf_counter() - t0
        return out

    def agree_max(self, value: int) -> int:
        """The largest ``value`` over the ranks, on every rank: a decision
        that any rank can force (a fault drawn there, its budget passed)."""
        if self.control is None:
            return int(value)
        t0 = time.perf_counter()
        out = self._host_reduce(value, dist.ReduceOp.MAX)
        AGREEMENTS["count"] += 1
        AGREEMENTS["seconds"] += time.perf_counter() - t0
        return out

    def replica(self) -> "Mesh":
        """A mesh of the same ranks, coordinates and device over process
        groups of its own: each axis group of size > 1 and ``control`` made
        anew, so that the collectives of two replicas (each driven by a
        thread of its own) never share a group. Every rank of the world
        calls it at the same point and in the same order: each new group is
        created on every rank. A one-device mesh returns a copy."""
        out = copy.copy(self)
        if self.device_mesh is None:
            return out
        ranks = self.device_mesh.mesh
        names = list(self.device_mesh.mesh_dim_names)
        me = dist.get_rank()
        out._groups = {}
        for ax in AXES:
            n = self.shape[ax]
            if n == 1:
                continue
            for row in ranks.movedim(names.index(ax), -1).reshape(-1, n).tolist():
                group = dist.new_group(ranks=row)
                if me in row:
                    out._groups[ax] = group
        blocks = ranks.reshape(ranks.shape[0], -1) if "block" in names else ranks.reshape(1, -1)
        for row in blocks.tolist():
            group = dist.new_group(ranks=row, backend="gloo")
            if me in row:
                out.control = group
        return out

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        if self.control is None:
            return [obj]
        out: List[Any] = [None] * dist.get_world_size(self.control)
        dist.all_gather_object(out, obj, group=self.control)
        return out


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> Mesh:
    """The mesh of ``cfg`` (data, fsdp, context, model) over the process
    group, one rank per device. The sizes' product must equal the world
    size, or divide it: then the world splits into consecutive blocks of
    that many ranks, each a mesh of its own (every block runs the same
    program; its first rank is the block's rank 0). A one-device mesh
    needs no process group."""
    shape = (cfg.data, cfg.fsdp, cfg.context, cfg.model)
    n = 1
    for v in shape:
        n *= v
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1 and not dist.is_initialized():
        return Mesh(cfg, rank_device(device_type))
    if n > world or world % n:
        raise ValueError(f"mesh {dict(zip(AXES, shape))} needs {n} ranks, have {world} "
                         f"(launch with python -m torch.distributed.run --nproc_per_node {n})")
    device = rank_device(device_type)
    from torch.distributed.device_mesh import init_device_mesh

    if device.type == "cuda":
        # A card made current first: DeviceMesh would otherwise pick card
        # LOCAL_RANK, which does not exist where ranks share a card.
        torch.cuda.set_device(device)
        torch.cuda.init()

    if n == world:
        dm = init_device_mesh(device_type, shape, mesh_dim_names=AXES)
        return Mesh(cfg, device, backend=dist.get_backend(), device_mesh=dm)
    blocks = world // n
    dm = init_device_mesh(device_type, (blocks,) + shape, mesh_dim_names=("block",) + AXES)
    control = None
    for b in range(blocks):
        # Every rank makes every block's group, in one order.
        group = dist.new_group(ranks=list(range(b * n, (b + 1) * n)), backend="gloo")
        if b == dist.get_rank() // n:
            control = group
    return Mesh(cfg, device, backend=dist.get_backend(), device_mesh=dm, control=control)


def single_device_mesh(device_type: str = "cuda") -> Mesh:
    """The 1x1x1x1 mesh of this process's device, with no process group."""
    return Mesh(MeshConfig(), rank_device(device_type))


def best_mesh_config(n_devices: int, *, fsdp_pref: int = 8, model: int = 1,
                     context: int = 1) -> MeshConfig:
    """Heuristic mesh for ``n_devices``: fill ``fsdp`` up to ``fsdp_pref``,
    the rest goes to ``data``; the JAX package's arithmetic."""
    inner = model * context
    if n_devices % inner:
        raise ValueError(f"{n_devices} devices not divisible by model*context={inner}")
    rest = n_devices // inner
    fsdp = 1
    for cand in range(min(fsdp_pref, rest), 0, -1):
        if rest % cand == 0:
            fsdp = cand
            break
    return MeshConfig(data=rest // fsdp, fsdp=fsdp, model=model, context=context)
