"""The mesh: a 1-D group of ranks on `torch.distributed`, the
communication substrate of the sharded engines.

Port of the JAX package's `parallel/mesh.py`. JAX lays a
`jax.sharding.Mesh` over the chips of one controller; here a `Mesh`
holds a process group, this process's rank in it, the group's size and
the rank's device, and its collective helpers are the only place the
engines (parallel/sharded.py) talk to `torch.distributed`:

    JAX                          port
    psum                         all_reduce(SUM)
    pmin / pmax                  all_reduce(MIN / MAX)
    all_gather                   all_gather_into_tensor
    all_to_all(tiled=True)       all_to_all_single over equal splits

The execution model is SPMD: one process a rank. Every rank makes the
same call with the same host arrays, stages only its own contiguous
slice of the edge axis (`Mesh.local`), and returns the same replicated
answer. A rank therefore never raises alone on its input: what one rank
refuses, every rank refuses (parallel/sharded.guard_wire checks every
shard's slice on every rank).

The backend follows the device, and never changes quietly:
`device=None` is the card, NCCL, each rank on `cuda:(local rank)`
(LOCAL_RANK, as torchrun sets it, else the rank modulo the cards);
`device="cpu"` is gloo. A process group of the other backend, or no
card with `device=None`, raises.

A collective that fails (a dead or hung peer, a transport error) raises
`CollectiveError` with the backend's error as its cause: such an error is
never retried, wrapped or demoted on (utils/resilience.is_device_error),
because a rank that retried a collective alone would wait forever for
peers that moved on.

Left out: `shard_map_norep`, the JAX replication checker's workaround
(it has no counterpart: nothing here traces a program), and the
`NamedSharding` helpers `edge_sharding` / `replicated` (a rank stages
its slice itself).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

SHARD_AXIS = "shard"

_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}


class CollectiveError(RuntimeError):
    """A collective of the mesh failed; the backend's error rides as
    __cause__."""


def _collective(name: str, call, *args, **kw) -> None:
    try:
        call(*args, **kw)
    except Exception as e:
        raise CollectiveError("%s over the mesh failed: %s: %s"
                              % (name, type(e).__name__, e)) from e


def backend_for(device) -> str:
    """"nccl" for the card (device None or a CUDA device), "gloo" for the
    CPU."""
    if device is None:
        return "nccl"
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError("no mesh backend for device %s" % device)


def rank_device(device=None) -> torch.device:
    """The device of this rank: for None the card of its local rank
    (raising where there is no card), else `device` as given."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the mesh; pass "
            "device='cpu' for a gloo mesh on the CPU")
    if device is not None and torch.device(device).index is not None:
        dev = torch.device(device)
    else:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", int(local) % torch.cuda.device_count())
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError("device %s requested but only %d CUDA devices "
                           "exist" % (dev, torch.cuda.device_count()))
    return dev


class Mesh:
    """A layout of ranks over a process group: `layout` the ranks (their
    global numbers) as an array of shape `shape`'s values, `axis_names`
    its axes. `rank` is this process's position in the flattened layout
    (-1 where it lies outside the mesh), `size` the number of ranks,
    `device` the rank's device. The collectives run over the whole
    layout, in its flattened order."""

    def __init__(self, group, layout: np.ndarray, axis_names: tuple,
                 device: torch.device, backend: str):
        self.group = group
        self.layout = np.asarray(layout, np.int64)
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device)
        self.backend = backend
        me = dist.get_rank()
        flat = self.layout.reshape(-1).tolist()
        self.rank = flat.index(me) if me in flat else -1

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.layout.shape))

    @property
    def size(self) -> int:
        return int(self.layout.size)

    @property
    def member(self) -> bool:
        return self.rank >= 0

    def __repr__(self) -> str:
        return "Mesh(%s, rank=%d, device=%s, %s)" % (
            self.shape, self.rank, self.device, self.backend)

    # -- the rank's slice and its staging -------------------------------

    def local(self, a: np.ndarray, axis: int = -1) -> np.ndarray:
        """This rank's contiguous slice of a host array along `axis`
        (whose length the mesh size divides), contiguous in memory."""
        a = np.asarray(a)
        width = a.shape[axis] // self.size
        if width * self.size != a.shape[axis]:
            raise ValueError("axis of %d does not split over %d ranks"
                             % (a.shape[axis], self.size))
        lo = self.rank * width
        return np.ascontiguousarray(
            np.take(a, np.arange(lo, lo + width), axis=axis))

    def put(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the rank's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- the collectives ------------------------------------------------

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise SUM, MIN or MAX of `t` over the mesh, in place
        (psum, pmin, pmax); returns t."""
        _collective("all_reduce", dist.all_reduce, t,
                    op=getattr(dist.ReduceOp, _OPS[op]), group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's `t` in mesh order."""
        t = t.contiguous()
        out = torch.empty(self.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        _collective("all_gather", gather, out, t.reshape(-1),
                    group=self.group)
        return out.reshape((self.size,) + tuple(t.shape))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """all_to_all(tiled=True) over dim 0: `t`'s dim 0 cut into `size`
        equal chunks, chunk j sent to rank j; the result's chunk j is
        what rank j sent here."""
        t = t.contiguous()
        out = torch.empty_like(t)
        _collective("all_to_all", dist.all_to_all_single, out, t,
                    group=self.group)
        return out


def shard_count(mesh: Mesh) -> int:
    return mesh.size


def mesh_padded_len(n_items: int, mesh: Mesh) -> int:
    """Smallest multiple of the mesh size ≥ n_items (≥ one per shard)."""
    n = shard_count(mesh)
    return ((n_items + n - 1) // n) * n if n_items else n


def pad_edges_for_mesh(src: np.ndarray, dst: np.ndarray, mesh: Mesh,
                       sentinel: int):
    """Pad a COO batch so its length divides the mesh; padding slots point
    at the sentinel vertex (one past the real vertex range)."""
    target = mesh_padded_len(len(src), mesh)
    pad = target - len(src)
    if pad:
        src = np.concatenate([src, np.full(pad, sentinel, src.dtype)])
        dst = np.concatenate([dst, np.full(pad, sentinel, dst.dtype)])
    return src, dst


def ensure_process_group(device=None) -> str:
    """The backend of the default process group, after making a one-rank
    group (an in-process store, no network) where none is initialized.
    Raises where the group's backend is not the device's."""
    want = backend_for(device)
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.set_device(rank_device(device))
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1,
                                timeout=datetime.timedelta(seconds=300))
    have = str(dist.get_backend())
    if want not in have:
        raise ValueError(
            "the process group runs %s; a mesh on %s needs %s (the "
            "backend follows the device: None or cuda → nccl, cpu → gloo)"
            % (have, "the card" if device is None else device, want))
    return want


def group_over(ranks: list, backend: str):
    """The process group over `ranks` (every rank of the world must call
    this, as torch.distributed.new_group requires): the default group
    where `ranks` is the whole world."""
    if list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks=list(ranks), backend=backend)


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis_name: str = SHARD_AXIS) -> Mesh:
    """A 1-D mesh over the first `n_devices` ranks of the default process
    group (all of them by default), as JAX's make_mesh takes the first
    n devices. With no process group initialized it makes a one-rank
    group on the caller's device: the counterpart of make_mesh() on one
    chip. Every rank of the world calls it (ranks past n get a mesh they
    are not a member of). `device=None` is the card (NCCL), "cpu" gloo."""
    backend = ensure_process_group(device)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 0 < n <= world:
        raise ValueError("a mesh of %d ranks in a world of %d" % (n, world))
    ranks = list(range(n))
    return Mesh(group_over(ranks, backend), np.array(ranks), (axis_name,),
                rank_device(device), backend)
