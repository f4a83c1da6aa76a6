"""Several hosts: the process group's launch and a two-level layout of
its ranks.

Port of the JAX package's `parallel/multihost.py`. JAX joins its hosts
with `jax.distributed` and lays a 2-D ("dcn", "shard") device mesh over
them: the inner axis the chips of one slice (ICI), the outer the slices
(DCN). Here every rank is a process: `initialize_runtime` joins the
process group (NCCL on the cards, gloo on the CPU, as parallel/mesh.py
resolves them), and `make_hybrid_mesh` lays the ranks out as a
("dcn", "shard") array whose rows are hosts. The sharded engines run
over the flat edge axis (`flatten_for_edges`), ranks in (dcn, ici)
order, so consecutive edge shards stay on one host.

A host is LOCAL_WORLD_SIZE consecutive ranks (torchrun's layout); with
that variable unset, every rank is taken to be on one host.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch.distributed as dist

from .mesh import (SHARD_AXIS, Mesh, backend_for, ensure_process_group,
                   group_over, rank_device)

DCN_AXIS = "dcn"


def initialize_runtime(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, device=None,
                       timeout_s: float = 300.0) -> None:
    """Join the process group (once a process, before any mesh):
    `coordinator_address` "host:port" of rank 0's store, reached over
    tcp://; with None, torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK). NCCL for `device` None or a CUDA device, gloo for
    "cpu"."""
    init = ("env://" if coordinator_address is None
            else "tcp://%s" % coordinator_address)
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend_for(device), init_method=init,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def _hosts_of(ranks) -> list:
    per = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    return [r // max(per, 1) for r in ranks]


def make_hybrid_mesh(ici_shards: Optional[int] = None,
                     dcn_shards: Optional[int] = None,
                     devices: Optional[Sequence[int]] = None,
                     device=None) -> Mesh:
    """A 2-D ("dcn", "shard") mesh over the ranks `devices` (default:
    all of the world; taken in ascending order, the group's), row-major:
    the inner axis the ranks of one host, the outer the hosts. Defaults: one DCN row a host, the rest on the
    inner axis. Every rank of the world calls it. Raises ValueError when
    the shape does not cover the ranks, RuntimeError when an inner row
    would span hosts."""
    backend = ensure_process_group(device)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else sorted(int(r) for r in devices))
    if dcn_shards is None:
        dcn_shards = max(len(set(_hosts_of(ranks))), 1)
    if ici_shards is None:
        ici_shards = len(ranks) // dcn_shards
    if ici_shards * dcn_shards != len(ranks):
        raise ValueError(
            f"{ici_shards} ICI x {dcn_shards} DCN shards != "
            f"{len(ranks)} devices")
    layout = np.array(ranks).reshape(dcn_shards, ici_shards)
    if dcn_shards > 1:
        for row in layout:
            hosts = set(_hosts_of(row.tolist()))
            if len(hosts) != 1:
                raise RuntimeError(
                    "hybrid mesh layout mismatch: an ICI row spans hosts "
                    "%s; expected one host a DCN row (ranks host-major)"
                    % sorted(hosts))
    return Mesh(group_over(ranks, backend), layout,
                (DCN_AXIS, SHARD_AXIS), rank_device(device), backend)


def flatten_for_edges(mesh: Mesh) -> Mesh:
    """The 1-D view of a hybrid mesh for the edge-sharded engines: the
    shard axis enumerates (dcn, ici) row-major, over the same group."""
    return Mesh(mesh.group, mesh.layout.reshape(-1), (SHARD_AXIS,),
                mesh.device, mesh.backend)
