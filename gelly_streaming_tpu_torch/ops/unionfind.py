"""Min-label connected components, carried across batches, and
bipartiteness through the double cover.

Port of the JAX package's `ops/unionfind.py`. Every function returns the
canonical labeling: each slot labelled with the smallest slot reachable
through the batch's edges plus, when `carried`, the links (v, labels0[v])
of the prior forest. That labeling is unique whatever the schedule, which
is what lets the two forms below agree bit for bit:

- `cc_fixpoint_plain`, the plain PyTorch version: rounds of scatter-min
  (`cc_round`) and pointer jumping until nothing changes, as the JAX
  package's `while_loop` does, one host check per round.
- on a CUDA tensor `cc_fixpoint` launches the union-find entry point of
  `csrc/window_summary.cu` (`gs_cc_fixpoint`): a lock-free union-find in
  device memory, no rounds and no host check, in one cooperative launch
  up to 131,072 edges (every call the models make) and four launches
  above (`plan`). It never runs the plain loop, and the plain loop never
  stands in for it.

With `exchange=` (the sharded engines' elementwise MIN over a process
group, parallel/sharded.py) the edges are one shard's and the labels are
replicated: the plain version runs the JAX package's sharded rounds
(`cc_round`, the exchange, pointer jumping); on the card each round is
one union-find launch from the replicated labels (carried), then the
exchange, until a round changes nothing. Both end at the canonical
labeling of all shards' edges: each round's MIN of per-shard canonical
labelings points every slot at a smaller slot of its component, its
partition only coarsens, and at the fixed point every shard's edges and
forest links lie inside its sets.

Padded edge slots point at the sentinel vertex `num_vertices`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..core.platform import resolve_device
from . import segment as seg_ops


def cc_round(labels: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor) -> torch.Tensor:
    """One min-label sweep: each edge's smaller label scatter-mins into
    both endpoints and both endpoints' current roots (the JAX package's
    `cc_round`, unionfind.py:31-44). Returns a new tensor."""
    ls = labels[src]
    ld = labels[dst]
    m = torch.minimum(ls, ld)
    new = labels.clone()
    for idx in (src, dst, ls, ld):
        new.scatter_reduce_(0, idx.long(), m, reduce="amin")
    return new


def cc_fixpoint_plain(labels0: torch.Tensor, src: torch.Tensor,
                      dst: torch.Tensor, carried: bool = True,
                      exchange=None) -> torch.Tensor:
    """`cc_round` + pointer jumping until a round changes nothing, on the
    tensors' device (unionfind.py:47-84). With `carried`, the forest's
    links (v, labels0[v]) join the edges in every round: without them an
    old root that merges into two trees in one round keeps only the
    smaller link and splits its component. Fresh callers (labels0 the
    identity) pass carried=False. `exchange(labels)`, where given, merges
    each round's labels across shards before the pointer jump."""
    src = src.to(torch.int32)
    dst = dst.to(torch.int32)
    if carried:
        n = labels0.shape[0]
        src = torch.cat([src, torch.arange(n, dtype=torch.int32,
                                           device=src.device)])
        dst = torch.cat([dst, labels0.to(torch.int32)])
    labels = labels0
    while True:
        new = cc_round(labels, src, dst)
        if exchange is not None:
            new = exchange(new)
        new = new[new.long()]
        if torch.equal(new, labels):
            return new
        labels = new


def cc_fixpoint(labels0: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, carried: bool = True,
                exchange=None) -> torch.Tensor:
    """The canonical labeling of labels0 [n] int32 folded with the edges
    (src, dst) [E] int32, as a new tensor: the union-find kernel for CUDA
    tensors, `cc_fixpoint_plain` for CPU ones. On the card, edges with
    an endpoint outside [0, n) are skipped, and without `carried` labels0
    must point each slot at an equal or smaller one (the identity, as
    fresh callers pass). With `exchange` (a merge of replicated labels
    across shards; the module docstring), src/dst are this shard's edges
    and the result is the labeling of every shard's edges."""
    if labels0.device.type == "cpu":
        return cc_fixpoint_plain(labels0, src, dst, carried, exchange)
    if exchange is None:
        return _launch_fixpoint(labels0, src, dst, carried)
    labels = labels0
    while True:
        # one launch from the replicated labels, then the merge: every
        # shard sees the same merged labels, so every shard stops at the
        # same round
        new = exchange(_launch_fixpoint(labels, src, dst, carried))
        if torch.equal(new, labels):
            return new
        labels, carried = new, True


def _launch_fixpoint(labels0, src, dst, carried: bool) -> torch.Tensor:
    """One launch of the union-find entry point on checked tensors."""
    _check(labels0, src, dst)
    out = torch.empty_like(labels0)
    lib = kernels.library("window_summary")
    code = lib.gs_cc_fixpoint(
        labels0.data_ptr(), labels0.shape[0], src.data_ptr(),
        dst.data_ptr(), src.shape[0], int(carried), out.data_ptr(),
        labels0.device.index, kernels.stream_of(labels0))
    kernels.check("window_summary", code)
    kernels.LAUNCHES["cc_fixpoint"] += 1
    return out


TIERS = ("grid", "four launches")


def plan(n: int, ne: int, device) -> dict:
    """The union-find kernel's plan for a call of n slots and ne edges on
    a card: its tier ("grid": one cooperative launch; "four launches")
    and the grid's blocks."""
    dev = torch.device(device)
    out = (ctypes.c_int * 2)()
    kernels.check("window_summary", kernels.library("window_summary")
                  .gs_cc_plan(n, ne, dev.index, out))
    return {"tier": TIERS[out[0]], "blocks": out[1]}


def cc_labels(src: torch.Tensor, dst: torch.Tensor,
              num_vertices: int) -> torch.Tensor:
    """labels[v] = the smallest vertex of v's component. src/dst [E]
    int32 with padding at `num_vertices`; returns int32
    [num_vertices + 1] (the last slot is the padding sentinel)."""
    labels0 = torch.arange(num_vertices + 1, dtype=torch.int32,
                           device=src.device)
    return cc_fixpoint(labels0, src, dst, carried=False)


def _padded_edges(src, dst, eb: int, vb: int, device):
    return tuple(torch.from_numpy(seg_ops.pad_to(np.asarray(x, np.int32),
                                                 eb, fill=vb)).to(device)
                 for x in (src, dst))


def connected_components(src: np.ndarray, dst: np.ndarray,
                         num_vertices: int, device=None) -> np.ndarray:
    """Host wrapper: pads to buckets, labels on `device`, returns
    labels[:num_vertices] as numpy."""
    device = resolve_device(device)
    eb = seg_ops.bucket_size(len(src))
    vb = seg_ops.bucket_size(num_vertices)
    s, d = _padded_edges(src, dst, eb, vb, device)
    return cc_labels(s, d, vb).cpu().numpy()[:num_vertices]


def connected_components_with_labels(src: np.ndarray, dst: np.ndarray,
                                     labels: np.ndarray,
                                     num_vertices: int,
                                     vertex_bucket: int = 0,
                                     edge_bucket: int = 0,
                                     device=None) -> np.ndarray:
    """Fold a batch of edges into an existing labeling: `labels` is a
    dense int32 [num_vertices] forest pointing at equal-or-smaller
    slots; returns the converged labels of the same length. Both
    dimensions are bucketed (at least to `vertex_bucket` / `edge_bucket`),
    as in the JAX package (unionfind.py:114-145)."""
    device = resolve_device(device)
    eb = seg_ops.bucket_size(max(len(src), edge_bucket))
    vb = seg_ops.bucket_size(max(num_vertices, vertex_bucket))
    s, d = _padded_edges(src, dst, eb, vb, device)
    lab = np.concatenate([np.asarray(labels, np.int32),
                          np.arange(num_vertices, vb + 1, dtype=np.int32)])
    out = cc_fixpoint(torch.from_numpy(lab).to(device), s, d)
    return out.cpu().numpy()[:num_vertices]


def double_cover_edges(src: np.ndarray, dst: np.ndarray,
                       num_vertices: int):
    """The bipartite double cover's edge list: (u,+) = u, (u,-) = u+v;
    edge u~w joins (u,+)-(w,-) and (u,-)-(w,+). (The summary engine's
    carry uses another layout, (-) at v+vb+1: ops/window_summary.py.)"""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    v = num_vertices
    return np.concatenate([src, src + v]), np.concatenate([dst + v, dst])


def decode_double_cover(lab2: np.ndarray, num_vertices: int):
    """(labels, signs, odd) from converged cover labels [>= 2·v]: a
    vertex is on its component minimum's side iff its (+) cover carries
    the smaller label; an odd cycle makes plus == minus."""
    v = num_vertices
    plus, minus = lab2[:v], lab2[v:2 * v]
    return np.minimum(plus, minus), plus <= minus, plus == minus


def bipartite_labels(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                     device=None):
    """2-coloring via the double cover: (labels[num_vertices],
    signs[num_vertices], odd[num_vertices]), `odd[v]` True iff v's
    component holds an odd cycle."""
    s2, d2 = double_cover_edges(src, dst, num_vertices)
    lab2 = connected_components(s2, d2, 2 * num_vertices, device)
    return decode_double_cover(lab2, num_vertices)


def _check(labels0, src, dst) -> None:
    dev = labels0.device
    if dev.type != "cuda":
        raise ValueError("the union-find kernel takes CUDA tensors, got %s"
                         % dev)
    for name, t in (("labels0", labels0), ("src", src), ("dst", dst)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError("%s must be a contiguous 1-d int32 tensor on "
                             "%s, got %s %s on %s" % (
                                 name, dev, tuple(t.shape), t.dtype,
                                 t.device))
    if src.shape != dst.shape or not 0 < labels0.shape[0] < 2 ** 31:
        raise ValueError("labels0 of %d slots, src %s, dst %s" % (
            labels0.shape[0], tuple(src.shape), tuple(dst.shape)))
