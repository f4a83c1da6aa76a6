"""Windowed neighborhood kernels: per-window columnar execution of
foldNeighbors / reduceOnEdges / applyOnNeighbors
(reference: GraphWindowStream.java:62-182).

Port of the JAX package's `ops/neighborhood.py`. Each kernel takes one
window's edges (already direction-transformed so key = source, neighbor
= target, as the reference's slice() does: SimpleEdgeStream.java:153-171),
makes COO arrays, interns the vertex ids and runs on the environment's
device (`env.device`, resolved at the kernel's first window):
- fold (`TorchEdgesFold`): the stepped fold of ops/segment.py;
- reduce (`TorchEdgesReduce`): a named monoid on the cell-reduce kernel
  (ops/cell_reduce.py: one window, its cells the interned vertices), an
  associative fn on the flagged scan, any other fn on the stepped fold;
- apply (`TorchEdgesApply`): the fn over a padded [vertices, max_deg]
  neighborhood view.
Host kernels reproduce the reference's per-record semantics for
arbitrary Python UDFs. Named and associative reduces also have a pane
path (`_make_pane_reduce`) for sliding windows: one call over the
[panes, vertices] cells of all panes (for the monoids, one cell-reduce
launch), windows combined from pane partials.
"""

from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from ..core.functions import (EdgesApply, EdgesFold, EdgesReduce,
                              TorchEdgesApply, TorchEdgesFold,
                              TorchEdgesReduce)
from . import segment as seg_ops
from .cell_reduce import cell_reduce

Record = Tuple[Any, int]


def _window_arrays(edges) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO arrays (key=source, neighbor=target, value) for a window batch."""
    src = np.asarray([e.source for e in edges])
    dst = np.asarray([e.target for e in edges])
    values = [e.value for e in edges]
    if all(isinstance(v, int) and not isinstance(v, bool) for v in values):
        val = np.asarray(values, dtype=np.int64)
    else:
        try:
            val = np.asarray(values, dtype=np.float64)
        except (TypeError, ValueError):
            val = np.zeros(len(edges), np.int32)  # NullValue edges
    return src, dst, val


def _group_by_key(edges) -> "OrderedDict[Any, List[Tuple[Any, Any]]]":
    """Arrival-order neighborhood grouping (host path)."""
    groups: "OrderedDict[Any, List]" = OrderedDict()
    for e in edges:
        groups.setdefault(e.source, []).append((e.target, e.value))
    return groups


def _py(x):
    """numpy scalar → python scalar for sink formatting."""
    if isinstance(x, np.generic):
        return x.item()
    return x


def _leaves(tree) -> list:
    """The leaves of a result tree as numpy arrays."""
    leaves, _rebuild = seg_ops.flatten_tree(tree)
    return [l.cpu().numpy() if isinstance(l, torch.Tensor)
            else np.asarray(l) for l in leaves]


# ----------------------------------------------------------------------
# fold
# ----------------------------------------------------------------------

def make_fold_kernel(fold, env) -> Callable[[List[Any], int], List[Record]]:
    if isinstance(fold, TorchEdgesFold):
        return _device_fold_kernel(fold, env)
    if isinstance(fold, tuple):  # (initial, EdgesFold)
        initial, fold_udf = fold
        return _host_fold_kernel(initial, fold_udf)
    raise TypeError(type(fold))


def _host_fold_kernel(initial, fold_udf: EdgesFold):
    def kernel(edges, wmax) -> List[Record]:
        out: List[Record] = []
        accs: "OrderedDict[Any, Any]" = OrderedDict()
        for e in edges:
            acc = accs.get(e.source)
            if acc is None:
                acc = copy.deepcopy(initial)
            accs[e.source] = fold_udf.fold_edges(acc, e.source, e.target, e.value)
        for _key, acc in accs.items():
            out.append((acc, wmax))
        return out

    return kernel


def _device_fold_kernel(fold: TorchEdgesFold, env):
    """No pane path exists for folds: a fold visits a vertex's edges in
    arrival order across the whole window, and pre-collapsing panes is
    only valid for an associative combine. Sliding folds pay the
    size/slide duplication by design."""

    def kernel(edges, wmax) -> List[Record]:
        src, dst, val = _window_arrays(edges)
        uniq, (s_dense,) = seg_ops.intern(src)
        order = np.argsort(s_dense, kind="stable")
        fields = (src[order], dst[order], val[order])
        result, has_any = seg_ops.segmented_fold(
            fold.fn, fold.init, s_dense[order], fields, len(uniq),
            env.device)
        out: List[Record] = []
        leaves = _leaves(result)
        for i, vid in enumerate(uniq):
            if not has_any[i]:
                continue
            row = tuple(_py(l[i]) for l in leaves)
            value = fold.emit(_py(vid), row) if fold.emit else row
            out.append((value, wmax))
        return out

    return kernel


# ----------------------------------------------------------------------
# reduce
# ----------------------------------------------------------------------

def make_reduce_kernel(reduce_udf, env) -> Callable[[List[Any], int],
                                                    List[Record]]:
    if isinstance(reduce_udf, TorchEdgesReduce):
        return _device_reduce_kernel(reduce_udf, env)
    if isinstance(reduce_udf, EdgesReduce):
        return _host_reduce_kernel(reduce_udf)
    raise TypeError(type(reduce_udf))


def _host_reduce_kernel(reduce_udf: EdgesReduce):
    def kernel(edges, wmax) -> List[Record]:
        groups = _group_by_key(edges)
        out: List[Record] = []
        for key, nbrs in groups.items():
            acc = nbrs[0][1]
            for _n, v in nbrs[1:]:
                acc = reduce_udf.reduce_edges(acc, v)
            # result projected to (vertexId, value) — reference
            # GraphWindowStream.java:103 `.project(0,2)`
            out.append(((key, acc), wmax))
        return out

    return kernel


def _monoid_cells(ids: np.ndarray, val: np.ndarray, n_cells: int,
                  name: str, device):
    """(cells, counts) [n_cells] of one cell-reduce launch over a flat
    stack of cell ids (one window of n_cells cells); padding takes the
    trash id n_cells."""
    nb = seg_ops.bucket_size(len(val))
    ids = seg_ops.pad_to(ids.astype(np.int32), nb, fill=n_cells)
    vals = seg_ops.pad_to(seg_ops.x64_off_values(val), nb)
    cells, counts = cell_reduce(torch.from_numpy(ids).to(device),
                                torch.from_numpy(vals).to(device), 1, nb,
                                n_cells, name)
    return cells[0], counts[0]


def _device_reduce_kernel(reduce_udf: TorchEdgesReduce, env):
    name = reduce_udf.name
    fn = reduce_udf.fn

    def kernel(edges, wmax) -> List[Record]:
        src, _dst, val = _window_arrays(edges)
        uniq, (s_dense,) = seg_ops.intern(src)
        n_seg = len(uniq)
        if name in ("sum", "min", "max"):
            cells, _counts = _monoid_cells(s_dense, val, n_seg, name,
                                           env.device)
            res = cells.cpu().numpy()
            has_any = np.ones(n_seg, bool)
        else:
            order = np.argsort(s_dense, kind="stable")
            reduce = (seg_ops.segmented_reduce_associative
                      if reduce_udf.associative
                      else seg_ops.segmented_reduce)
            res, has_any = reduce(fn, s_dense[order], val[order], n_seg,
                                  env.device)
        return [
            ((_py(uniq[i]), _py(res[i])), wmax)
            for i in range(n_seg) if has_any[i]
        ]

    if name in ("sum", "min", "max"):
        kernel.pane_kernel = _make_pane_reduce(kernel, env, name=name)
    elif reduce_udf.associative:
        # associativity is exactly the license pane decomposition needs;
        # other reduces (and folds) stay on the duplicating path
        kernel.pane_kernel = _make_pane_reduce(kernel, env, fn=fn)
    return kernel


_PANE_CELL_LIMIT = 1 << 22  # (panes x vertex-bucket) cells per call


def _pane_identity(name: str, dtype: torch.dtype):
    if name == "sum":
        return 0
    big = (torch.finfo(dtype).max if dtype.is_floating_point
           else torch.iinfo(dtype).max)
    return big if name == "min" else -big


def _combine_shifted(pv, pc, wp: int, step):
    """Combine the wp shifted slices of both-end-padded (pane, vertex)
    stacks: window w covers padded pane rows [w, w+wp-1], so
    W = P + wp - 1. step(acc_v, acc_c, next_v, next_c) -> (acc_v, acc_c)."""
    n_w = pv.shape[0] - (wp - 1)
    accv, accc = pv[:n_w], pc[:n_w]
    for k in range(1, wp):
        accv, accc = step(accv, accc, pv[k:k + n_w], pc[k:k + n_w])
    return accv, accc


def window_stack_combine(cells, counts, wp: int, name: str):
    """Sliding-window combine from pane partials: empty (pane, vertex)
    cells set to the monoid identity, wp-1 identity rows padded on both
    ends, then the wp shifted slices combined elementwise. Returns
    ([W, V] values, [W, V] counts), W = P + wp - 1."""
    ident = _pane_identity(name, cells.dtype)
    if name != "sum":
        cells = torch.where(counts > 0, cells,
                            torch.tensor(ident, dtype=cells.dtype,
                                         device=cells.device))
    comb = {"sum": torch.add, "min": torch.minimum,
            "max": torch.maximum}[name]
    cols = cells.shape[1]
    pad_v = torch.full((wp - 1, cols), ident, dtype=cells.dtype,
                       device=cells.device)
    pad_c = torch.zeros((wp - 1, cols), dtype=counts.dtype,
                        device=counts.device)
    pv = torch.cat([pad_v, cells, pad_v])
    pc = torch.cat([pad_c, counts, pad_c])
    return _combine_shifted(
        pv, pc, wp, lambda av, ac, nv, nc: (comb(av, nv), ac + nc))


def masked_combine(fn, av, ap, nv, npn):
    """One presence-masked combine step for an associative fn without an
    identity: fn(a, next) where both cells are present, the present side
    where one is, `a` unchanged otherwise."""
    return (torch.where(ap & npn, fn(av, nv).to(av.dtype),
                        torch.where(npn, nv, av)), ap | npn)


def assoc_window_combine(fn, wp: int, cells, counts):
    """The window combine of an associative fn: empty cells carried as a
    presence mask (no identity exists for the values), counts summed."""
    cols = cells.shape[1]
    dev = cells.device
    present = counts > 0
    pad_v = torch.zeros((wp - 1, cols), dtype=cells.dtype, device=dev)
    pad_p = torch.zeros((wp - 1, cols), dtype=torch.bool, device=dev)
    pad_c = torch.zeros((wp - 1, cols), dtype=counts.dtype, device=dev)
    pv = torch.cat([pad_v, cells, pad_v])
    pp = torch.cat([pad_p, present, pad_p])
    pc = torch.cat([pad_c, counts, pad_c])
    accv, _ = _combine_shifted(
        pv, pp, wp,
        lambda av, ap, nv, npn: masked_combine(fn, av, ap, nv, npn))
    accc, _ = _combine_shifted(
        pc, pc, wp, lambda av, ac, nv, nc: (av + nv, ac))
    return accv, accc


def _make_pane_reduce(per_window_kernel, env, name: str = None, fn=None):
    """Sliding-window reduce from slide-sized pane partials: one call
    computes every window instead of reducing each edge size/slide
    times. partial[p, v] = the reduce of pane p's edges at vertex v (for
    a monoid one cell-reduce launch over the [panes, vertices] cells;
    for an associative fn the flagged scan); window w combines its
    size/slide consecutive panes. Falls back to per-window calls of the
    plain kernel when the dense pane axis would be degenerate (a sparse
    stream spanning a huge time range)."""
    assert (name is None) != (fn is None)

    def pane_kernel(panes, size: int, slide: int) -> List[Record]:
        if not panes:
            return []
        starts = sorted(panes)
        p0 = starts[0]
        wp = size // slide
        n_panes = (starts[-1] - p0) // slide + 1

        srcs, vals, pids = [], [], []
        for st in starts:
            s, _d, v = _window_arrays(panes[st])
            srcs.append(s)
            vals.append(v)
            pids.append(np.full(len(s), (st - p0) // slide, np.int64))
        src = np.concatenate(srcs)
        val = np.concatenate(vals)
        pid = np.concatenate(pids)
        uniq, (s_dense,) = seg_ops.intern(src)
        n_seg = len(uniq)
        sb = seg_ops.bucket_size(n_seg)
        pb = seg_ops.bucket_size(n_panes)

        if pb * (sb + 1) > _PANE_CELL_LIMIT:
            # per-window calls over only the windows that hold an
            # occupied pane
            out: List[Record] = []
            occupied = set(starts)
            wstarts = sorted({st - k * slide for st in starts
                              for k in range(wp)})
            for wstart in wstarts:
                values = [v_ for j in range(wp)
                          if (wstart + j * slide) in occupied
                          for v_ in panes[wstart + j * slide]]
                if values:
                    out.extend(per_window_kernel(values,
                                                 wstart + size - 1))
            return out

        dev = env.device
        n_cells = pb * (sb + 1)
        seg = pid * (sb + 1) + s_dense
        if name is not None:
            part, counts = _monoid_cells(seg, val, n_cells, name, dev)
            accv, accc = window_stack_combine(part.reshape(pb, sb + 1),
                                              counts.reshape(pb, sb + 1),
                                              wp, name)
        else:
            order = np.argsort(seg, kind="stable")
            res, _has_any = seg_ops.segmented_reduce_associative(
                fn, seg[order], val[order], n_cells, dev)
            part = torch.from_numpy(res).to(dev).reshape(pb, sb + 1)
            cnt = np.bincount(seg, minlength=n_cells).astype(
                np.int32).reshape(pb, sb + 1)
            accv, accc = assoc_window_combine(
                fn, wp, part, torch.from_numpy(cnt).to(dev))
        accv, accc = accv.cpu().numpy(), accc.cpu().numpy()

        # emit only occupied (window, vertex) cells
        ws, vs = np.nonzero(accc[:n_panes + wp - 1, :n_seg])
        return [
            ((_py(uniq[v]), _py(accv[w, v])),
             p0 + (w - (wp - 1)) * slide + size - 1)
            for w, v in zip(ws.tolist(), vs.tolist())
        ]

    return pane_kernel


# ----------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------

def make_apply_kernel(apply_udf, env) -> Callable[[List[Any], int],
                                                  List[Record]]:
    if isinstance(apply_udf, TorchEdgesApply):
        return _device_apply_kernel(apply_udf, env)
    if isinstance(apply_udf, EdgesApply):
        return _host_apply_kernel(apply_udf)
    raise TypeError(type(apply_udf))


def _host_apply_kernel(apply_udf: EdgesApply):
    """Buffered whole-neighborhood apply, 0..n outputs per vertex
    (reference: EdgesWindowFunction, GraphWindowStream.java:135-182)."""

    def kernel(edges, wmax) -> List[Record]:
        groups = _group_by_key(edges)
        out: List[Record] = []
        for key, nbrs in groups.items():
            apply_udf.apply_on_edges(key, nbrs, lambda v: out.append((v, wmax)))
        return out

    return kernel


def _device_apply_kernel(apply_udf: TorchEdgesApply, env):
    """The fn over a padded CSR neighborhood view, one row a vertex."""

    def kernel(edges, wmax) -> List[Record]:
        src, dst, val = _window_arrays(edges)
        uniq, (s_dense,) = seg_ops.intern(src)
        order = np.argsort(s_dense, kind="stable")
        s_sorted = s_dense[order]
        n_seg = len(uniq)
        counts = np.bincount(s_sorted, minlength=n_seg)
        max_deg = seg_ops.bucket_size(int(counts.max()) if n_seg else 1)
        nbr = np.zeros((n_seg, max_deg), dtype=np.int64)
        vals = np.zeros((n_seg, max_deg), dtype=val.dtype)
        mask = np.zeros((n_seg, max_deg), dtype=bool)
        starts = np.zeros(n_seg + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        # each sorted edge's slot is its rank within its vertex's run
        rank = np.arange(len(s_sorted)) - starts[s_sorted]
        nbr[s_sorted, rank] = np.asarray(dst)[order]
        vals[s_sorted, rank] = val[order]
        mask[s_sorted, rank] = True
        dev = env.device
        res = apply_udf.fn(seg_ops.device_values(uniq, dev),
                           seg_ops.device_values(nbr, dev),
                           seg_ops.device_values(vals, dev),
                           torch.from_numpy(mask).to(dev))
        leaves = _leaves(res)
        out: List[Record] = []
        for i in range(n_seg):
            row = tuple(_py(l[i]) for l in leaves)
            value = apply_udf.emit(_py(uniq[i]), row) if apply_udf.emit else row
            out.append((value, wmax))
        return out

    return kernel
