"""The per-(window, vertex) cell reduce: for a stack of `wb` windows, the
sum, min or max of each window's contributions at each vertex, and how
many there were.

Stands in for the JAX package's XLA segment programs of the columnar
windowed reduce (`ops/windowed_reduce.py` `_stack_fn` :317,
`_stack_fn_compact` :341, the delta tail `_delta_tail` :307) and of the
neighborhood API's named-monoid reduce (`ops/neighborhood.py` :169,
:380 through `ops/segment.py` `segment_reduce` :51), which have no
Pallas kernel. Outputs: cells [wb, vbp] in the values' dtype (int32 or
float32: the JAX package runs with x64 off) and counts [wb, vbp] int32;
a cell nothing reached holds `cell_fill` (0 for sum, the dtype's
extremes or ±inf for min and max), as XLA's empty segments do. With
egress="delta" the touched-cell wire of ops/delta_egress.py instead:
(cnt [wb], idx [wb, cap] ascending, cells [wb, cap], counts [wb, cap]),
slots past cnt holding cell 0's entry.

Two wires, as the JAX programs take them:
- standard: int32 cell ids and values [rep, wb, eb] flattened (rep 2
  for direction "all"), id w·vbp + v, and anything outside window w's
  range [w·vbp, (w+1)·vbp) (the trash id wb·vbp) for padding;
- compact: uint16 src and dst [wb, eb], [wb] valid counts (padding is
  each window's suffix) and values [wb, eb], with a direction.

`cell_reduce` and `cell_reduce_compact` launch the CUDA kernel of
csrc/cell_reduce.cu on CUDA tensors (one launch a call on the current
stream, no synchronisation) and run the plain PyTorch version
(`cell_reduce_plain`: `index_add_`, `scatter_reduce_` from the fill) on
CPU ones; they never fall back from one to the other. A float32 sum on
the card adds in an order that changes from run to run: it is held to
|got - want| <= 1e-5 · Σ|v| a cell; everything else is bit-equal.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .compact_ingress import widen_stack
from .segment import cell_fill

OPS = {"sum": 0, "min": 1, "max": 2}
DIRECTIONS = {"out": 0, "in": 1, "all": 2}
EGRESS = ("full", "delta")
VALUE_DTYPES = (torch.int32, torch.float32)


def touched_wire(cells: torch.Tensor, counts: torch.Tensor, cap: int):
    """The delta wire of full [wb, vbp] rows (the JAX package's
    `delta_egress.compact_touched`, row by row): (cnt, idx, cells,
    counts), the touched cells ascending, slots past cnt at cell 0."""
    touched = counts > 0
    cnt = touched.sum(1, dtype=torch.int32)
    order = torch.argsort((~touched).to(torch.int8), dim=1,
                          stable=True)[:, :cap]
    slot = torch.arange(cap, device=cells.device)[None, :]
    idx = torch.where(slot < cnt[:, None], order, 0)
    return (cnt, idx.to(torch.int32), torch.gather(cells, 1, idx),
            torch.gather(counts, 1, idx))


def cell_reduce_plain(ids: torch.Tensor, vals: torch.Tensor, wb: int,
                      eb: int, vbp: int, name: str):
    """The plain version on the tensors' device: (cells, counts) [wb, vbp]
    of the standard wire."""
    ids, vals = ids.reshape(-1), vals.reshape(-1)
    n_cells = wb * vbp
    dev = ids.device
    cid = ids.long()
    if wb * eb:
        win = (torch.arange(cid.numel(), device=dev) % (wb * eb)) // eb
        own = (cid >= win * vbp) & (cid < (win + 1) * vbp)
        cid = torch.where(own, cid, n_cells)
    cells = torch.full((n_cells + 1,), cell_fill(name, vals.dtype),
                       dtype=vals.dtype, device=dev)
    if name == "sum":
        cells.index_add_(0, cid, vals)
    else:
        cells.scatter_reduce_(0, cid, vals, "amin" if name == "min"
                              else "amax", include_self=True)
    counts = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, cid, torch.ones_like(cid, dtype=torch.int32))
    return cells[:-1].reshape(wb, vbp), counts[:-1].reshape(wb, vbp)


def compact_cell_ids(s16, d16, nvalid, vals, vbp: int, direction: str):
    """The standard wire (ids, values) of a compact-wire stack: the plain
    decode the JAX package's `_stack_fn_compact` runs before its segment
    program."""
    wb, eb = s16.shape
    s, d, valid = widen_stack(s16, d16, nvalid, eb, 0)
    base = (torch.arange(wb, dtype=torch.int32, device=s.device)
            * vbp)[:, None]

    def ids_of(v):
        return torch.where(valid, base + v, wb * vbp).reshape(-1)

    if direction == "out":
        return ids_of(s), vals.reshape(-1)
    if direction == "in":
        return ids_of(d), vals.reshape(-1)
    return (torch.cat([ids_of(s), ids_of(d)]),
            torch.cat([vals.reshape(-1)] * 2))


class _Out(ctypes.Structure):
    """csrc/cell_reduce.cu's CellOut."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("cells", "counts", "cnt", "idx", "dcells", "dcounts")] + [
        ("cap", ctypes.c_int)]


def _check(name, vals, wb, vbp, egress, cap, dev, numel) -> None:
    if name not in OPS:
        raise ValueError("unknown monoid %r (choices: %s)"
                         % (name, ", ".join(OPS)))
    if egress not in EGRESS:
        raise ValueError("unknown egress %r (choices: %s)"
                         % (egress, ", ".join(EGRESS)))
    if vals.dtype not in VALUE_DTYPES or vals.device != dev \
            or vals.numel() != numel or not vals.is_contiguous():
        raise ValueError("values must be a contiguous int32 or float32 "
                         "tensor of %d entries on %s" % (numel, dev))
    if not (wb > 0 and 0 < vbp and wb * vbp < 2 ** 31 - 1):
        raise ValueError("unsupported shape: wb=%d vbp=%d" % (wb, vbp))
    if egress == "delta" and not 0 < cap <= vbp:
        raise ValueError("delta egress needs 0 < cap <= vbp, got %d" % cap)


def _outputs(wb, vbp, dtype, egress, cap, dev):
    """The output tensors and the CellOut pointing at them."""
    out = _Out(cap=cap)
    if egress == "delta":
        res = (torch.empty(wb, dtype=torch.int32, device=dev),
               torch.empty(wb, cap, dtype=torch.int32, device=dev),
               torch.empty(wb, cap, dtype=dtype, device=dev),
               torch.empty(wb, cap, dtype=torch.int32, device=dev))
        out.cnt, out.idx, out.dcells, out.dcounts = (t.data_ptr()
                                                     for t in res)
    else:
        res = (torch.empty(wb, vbp, dtype=dtype, device=dev),
               torch.empty(wb, vbp, dtype=torch.int32, device=dev))
        out.cells, out.counts = (t.data_ptr() for t in res)
    return res, out


def _egress(cells, counts, egress, cap):
    return touched_wire(cells, counts, cap) if egress == "delta" \
        else (cells, counts)


def cell_reduce(ids: torch.Tensor, vals: torch.Tensor, wb: int, eb: int,
                vbp: int, name: str, egress: str = "full", cap: int = 0):
    """The standard wire: ids int32 and vals (int32 or float32) of
    rep·wb·eb entries, rep 1 or 2. Full rows (cells, counts) or the delta
    wire (cnt, idx, cells, counts)."""
    dev = ids.device
    rep = ids.numel() // max(wb * eb, 1)
    if ids.dtype != torch.int32 or not ids.is_contiguous() \
            or rep not in (1, 2) or ids.numel() != rep * wb * eb:
        raise ValueError("ids must be a contiguous int32 tensor of wb·eb "
                         "or 2·wb·eb entries")
    _check(name, vals, wb, vbp, egress, cap, dev, ids.numel())
    if dev.type == "cpu":
        return _egress(*cell_reduce_plain(ids, vals, wb, eb, vbp, name),
                       egress, cap)
    res, out = _outputs(wb, vbp, vals.dtype, egress, cap, dev)
    lib = kernels.library("cell_reduce")
    code = lib.gs_cell_reduce(
        ids.data_ptr(), vals.data_ptr(), wb, eb, rep, vbp, OPS[name],
        int(vals.dtype == torch.float32), ctypes.byref(out), dev.index,
        kernels.stream_of(ids))
    kernels.check("cell_reduce", code)
    kernels.LAUNCHES["cell_reduce"] += 1
    return res


def cell_reduce_compact(s16: torch.Tensor, d16: torch.Tensor,
                        nvalid: torch.Tensor, vals: torch.Tensor, vbp: int,
                        name: str, direction: str, egress: str = "full",
                        cap: int = 0):
    """The compact wire: s16, d16 uint16 and vals [wb, eb], nvalid [wb]
    int32. Returns what `cell_reduce` does."""
    dev = s16.device
    if direction not in DIRECTIONS:
        raise ValueError("unknown direction %r" % (direction,))
    if s16.dim() != 2:
        raise ValueError("s16 must be [wb, eb]")
    wb, eb = s16.shape
    for t, dtype, shape in ((s16, torch.uint16, (wb, eb)),
                            (d16, torch.uint16, (wb, eb)),
                            (nvalid, torch.int32, (wb,))):
        if t.dtype != dtype or t.device != dev \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("compact wire: a contiguous %s %s tensor on "
                             "%s expected" % (dtype, shape, dev))
    _check(name, vals, wb, vbp, egress, cap, dev, wb * eb)
    if dev.type == "cpu":
        ids, v = compact_cell_ids(s16, d16, nvalid, vals, vbp, direction)
        return _egress(*cell_reduce_plain(ids, v, wb, eb, vbp, name),
                       egress, cap)
    res, out = _outputs(wb, vbp, vals.dtype, egress, cap, dev)
    lib = kernels.library("cell_reduce")
    code = lib.gs_cell_reduce_compact(
        s16.data_ptr(), d16.data_ptr(), nvalid.data_ptr(), vals.data_ptr(),
        wb, eb, DIRECTIONS[direction], vbp, OPS[name],
        int(vals.dtype == torch.float32), ctypes.byref(out), dev.index,
        kernels.stream_of(s16))
    kernels.check("cell_reduce", code)
    kernels.LAUNCHES["cell_reduce"] += 1
    return res


def plan(wb: int, vbp: int, device) -> dict:
    """The kernel's launch shape for wb windows of vbp cells on a card:
    blocks a window (the cluster), vertices a block holds a pass, and
    passes."""
    dev = torch.device(device)
    out = (ctypes.c_int * 3)()
    kernels.check("cell_reduce", kernels.library("cell_reduce")
                  .gs_cell_reduce_plan(wb, vbp, dev.index, out))
    return {"cluster": out[0], "span": out[1], "passes": out[2]}
