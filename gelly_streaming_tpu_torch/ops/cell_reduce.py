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


PLAN_KEYS = ("cluster", "span", "passes", "stages", "stage_bytes",
             "clusters", "sms", "room")

# csrc/cell_reduce.cu's plan constants
STAGE_BYTES = 49152
MIN_STAGES, MAX_STAGES = 2, 4
RING_MIN_BYTES = 262144  # smaller windows are read with plain loads
MAX_CLUSTER = 8
SPREAD_MIN = 2048
SLOT_ALIGN = 8
SMEM_OPTIN = 232448      # shared memory a block may use on an H100


def slot_bytes(wire: str, direction: str) -> int:
    """Bytes a slot of a window of the wire holds: 8 a direction on the
    standard wire (an int32 id and a value), two uint16 ids or one and
    a value on the compact one."""
    rep = 2 if direction == "all" else 1
    return 8 * rep if wire == "standard" else 2 * rep + 4


def plan(wb: int, vbp: int, device, eb: int, wire: str = "standard",
         direction: str = "out") -> dict:
    """The kernel's launch shape for wb windows of eb slots at vbp cells
    on a card (PLAN_KEYS): blocks a window (the cluster), vertices a
    block holds a pass, passes, the ring's stages (0: each window read
    with plain loads) and bytes a stage, the clusters launched (one a
    window), and the card's SMs and the shared memory a block may use
    beside the kernel's static part (`room`), from which `plan_mirror`
    derives the same shape."""
    dev = torch.device(device)
    out = (ctypes.c_int * len(PLAN_KEYS))()
    kernels.check("cell_reduce", kernels.library("cell_reduce")
                  .gs_cell_reduce_plan(wb, eb, slot_bytes(wire, direction),
                                       vbp, dev.index, out))
    return dict(zip(PLAN_KEYS, out))


def plan_smem(span: int, stages: int) -> int:
    """Dynamic shared memory of a plan: the ring, then the cells and the
    counts, each span words and up to 12 bytes to set its 16-byte
    phase."""
    return stages * STAGE_BYTES + 2 * ((span * 4 + 31) & ~15)


def plan_mirror(wb: int, vbp: int, sms: int, room: int,
                window_bytes: int) -> dict:
    """csrc/cell_reduce.cu `plan` in Python: the cluster, span, passes,
    stages and dynamic shared memory of a call of wb windows of
    `window_bytes` at vbp cells on a card of `sms` SMs with `room` bytes
    of shared memory a block."""
    wb, vbp = max(wb, 1), max(vbp, 1)
    ring = window_bytes >= RING_MIN_BYTES
    max_span = ((room - (MIN_STAGES * STAGE_BYTES if ring else 0) - 64)
                // 8) & ~31
    c = 1
    while c < MAX_CLUSTER and max_span * c < vbp:
        c *= 2
    while (c < MAX_CLUSTER and 2 * wb * c <= sms
           and -(-vbp // (2 * c)) >= SPREAD_MIN):
        c *= 2
    span = max(1, min(max_span, -(-vbp // c)))
    passes = -(-vbp // (c * span))
    stages = MAX_STAGES if ring else 0
    while plan_smem(span, stages) > room:
        stages -= 1
    return {"cluster": c, "span": span, "passes": passes,
            "stages": stages, "stage_bytes": STAGE_BYTES,
            "smem": plan_smem(span, stages)}


def tile_slots(per_slot: int) -> int:
    """Slots a stage holds of a wire of `per_slot` bytes a slot (the
    kernel's tile), a multiple of SLOT_ALIGN."""
    return STAGE_BYTES // per_slot // SLOT_ALIGN * SLOT_ALIGN
