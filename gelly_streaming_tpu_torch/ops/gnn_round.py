"""One GCN message-passing round per window of a [W, eb] chunk, folded
into a [vb+1, F] float32 feature slab.

Port of the JAX package's `gnn_window._build_gnn_round` (gnn_window.py:
172-209) and of its Pallas kernel `pallas_window._gnn_call` (:1099-1190).
Per window, with invalid slots mapped to the sentinel row vb:

  m  = Σ over valid slots (s → d) of floor(h[s] · 2^-shift)   (scatter)
  p  = min(h + min(m, 511), 511)
  h' = clip(act(p @ W + b), 0, 511), row vb zeroed
  h' = h when the window has no valid slot (the hold rule)

then (max_feat, active_vertices, feat_checksum, msg_edges) of h':
max_feat and active over rows [:vb], the checksum a wrapping int32 sum
over all vb+1 rows. Features and weights lie on an integer lattice
(ops/gnn_window.py), so every intermediate is an integer below 2^24 in
float32 and the round is exact in any summation order.

`GnnRound` launches the CUDA kernel of csrc/gnn_round.cu (through
`gnn_rounds`) on CUDA tensors and runs `gnn_rounds_plain`, the plain
PyTorch version, on CPU ones; it never falls back from one to the
other. The two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils import costmodel

UNIT_CAP = 511                # max lattice units per slot (< 2^9)
AGG_EXACT_LOG2 = 15           # eb ≤ 2^15 sums exactly at full width

# activation name -> its code in csrc/gnn_round.cu; all exact elementwise
ACTIVATIONS = {"relu": 0, "abs": 1, "identity": 2}
_ACTS = {
    "relu": lambda z: torch.clamp_min(z, 0.0),
    "abs": torch.abs,
    "identity": lambda z: z,
}


def agg_shift(eb: int) -> int:
    """Pre-aggregation message shift: messages floor-divide by 2^shift so
    a full eb-edge window's sum stays under 2^24 lattice units (exact
    float32 integers in any order). From eb alone."""
    return max(0, int(eb).bit_length() - 1 - AGG_EXACT_LOG2)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement int32 wrap of an int64 tensor."""
    x = torch.remainder(x, 2 ** 32)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def gnn_round_plain(h, W, b, s, d, v, eb: int, act: str):
    """One window's round in PyTorch on the tensors' device: h [vb+1, F]
    float32, W [F, F], b [F], s/d [eb] int32, v [eb] bool. Returns
    (h', (max_feat, active, checksum, msg_edges)), the four 0-dim int32.
    The product is `lattice_product`."""
    vb = h.shape[0] - 1
    cap = float(UNIT_CAP)
    sh = agg_shift(eb)
    s = torch.where(v, s, vb).long()
    d = torch.where(v, d, vb).long()
    msgs = h[s]
    if sh:
        msgs = torch.floor(msgs * 2.0 ** -sh)
    m = torch.zeros_like(h).index_add_(0, d, msgs)
    p = torch.clamp_max(h + torch.clamp_max(m, cap), cap)
    z = lattice_product(p, W) + b
    h2 = torch.clamp(_ACTS[act](z), 0.0, cap)
    h2[vb] = 0.0
    h2 = torch.where(v.any(), h2, h)     # an empty window holds the slab
    return h2, slab_summaries(h2) + (v.sum().to(torch.int32),)


def lattice_product(p, W):
    """p @ W in float32 for lattice operands (p integers in [0, 511], W
    integers with |W| ≤ weight_cap(F)). It runs in float64 (exact, and
    independent of PyTorch's TF32 setting); every value it produces is
    an integer below 2^24, so the float32 result equals the JAX
    package's Precision.HIGHEST dot and the kernel's fp16 tensor-core
    product with fp32 sums."""
    return (p.double() @ W.double()).float()


def slab_summaries(h):
    """(max_feat, active, checksum) of a [vb+1, F] slab as 0-dim int32:
    max_feat and active over rows [:vb], the checksum a wrapping int32
    sum over all vb+1 rows."""
    vb = h.shape[0] - 1
    return (h[:vb].max().to(torch.int32),
            (h[:vb] > 0).any(dim=1).sum().to(torch.int32),
            _wrap_i32(h.to(torch.int32).sum(dtype=torch.int64)))


def gnn_rounds_plain(h, W, b, src, dst, valid, act: str,
                     sums: torch.Tensor) -> None:
    """The plain version of `GnnRound`: window by window, `h` updated
    in place, sums [4, W] int32 written."""
    eb = src.shape[1]
    for w in range(src.shape[0]):
        h2, outs = gnn_round_plain(h, W, b, src[w], dst[w], valid[w], eb,
                                   act)
        h.copy_(h2)
        sums[:, w] = torch.stack(outs)


class GnnRound:
    """round(h, W, b, src[W, eb], dst, valid, act, sums[4, W]) at a fixed
    slab shape [vb+1, F] on one device: folds the chunk into h in place,
    window after window, and writes the [4, W] int32 sums (rows
    max_feat, active_vertices, feat_checksum, msg_edges). W [F, F] and
    b [F] are float32 on the integer lattice.

    On a card it is the only owner of the kernel's [vb+1, F] float32
    aggregate scratch, allocated at its first call and reused after, and
    launches `gnn_rounds` on the current stream with no host
    synchronisation: W's fp16 image once a call, then a scatter and an
    update launch a window. The update is bound by bytes (the slab read
    and written in place, 536.9 MB and 0.160 ms at 3.35 TB/s a window at
    vb = 262,144, F = 256; 8.59 GB and 2.564 ms at vb = 4,194,304), so it
    streams the slab: persistent blocks keep the next rows' copies in
    flight in a ring in shared memory while the tensor cores multiply
    the rows before them by W (resident in shared memory) and the
    epilogue writes them back (csrc/gnn_round.cu). On the CPU it runs
    `gnn_rounds_plain`."""

    def __init__(self, vb: int, F: int, device: torch.device):
        self.vb, self.F = vb, F
        self.device = torch.device(device)
        self.scratch = None

    def __call__(self, h, W, b, src, dst, valid, act: str,
                 sums: torch.Tensor) -> None:
        _act_code(act)
        if src.device != self.device:
            raise ValueError("GNN round on %s given tensors on %s"
                             % (self.device, src.device))
        if tuple(h.shape) != (self.vb + 1, self.F):
            raise ValueError("GNN round at vb+1=%d, F=%d given a %s slab"
                             % (self.vb + 1, self.F, tuple(h.shape)))
        with costmodel.launch(
                "gnn_round", (h, src),
                lambda: costmodel.gnn_work(src.shape[0], src.shape[1],
                                           self.vb, self.F), src.device):
            if src.device.type == "cpu":
                gnn_rounds_plain(h, W, b, src, dst, valid, act, sums)
                return
            if self.scratch is None:
                self.scratch = torch.empty_like(h)
            gnn_rounds(h, W, b, src, dst, valid, act, sums, self.scratch)


def gnn_rounds(h, W, b, src, dst, valid, act: str, sums: torch.Tensor,
               scratch: torch.Tensor) -> None:
    """The kernel alone, on CUDA tensors: `GnnRound`'s fold, with
    `scratch` a float32 tensor shaped like h that the call zeroes and
    leaves zero (the kernel reads and clears it only in the rows that
    a window's messages reach, which it marks in a uint8 [vb+1] tensor
    allocated here, beside the scratch of W's fp16 image that the update
    blocks copy, of the size the library gives)."""
    act_id = _act_code(act)
    _check(h, W, b, src, dst, valid, sums, scratch)
    vb, feat = h.shape[0] - 1, h.shape[1]
    windows, eb = src.shape
    # the rows each window's messages reach, one byte a row (the call
    # zeroes it first); from PyTorch's caching allocator, on the stream
    touched = torch.empty(vb + 1, dtype=torch.uint8, device=h.device)
    lib = kernels.library("gnn_round")
    image_bytes = ctypes.c_int()
    kernels.check("gnn_round", lib.gs_gnn_w_image_bytes(
        feat, ctypes.byref(image_bytes)))
    w_image = torch.empty(image_bytes.value, dtype=torch.uint8,
                          device=h.device)
    code = lib.gs_gnn_rounds(
        h.data_ptr(), W.data_ptr(), b.data_ptr(), src.data_ptr(),
        dst.data_ptr(), valid.data_ptr(), windows, eb, vb, feat, act_id,
        agg_shift(eb), scratch.data_ptr(), touched.data_ptr(),
        w_image.data_ptr(), sums.data_ptr(), h.device.index,
        kernels.stream_of(h))
    kernels.check("gnn_round", code)
    kernels.LAUNCHES["gnn_round"] += 1


def _act_code(act: str) -> int:
    if act not in ACTIVATIONS:
        raise ValueError("unknown GNN activation %r (choices: %s)"
                         % (act, sorted(ACTIVATIONS)))
    return ACTIVATIONS[act]


def _check(h, W, b, src, dst, valid, sums, scratch) -> None:
    dev = src.device
    if dev.type != "cuda":
        raise ValueError("the GNN round kernel takes CUDA tensors, got %s"
                         % dev)
    w, eb = src.shape if src.dim() == 2 else (0, 0)
    rows, feat = h.shape if h.dim() == 2 else (0, 0)
    want = [("h", h, torch.float32, (rows, feat)),
            ("W", W, torch.float32, (feat, feat)),
            ("b", b, torch.float32, (feat,)),
            ("src", src, torch.int32, (w, eb)),
            ("dst", dst, torch.int32, (w, eb)),
            ("valid", valid, torch.bool, (w, eb)),
            ("sums", sums, torch.int32, (4, w)),
            ("scratch", scratch, torch.float32, (rows, feat))]
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s %s tensor on %s, "
                             "got %s %s on %s" % (name, shape, dtype, dev,
                                                  tuple(t.shape), t.dtype,
                                                  t.device))
    if not (0 < w and 0 < eb < 2 ** 24 and 2 <= rows < 2 ** 26
            and 1 <= feat <= 256):
        raise ValueError("unsupported shape: W=%d eb=%d vb+1=%d F=%d"
                         % (w, eb, rows, feat))


def register_cost_model(eb: int, vb: int, feat: int, windows: int,
                        device) -> None:
    """State the cost of a `GnnRound` call of `windows` windows at (eb,
    vb, F) on `device` to the cost observatory before its first launch
    (armed only; the JAX package's `register_gnn_cost_model`): the row
    its launches then join."""
    nbytes, ops, kind = costmodel.gnn_work(windows, eb, vb, feat)
    costmodel.record_analytic(
        "gnn_round",
        costmodel.shape_sig((torch.float32, (vb + 1, feat)),
                            (torch.int32, (windows, eb))),
        ops, nbytes, kind=kind, card=costmodel.card_of(device))
