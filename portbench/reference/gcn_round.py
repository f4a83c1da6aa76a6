"""Plain reference of the windowed GCN round, in PyTorch, for the
benchmark's check of `correct`.

It is written from the round's published semantics and imports nothing
of the program. From the inputs the benchmark makes (the stream, the
real-valued weights, the engine's stated buckets) it works out again
everything the program derives: the vertex bucket and its sentinel
row, the aggregation shift from the edge bucket, the lattice snap of
the weights, the cut of a call's edges into windows.

Semantics, for a slab h of [rows + 1, F] lattice units (rows the vertex
bucket, the next power of two at or above the configured count, at
least 8; row `rows` the sentinel that invalid slots point at) and one
window of up to eb edges s -> d:

  m  = sum over the window's edges of floor(h[s] * 2^-shift)   at row d
  p  = min(h + min(m, 511), 511)
  h' = clip(act(p @ W + b), 0, 511), the sentinel row zeroed
  h' = h where the window has no edge (the hold rule)

with W and b the real weights snapped to the 2^-5 grid as integer units
(round half to even, clipped to +-weight_cap(F)), and shift the number
of doublings by which eb passes 2^15. After each window it reports
(max_feat, active_vertices, feat_checksum, msg_edges): the largest unit
in rows [:rows], the rows of [:rows] with a unit above 0, the sum of
every unit of all rows + 1 wrapped to int32, and the window's edges.

Every value is an integer below 2^24, so float32 sums and products are
exact in any order: the reference computes the product in float32 with
TF32 off. `precision="fp8"` is the benchmark's control: the product's
operands rounded to float8 e4m3 with one scale a tensor (the step below
the program's float16 operands), float32 sums.
"""

from __future__ import annotations

import contextlib

import torch

UNIT_CAP = 511
Q_BITS = 5
AGG_EXACT_LOG2 = 15
MIN_BUCKET = 8
FP8_MAX = 448.0
PRECISIONS = ("float32", "fp8")
ACTIVATIONS = ("relu", "abs", "identity")


def bucket(n: int) -> int:
    """The next power of two at or above n, at least MIN_BUCKET."""
    b = MIN_BUCKET
    while b < int(n):
        b *= 2
    return b


def agg_shift(eb: int) -> int:
    return max(0, bucket(eb).bit_length() - 1 - AGG_EXACT_LOG2)


def weight_cap(F: int) -> int:
    shift = max(0, (int(F) - 1).bit_length() - 6)
    return max(1, (UNIT_CAP + 1) >> shift)


def snap(W: torch.Tensor, b: torch.Tensor, F: int):
    """Real weights onto the lattice: units of 2^-5, clipped."""
    cap = float(weight_cap(F))
    units = [torch.clamp(torch.round(x.double() * (1 << Q_BITS)), -cap, cap)
             .float() for x in (W, b)]
    if tuple(units[0].shape) != (F, F) or tuple(units[1].shape) != (F,):
        raise ValueError("weights must be W [F, F] and b [F] at F=%d" % F)
    return units


def wrap_i32(x: int) -> int:
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale, back in float32."""
    scale = x.abs().max().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def slab_checksum(h: torch.Tensor) -> int:
    """The wrapping int32 sum of every unit of the slab (exact: the sum
    of integers below 2^53 in float64)."""
    return wrap_i32(int(h.sum(dtype=torch.float64).item()))


class GcnRound:
    """The reference engine of one configuration: `run(h, src, dst)`
    folds a call's edges, cut into windows of eb, into the slab h and
    returns (h', [windows, 4] int64 summaries on the CPU)."""

    def __init__(self, vertex_bucket: int, edge_bucket: int,
                 feature_dim: int, activation: str, W: torch.Tensor,
                 b: torch.Tensor, precision: str = "float32"):
        if activation not in ACTIVATIONS or precision not in PRECISIONS:
            raise ValueError("activation %r / precision %r unknown"
                             % (activation, precision))
        self.rows = bucket(vertex_bucket)
        self.eb = bucket(edge_bucket)
        self.F = int(feature_dim)
        self.act = activation
        self.shift = agg_shift(self.eb)
        self.precision = precision
        self.W, self.b = snap(W, b, self.F)

    def fresh_slab(self, device) -> torch.Tensor:
        return torch.zeros(self.rows + 1, self.F, dtype=torch.float32,
                           device=device)

    def _product(self, p: torch.Tensor) -> torch.Tensor:
        W = self.W
        if self.precision == "fp8":
            p, W = _fp8(p), _fp8(W)
        with _no_tf32():
            return torch.addmm(self.b, p, W)

    def window(self, h, s, d, v):
        """One window: (h', (max_feat, active, checksum, msg_edges))."""
        rows, cap = self.rows, float(UNIT_CAP)
        n_msg = v.sum()
        if not bool(n_msg):
            return h, [h[:rows].max(), (h[:rows] > 0).any(dim=1).sum(),
                       slab_checksum(h), n_msg]
        s = torch.where(v, s, rows).long()
        d = torch.where(v, d, rows).long()
        msgs = h[s]
        if self.shift:
            msgs = torch.floor(msgs * 2.0 ** -self.shift)
        targets, slot = torch.unique(d, return_inverse=True)
        m = torch.zeros(targets.numel(), self.F, dtype=h.dtype,
                        device=h.device).index_add_(0, slot, msgs)
        p = torch.clamp_max(h, cap)
        p[targets] = torch.clamp_max(
            h[targets] + torch.clamp_max(m, cap), cap)
        del h, msgs, m
        z = self._product(p)
        del p
        if self.act == "relu":
            z.clamp_min_(0.0)
        elif self.act == "abs":
            z.abs_()
        z.clamp_(0.0, cap)
        z[rows] = 0.0
        return z, [z[:rows].max(), (z[:rows] > 0).any(dim=1).sum(),
                   slab_checksum(z), n_msg]

    def run(self, h, src, dst):
        """Fold a call's edges (1-D id tensors on h's device; a ragged
        tail is a last, partial window) into h, window after window."""
        n = int(src.numel())
        out = []
        for lo in range(0, n, self.eb):
            s = torch.full((self.eb,), self.rows, dtype=torch.int64,
                           device=h.device)
            d = s.clone()
            v = torch.zeros(self.eb, dtype=torch.bool, device=h.device)
            hi = min(lo + self.eb, n)
            s[:hi - lo] = src[lo:hi]
            d[:hi - lo] = dst[lo:hi]
            v[:hi - lo] = True
            h, sums = self.window(h, s, d, v)
            out.append(sums)
        table = torch.tensor([[int(x) for x in row] for row in out],
                             dtype=torch.int64)
        return h, table.reshape(len(out), 4)
