"""The fused summary body: per window of a [W, eb] chunk, the carried
degree fold, CC labels and double cover, then (max_degree,
num_components, odd, triangles, k_overflow).

Port of the JAX package's `scan_analytics._build_scan` body
(scan_analytics.py:87-111) and of its Pallas kernel
`pallas_window._window_call` (:504-637, with `_final_summaries` :488-496
and the triangle stage `_tri_stage` :448-485). The carry is
(deg[vb+1], labels[vb+1], cover[2(vb+1)]) int32 with slot vb the
sentinel; the cover puts (+) at v and (-) at v+vb+1, so edge padding
(vb) meets the two cover sentinels (vb, 2vb+1) and never a real slot.
Every window with a padded slot joins those two sentinels, so
cover[2vb+1] becomes vb: callers pad exactly as the JAX engine does.

`WindowSummary` launches the CUDA kernel of csrc/window_summary.cu
(degrees, union-find, summaries: one launch per chunk, the body of
csrc/summary_body.cuh) and the window counter
(ops/window_counter.py, for triangles and K-overflow) on CUDA tensors,
and runs `summarize_windows_plain`, the plain PyTorch version, on CPU
ones; it never falls back from one to the other. The two agree bit for
bit, overflowing windows included. Both read either wire (ops/compact_ingress.py):
on the compact one (`wire="compact"`: uint16 ids, one valid count per
window) the two kernels decode each slot where they load it, and the
plain version widens the stack first (`widen_stack`). A padded slot folds
the same on both wires, so the carries agree bit for bit across them.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import costmodel
from . import unionfind
from .compact_ingress import widen_stack
from .window_counter import (WIRES, WindowCounter, check_wire,
                             count_windows_plain)


def fresh_carry(vb: int, device) -> tuple:
    """The carry of a stream that has folded nothing yet."""
    return (torch.zeros(vb + 1, dtype=torch.int32, device=device),
            torch.arange(vb + 1, dtype=torch.int32, device=device),
            torch.arange(2 * (vb + 1), dtype=torch.int32, device=device))


def summarize_windows_plain(carry, src, dst, valid, vb: int, kb: int):
    """The plain version, window by window in PyTorch on the tensors'
    device: folds src/dst/valid [W, eb] into `carry` (updated in place)
    and returns (max_degree[W] int32, num_components[W] int32, odd[W]
    bool, triangles[W] int32, k_overflow[W] int32)."""
    deg, labels, cover = carry
    num_w = src.shape[0]
    dev = src.device
    sums = torch.zeros(3, num_w, dtype=torch.int32, device=dev)
    vidx = torch.arange(vb, dtype=torch.int32, device=dev)
    for w in range(num_w):
        v = valid[w]
        s = torch.where(v, src[w], vb)
        d = torch.where(v, dst[w], vb)
        ones = v.to(torch.int32)
        deg.index_add_(0, s, ones).index_add_(0, d, ones)
        labels.copy_(unionfind.cc_fixpoint_plain(labels, s, d))
        cover.copy_(unionfind.cc_fixpoint_plain(
            cover, torch.cat([s, s + (vb + 1)]),
            torch.cat([d + (vb + 1), d])))
        touched = deg[:vb] > 0
        sums[0, w] = deg[:vb].max()
        sums[1, w] = (touched & (labels[:vb] == vidx)).sum()
        sums[2, w] = (touched & (cover[:vb] == cover[vb + 1:2 * vb + 1])
                      ).any()
    tri, overflow = count_windows_plain(src, dst, valid, vb, kb)
    return sums[0], sums[1], sums[2] != 0, tri, overflow


class WindowSummary:
    """summary(carry, src[W, eb], dst, valid) -> (max_degree[W],
    num_components[W], odd[W], triangles[W], k_overflow[W]) at fixed
    (vb, kb) on one device, or summary(carry, s16[W, eb], d16, nvalid[W],
    wire="compact"). The carry (deg, labels, cover) is updated in
    place: after the call it holds the state after the chunk's last
    window. It must be a carry the engines make, as
    ops/scan_analytics.check_summary_carry says: labels and cover point
    every slot at an equal or smaller one, a vertex of degree 0 is a
    singleton root in labels, and the cover's sets are closed under the
    mirror v <-> v+vb+1 (the kernel reads the summaries incrementally on
    these invariants).

    On a card it launches the summary kernel (csrc/window_summary.cu:
    one launch per call on the current stream) and its
    `WindowCounter` (kernel 2, all W windows in one launch) on the same
    device-resident chunk and wire, with no synchronisation and no
    widened intermediate; the counter is the only owner of its device
    scratch. On the CPU it runs `summarize_windows_plain` (after
    `widen_stack` on the compact wire)."""

    def __init__(self, vb: int, kb: int, device: torch.device):
        self.vb, self.kb = vb, kb
        self.device = torch.device(device)
        self.counter = WindowCounter(vb, kb, self.device)

    def __call__(self, carry, src, dst, valid, wire: str = "standard"):
        if src.device != self.device:
            raise ValueError("window summary on %s given tensors on %s"
                             % (self.device, src.device))
        if wire not in WIRES:
            raise ValueError("unknown wire %r (choices: %s)"
                             % (wire, WIRES))
        w, eb = src.shape
        with costmodel.launch(
                "window_summary_compact" if wire == "compact"
                else "window_summary", (carry[0], src),
                lambda: costmodel.summary_work(w, eb, self.vb, wire),
                src.device):
            if src.device.type == "cpu":
                if wire == "compact":
                    src, dst, valid = widen_stack(src, dst, valid, eb,
                                                  self.vb)
                return summarize_windows_plain(carry, src, dst, valid,
                                               self.vb, self.kb)
            sums = torch.empty(3, w, dtype=torch.int32, device=src.device)
            summarize(carry, src, dst, valid, self.vb, sums, wire)
            tri, overflow = self.counter(src, dst, valid, wire)
        return sums[0], sums[1], sums[2] != 0, tri, overflow


def summarize(carry, src, dst, valid, vb: int, sums: torch.Tensor,
              wire: str = "standard") -> None:
    """The summary kernel alone, on CUDA tensors of either wire: folds
    the [W, eb] chunk into `carry` in place and writes sums [3, W] int32
    (rows max_degree, num_components, odd as 0/1)."""
    _check(carry, src, dst, valid, vb, sums, wire)
    deg, labels, cover = carry
    lib = kernels.library("window_summary")
    entry = (lib.gs_window_summary_compact if wire == "compact"
             else lib.gs_window_summary)
    code = entry(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), src.shape[0],
        src.shape[1], vb, deg.data_ptr(), labels.data_ptr(),
        cover.data_ptr(), sums.data_ptr(), src.device.index,
        kernels.stream_of(src))
    kernels.check("window_summary", code)
    kernels.LAUNCHES["window_summary_compact" if wire == "compact"
                     else "window_summary"] += 1


def _check(carry, src, dst, valid, vb: int, sums, wire: str) -> None:
    check_wire(src, dst, valid, wire, "window summary")
    dev = src.device
    if len(carry) != 3:
        raise ValueError("carry must be (deg, labels, cover)")
    w, eb = src.shape
    want = [("deg", carry[0], torch.int32, (vb + 1,)),
            ("labels", carry[1], torch.int32, (vb + 1,)),
            ("cover", carry[2], torch.int32, (2 * (vb + 1),)),
            ("sums", sums, torch.int32, (3, w))]
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s %s tensor on %s, "
                             "got %s %s on %s" % (name, shape, dtype, dev,
                                                  tuple(t.shape), t.dtype,
                                                  t.device))
    if not (0 < w and 0 < eb < 2 ** 30 and 0 < vb < 2 ** 29):
        raise ValueError("unsupported shape: W=%d eb=%d vb=%d"
                         % (w, eb, vb))
