"""The cohort summary body: per window round of an [nb, W, eb] slab, the
window summary of every tenant row against that row's own carry, then
(max_degree, num_components, odd, triangles, k_overflow) as [nb, W].

Port of the JAX package's `scan_analytics.build_cohort_scan` body
(scan_analytics.py:116-170: the summary body vmapped over the tenant
axis) and of its Pallas kernel `pallas_window._cohort_call` (:640-745,
reached through `build_cohort_window_body` :886-916). The carries are
stacked per tenant: deg[nb, vb+1], labels[nb, vb+1], cover[nb, 2(vb+1)]
int32, each row laid out as ops/window_summary.py says. A pad row (all
windows invalid) folds only the cover's sentinel join into its carry;
a tenant with fewer windows than the slab's W folds the all-invalid
windows the same way, so callers batch as the JAX cohort does.

`CohortSummary` is the cohort's one entry, the counterpart of the JAX
`build_cohort_scan` (its outputs are [nb, W] as that function's; the
carries are updated in place rather than returned). It launches the CUDA
kernel of csrc/cohort_summary.cu (degrees, union-find, summaries: one
launch per dispatch, whatever nb and W are; csrc/summary_body.cuh) and a
`WindowCounter` (ops/window_counter.py) for triangles and K-overflow on
CUDA tensors, and runs `summarize_cohort_plain`, the plain PyTorch
version, on CPU ones; it never falls back from one to the other. The
two agree bit for bit, overflowing windows included. With the cost
observatory armed (GS_COSTMODEL, utils/costmodel.py) each call is one
`cohort_summary` row: CUDA events around its two launches, its bytes and
operations from `costmodel.summary_work(W, eb, vb, rows=nb)`.
Each carry row must be one the engines make
(ops/scan_analytics.check_summary_carry says which).
"""

from __future__ import annotations

import torch

from .. import kernels
from ..utils import costmodel
from .window_counter import WindowCounter
from .window_summary import summarize_windows_plain

def fresh_cohort_carry(nb: int, vb: int, device) -> tuple:
    """The stacked carries of nb streams that have folded nothing yet."""
    return (torch.zeros(nb, vb + 1, dtype=torch.int32, device=device),
            torch.arange(vb + 1, dtype=torch.int32,
                         device=device).repeat(nb, 1),
            torch.arange(2 * (vb + 1), dtype=torch.int32,
                         device=device).repeat(nb, 1))


def summarize_cohort_plain(carries, src, dst, valid, vb: int, kb: int):
    """The plain version: `summarize_windows_plain` over each tenant row
    of the [nb, W, eb] slab, updating that row of `carries` in place.
    Returns (max_degree, num_components, odd (bool), triangles,
    k_overflow), each [nb, W]."""
    rows = [summarize_windows_plain(tuple(c[n] for c in carries), src[n],
                                    dst[n], valid[n], vb, kb)
            for n in range(src.shape[0])]
    return tuple(torch.stack([r[i] for r in rows]) for i in range(5))


class CohortSummary:
    """summary(carries, src[nb, W, eb], dst, valid) -> (max_degree,
    num_components, odd, triangles, k_overflow), each [nb, W], at fixed
    (vb, kb) on one device. The stacked carries are updated in place:
    after the call row n holds tenant n's state after its slab row. Rows
    are independent: a pad row folds as a no-op against its carry, apart
    from the cover's sentinel join. Device, dtypes, shapes and
    contiguity are checked on both paths and raise ValueError.

    On a card it launches the cohort kernel (csrc/cohort_summary.cu: one
    launch per call on the current stream) and its `WindowCounter`
    (kernel 2, one launch) over the slab seen as [nb·W, eb] (`count`),
    with no synchronisation. On the CPU it runs
    `summarize_cohort_plain`."""

    def __init__(self, vb: int, kb: int, device: torch.device):
        self.vb, self.kb = vb, kb
        self.device = torch.device(device)
        self.counter = WindowCounter(vb, kb, self.device)

    def __call__(self, carries, src, dst, valid):
        if src.device != self.device:
            raise ValueError("cohort summary on %s given tensors on %s"
                             % (self.device, src.device))
        _check(carries, src, dst, valid, self.vb)
        nb, windows, eb = src.shape
        with costmodel.launch(
                "cohort_summary", (carries[0], src),
                lambda: costmodel.summary_work(windows, eb, self.vb,
                                               rows=nb), src.device):
            if src.device.type == "cpu":
                return summarize_cohort_plain(carries, src, dst, valid,
                                              self.vb, self.kb)
            sums = torch.empty(nb, 3, windows, dtype=torch.int32,
                               device=src.device)
            summarize_cohort(carries, src, dst, valid, self.vb, sums)
            tri, overflow = self.count(src, dst, valid)
            return (sums[:, 0], sums[:, 1], sums[:, 2] != 0,
                    tri.view(nb, windows), overflow.view(nb, windows))

    def count(self, src, dst, valid):
        """The triangle stage alone, on a checked CUDA slab: (count,
        overflow), each [nb·W] int32, from one counter call over the slab
        seen as [nb·W, eb]."""
        nb, windows, eb = src.shape
        return self.counter(*(x.view(nb * windows, eb)
                              for x in (src, dst, valid)))


def summarize_cohort(carries, src, dst, valid, vb: int,
                     sums: torch.Tensor) -> None:
    """The cohort kernel alone, on CUDA tensors: folds the [nb, W, eb]
    slab into the stacked `carries` in place and writes sums [nb, 3, W]
    int32 (rows max_degree, num_components, odd as 0/1)."""
    if src.device.type != "cuda":
        raise ValueError("the cohort summary kernel takes CUDA tensors, "
                         "got %s" % src.device)
    _check(carries, src, dst, valid, vb,
           [("sums", sums, torch.int32, (src.shape[0], 3, src.shape[1]))])
    deg, labels, cover = carries
    nb, windows, eb = src.shape
    lib = kernels.library("cohort_summary")
    code = lib.gs_cohort_summary(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), nb, windows, eb,
        vb, deg.data_ptr(), labels.data_ptr(), cover.data_ptr(),
        sums.data_ptr(), src.device.index, kernels.stream_of(src))
    kernels.check("cohort_summary", code)
    kernels.LAUNCHES["cohort_summary"] += 1


def _check(carries, src, dst, valid, vb: int, more=()) -> None:
    """Raise ValueError unless the slab, the carries (and `more`, as
    (name, tensor, dtype, shape)) are contiguous tensors of the cohort's
    dtypes and shapes on src's device."""
    dev = src.device
    if len(carries) != 3:
        raise ValueError("carries must be (deg, labels, cover)")
    nb, w, eb = src.shape if src.dim() == 3 else (0, 0, 0)
    want = [("src", src, torch.int32, (nb, w, eb)),
            ("dst", dst, torch.int32, (nb, w, eb)),
            ("valid", valid, torch.bool, (nb, w, eb)),
            ("deg", carries[0], torch.int32, (nb, vb + 1)),
            ("labels", carries[1], torch.int32, (nb, vb + 1)),
            ("cover", carries[2], torch.int32, (nb, 2 * (vb + 1)))]
    want.extend(more)
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError("%s must be a contiguous %s %s tensor on %s, "
                             "got %s %s on %s" % (name, shape, dtype, dev,
                                                  tuple(t.shape), t.dtype,
                                                  t.device))
    # the kernel indexes a call's slots, carry slots and sums in 32 bits
    if not (0 < nb <= 65535 and 0 < w and 0 < eb < 2 ** 30
            and 0 < vb < 2 ** 29 and nb * max(eb, 3 * (vb + 1)) < 2 ** 31
            and 3 * nb * w < 2 ** 31):
        raise ValueError("unsupported shape: nb=%d W=%d eb=%d vb=%d"
                         % (nb, w, eb, vb))
