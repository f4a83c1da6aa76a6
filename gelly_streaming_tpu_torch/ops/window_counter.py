"""The triangle-only window counter: per window of a [W, eb] edge stack,
(count, overflow) as int32.

Port of the JAX package's `triangles.build_window_counter` body
(triangles.py:397-430) and of its Pallas kernel
`pallas_window._counter_call` (pallas_window.py:748-792, with
`_tri_stage` :448-485). Each window runs clean -> multigraph degree ->
orient low(deg, id) -> high(deg, id) -> dedupe -> R(v), v's distinct
out-neighbors truncated to the kb smallest ids -> count = Σ over distinct
oriented edges (a, b) of |R(a) ∩ R(b)|, overflow = Σ_v max(0, distinct
outdeg_v - kb). `count` is exact whenever overflow is 0, and callers
recount otherwise; where overflow > 0 it is still the JAX package's
value.

`WindowCounter` (and `count_windows_device`, one call of it) launches
the CUDA kernel of csrc/window_counter.cu on CUDA tensors: one launch a
call, one block a window at a time, which builds the window's short
sorted CSR rows and intersects them (its tiers and stages are described
there). On CPU tensors it runs `count_windows_plain`, the plain PyTorch
version; it never falls back from one to the other. It reads either wire
(ops/compact_ingress.py): the standard (src, dst, valid), or with
`wire="compact"` the compact (s16, d16, nvalid), which the kernel decodes
slot by slot as it loads it and the plain version widens first
(`widen_stack`). Kernel and plain version agree on both outputs of every
window.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..utils import costmodel
from . import intersect
from .compact_ingress import widen_stack

WIRES = ("standard", "compact")


def orient_by_degree(s: torch.Tensor, d: torch.Tensor,
                     deg: torch.Tensor):
    """Orient each edge low(deg, id) -> high(deg, id); the sentinel maps
    to itself. The tie-break of the JAX package's
    triangles.orient_by_degree (triangles.py:334-342)."""
    lo = torch.minimum(s, d)
    hi = torch.maximum(s, d)
    dlo, dhi = deg[lo], deg[hi]
    swap = (dlo > dhi) | ((dlo == dhi) & (lo > hi))
    return torch.where(swap, hi, lo), torch.where(swap, lo, hi)


def dedupe_and_positions(a: torch.Tensor, b: torch.Tensor, sent: int,
                         vb: int):
    """One sort of the packed int64 key a·(vb+1) + b (the lexicographic
    order of (a, b)), first-occurrence marking, and each valid edge's
    column among the valid edges of its source by a prefix count — the
    JAX package's dedupe_and_positions (triangles.py:345-376).

    Returns (a_sorted, b_sorted, evalid, pos); pos is meaningless where
    ~evalid. Within each source run the valid b's ascend and take
    columns 0..deg-1."""
    key, _ = torch.sort(a.to(torch.int64) * (vb + 1) + b.to(torch.int64))
    a = torch.div(key, vb + 1, rounding_mode="floor").to(torch.int32)
    b = (key % (vb + 1)).to(torch.int32)
    n = key.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    evalid = first & (a < sent)
    ev = evalid.to(torch.int64)
    before = torch.cumsum(ev, 0) - ev     # valid edges strictly before i
    idx = torch.arange(n, device=key.device)
    run = torch.ones(n, dtype=torch.bool, device=key.device)
    run[1:] = a[1:] != a[:-1]
    run_start = torch.cummax(torch.where(run, idx, 0), 0).values
    pos = before - before[run_start]
    return a, b, evalid, pos


def count_window_plain(src: torch.Tensor, dst: torch.Tensor,
                       valid: torch.Tensor, vb: int, kb: int):
    """One window [eb] -> (count, overflow) as 0-dim int32 tensors, in
    plain PyTorch on the tensors' device. Ids outside [0, vb) count as
    padding, as in the kernel."""
    sent = vb
    valid = (valid & (src != dst) & (src >= 0) & (src < vb)
             & (dst >= 0) & (dst < vb))
    s = torch.where(valid, src, sent)
    d = torch.where(valid, dst, sent)
    ones = valid.to(torch.int32)
    deg = torch.zeros(vb + 1, dtype=torch.int32, device=src.device)
    deg.index_add_(0, s, ones).index_add_(0, d, ones)
    a, b = orient_by_degree(s, d, deg)
    a, b, evalid, pos = dedupe_and_positions(a, b, sent, vb)
    overflow = ((pos >= kb) & evalid).sum().to(torch.int32)
    ok = evalid & (pos < kb)
    rows = torch.where(ok, a, vb).to(torch.int64)
    cols = pos.clamp(0, kb - 1)
    nbr = torch.full((vb + 1, kb), sent, dtype=torch.int32,
                     device=src.device)
    nbr[rows, cols] = torch.where(ok, b, sent)
    count = intersect.intersect_local_plain(nbr, a, b, evalid)
    return count, overflow


def count_windows_plain(src: torch.Tensor, dst: torch.Tensor,
                        valid: torch.Tensor, vb: int, kb: int):
    """[W, eb] stacks -> (count[W], overflow[W]) int32, window by window
    in plain PyTorch."""
    if src.shape[0] == 0:
        empty = torch.zeros(0, dtype=torch.int32, device=src.device)
        return empty, empty.clone()
    pairs = [count_window_plain(src[w], dst[w], valid[w], vb, kb)
             for w in range(src.shape[0])]
    return (torch.stack([c for c, _ in pairs]),
            torch.stack([o for _, o in pairs]))


class CounterScratch:
    """Device scratch of a `WindowCounter`: what the kernel's plan
    (`plan`) asks for a call of up to `windows` windows of `eb` slots at
    vb, allocated once with torch.empty and never cleared. The kernel
    keeps each window's vertex table and rows in a block's shared memory
    where they fit (the shared-memory tier), so the scratch is per block,
    not per window: a 4-byte key a slot (16.8 MB for 64 windows at
    eb=32768, vb=65536, two blocks a window). The L2 tier keeps the
    tables here too: about 4·vb + 14·eb bytes a block."""

    def __init__(self, windows: int, eb: int, vb: int,
                 device: torch.device):
        self.windows, self.eb = windows, eb
        self.shared_tier, self.blocks, nbytes, _cluster = plan(
            windows, eb, vb, device)
        self.buffer = torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                  device=device)


def plan(windows: int, eb: int, vb: int, device: torch.device) -> tuple:
    """(shared_tier, blocks, scratch bytes, cluster) of a counter call of
    `windows` windows of eb slots at vb on a CUDA device: the tier its
    shape picks, the blocks of its grid, the device scratch they need and
    the blocks a window (csrc/window_counter.cu `gs_counter_plan`)."""
    out = (ctypes.c_longlong * 4)()
    device = torch.device(device)
    code = kernels.library("window_counter").gs_counter_plan(
        windows, eb, vb, device.index if device.index is not None
        else torch.cuda.current_device(), out)
    kernels.check("window_counter", code)
    return bool(out[0]), int(out[1]), int(out[2]), int(out[3])


class WindowCounter:
    """The window counter at fixed (vb, kb) on one device:
    counter(src[W, eb], dst, valid) -> (count[W], overflow[W]) int32, or
    counter(s16[W, eb], d16, nvalid[W], wire="compact").

    On a card it is the only owner of its `CounterScratch`: it allocates
    one when a call brings more windows or another eb than the last, and
    reuses it otherwise. Each call is one launch of the counter kernel
    (csrc/window_counter.cu, one entry per wire) on the current stream,
    with no synchronisation. On the CPU it runs `count_windows_plain`
    (after `widen_stack` on the compact wire). A call is one launch of
    the cost observatory (utils/costmodel.py, `counter_work`)."""

    def __init__(self, vb: int, kb: int, device: torch.device):
        self.vb, self.kb = vb, kb
        self.device = torch.device(device)
        self.scratch = None

    def reserve(self, windows: int, eb: int) -> None:
        """On a card, allocate the scratch of a call of `windows` windows
        of eb slots now (a call of at most that many windows then never
        reallocates it: a CUDA graph that captured the counter keeps its
        address). Nothing on the CPU."""
        if self.device.type != "cuda":
            return
        sc = self.scratch
        if sc is None or windows > sc.windows or eb != sc.eb:
            self.scratch = None               # free before allocating
            self.scratch = CounterScratch(windows, eb, self.vb, self.device)

    def __call__(self, src, dst, valid, wire: str = "standard",
                 out=None):
        """`out`, if given, is (count, overflow): contiguous int32 [W]
        tensors on the stack's device, written in place of new ones."""
        if src.device != self.device:
            raise ValueError("window counter on %s given tensors on %s"
                             % (self.device, src.device))
        if wire not in WIRES:
            raise ValueError("unknown wire %r (choices: %s)"
                             % (wire, WIRES))
        w, eb = src.shape
        for t in out or ():
            if t.device != src.device or t.dtype != torch.int32 \
                    or tuple(t.shape) != (w,) or not t.is_contiguous():
                raise ValueError("out must be two contiguous int32 [%d] "
                                 "tensors on %s" % (w, src.device))
        with costmodel.launch(
                "window_counter_compact" if wire == "compact"
                else "window_counter", (src,),
                lambda: costmodel.counter_work(w, eb, wire), src.device):
            if src.device.type == "cpu":
                if wire == "compact":
                    src, dst, valid = widen_stack(src, dst, valid, eb,
                                                  self.vb)
                got = count_windows_plain(src, dst, valid, self.vb,
                                          self.kb)
                if out is None:
                    return got
                for t, g in zip(out, got):
                    t.copy_(g)
                return out
            _check(src, dst, valid, self.vb, self.kb, wire)
            self.reserve(w, eb)
            count, overflow = out or (
                torch.empty(w, dtype=torch.int32, device=src.device)
                for _ in range(2))
            launch(src, dst, valid, self.vb, self.kb, self.scratch, count,
                   overflow, wire)
        return count, overflow


def count_windows_device(src: torch.Tensor, dst: torch.Tensor,
                         valid: torch.Tensor, vb: int, kb: int):
    """src/dst [W, eb] int32, valid [W, eb] bool -> (count[W],
    overflow[W]) int32: one call of a `WindowCounter` made for it (the
    CUDA kernels on CUDA tensors, `count_windows_plain` on CPU ones).
    Callers that count many stacks keep a `WindowCounter` instead, so
    that its scratch is reused."""
    return WindowCounter(vb, kb, src.device)(src, dst, valid)


def launch(src, dst, valid, vb: int, kb: int, scratch: CounterScratch,
           count: torch.Tensor, overflow: torch.Tensor,
           wire: str = "standard") -> None:
    """One launch of the counter kernel (csrc/window_counter.cu) on a
    checked CUDA stack of either wire: count[W] and overflow[W] of its W
    windows, written in full (nothing needs clearing)."""
    w, eb = src.shape
    lib = kernels.library("window_counter")
    entry = (lib.gs_window_counter_compact if wire == "compact"
             else lib.gs_window_counter)
    buf = scratch.buffer
    code = entry(
        src.data_ptr(), dst.data_ptr(), valid.data_ptr(), w, eb, vb, kb,
        buf.data_ptr(), buf.numel(), count.data_ptr(), overflow.data_ptr(),
        src.device.index, kernels.stream_of(src))
    kernels.check("window_counter", code)
    kernels.LAUNCHES["window_counter_compact" if wire == "compact"
                     else "window_counter"] += 1


def wire_specs(src, wire: str) -> list:
    """(name, dtype, shape) of the three tensors of a [W, eb] stack on
    `wire`, W and eb read off src."""
    w, eb = tuple(src.shape) if src.dim() == 2 else (0, 0)
    if wire == "compact":
        return [("s16", torch.uint16, (w, eb)), ("d16", torch.uint16, (w, eb)),
                ("nvalid", torch.int32, (w,))]
    return [("src", torch.int32, (w, eb)), ("dst", torch.int32, (w, eb)),
            ("valid", torch.bool, (w, eb))]


def check_wire(src, dst, valid, wire: str, what: str) -> None:
    """Raise ValueError unless (src, dst, valid) is a contiguous [W, eb]
    stack of `wire` on one CUDA device."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError("the %s kernel takes CUDA tensors, got %s"
                         % (what, dev))
    for (name, dtype, shape), t in zip(wire_specs(src, wire),
                                       (src, dst, valid)):
        if t.device != dev or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                "%s must be a contiguous %s %s tensor on %s (the %s wire), "
                "got %s %s on %s" % (name, shape, dtype, dev, wire,
                                     tuple(t.shape), t.dtype, t.device))


def _check(src, dst, valid, vb: int, kb: int, wire: str) -> None:
    check_wire(src, dst, valid, wire, "window counter")
    w, eb = src.shape
    if not (0 < w < 2 ** 31 and 0 < eb < 2 ** 30 and 0 < vb < 2 ** 30
            and 0 < kb):
        raise ValueError("unsupported shape: W=%d eb=%d vb=%d kb=%d"
                         % (w, eb, vb, kb))
