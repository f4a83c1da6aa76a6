"""The driver's snapshot program: per window of a [W, eb] chunk, the
carried degrees, CC labels and odd-cycle flags of every vertex slot, or
the slots that changed.

Stands in for the JAX package's `core/driver._build_snapshot_scan`
(driver.py:91-212), an XLA lax.scan with no Pallas kernel. The carry is
the summary engines' layout (ops/window_summary.py): deg [vb+1], labels
[vb+1], cover [2(vb+1)] int32 with (-) at v+vb+1, one entry None where
its analytic is off; the driver's host mirrors keep the JAX package's
layout ((-) at vb+v, no sentinels) and convert at the carry boundary
(`engine_carry`, `driver_cover`: the slot map v -> v, vb+v -> vb+1+v is
monotone, so min labels stay min labels). Padding folds nothing here,
so the sentinel slots stay singletons and never reach a snapshot.

Per window the program emits (`outs`, tensors on the carry's device):
- full rows: "deg", "labels" [W, vb] int32 and "odd" [W, vb] bool, and
  with `deltas` the changed-slot masks "deg_chg", "labels_chg" and
  "cover_chg" [W, vb] bool (the odd flag's changes, as in the JAX
  scan);
- or, with egress="delta", the wire of ops/delta_egress.py per
  analytic: "<k>_cnt" [W] int32 (it may pass cap: the driver then
  runs the chunk again on full rows), "<k>_idx" [W, cap] int32 ascending
  and "<k>_val" [W, cap] (int32, bool for "cover"), for k in deg,
  labels, cover; entries past the count are never read.
After the call the carry holds the state after the last window, labels
and cover canonical (each slot at the smallest slot of its set).

`WindowSnapshot` launches the CUDA kernel of csrc/window_snapshot.cu
(one cooperative launch a call over device memory) on CUDA tensors and
runs `snapshot_windows_plain`, the plain PyTorch version, on CPU ones;
it never falls back from one to the other. Each call is one launch of
the cost observatory (utils/costmodel.py `snapshot_work`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..utils import costmodel
from . import unionfind
from .delta_egress import EGRESS, compact_changed

ANALYTICS = ("degrees", "cc", "bipartite")
_FLAG = {"degrees": 1, "cc": 2, "bipartite": 4}
_MASKS, _DELTA = 8, 16
MAX_BLOCKS = 2048          # the most blocks of one call's cooperative grid
_KEYS = ("deg", "labels", "cover")


def engine_carry(vb: int, deg=None, labels=None, cover=None,
                 device="cpu") -> tuple:
    """The kernel's carry on `device` from the driver's mirrors (numpy:
    deg [<= vb], labels [<= vb], cover [2·vb] with (-) at vb+v; None to
    leave an analytic off). Slots past a mirror's end are fresh."""
    out = [None, None, None]
    if deg is not None:
        d = np.zeros(vb + 1, np.int32)
        d[:len(deg)] = deg
        out[0] = d
    if labels is not None:
        lab = np.arange(vb + 1, dtype=np.int32)
        lab[:len(labels)] = labels
        out[1] = lab
    if cover is not None:
        if len(cover) != 2 * vb:
            raise ValueError("cover mirror of %d slots at vb=%d"
                             % (len(cover), vb))
        cov = np.arange(2 * (vb + 1), dtype=np.int32)
        lifted = np.where(cover >= vb, cover + 1, cover).astype(np.int32)
        cov[:vb] = lifted[:vb]
        cov[vb + 1:2 * vb + 1] = lifted[vb:]
        out[2] = cov
    return tuple(None if a is None else torch.from_numpy(a).to(device)
                 for a in out)


def driver_cover(cover: np.ndarray, vb: int) -> np.ndarray:
    """The driver's cover mirror [2·vb] ((-) at vb+v) from the kernel's
    [2(vb+1)] ((-) at v+vb+1), its sentinels dropped."""
    cover = np.asarray(cover)
    both = np.concatenate([cover[:vb], cover[vb + 1:2 * vb + 1]])
    return np.where(both > vb, both - 1, both).astype(np.int32)


def analytics_flags(analytics) -> int:
    return sum(_FLAG[a] for a in ANALYTICS if a in analytics)


def snapshot_windows_plain(carry, src, dst, valid, vb: int,
                           deltas: bool = False, egress: str = "full",
                           cap: int = 0) -> dict:
    """The plain version, window by window in PyTorch on the tensors'
    device: folds src/dst/valid [W, eb] into `carry` (in place) and
    returns the outs described in the module docstring."""
    deg, labels, cover = carry
    num_w = src.shape[0]
    dev = src.device
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    # the start of the call: labels and cover at their roots
    if labels is not None:
        labels.copy_(unionfind.cc_fixpoint_plain(labels, none, none))
    if cover is not None:
        cover.copy_(unionfind.cc_fixpoint_plain(cover, none, none))

    def rows():
        out = {}
        if deg is not None:
            out["deg"] = deg[:vb].clone()
        if labels is not None:
            out["labels"] = labels[:vb].clone()
        if cover is not None:
            out["cover"] = cover[:vb] == cover[vb + 1:2 * vb + 1]
        return out

    prev = rows()
    per = {key: [] for key in _KEYS}
    for w in range(num_w):
        v = (valid[w] & (src[w] >= 0) & (src[w] < vb) & (dst[w] >= 0)
             & (dst[w] < vb))
        s = torch.where(v, src[w], vb)
        d = torch.where(v, dst[w], vb)
        if deg is not None:
            ones = v.to(torch.int32)
            deg.index_add_(0, s, ones).index_add_(0, d, ones)
        if labels is not None:
            labels.copy_(unionfind.cc_fixpoint_plain(labels, s, d))
        if cover is not None:
            cover.copy_(unionfind.cc_fixpoint_plain(
                cover, torch.cat([s, torch.where(v, s + vb + 1, vb)]),
                torch.cat([torch.where(v, d + vb + 1, vb), d])))
        now = rows()
        for key, row in now.items():
            per[key].append((row, row != prev[key]))
        prev = now
    outs = {}
    for key, got in per.items():
        if not got:
            continue
        new = torch.stack([row for row, _c in got])
        chg = torch.stack([c for _r, c in got])
        if egress == "delta":
            wire = [compact_changed(c, row, cap) for row, c in got]
            outs[key + "_cnt"] = torch.stack([x[0] for x in wire])
            outs[key + "_idx"] = torch.stack([x[1] for x in wire])
            outs[key + "_val"] = torch.stack([x[2] for x in wire])
            continue
        outs["odd" if key == "cover" else key] = new
        if deltas:
            outs[key + "_chg"] = chg
    return outs


class _Args(ctypes.Structure):
    """csrc/window_snapshot.cu's SnapshotArgs."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("prev", "chg", "block_counts")] + [
        ("max_blocks", ctypes.c_int), ("cap", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in
        ("out_deg", "out_labels", "out_odd", "chg_deg", "chg_labels",
         "chg_odd", "cnt", "idx", "val_deg", "val_labels", "val_odd")]


class WindowSnapshot:
    """snapshot(carry, src[W, eb], dst, valid) -> outs at vertex bucket
    vb on one device, for `analytics` (a subset of ANALYTICS), with the
    changed-slot masks (`deltas`) and on the full or delta egress (with
    `cap` changed slots a window row). On a card it launches the kernel
    of csrc/window_snapshot.cu (one launch a call on the current stream,
    no synchronisation; scratch kept across calls); on the CPU it runs
    `snapshot_windows_plain`."""

    def __init__(self, vb: int, analytics, device, deltas: bool = False,
                 egress: str = "full", cap: int = 0):
        if egress not in EGRESS:
            raise ValueError("unknown egress %r (choices: %s)"
                             % (egress, ", ".join(EGRESS)))
        self.vb = int(vb)
        self.flags = analytics_flags(analytics)
        if not self.flags:
            raise ValueError("no snapshot analytic in %r" % (analytics,))
        self.device = torch.device(device)
        self.deltas = bool(deltas)
        self.egress = egress
        self.cap = int(cap)
        if egress == "delta" and not 0 < self.cap <= self.vb:
            raise ValueError("delta egress needs 0 < cap <= vb, got %d"
                             % self.cap)
        self._scratch = None

    def __call__(self, carry, src, dst, valid) -> dict:
        self._check(carry, src, dst, valid)
        w, eb = src.shape
        delta = self.egress == "delta"
        with costmodel.launch(
                "window_snapshot" + ("_delta" if delta else "_masks"
                                     if self.deltas else ""),
                [t for t in carry if t is not None][:1] + [src],
                lambda: costmodel.snapshot_work(
                    w, eb, self.vb, self.egress, self.cap,
                    [bool(self.flags >> k & 1) for k in range(3)],
                    masks=self.deltas and not delta), src.device):
            return self._launch(carry, src, dst, valid)

    def _launch(self, carry, src, dst, valid) -> dict:
        if src.device.type == "cpu":
            return snapshot_windows_plain(carry, src, dst, valid, self.vb,
                                          self.deltas, self.egress,
                                          self.cap)
        w, vb, cap, dev = src.shape[0], self.vb, self.cap, src.device
        if self._scratch is None:
            self._scratch = (
                torch.empty(3, vb, dtype=torch.int32, device=dev),
                torch.empty(3, vb, dtype=torch.uint8, device=dev),
                torch.empty(3, MAX_BLOCKS, dtype=torch.int32, device=dev))
        prev, chg, blocks = self._scratch
        args = _Args(prev=prev.data_ptr(), chg=chg.data_ptr(),
                     block_counts=blocks.data_ptr(), max_blocks=MAX_BLOCKS,
                     cap=cap)
        outs = {}
        on = [bool(self.flags >> k & 1) for k in range(3)]
        if self.egress == "delta":
            cnt = torch.empty(3, w, dtype=torch.int32, device=dev)
            idx = torch.empty(3, w, cap, dtype=torch.int32, device=dev)
            args.cnt, args.idx = cnt.data_ptr(), idx.data_ptr()
            for k, (key, field, dtype) in enumerate((
                    ("deg", "val_deg", torch.int32),
                    ("labels", "val_labels", torch.int32),
                    ("cover", "val_odd", torch.bool))):
                if on[k]:
                    val = torch.empty(w, cap, dtype=dtype, device=dev)
                    setattr(args, field, val.data_ptr())
                    outs.update({key + "_cnt": cnt[k], key + "_idx": idx[k],
                                 key + "_val": val})
        else:
            for k, (key, out_field, chg_field, dtype) in enumerate((
                    ("deg", "out_deg", "chg_deg", torch.int32),
                    ("labels", "out_labels", "chg_labels", torch.int32),
                    ("cover", "out_odd", "chg_odd", torch.bool))):
                if not on[k]:
                    continue
                row = torch.empty(w, vb, dtype=dtype, device=dev)
                setattr(args, out_field, row.data_ptr())
                outs["odd" if key == "cover" else key] = row
                if self.deltas:
                    mask = torch.empty(w, vb, dtype=torch.bool, device=dev)
                    setattr(args, chg_field, mask.data_ptr())
                    outs[key + "_chg"] = mask
        flags = (self.flags | (_DELTA if self.egress == "delta" else 0)
                 | (_MASKS if self.deltas and self.egress == "full" else 0))
        lib = kernels.library("window_snapshot")
        code = lib.gs_window_snapshot(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), w,
            src.shape[1], vb, flags,
            *[0 if t is None else t.data_ptr() for t in carry],
            ctypes.addressof(args), dev.index, kernels.stream_of(src))
        kernels.check("window_snapshot", code)
        kernels.LAUNCHES["window_snapshot"] += 1
        return outs

    def _check(self, carry, src, dst, valid) -> None:
        dev = src.device
        if dev != self.device:
            raise ValueError("window snapshot on %s given tensors on %s"
                             % (self.device, dev))
        for name, t, dtype in (("src", src, torch.int32),
                               ("dst", dst, torch.int32),
                               ("valid", valid, torch.bool)):
            if t.device != dev or t.dtype != dtype or t.dim() != 2 \
                    or t.shape != src.shape or not t.is_contiguous():
                raise ValueError("%s must be a contiguous [W, eb] %s "
                                 "tensor on %s" % (name, dtype, dev))
        if not (0 < src.shape[0] and 0 < src.shape[1] < 2 ** 30
                and 0 < self.vb < 2 ** 29):
            raise ValueError("unsupported shape: W=%d eb=%d vb=%d"
                             % (src.shape[0], src.shape[1], self.vb))
        if len(carry) != 3:
            raise ValueError("carry must be (deg, labels, cover)")
        vb = self.vb
        for k, (name, t, n) in enumerate((("deg", carry[0], vb + 1),
                                          ("labels", carry[1], vb + 1),
                                          ("cover", carry[2],
                                           2 * (vb + 1)))):
            if not (self.flags >> k & 1):
                if t is not None:
                    raise ValueError("%s given, but its analytic is off"
                                     % name)
                continue
            if t is None or t.device != dev or t.dtype != torch.int32 \
                    or tuple(t.shape) != (n,) or not t.is_contiguous():
                raise ValueError("%s must be a contiguous (%d,) int32 "
                                 "tensor on %s" % (name, n, dev))
