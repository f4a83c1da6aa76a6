"""Exact per-window triangle counting over an edge stream: the port's
main path.

Port of the JAX package's `ops/triangles.py` (:287-438, :783-1305):
`TriangleWindowKernel.count_stream` cuts the stream into tumbling
windows of `edge_bucket` edges, stacks them [W, eb] in chunks of up to
MAX_STREAM_WINDOWS, and counts each chunk on the device with the window
counter (ops/window_counter.py: the CUDA kernels on a card, the plain
PyTorch version on the CPU). A window whose hubs outrun the K bucket
(overflow > 0) is recounted exactly: up the K ladder to `kb_max`, then
by `triangle_count_sparse`, a host CSR build intersected on the device.
`triangle_count` counts one window of any size: the dense contraction
(ops/dense_triangles.py) up to 2·DENSE_LIMIT vertices, the sparse path
past it.

Not ported from the JAX package: the host/native tier routing, compact
ingress, the online autotuner and the threaded ingress pipeline (see
ROADMAP.md); K comes from the analytic rule, not from evidence files.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.platform import resolve_device
from . import intersect as _intersect
from . import segment as seg_ops
from .dense_triangles import triangle_count_dense
from .staging import ChunkStager
from .window_counter import (WindowCounter, dedupe_and_positions,
                             orient_by_degree)

__all__ = ["DENSE_LIMIT", "TriangleWindowKernel", "build_window_counter",
           "default_kb", "dedupe_and_positions", "orient_by_degree",
           "triangle_count", "triangle_count_dense",
           "triangle_count_sparse"]

# the JAX package's XLA dense limit; its fused contraction, which the
# port's dense kernel replaces, is exact to twice it
DENSE_LIMIT = 2048


def default_kb(eb: int) -> int:
    """The analytic starting K of an edge bucket: min(128, 2·⌊√eb⌋)
    (the JAX package's fallback when no tuning evidence exists)."""
    return min(128, 2 * math.isqrt(eb))


def build_window_counter(vb: int, kb: int, device=None) -> WindowCounter:
    """The window counter at (vb, kb) on `device`: counter(src[W, eb],
    dst, valid) -> (count[W], overflow[W]) int32, keeping its device
    scratch across calls."""
    return WindowCounter(vb, kb, resolve_device(device))


def triangle_count_sparse(src: np.ndarray, dst: np.ndarray,
                          num_vertices: int, device=None) -> int:
    """Exact count of one window of any size: undirect + dedupe, orient
    by (degree, id), CSR rows on the host (numpy, as the JAX package's
    :287-327), then the row intersection on `device`."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if len(src) == 0:
        return 0
    # undirect + dedupe
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    und = np.unique(lo * num_vertices + hi)
    lo, hi = und // num_vertices, und % num_vertices
    # orient low-rank → high-rank by (degree, id)
    deg = np.bincount(np.concatenate([lo, hi]), minlength=num_vertices)
    rank = np.argsort(np.argsort(deg.astype(np.int64) * num_vertices
                                 + np.arange(num_vertices)))
    a = np.where(rank[lo] < rank[hi], lo, hi).astype(np.int32)
    b = np.where(rank[lo] < rank[hi], hi, lo).astype(np.int32)
    e = len(a)
    order = np.argsort(a.astype(np.int64) * num_vertices + b, kind="stable")
    a, b = a[order], b[order]
    counts = np.bincount(a, minlength=num_vertices)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    max_out = seg_ops.bucket_size(int(counts.max()))
    vb = seg_ops.bucket_size(num_vertices)
    nbr = np.full((vb + 1, max_out), vb, np.int32)
    nbr[a, np.arange(e) - starts[a]] = b  # ascending within each row
    ep = seg_ops.bucket_size(e)
    args = (nbr, seg_ops.pad_to(a, ep, fill=vb),
            seg_ops.pad_to(b, ep, fill=vb),
            seg_ops.pad_to(np.ones(e, bool), ep, fill=False))
    count = _intersect.intersect_local(
        *(torch.from_numpy(x).to(device) for x in args))
    return int(count)


def triangle_count(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   device=None) -> int:
    """Exact triangle count of one window: the dense contraction for
    num_vertices ≤ 2·DENSE_LIMIT (where its float32 partials stay
    exact), `triangle_count_sparse` above."""
    if num_vertices <= 2 * DENSE_LIMIT:
        return triangle_count_dense(src, dst, num_vertices, device)
    return triangle_count_sparse(src, dst, num_vertices, device)


class TriangleWindowKernel:
    """Exact triangle counts of an unbounded stream of windows over fixed
    buckets (edge_bucket, vertex_bucket, k_bucket).

    The host sends only the raw COO stack of a chunk (9 bytes per slot:
    int32 src, int32 dst, bool valid) in one copy from a pinned buffer
    (ops/staging.ChunkStager); the device runs the window counter and
    returns (count, overflow) per window in one copy back. `overflow` > 0
    means some vertex's oriented out-degree exceeded k_bucket; that
    window is recounted exactly up the K ladder (`_escalation_ladder`,
    4·K per rung up to kb_max) and, past it, by `triangle_count_sparse`.

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path.
    """

    MAX_STREAM_WINDOWS = 64  # windows per device call in count_stream

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, device=None):
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.kb = seg_ops.bucket_size(
            k_bucket if k_bucket else default_kb(self.eb))
        self.kb_max = seg_ops.bucket_size(2 * math.isqrt(self.eb))
        self._counters = {}
        self._stage = ChunkStager(self.device)

    def _counter(self, kb: int) -> WindowCounter:
        counter = self._counters.get(kb)
        if counter is None:
            counter = build_window_counter(self.vb, kb, self.device)
            self._counters[kb] = counter
        return counter

    def _escalation_ladder(self):
        """K values to try in order: kb, 4·kb, ... up to kb_max."""
        ks, k = [], self.kb
        while k < self.kb_max:
            ks.append(k)
            k *= 4
        ks.append(max(self.kb, self.kb_max))
        return ks

    def _count_stack(self, kb: int, s, d, valid) -> np.ndarray:
        """(count, overflow) of a staged [W, eb] stack at K=kb, as one
        [2, W] host array (one copy back)."""
        c, o = self._counter(kb)(*self._stage(s, d, valid))
        return torch.stack((c, o)).cpu().numpy()

    def count(self, src: np.ndarray, dst: np.ndarray,
              min_k: int = 0) -> int:
        """Exact triangle count of one window batch (dense ids < vb).

        `min_k` skips ladder rungs already known to overflow (count_stream's
        recount passes the K that just failed)."""
        n = len(src)
        if n == 0:
            return 0
        if n > self.eb:
            raise ValueError(f"window of {n} edges exceeds edge bucket "
                             f"{self.eb}")
        s = seg_ops.pad_to(np.asarray(src, np.int32), self.eb, fill=self.vb)
        d = seg_ops.pad_to(np.asarray(dst, np.int32), self.eb, fill=self.vb)
        valid = seg_ops.pad_to(np.ones(n, bool), self.eb, fill=False)
        for kb in self._escalation_ladder():  # widen K only when a hub
            if kb <= min_k:                   # outruns the current table
                continue
            (count,), (overflow,) = self._count_stack(
                kb, s[None], d[None], valid[None])
            if not overflow:
                return int(count)
        return triangle_count_sparse(src, dst, self.vb, self.device)

    def _run_stack(self, s, d, valid, get_window) -> list:
        """The chunk loop: per chunk of ≤ MAX_STREAM_WINDOWS windows (a
        ragged last chunk pads its window axis to a power of two), one
        copy in, one counter call, one copy back, then an exact recount
        of each window whose overflow is > 0."""
        counts: list = []
        num_w = s.shape[0]
        for at in range(0, num_w, self.MAX_STREAM_WINDOWS):
            hi = min(at + self.MAX_STREAM_WINDOWS, num_w)
            sc, dc, vc, n = seg_ops.pad_window_chunk(
                s, d, valid, at, hi, self.MAX_STREAM_WINDOWS, self.eb,
                self.vb)
            res = self._count_stack(self.kb, sc, dc, vc)
            c, o = res[0, :n].copy(), res[1, :n]
            for w in np.nonzero(o)[0]:  # rare hub overflow: exact redo
                ws, wd = get_window(at + int(w))
                c[w] = self.count(ws, wd, min_k=self.kb)
            counts.extend(int(x) for x in c)
        return counts

    def count_stream(self, src: np.ndarray, dst: np.ndarray) -> list:
        """Exact counts of every tumbling `edge_bucket`-sized window of
        the stream (a shorter last window included)."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if len(src) == 0:
            return []
        eb = self.eb
        _num_w, s, d, valid = seg_ops.window_stack(src, dst, eb,
                                                   sentinel=self.vb)
        return self._run_stack(
            s, d, valid,
            lambda w: (src[w * eb:(w + 1) * eb], dst[w * eb:(w + 1) * eb]))

    def count_windows(self, windows) -> list:
        """Exact counts of a list of (src, dst) window batches of varying
        lengths (each ≤ edge_bucket), stacked and counted in chunks."""
        if not windows:
            return []
        s, d, valid = seg_ops.stack_window_list(windows, self.eb, self.vb)
        return self._run_stack(s, d, valid, lambda w: windows[w])
