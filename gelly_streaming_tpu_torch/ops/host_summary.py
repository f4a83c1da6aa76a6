"""Exact numpy window summaries with carried state: the port's
independent oracle for the summary engine.

A copy of the JAX package's numpy twins, which import nothing of JAX but
live in a package whose `__init__` does: the carried min-label fixpoint
of `ops/host_snapshot._fixpoint` (:36-59) and the per-window fold of
`parallel/host_twin.HostSummaryEngine._dispatch_async` (:246-282). It
shares no code with the device path (ops/window_summary.py,
ops/scan_analytics.py) beyond the numpy window layout of
ops/segment.py, which is what makes it an oracle for that path; it is
not on the main path.

The carry is the engines' layout: degrees [vb+1], CC labels [vb+1],
double cover [2(vb+1)] with (+) at v and (-) at v+vb+1, slot vb the
sentinel, all int32.
"""

from __future__ import annotations

import numpy as np

from . import host_triangles
from . import segment as seg_ops

MAX_WINDOWS = 64   # windows per chunk, as the engines cut the stream


def fresh_carry(vb: int):
    return (np.zeros(vb + 1, np.int32),
            np.arange(vb + 1, dtype=np.int32),
            np.arange(2 * (vb + 1), dtype=np.int32))


def fixpoint(labels: np.ndarray, s: np.ndarray,
             d: np.ndarray) -> np.ndarray:
    """Carried min-label fixpoint: scatter-min each edge's smaller label
    into both endpoints and both endpoints' roots, with the carried
    forest's links (v, labels[v]) among the edges, then pointer-jump,
    until stable."""
    n = len(labels)
    src = np.concatenate([s, np.arange(n, dtype=np.int64)])
    dst = np.concatenate([d, labels.astype(np.int64)])
    while True:
        ls = labels[src]
        ld = labels[dst]
        m = np.minimum(ls, ld)
        new = labels.copy()
        np.minimum.at(new, src, m)
        np.minimum.at(new, dst, m)
        np.minimum.at(new, ls, m)
        np.minimum.at(new, ld, m)
        new = new[new]
        if np.array_equal(new, labels):
            return new
        labels = new


def fold_windows(carry, s: np.ndarray, d: np.ndarray, valid: np.ndarray):
    """Fold a [W, eb] window stack into `carry` window by window.
    Returns (new carry, max_degree[W], num_components[W], odd[W],
    triangles[W]); the carry passed in is not changed."""
    deg, labels, cover = (np.array(a, np.int32) for a in carry)
    vb = len(deg) - 1
    num_w = s.shape[0]
    mdeg = np.zeros(num_w, np.int32)
    ncomp = np.zeros(num_w, np.int32)
    odd = np.zeros(num_w, bool)
    tri = np.zeros(num_w, np.int64)
    vidx = np.arange(vb)
    for i in range(num_w):
        v = valid[i]
        # padding maps to the sentinel: CC sees (vb, vb) self-loops, the
        # cover the (vb, 2vb+1) sentinel join; degrees count real edges
        si = np.where(v, s[i], vb).astype(np.int64)
        di = np.where(v, d[i], vb).astype(np.int64)
        np.add.at(deg, si[v], 1)
        np.add.at(deg, di[v], 1)
        mdeg[i] = deg[:vb].max()
        labels = fixpoint(labels, si, di)
        touched = deg[:vb] > 0
        ncomp[i] = int(np.sum(touched & (labels[:vb] == vidx)))
        cover = fixpoint(cover, np.concatenate([si, si + (vb + 1)]),
                         np.concatenate([di + (vb + 1), di]))
        odd[i] = bool(np.any(
            touched & (cover[:vb] == cover[vb + 1:2 * vb + 1])))
        tri[i] = host_triangles.window_count(s[i][v], d[i][v])
    return (deg, labels, cover), mdeg, ncomp, odd, tri


def summarize_stream(src: np.ndarray, dst: np.ndarray, eb: int, vb: int,
                     carry=None, max_windows: int = MAX_WINDOWS):
    """Summaries of every tumbling `eb`-sized window of the stream (a
    shorter last window included), cut into chunks of `max_windows`
    windows whose ragged last chunk pads its window axis as the engines
    do. Returns (list of summary dicts, carry)."""
    carry = fresh_carry(vb) if carry is None else carry
    if len(src) == 0:
        return [], carry
    num_w, s, d, valid = seg_ops.window_stack(src, dst, eb, sentinel=vb)
    out = []
    for at in range(0, num_w, max_windows):
        hi = min(at + max_windows, num_w)
        sc, dc, vc, n = seg_ops.pad_window_chunk(s, d, valid, at, hi,
                                                 max_windows, eb, vb)
        carry, mdeg, ncomp, odd, tri = fold_windows(carry, sc, dc, vc)
        out.extend({"max_degree": int(mdeg[w]),
                    "num_components": int(ncomp[w]),
                    "odd_cycle": bool(odd[w]),
                    "triangles": int(tri[w])} for w in range(n))
    return out, carry
