"""Exact numpy window triangle count: the port's independent oracle.

A copy of the JAX package's `ops/host_triangles.py` (pure numpy there
too): drop self-loops, undirect + dedupe, orient low(deg, id) →
high(deg, id), then count each triangle once at its min-rank edge by
wedge enumeration and one searchsorted probe into the sorted edge keys.
It shares no code with the device path (`ops/triangles.py`), which is
what makes it an oracle for that path; it is not on the main path.
"""

from __future__ import annotations

import numpy as np

# wedge-enumeration slice cap: bounds peak memory of the repeat/searchsorted
# arrays (~5 int64 arrays of this length) regardless of window skew
_WEDGE_CHUNK = 4 << 20


def window_count(src: np.ndarray, dst: np.ndarray) -> int:
    """Exact triangle count of one window (any integer vertex ids:
    negative or huge ids are first compressed to dense slots)."""
    s = np.asarray(src, np.int64)
    d = np.asarray(dst, np.int64)
    keep = s != d
    s, d = s[keep], d[keep]
    if len(s) == 0:
        return 0
    if int(s.min()) < 0 or int(d.min()) < 0 \
            or int(max(s.max(), d.max())) >= (1 << 31):
        uniq, inv = np.unique(np.concatenate([s, d]),
                              return_inverse=True)
        s, d = inv[:len(s)].astype(np.int64), inv[len(s):].astype(
            np.int64)
    v = int(max(s.max(), d.max())) + 1

    # undirect + dedupe on packed keys
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    und = np.unique(lo * v + hi)
    lo, hi = und // v, und % v

    # (degree, id) orientation over the deduplicated graph
    deg = np.bincount(lo, minlength=v) + np.bincount(hi, minlength=v)
    swap = (deg[lo] > deg[hi]) | ((deg[lo] == deg[hi]) & (lo > hi))
    a = np.where(swap, hi, lo)
    b = np.where(swap, lo, hi)

    # sort by (a, b): one argsort of packed keys; CSR starts by cumsum
    keys = a * v + b
    order = np.argsort(keys, kind="stable")
    a, b, keys = a[order], b[order], keys[order]
    e = len(a)
    cnt = np.bincount(a, minlength=v)
    starts = np.zeros(v + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])

    # wedge enumeration: for each oriented edge (a,b) and each
    # x in N_out(a), the triangle {a,b,x} exists iff the oriented edge
    # (b,x) is present — one searchsorted probe into the sorted keys
    wedge_cnt = cnt[a]                       # out_deg(a) per edge
    wedge_starts = np.zeros(e + 1, np.int64)
    np.cumsum(wedge_cnt, out=wedge_starts[1:])
    count = 0
    # slice by EDGE ranges so each slice's wedges stay contiguous
    lo_e = 0
    while lo_e < e:
        hi_e = int(np.searchsorted(wedge_starts,
                                   wedge_starts[lo_e] + _WEDGE_CHUNK,
                                   side="left"))
        hi_e = max(hi_e - 1, lo_e + 1)
        hi_e = min(hi_e, e)
        n_w = int(wedge_starts[hi_e] - wedge_starts[lo_e])
        if n_w:
            eidx = np.repeat(np.arange(lo_e, hi_e),
                             wedge_cnt[lo_e:hi_e])
            off = (np.arange(n_w) + wedge_starts[lo_e]
                   - wedge_starts[eidx])
            x = b[starts[a[eidx]] + off]
            q = b[eidx] * v + x
            pos = np.searchsorted(keys, q)
            hit = keys[np.minimum(pos, e - 1)] == q
            count += int(hit.sum())
        lo_e = hi_e
    return count


def count_stream(src: np.ndarray, dst: np.ndarray, eb: int) -> list:
    """Exact counts of every tumbling eb-sized window of the stream."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    return [window_count(src[at:at + eb], dst[at:at + eb])
            for at in range(0, len(src), eb)]


def count_windows(windows) -> list:
    """Exact counts of explicit (src, dst) window batches."""
    return [window_count(s, d) for s, d in windows]
