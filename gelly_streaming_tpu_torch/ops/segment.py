"""Host-side (numpy) layout helpers of the window kernels: power-of-two
buckets, padding, and the [W, eb] window stacks every batched window
dispatch consumes.

Copies of the numpy-only helpers of the JAX package's `ops/segment.py`
(the port imports nothing of that package, whose `__init__` imports
JAX); the tests hold them equal to the originals.
"""

from __future__ import annotations

import numpy as np

_MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Next power-of-two ≥ n (min 8)."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = np.full((size - arr.shape[0],) + arr.shape[1:], fill,
                  dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def window_stack(src: np.ndarray, dst: np.ndarray, eb: int,
                 sentinel: int):
    """Pad a COO stream to whole `eb`-sized windows and reshape to
    [W, eb] stacks plus the validity mask."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    n = len(src)
    num_w = -(-n // eb)
    s = pad_to(src, num_w * eb, fill=sentinel).reshape(num_w, eb)
    d = pad_to(dst, num_w * eb, fill=sentinel).reshape(num_w, eb)
    valid = pad_to(np.ones(n, bool), num_w * eb,
                   fill=False).reshape(num_w, eb)
    return num_w, s, d, valid


def stack_window_list(windows, eb: int, sentinel: int):
    """Pad a list of (src, dst) window batches of varying lengths
    (each ≤ eb) into [W, eb] stacks + validity mask."""
    num_w = len(windows)
    s = np.full((num_w, eb), sentinel, np.int32)
    d = np.full((num_w, eb), sentinel, np.int32)
    valid = np.zeros((num_w, eb), bool)
    for w, (ws, wd) in enumerate(windows):
        n = len(ws)
        if n > eb:
            raise ValueError(f"window of {n} edges exceeds edge "
                             f"bucket {eb}")
        s[w, :n] = ws
        d[w, :n] = wd
        valid[w, :n] = True
    return s, d, valid


def stack_window_rows(pairs, wb: int, eb: int, sentinel: int):
    """Pack a chunk's dense (src, dst) window arrays into [wb, eb]
    stacks + validity mask (rows past len(pairs) stay all-sentinel)."""
    s_w = np.full((wb, eb), sentinel, np.int32)
    d_w = np.full((wb, eb), sentinel, np.int32)
    valid = np.zeros((wb, eb), bool)
    for i, (s, d) in enumerate(pairs):
        s_w[i, :len(s)] = s
        d_w[i, :len(d)] = d
        valid[i, :len(s)] = True
    return s_w, d_w, valid


def pad_window_chunk(s, d, valid, at: int, hi: int, max_w: int,
                     eb: int, sentinel: int):
    """Slice [at:hi] of a [W, eb] stack and pad the window axis to a
    power-of-two bucket (≤ max_w) with all-invalid rows. Returns
    (s, d, valid, n) with n = the real window count."""
    n = hi - at
    wb = min(bucket_size(n), max_w)
    if n == wb:  # full chunk (the steady state): zero-copy views
        return s[at:hi], d[at:hi], valid[at:hi], n
    sc = np.full((wb, eb), sentinel, np.int32)
    dc = np.full((wb, eb), sentinel, np.int32)
    vc = np.zeros((wb, eb), bool)
    sc[:n], dc[:n], vc[:n] = s[at:hi], d[at:hi], valid[at:hi]
    return sc, dc, vc, n


def intern(*id_arrays: np.ndarray):
    """Map arbitrary numeric vertex ids in the given arrays to dense
    0..V-1 ints. Returns (unique_ids, [dense_arrays...])."""
    stacked = np.concatenate([np.asarray(a) for a in id_arrays])
    uniq, inv = np.unique(stacked, return_inverse=True)
    out = []
    off = 0
    for a in id_arrays:
        n = np.asarray(a).shape[0]
        out.append(inv[off:off + n].astype(np.int32))
        off += n
    return uniq, out
