"""The compact wire of a [W, eb] window stack: 4 bytes per slot plus 4
bytes per window, against the standard wire's 9 bytes per slot.

Copies of the numpy helpers of the JAX package's `ops/compact_ingress.py`
(:34-143; the port imports nothing of that package, whose `__init__`
imports JAX), bit-identical there (the tests hold them so), plus
`widen_stack` in PyTorch, the plain decode. Two facts make the wire
lossless:

  1. ids fit uint16 whenever the vertex bucket is ≤ 65536 (id 65535 is
     real: padding is not marked by a sentinel id);
  2. padding is always a suffix of its window (window_stack,
     stack_window_list and pad_chunk fill tails), so one int32 count of
     valid slots per window rebuilds the [W, eb] mask.

On the card the decode is fused into the kernels that read the wire
(csrc/window_counter.cu, csrc/window_summary.cu): a slot i ≥ nvalid[w]
is padding, and no widened [W, eb] int32 stack is ever made.
"""

from __future__ import annotations

import numpy as np
import torch

from .segment import bucket_size

MAX_U16_VB = 65536  # ids ≤ 65535 fit; the sentinel is rebuilt on decode


def supports(vb: int) -> bool:
    """The compact wire is lossless iff every real id is < 65536."""
    return vb <= MAX_U16_VB


def validate_ids(src: np.ndarray, dst: np.ndarray, bound: int,
                 what: str = "compact ingress") -> None:
    """Raise ValueError for any id the uint16 cast would wrap: negatives,
    and ids ≥ min(bound, 65536). Callers run it on the main thread before
    their pipeline, so the error is a ValueError, never a prep failure."""
    if len(src) == 0 and len(dst) == 0:
        return
    top = int(max(src.max(), dst.max()))
    bot = int(min(src.min(), dst.min()))
    limit = min(bound, MAX_U16_VB)
    if bot < 0 or top >= limit:
        raise ValueError(
            "vertex id %d outside [0, %d) in %s input"
            % (bot if bot < 0 else top, limit, what))


def widen_stack(s16: torch.Tensor, d16: torch.Tensor, nvalid: torch.Tensor,
                eb: int, sentinel: int):
    """The plain decode of the compact wire, on the tensors' device: the
    suffix mask pos < nvalid[:, None], and the uint16 ids widened to int32
    with `sentinel` in the padded slots. Returns (s, d, valid), each
    [W, eb]: the standard wire of the same windows."""
    s = s16.to(torch.int32)          # widen first: uint16 is a limited dtype
    d = d16.to(torch.int32)
    pos = torch.arange(eb, dtype=torch.int32, device=s.device)[None, :]
    valid = pos < nvalid.to(torch.int32)[:, None]
    return (torch.where(valid, s, sentinel), torch.where(valid, d, sentinel),
            valid)


def window_stack(src: np.ndarray, dst: np.ndarray, eb: int):
    """Compact form of segment.window_stack: [W, eb] uint16 stacks + [W]
    int32 valid counts (padding implied as each window's suffix)."""
    n = len(src)
    num_w = -(-n // eb)
    s16 = np.zeros(num_w * eb, np.uint16)
    d16 = np.zeros(num_w * eb, np.uint16)
    s16[:n] = src.astype(np.uint16)
    d16[:n] = dst.astype(np.uint16)
    nvalid = np.full(num_w, eb, np.int32)
    if n % eb:
        nvalid[-1] = n % eb
    return num_w, s16.reshape(num_w, eb), d16.reshape(num_w, eb), nvalid


def stack_window_list(windows, eb: int):
    """Compact form of segment.stack_window_list: per-window uint16 rows +
    valid counts."""
    num_w = len(windows)
    s16 = np.zeros((num_w, eb), np.uint16)
    d16 = np.zeros((num_w, eb), np.uint16)
    nvalid = np.zeros(num_w, np.int32)
    for w, (ws, wd) in enumerate(windows):
        k = len(ws)
        if k > eb:
            raise ValueError(f"window of {k} edges exceeds edge "
                             f"bucket {eb}")
        s16[w, :k] = np.asarray(ws, np.uint16)
        d16[w, :k] = np.asarray(wd, np.uint16)
        nvalid[w] = k
    return s16, d16, nvalid


def pad_chunk(s16, d16, nvalid, at: int, hi: int, max_w: int, eb: int):
    """Compact form of segment.pad_window_chunk: slice [at:hi] and pad the
    window axis to a power-of-two bucket with empty (count-0) rows.
    Returns (s16, d16, nvalid, n)."""
    n = hi - at
    wb = min(bucket_size(n), max_w)
    if n == wb:  # steady state: zero-copy views
        return s16[at:hi], d16[at:hi], nvalid[at:hi], n
    sc = np.zeros((wb, eb), np.uint16)
    dc = np.zeros((wb, eb), np.uint16)
    nv = np.zeros(wb, np.int32)
    sc[:n], dc[:n], nv[:n] = s16[at:hi], d16[at:hi], nvalid[at:hi]
    return sc, dc, nv, n
