"""The delta wire of the driver's snapshot egress: per window the slots
that changed, not whole snapshot rows.

Port of the JAX package's `ops/delta_egress.py` (:83-131). Per window
and analytic: an int32 count of changed slots, a [cap] row of their
indices ascending and a [cap] row of their new values. The host applies
each window's pairs to its carried mirror, which then is that window's
snapshot. Degrees change at most 2·eb slots a window, so cap =
min(2·eb, vb) is exact for them; labels can cascade past any cap < vb,
so a count past the cap sends its chunk back through the snapshot
program on full rows (the driver's `_refold_chunk_outs`). The JAX package's evidence-routed
`resolve_egress` and its GS_EGRESS / GS_EGRESS_CAP knobs are the
driver's `egress=` and `egress_cap=` arguments here.
"""

from __future__ import annotations

import numpy as np
import torch

EGRESS = ("full", "delta")


def egress_cap(eb: int, vb: int, cap: int = None) -> int:
    """Changed slots a window's delta row holds: min(2·eb, vb), or `cap`
    where given (at least 1, at most vb)."""
    if cap is None:
        return min(2 * eb, vb)
    return max(1, min(int(cap), vb))


def compact_changed(mask: torch.Tensor, new_vals: torch.Tensor, cap: int,
                    pad_idx: int = 0):
    """The plain encode of one window's delta wire: (changed count,
    changed indices [cap] ascending, their new values [cap]). The count
    may exceed cap (the host then refolds); index slots past it hold
    `pad_idx` and values new_vals[pad_idx]."""
    idx = torch.nonzero(mask).reshape(-1)[:cap].to(torch.int32)
    if idx.numel() < cap:
        idx = torch.cat([idx, torch.full((cap - idx.numel(),), pad_idx,
                                         dtype=torch.int32,
                                         device=mask.device)])
    return (mask.sum(dtype=torch.int32), idx, new_vals[idx.long()])


def apply_delta(mirror: np.ndarray, cnt: int, idx: np.ndarray,
                vals: np.ndarray) -> None:
    """Scatter one window's (idx, vals) pairs into the mirror in place:
    the mirror then is that window's snapshot."""
    k = int(cnt)
    mirror[idx[:k]] = vals[:k]
