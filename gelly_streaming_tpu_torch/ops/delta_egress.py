"""The delta wire of the driver's snapshot egress: per window the slots
that changed, not whole snapshot rows.

Port of the JAX package's `ops/delta_egress.py` (:83-131). Per window
and analytic: an int32 count of changed slots, a [cap] row of their
indices ascending and a [cap] row of their new values. The host applies
each window's pairs to its carried mirror, which then is that window's
snapshot. Degrees change at most 2·eb slots a window, so cap =
min(2·eb, vb) is exact for them; labels can cascade past any cap < vb,
so a count past the cap sends its chunk back through the snapshot
program on full rows (the driver's `_refold_chunk_outs`).

Selection (the JAX package's :47-93): `resolve_egress(device)` is the
egress of a driver or a windowed reduce given none: GS_EGRESS pins
("full"/"delta"); unset or "auto" is "delta" only where every `egress_ab`
row of the device (utils/evidence.py) shows parity and a 5% win (on a
card, in its worst turns), else "full". GS_EGRESS_CAP narrows the cap where no `egress_cap=` is given.
The JAX reduce wire's `compact_touched` and `scatter_full` have their
equivalent in the cell-reduce kernel's delta form (ops/cell_reduce.py:
the touched cells of a window, ascending, with their values and counts)
and its decode in ops/windowed_reduce.py (`_device_process_stream`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import evidence
from ..utils import knobs

EGRESS = ("full", "delta")

def _reset_egress() -> None:
    """Test hook: forget the memoized egress selections."""
    evidence.forget("egress")


def resolve_egress(device=None) -> str:
    """The d2h egress of the driver's scan tier and the windowed reduce
    where none is given: the GS_EGRESS pin, else "delta" where every
    `egress_ab` row of the device clears the bar (the CPU: parity and a
    `speedup` of 1.05; a card: `evidence.worst_clears_bar`), else
    "full". Memoized per device."""
    pin = knobs.get_str("GS_EGRESS")
    if pin in EGRESS:
        return pin

    def gate(perf, label):
        rows = perf.get("egress_ab", [])
        if evidence.on_card(label):
            won = evidence.worst_clears_bar(rows, "delta", "full")
        else:
            won = evidence.rows_clear_bar(rows, "speedup", lambda r: 1.0)
        return "delta" if won else "full"

    return evidence.choose("egress", device, gate, "full")


def egress_cap(eb: int, vb: int, cap: int = None) -> int:
    """Changed slots a window's delta row holds: `cap` where given, else
    GS_EGRESS_CAP where set, else min(2·eb, vb); at least 1, at most
    vb."""
    if cap is None:
        cap = knobs.get_int("GS_EGRESS_CAP")
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
