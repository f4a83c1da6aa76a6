"""The measured-adoption routing's evidence: the port's committed A/B rows,
read for the device an engine runs on, and the one gate every selection
holds them to.

Port of the JAX package's `_load_matching_perf` and `rows_clear_bar`
(ops/triangles.py:166-229 there). Where a caller gives no tier, wire, K,
egress or table mode, the resolvers of the port (ops/triangles.py,
ops/resident_engine.py, core/driver.py, ops/delta_egress.py,
ops/windowed_reduce.py, parallel/sharded.py) keep the default unless the
rows measured on that device show the alternative at parity and at least
`margin` (1.05) times faster on every row. On the CPU that is the JAX
rule on the rows' median rates. On a card it is `worst_clears_bar`: the
alternative's slowest turn against the baseline's fastest, so that a
win inside the turns' spread never moves a path off its kernel.

Each resolver is a gate handed to `choose`, which owns the memo (one
choice a component, device and key until `forget`), the load and the
`selection.fallback` event of an evidence file that cannot be read as
rows.

The evidence file is `PERF_torch.json` in this package (`PERF_PATH`), as
`utils/evidence_ab.py --out` writes it on a card:

    {"devices": {"NVIDIA H100 80GB HBM3": {"host_stream": [...], ...},
                 "cpu": {...}}}

A section set is taken only for the exact name of the device the engine
runs on (`device_label`: `torch.cuda.get_device_name` on a card, "cpu"
for device="cpu"), so rows of one device never route another, and
profiling one device leaves the others' rows in place. Sections that
hold an error stub ({"error": ...}) are dropped. An absent, corrupt or
unmatched file is None: every resolver then returns its default. The
tree ships no such file; whether rows are committed is a decision of the
port's benchmark.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from ..core.platform import resolve_device
from . import telemetry

__all__ = ["CPU", "PERF_PATH", "choose", "device_label", "forget",
           "load_label", "load_matching", "on_card", "rows_clear_bar",
           "worst_clears_bar"]

CPU = "cpu"
# module-level so tests point it at a file of their own
PERF_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "PERF_torch.json")


_CHOSEN = {}   # (component, device label, key) -> the resolver's choice


def forget(component: str = None) -> None:
    """Forget the memoized choices of `component` (of every resolver
    where None), so the next engine routes on the evidence file as it is
    now (the resolvers read it once a device and key otherwise)."""
    for memo in [m for m in _CHOSEN if component in (None, m[0])]:
        _CHOSEN.pop(memo, None)


def choose(component: str, device, gate, default, key=None):
    """The choice of `component` on `device` (and `key`):
    gate(sections, label) on the sections measured on the device's label
    ({} where there are none), memoized until `forget`. Where the label
    or the rows raise, `default`, and a `selection.fallback` event."""
    try:
        label = device_label(device)
        memo = (component, label, key)
        if memo not in _CHOSEN:
            _CHOSEN[memo] = gate(load_label(label) or {}, label)
        return _CHOSEN[memo]
    except Exception as e:
        telemetry.event("selection.fallback", durable=True,
                        component=component, fallback=default,
                        error="%s: %s" % (type(e).__name__, e))
        return default


def device_label(device=None) -> str:
    """The evidence label of `device`: the card's name
    (torch.cuda.get_device_name) for a CUDA device, "cpu" otherwise.
    None is the current card where there is one, else "cpu" (a resolver
    never raises for want of a card; the engine it serves does). An
    explicit CUDA device with no card raises as `resolve_device` does."""
    if device is None and not torch.cuda.is_available():
        return CPU
    dev = resolve_device(device)
    if dev.type != "cuda":
        return CPU
    return torch.cuda.get_device_name(dev)


def on_card(label: str) -> bool:
    """True for a card's label, False for the CPU's."""
    return label != CPU


def load_label(label: str) -> Optional[dict]:
    """The sections measured on the device labelled `label`, error stubs
    dropped; None where the file is absent, corrupt or holds no such
    device."""
    try:
        with open(PERF_PATH) as f:
            perf = json.load(f)
        sections = perf["devices"][label]
        if not isinstance(sections, dict):
            return None
        return {k: v for k, v in sections.items()
                if not (isinstance(v, dict) and "error" in v)}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def load_matching(device=None) -> Optional[dict]:
    """`load_label` for the device an engine runs on (the counterpart of
    the JAX package's `_load_matching_perf`)."""
    return load_label(device_label(device))


def rows_clear_bar(rows, num_key, den, parity_key="parity",
                   margin=1.05) -> bool:
    """The adoption gate: True iff `rows` is a non-empty list whose every
    row has `parity_key` exactly True and `num_key` at least `margin`
    times the baseline (`den`: a row key, or a callable(row) -> float
    for a composite baseline). A missing or zero rate on either side
    fails the gate."""
    if not (isinstance(rows, list) and rows):
        return False
    for r in rows:
        if not isinstance(r, dict) or r.get(parity_key) is not True:
            return False
        num = r.get(num_key)
        base = den(r) if callable(den) else r.get(den)
        if not num or not base or num <= 0 or base <= 0:
            return False
        if num < margin * base:
            return False
    return True


def worst_clears_bar(rows, alt: str, base, parity_key="parity",
                     margin=1.05) -> bool:
    """The card's adoption gate: True iff `rows` is a non-empty list
    whose every row has `parity_key` exactly True and whose baseline's
    fastest turn took at least `margin` times the alternative's slowest,
    read from the seconds utils/evidence_ab.py writes for each arm
    (`<arm>_s_min`, `<arm>_s_max`). `base` is an arm or a tuple of arms
    whose best is the baseline; its first arm (the default path) must be
    in every row, the others count where a row has them. A missing or
    zero time fails the gate."""
    bases = (base,) if isinstance(base, str) else tuple(base)

    def rate(r, key):   # one stream's worth a second
        t = r.get(key)
        return 1.0 / t if isinstance(t, (int, float)) and t > 0 else 0.0

    def pairs(r):
        if not isinstance(r, dict):
            return r
        first = rate(r, bases[0] + "_s_min")
        return {"parity": r.get(parity_key),
                "alt": rate(r, alt + "_s_max"),
                "base": first and max(rate(r, b + "_s_min") for b in bases)}

    return rows_clear_bar([pairs(r) for r in rows]
                          if isinstance(rows, list) else rows,
                          "alt", "base", margin=margin)
