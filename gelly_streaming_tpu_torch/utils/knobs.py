"""The typed `GS_*` knob registry: the one place the port's environment
knobs are declared, parsed and documented.

Port of the JAX package's `utils/knobs.py`: the registry API as it is
(`Knob`, `KnobError`, `register`, `get_int`, `get_bool`, `get_str`,
`get_path`; :46-180 there; `get_float` and the README table's
`render_table` come with the float knobs of step 1.8), with
only the knobs the port reads so far registered, under the JAX names,
defaults and bounds (:228-262): the dispatch autotuner's
(`ops/autotune.py`) and the resident tier's (`ops/resident_engine.py`).
The rest of the registry comes with the host hooks (ROADMAP step 1.8).

- Reads are live: `os.environ` is consulted on every call, never
  cached, so a test or a tool can flip a knob mid-process.
- A malformed value raises `KnobError` naming the knob, the text and the
  expected kind, at the read site.
- Unset and empty both mean the default.
- Numbers are clamped to `lo`/`hi`, not refused: the bounds say "2 is
  the smallest useful explore period", not that the user erred.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["Knob", "KnobError", "REGISTRY", "register", "get_int",
           "get_bool", "get_str", "get_path"]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


class KnobError(ValueError):
    """A `GS_*` environment value could not be parsed as its declared
    kind. Carries `.knob` (the Knob) and `.value` (the offending text)."""

    def __init__(self, knob: "Knob", value: str, problem: str):
        super().__init__(
            "%s=%r: %s (expected %s; default %r)"
            % (knob.name, value, problem, knob.kind, knob.default))
        self.knob = knob
        self.value = value


@dataclass(frozen=True)
class Knob:
    """One declared environment knob. `kind` is one of 'int', 'bool',
    'str', 'path'; `lo`/`hi` clamp parsed numbers; `choices`
    restricts str knobs; `default_text` says how the default reads
    where it is computed; `help` is the knob's meaning."""

    name: str
    kind: str
    default: object
    help: str
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None
    default_text: Optional[str] = None


REGISTRY: Dict[str, Knob] = {}


def register(name: str, kind: str, default, help: str, **kw) -> Knob:
    assert name.startswith("GS_"), name
    assert kind in ("int", "bool", "str", "path"), kind
    assert name not in REGISTRY, "duplicate knob %s" % name
    knob = Knob(name, kind, default, help, **kw)
    REGISTRY[name] = knob
    return knob


def _raw(name: str) -> Optional[str]:
    """The live environment text; unset and empty are both None (the
    default)."""
    val = os.environ.get(name)
    return None if val is None or val == "" else val


def _clamp(knob: Knob, num):
    if knob.lo is not None and num < knob.lo:
        num = type(num)(knob.lo)
    if knob.hi is not None and num > knob.hi:
        num = type(num)(knob.hi)
    return num


def _knob(name: str, kind: str) -> Knob:
    knob = REGISTRY.get(name)
    assert knob is not None, "unregistered knob %s" % name
    assert knob.kind == kind, (name, knob.kind, kind)
    return knob


def get_int(name: str) -> Optional[int]:
    knob = _knob(name, "int")
    raw = _raw(name)
    if raw is None:
        return knob.default if knob.default is None \
            else _clamp(knob, int(knob.default))
    try:
        num = int(raw)
    except ValueError:
        raise KnobError(knob, raw, "not an integer") from None
    return _clamp(knob, num)


def get_bool(name: str) -> bool:
    knob = _knob(name, "bool")
    raw = _raw(name)
    if raw is None:
        return bool(knob.default)
    low = raw.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise KnobError(knob, raw, "not a boolean (%s / %s)"
                    % ("/".join(_TRUE), "/".join(_FALSE)))


def get_str(name: str) -> str:
    knob = _knob(name, "str")
    raw = _raw(name)
    if raw is None:
        return knob.default
    if knob.choices is not None and raw not in knob.choices:
        raise KnobError(knob, raw,
                        "not one of %s" % "/".join(knob.choices))
    return raw


def get_path(name: str) -> Optional[str]:
    """Path knobs: a filesystem location, or the conventional "0" for
    explicitly disabled, which callers test for. None = unset."""
    knob = _knob(name, "path")
    raw = _raw(name)
    return knob.default if raw is None else raw


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------

# dispatch autotuner (ops/autotune.py)
register("GS_AUTOTUNE", "bool", True,
         help="`0` disables the online dispatch tuner "
              "(`ops/autotune.py`): windows-per-dispatch, K and the wire "
              "then run the static configuration; on, the tuner "
              "deterministically (with 1.05× hysteresis) finds the fast "
              "configuration on the live stream")
register("GS_AUTOTUNE_ROUND", "int", 4, lo=1,
         help="dispatch chunks per tuner measurement round; a 1-chunk "
              "round would measure the synchronous form")
register("GS_AUTOTUNE_EXPLORE", "int", 3, lo=2,
         help="every Nth measurement round explores the next "
              "single-knob move off the incumbent; the rest exploit")
register("GS_TUNE_CACHE", "path", None,
         help="directory of the per-backend tuning cache "
              "(`tuning_<backend>.json`, backend `cuda` or `cpu`) that "
              "seeds the next run with this run's optimum; `0` disables "
              "persistence",
         default_text="`~/.cache/gelly_streaming_tpu_torch`")

# resident-state tier (ops/resident_engine.py)
register("GS_RESIDENT", "str", "", choices=("on", "off", "auto"),
         help="pin the driver's resident snapshot tier "
              "(`ops/resident_engine.py`): `on` selects it, `off` never; "
              "unset/`auto` = the scan tier until the port has its own "
              "measured evidence",
         default_text="auto")
register("GS_RESIDENT_SPB", "int", 256, lo=1,
         help="windows per super-batch of the resident tier (one CUDA "
              "graph replay folds this many windows; rounded up to a "
              "power of two)")
register("GS_RESIDENT_SLOTS", "int", 2, lo=1,
         help="ingest-ring depth of the resident tier: super-batches "
              "prepped and copied ahead of dispatch (2 = slot N+1 fills "
              "while N computes)")

