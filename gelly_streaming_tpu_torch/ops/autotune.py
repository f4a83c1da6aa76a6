"""Online dispatch autotuner: find the fast configuration (windows per
dispatch, K bucket, wire) on the stream that is actually running.

Port of the JAX package's `ops/autotune.py` (the knobs :55-97, the
cache :100-150, `DispatchTuner` :153-359). The engines that use it
(`TriangleWindowKernel.count_stream`, `StreamSummaryEngine.process`,
`ResidentSummaryEngine`, the driver's scan and resident tiers) fold a
long call in measurement rounds, and `TenantCohort` (core/tenancy.py,
family `tenant_cohort`: tenants per dispatch, and windows per
super-batch on its resident tier) its pump rounds; the tuner picks each
round's arm and takes back its measured edges/s:

- The space is small and safe: every arm is a configuration the kernels
  already run exactly (wb rungs under the chunk limit, K rungs of the
  escalation ladder, whose overflow recount keeps counts exact at any
  K, and the two wires), so an arm changes timing only, never results.
- Exploration is deterministic: every `explore_period()`-th round tries
  the next single-knob move off the incumbent (round robin); the others
  exploit it. The same timings give the same decisions, in either
  package (tests/test_torch_autotune.py feeds both the same sequence).
- Promotion has hysteresis: a challenger replaces the incumbent only
  when its smoothed (EMA) edges/s clears `margin` (1.05) times the
  incumbent's, and never on its first observation.
- The winner persists to a per-backend cache,
  `~/.cache/gelly_streaming_tpu_torch/tuning_<backend>.json` (the
  directory from GS_TUNE_CACHE, "0" disables it), with backend "cuda"
  or "cpu", so a cache of the JAX package (a TPU's) never seeds a card
  run. The cache is advisory: a missing or corrupt file is ignored, and
  it seeds only arms inside the current space.

`GS_AUTOTUNE=0` turns it off: the engines then run their static
configuration, with the same results.

`RoundPlan` is the one chunk loop's schedule in every engine: the chunks
of a call, drawn lazily by `ingress_pipeline.run_pipeline`, so a round's
arm is decided while the round before it is still in flight and the
pipeline never drains between rounds. With no tuner (GS_AUTOTUNE=0, a
short call) or under `forced_sync` it is the static configuration's
chunk sequence.

`DispatchTuner.timeline` keeps the decisions, and each is an
`autotune.<action>` flight-recorder event (utils/telemetry.py), as in
the JAX tuner; a tuned call's rounds record the engines' round spans.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional

from ..utils import knobs
from ..utils import telemetry
from . import ingress_pipeline

__all__ = ["Chunk", "DispatchTuner", "RoundPlan", "cache_path", "enabled",
           "explore_period", "load_cached_best", "round_chunks", "rungs",
           "store_best"]

_DEF_MARGIN = 1.05        # the repo-wide measured-adoption bar
_EMA_ALPHA = 0.5          # smoothing of per-arm measured rates
_TIMELINE_CAP = 256       # bound on a tuner's event history

_CACHE_LOCK = threading.Lock()


def enabled() -> bool:
    """GS_AUTOTUNE=0 turns the online tuner off process wide."""
    return knobs.get_bool("GS_AUTOTUNE")


def round_chunks() -> int:
    """Dispatch chunks per measurement round (GS_AUTOTUNE_ROUND, default
    4): the rate of so many chunks in a row, timed finalize to finalize
    inside one pipelined run."""
    return knobs.get_int("GS_AUTOTUNE_ROUND")


def explore_period() -> int:
    """Every Nth measurement round explores (GS_AUTOTUNE_EXPLORE,
    default 3); the rest exploit the incumbent."""
    return knobs.get_int("GS_AUTOTUNE_EXPLORE")


def cache_path(backend: str) -> str:
    """The per-backend tuning cache file; GS_TUNE_CACHE overrides the
    directory, "0" disables persistence ("" returned)."""
    root = knobs.get_path("GS_TUNE_CACHE")
    if root == "0":
        return ""
    if not root:
        root = os.path.join(os.path.expanduser("~"), ".cache",
                            "gelly_streaming_tpu_torch")
    return os.path.join(root, "tuning_%s.json" % backend)


def _backend() -> str:
    """The cache's backend name when a caller gives none: "cuda" where a
    card is present, else "cpu"."""
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def load_cached_best(key: str, backend: str = None) -> Optional[dict]:
    """The persisted best entry {"arm": {...}, "edges_per_s": float} of
    `key`, or None (missing, disabled or corrupt cache)."""
    path = cache_path(backend or _backend())
    if not path:
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        entry = data.get(key)
        if isinstance(entry, dict) and isinstance(entry.get("arm"), dict):
            return entry
    except (OSError, ValueError, AttributeError):
        pass
    return None


def store_best(key: str, arm: dict, edges_per_s: float,
               backend: str = None) -> None:
    """Merge one key's best arm into the cache (atomic replace; a
    read-only home never breaks a stream)."""
    path = cache_path(backend or _backend())
    if not path:
        return
    with _CACHE_LOCK:
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            try:
                with open(path) as f:
                    data = json.load(f)
                if not isinstance(data, dict):
                    data = {}
            except (OSError, ValueError):
                data = {}
            data[key] = {"arm": dict(arm),
                         "edges_per_s": round(float(edges_per_s))}
            tmp = "%s.tmp.%d" % (path, os.getpid())
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            pass


def rungs(cap: int) -> list:
    """The windows-per-dispatch arms under a chunk limit: {cap/4, cap/2,
    cap}, at least 1."""
    return sorted({max(1, cap // 4), max(1, cap // 2), cap})


def _akey(arm: dict) -> str:
    """Canonical identity of an arm (key of the EMAs and the state)."""
    return json.dumps(arm, sort_keys=True)


class DispatchTuner:
    """Deterministic epsilon-greedy coordinate search over a small knob
    space, with hysteresis and persistence (module docstring).

    space:   {knob: [ordered values]}, e.g. {"wb": [16, 32, 64],
             "ingress": ["standard", "compact"]}
    initial: the static configuration (a value of the space for every
             knob): the incumbent before any measurement, and what
             `GS_AUTOTUNE=0` runs.
    backend: the cache's backend ("cuda" or "cpu"; the engines pass
             their device's type).

    Per measurement round:
        arm = tuner.next_round()      # the caller warms the arm first
        ... run round_chunks() chunks at `arm`, timed ...
        tuner.record(arm, edges, seconds)
    and once a call: tuner.save(). The engines do this through
    RoundPlan."""

    def __init__(self, key: str, space: Dict[str, list], initial: dict,
                 margin: float = _DEF_MARGIN, backend: str = None):
        for k, v in initial.items():
            if k not in space or v not in space[k]:
                raise ValueError("initial %s=%r outside tuning space %r"
                                 % (k, v, space.get(k)))
        self.key = key
        self.space = {k: list(vs) for k, vs in space.items()}
        self.margin = float(margin)
        self.backend = backend or _backend()
        self.incumbent = dict(initial)
        self._ema: Dict[str, float] = {}
        self._round = 0
        self._promotions = 0
        self._explore_cursor = 0
        self.timeline: List[dict] = []
        cached = load_cached_best(key, self.backend)
        if cached and self._in_space(cached["arm"]) \
                and cached["arm"] != self.incumbent:
            # the previous run's optimum: start there (it stays on
            # probation like any incumbent)
            self.incumbent = {k: cached["arm"][k] for k in self.space}
            self._event("cache_seed", self.incumbent, None)

    def _in_space(self, arm: dict) -> bool:
        return all(k in arm and arm[k] in vs
                   for k, vs in self.space.items())

    def _candidates(self) -> List[dict]:
        """Single-knob moves off the incumbent, knobs in name order,
        nearest values first (down, then up)."""
        out = []
        for k in sorted(self.space):
            vs = self.space[k]
            i = vs.index(self.incumbent[k])
            for j in (i - 1, i + 1):
                if 0 <= j < len(vs):
                    cand = dict(self.incumbent)
                    cand[k] = vs[j]
                    out.append(cand)
        return out

    def _event(self, action: str, arm: dict, rate) -> None:
        self.timeline.append({
            "round": self._round, "action": action, "arm": dict(arm),
            "edges_per_s": None if rate is None else round(rate)})
        if len(self.timeline) > _TIMELINE_CAP:
            del self.timeline[:len(self.timeline) - _TIMELINE_CAP]
        # every decision is a flight-recorder event, a promotion a
        # durable one (a mid-stream change of configuration)
        telemetry.event("autotune." + action, durable=action == "promote",
                        key=self.key, round=self._round,
                        arm=json.dumps(arm, sort_keys=True),
                        edges_per_s=None if rate is None else round(rate))

    def next_round(self, in_flight: int = 0) -> dict:
        """The arm of the next round: the incumbent, except on every
        `explore_period()`-th round, which probes the next coordinate
        move (round robin over the candidates). `in_flight` counts rounds
        already decided whose record() is still to come (RoundPlan
        decides ahead of its measurements): they take their places in
        the explore period, so the schedule is the one of a caller that
        records each round before deciding the next."""
        cands = self._candidates()
        if not cands or (self._round + in_flight + 1) % explore_period():
            return dict(self.incumbent)
        arm = cands[self._explore_cursor % len(cands)]
        self._explore_cursor += 1
        return arm

    def record(self, arm: dict, edges: int, seconds: float) -> None:
        """Fold one round's rate into the arm's EMA; promote the arm
        when its EMA clears the margin over the incumbent's (never on a
        challenger's first observation)."""
        if seconds <= 0 or edges <= 0:
            return
        rate = edges / seconds
        self._round += 1
        k = _akey(arm)
        seen = k in self._ema
        self._ema[k] = (rate if not seen
                        else (1 - _EMA_ALPHA) * self._ema[k]
                        + _EMA_ALPHA * rate)
        explored = arm != self.incumbent
        promoted = False
        inc_ema = self._ema.get(_akey(self.incumbent))
        if explored and seen and inc_ema is not None \
                and self._ema[k] >= self.margin * inc_ema:
            self.incumbent = dict(arm)
            self._promotions += 1
            self._explore_cursor = 0
            promoted = True
        self._event("promote" if promoted
                    else ("explore" if explored else "exploit"), arm, rate)

    def rekey(self, key: str, space: Dict[str, list] = None,
              initial: dict = None) -> None:
        """Adopt a new cache identity mid-stream (bucket growth changed
        the shapes the rates were measured at): the EMAs reset, the
        incumbent survives as the prior (`initial` where the new space
        dropped it), and the new key's persisted best re-seeds it."""
        self.key = key
        if space is not None:
            self.space = {k: list(vs) for k, vs in space.items()}
        if not self._in_space(self.incumbent):
            if initial is None or not self._in_space(initial):
                raise ValueError(
                    "rekey needs an in-space initial when the incumbent "
                    "%r left the space" % (self.incumbent,))
            self.incumbent = dict(initial)
        self._ema = {}
        self._explore_cursor = 0
        cached = load_cached_best(key, self.backend)
        if cached and self._in_space(cached["arm"]):
            self.incumbent = {k: cached["arm"][k] for k in self.space}
        self._event("rekey", self.incumbent, None)

    def best(self) -> dict:
        return dict(self.incumbent)

    def best_rate(self) -> Optional[float]:
        return self._ema.get(_akey(self.incumbent))

    def save(self) -> None:
        """Persist the incumbent with its smoothed rate."""
        rate = self.best_rate()
        if rate:
            store_best(self.key, self.incumbent, rate, self.backend)

    def summary(self) -> dict:
        """The chosen knobs and the last decisions."""
        return {
            "key": self.key,
            "chosen": dict(self.incumbent),
            "rounds": self._round,
            "promotions": self._promotions,
            "edges_per_s_ema": (None if self.best_rate() is None
                                else round(self.best_rate())),
            "timeline": [dict(e) for e in self.timeline[-32:]],
        }

    def state_dict(self) -> dict:
        """The tuning state that rides engine and driver checkpoints
        (the JAX tuner's keys). The cache key is not state: it names the
        current buckets, and a resume after growth restores the learned
        values into the new identity."""
        return {
            "incumbent": dict(self.incumbent),
            "ema": [[k, float(v)] for k, v in sorted(self._ema.items())],
            "round": int(self._round),
            "promotions": int(self._promotions),
            "explore_cursor": int(self._explore_cursor),
        }

    def load_state_dict(self, state: dict) -> None:
        """Adopt checkpointed tuning state (either package's); an
        incumbent outside the current space is dropped."""
        inc = state.get("incumbent")
        if isinstance(inc, dict) and self._in_space(inc):
            self.incumbent = {k: inc[k] for k in self.space}
        self._ema = {str(k): float(v) for k, v in state.get("ema", [])}
        self._round = int(state.get("round", 0))
        self._promotions = int(state.get("promotions", 0))
        self._explore_cursor = int(state.get("explore_cursor", 0))


class Chunk(NamedTuple):
    """One chunk of a call: its position in the call (`seq`, its staging
    slot's ordinal), windows [at, hi), the arm it runs at and the
    measurement round it belongs to."""

    seq: int
    at: int
    hi: int
    arm: dict
    round: int


class RoundPlan:
    """The chunks of one call of `num_w` windows for run_pipeline, in
    rounds of `round_len` chunks (default round_chunks()), each round at
    one arm (its "wb" the windows a chunk):

    - Iterating yields Chunks lazily. A round's arm is decided when the
      pipeline draws its first chunk, `tuner.next_round(in_flight=...)`,
      while the rounds before it are still in flight: nothing drains
      between rounds, the explore schedule counts the rounds in flight,
      and a promotion shows from the first round decided after the
      measurement that earned it.
    - `on_round(arm, windows)`, if given, runs on the caller's thread as
      a round is decided (an engine warms the arm or captures its graphs
      there); its time is left out of the measurement.
    - `done(chunk, edges)`, in the finalize (chunk order), closes a round
      at its last chunk: the round's edges over the time since the
      previous round closed (the first: since the call began) go to
      `tuner.record`. A round shorter than a full one is recorded only
      when it is the whole call (a long call's ragged tail would drag
      the arm's rate).
    - `close()` after the run persists the tuner's best.
    - `span`, if given, names the flight-recorder span each round of a
      tuned call records as it closes (the JAX engines' round span:
      "triangles.round", "fused_scan.round"), with the round's first
      window (`base` + its offset in the call), its arm and its edges;
      a static call records none, as in the JAX engines.

    With no tuner the call is one round at `arm`, the static
    configuration; under forced_sync the tuner freezes: every round runs
    its incumbent and nothing is recorded."""

    def __init__(self, num_w: int, arm: dict,
                 tuner: Optional[DispatchTuner] = None,
                 round_len: Optional[int] = None,
                 on_round: Optional[Callable] = None,
                 span: Optional[str] = None, base: int = 0):
        self.num_w = int(num_w)
        self.static = dict(arm)
        self.tuner = tuner
        self.frozen = tuner is None or ingress_pipeline.forced_sync_active()
        self.round_len = (round_chunks() if round_len is None
                          else max(1, int(round_len)))
        self.on_round = on_round
        self.span = span if tuner is not None else None
        self.base = int(base)
        self._open = {}   # round -> [arm, windows, edges, chunks left, at]
        self._to_record = 0     # open rounds whose record() is to come
        self._mark = None       # when the last round closed
        self._excluded = 0.0    # on_round seconds since then

    def _arm(self) -> dict:
        if self.tuner is None:
            return dict(self.static)
        if self.frozen:
            return self.tuner.best()
        return self.tuner.next_round(in_flight=self._to_record)

    def _recorded(self, arm: dict, span: int) -> bool:
        """Does a round of `span` windows at `arm` go to the tuner?"""
        return not self.frozen and span == min(
            self.round_len * int(arm["wb"]), self.num_w)

    def __iter__(self):
        self._mark = time.perf_counter()
        at, seq, r = 0, 0, 0
        while at < self.num_w:
            arm = self._arm()
            wb = int(arm["wb"])
            span = (self.num_w - at if self.tuner is None
                    else min(self.num_w - at, self.round_len * wb))
            chunks = -(-span // wb)
            self._open[r] = [arm, span, 0, chunks, at]
            self._to_record += self._recorded(arm, span)
            if self.on_round is not None:
                t0 = time.perf_counter()
                self.on_round(arm, span)
                self._excluded += time.perf_counter() - t0
            end = at + span
            for lo in range(at, end, wb):
                yield Chunk(seq, lo, min(lo + wb, end), arm, r)
                seq += 1
            at, r = end, r + 1

    def done(self, chunk: Chunk, edges: int) -> None:
        entry = self._open[chunk.round]
        entry[2] += int(edges)
        entry[3] -= 1
        if entry[3]:
            return
        del self._open[chunk.round]
        now = time.perf_counter()
        elapsed = now - self._mark - self._excluded
        self._mark, self._excluded = now, 0.0
        arm, span, edges_r, _, at = entry
        if self._recorded(arm, span):
            self._to_record -= 1
            self.tuner.record(arm, edges_r, elapsed)
        if self.span is not None:
            telemetry.record_span(self.span, now - elapsed, elapsed,
                                  window=self.base + at, edges=edges_r,
                                  **arm)

    def close(self) -> None:
        if not self.frozen:
            self.tuner.save()
