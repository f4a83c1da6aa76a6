"""End-to-end latency plane: from a batch's admission to its windows'
delivery.

Port of the JAX package's `utils/latency.py`, with the same records
(keys, stages, lane and ordinal) and metric names on equal input; only
the times differ. Every stamp is `time.perf_counter_ns` (CLOCK_MONOTONIC,
the clock of the span ledger): `admit_ns()` is that integer, `clock()`
the same instant in seconds.

- Admission marks (`on_admit`): every accepted batch is stamped at the
  engine's admission (SummaryEngineBase.process). Marks are per-lane
  cumulative-edge-offset cursors, so a finalized window joins back to
  the admission time of the edge that completed it.
- Stage waterfall (`stamps`/`stamp`): the engine's chunk prep, h2d and
  dispatch stamp their boundaries as a chunk moves through the ingress
  pipeline; a window's stage latencies are the consecutive differences,
  so they sum to its end-to-end latency by construction (`reconcile`).
- Per-lane percentiles in bounded reservoirs, under the metrics
  registry's cardinality bound (`percentile_fields` pools them into a
  bench row's `e2e_p{50,95,99}_s`); armed metrics add the
  `gs_latency_e2e_seconds` and `gs_latency_stage_seconds` histograms.
- `queue_age(lane)`: the age of the oldest admitted but unfinalized
  edge (`gs_latency_oldest_edge_age_s`). A lane whose owner reports an
  event-time watermark (`note_watermark`: the cohort's GS_OOO_BOUND
  reorder buffer) contributes its watermark lag to that gauge instead.
- SLO burn: with GS_SLO_P99_S set, each window is good or bad against
  the target; a burn rate ≥ GS_SLO_BURN over GS_SLO_WINDOW_S flips the
  `/healthz` `latency` section to `degraded` (durable `slo_burn`).
- Replay: admission stamps ride the journal's ts column (int64 ns), so
  a journal replay (`on_replay`) re-seeds the marks with the original
  admission times.

With GS_LATENCY=0 (the default) every hook is a guarded no-op, and
summaries and journal bytes are bit-identical to a run without the
plane. The hooks read only host clocks: no device sync.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from . import knobs
from . import metrics
from . import telemetry

def clock() -> float:
    """Now, in seconds of `time.perf_counter_ns` (the span ledger's
    clock)."""
    return time.perf_counter_ns() * 1e-9

# canonical stage taxonomy, in pipeline order; boundary stamps carry
# the name of the stage they CLOSE (see stamp()/on_window)
STAGES = ("admission", "queue_wait", "prep", "h2d", "dispatch",
          "finalize", "deliver")
# boundary-stamp keys a stamps() dict may carry, in order; "start"
# closes queue_wait (it is the first post-queue boundary)
_BOUNDARIES = (("queue_wait", "start"), ("prep", "prep"),
               ("h2d", "h2d"), ("dispatch", "dispatch"))

_RESERVOIR = 512   # per-lane / per-stage sample cap (percentile source)
_RECENT = 2048     # introspection ring of emitted window records
_SLO_MIN_WINDOWS = 8  # burn verdicts need a minimal sample


def enabled() -> bool:
    """GS_LATENCY arms the plane; off (the default) every hook is a
    guarded no-op and the hot path is bit-identical."""
    return knobs.get_bool("GS_LATENCY")


def marks_cap() -> int:
    return knobs.get_int("GS_LAT_MARKS")


def pending_cap() -> int:
    return knobs.get_int("GS_LAT_PENDING")


def slo_target_s() -> float:
    return knobs.get_float("GS_SLO_P99_S")


class _Lane:
    """One stream's latency cursors: cumulative admitted (`fed`) and
    finalized (`done`) edge offsets, the bounded admission-mark deque
    joining windows back to admission times, and the e2e reservoir."""

    __slots__ = ("fed", "done", "marks", "e2e", "windows",
                 "evicted_to", "wm_armed", "wm_lag", "wm_held")

    def __init__(self):
        self.fed = 0
        self.done = 0
        # (end_offset, t_admit_start, t_admit_end, replayed)
        self.marks = collections.deque(maxlen=marks_cap())
        self.e2e = collections.deque(maxlen=_RESERVOIR)
        self.windows = 0
        # highest end_offset pushed out of the bounded mark deque: a
        # window at or below it lost its true admission anchor and
        # reports approximate latency instead of growing memory
        self.evicted_to = 0
        # event-time watermark (note_watermark, GS_OOO_BOUND armed):
        # while armed, the lane's age-gauge contribution is its
        # watermark lag instead of the ingestion-time queue age
        self.wm_armed = False
        self.wm_lag = 0.0
        self.wm_held = 0

    def push_mark(self, mark) -> None:
        if len(self.marks) == self.marks.maxlen:
            self.evicted_to = max(self.evicted_to, self.marks[0][0])
        self.marks.append(mark)


class _Plane:
    """All mutable state behind one lock (rebuilt by reset())."""

    def __init__(self):
        self.lock = threading.RLock()
        self.lanes: Dict[str, _Lane] = {}
        # (lane, ordinal) → record awaiting its delivery stamp; past
        # pending_cap() the OLDEST is emitted as-finalized instead of
        # growing without bound (a pump whose caller never delivers)
        self.pending = collections.OrderedDict()
        self.recent = collections.deque(maxlen=_RECENT)
        self.stage_samples: Dict[str, collections.deque] = {}
        # SLO burn state: sliding (t, bad) results + episode status.
        # slo_bad is a RUNNING counter maintained on append/expiry —
        # the hot path never rescans the deque under the lock.
        self.slo_results = collections.deque(maxlen=4096)
        self.slo_status = "ok"
        self.slo_burn = 0.0
        self.slo_windows = 0
        self.slo_bad = 0

    def lane(self, name: str) -> _Lane:
        """Admit one lane under the registry's cardinality bound —
        the same collapse-don't-grow policy as metrics.tenant_key:
        past GS_METRICS_SERIES, new lanes share one `overflow` row."""
        name = str(name)
        ln = self.lanes.get(name)
        if ln is not None:
            return ln
        if len(self.lanes) >= knobs.get_int("GS_METRICS_SERIES"):
            return self.lanes.setdefault("overflow", _Lane())
        ln = self.lanes[name] = _Lane()
        return ln


_PLANE: Optional[_Plane] = None
_PLANE_LOCK = threading.Lock()


def _plane() -> _Plane:
    global _PLANE
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = _Plane()
    return _PLANE


def reset() -> None:
    """Test/tool hook: drop all lanes, marks and SLO state."""
    global _PLANE
    with _PLANE_LOCK:
        _PLANE = None


# ----------------------------------------------------------------------
# admission
# ----------------------------------------------------------------------
def admit_ns(t: Optional[float] = None) -> int:
    """The journal ts-column form of one admission stamp: int64
    nanoseconds of the monotonic clock (comparable across a kill and a
    restart on one boot): `time.perf_counter_ns()`, or `t` seconds."""
    return time.perf_counter_ns() if t is None else int(t * 1e9)


def on_admit(lane, n: int, t0: Optional[float] = None,
             t1: Optional[float] = None) -> None:
    """Mark `n` edges accepted into `lane` at its admission boundary:
    `t0` = admission start (request receive / process() entry), `t1` =
    admission end (journaled + enqueued; defaults to now). The
    admission stage of every window completed by this batch is
    t1 - t0; its end-to-end clock starts at t0."""
    if not enabled() or n <= 0:
        return
    p = _plane()
    now = clock()
    t1 = now if t1 is None else t1
    t0 = t1 if t0 is None else t0
    with p.lock:
        ln = p.lane(lane)
        ln.fed += n
        ln.push_mark((ln.fed, t0, t1, False))
        age = _queue_age_locked(ln, now)
    metrics.gauge_set("gs_tenant_queue_age_s", age or 0.0,
                      tenant=str(lane))
    _age_gauge(p, now)


def on_replay(lane, n: int, ts_ns=None) -> None:
    """Re-seed admission marks for `n` journal-replayed edges with
    their ORIGINAL admission stamps (the WAL ts column, ns of the
    monotonic clock) — replayed windows then report their honest,
    larger ingest→deliver latency instead of reset-to-zero. With no
    journaled stamps (a disarmed-at-feed-time run) the replay moment
    stands in."""
    if not enabled() or n <= 0:
        return
    p = _plane()
    now = clock()
    t = now
    if ts_ns is not None and len(ts_ns):
        t = min(float(ts_ns[0]) / 1e9, now)  # cross-boot clamp
    with p.lock:
        ln = p.lane(lane)
        ln.fed += n
        ln.push_mark((ln.fed, t, t, True))
    _age_gauge(p, now)


# ----------------------------------------------------------------------
# stage boundary stamps
# ----------------------------------------------------------------------
def stamps() -> Optional[dict]:
    """A per-dispatch boundary-stamp dict, or None disarmed (every
    stamp() on None is a no-op — the disarmed hot path carries one
    falsy check per stage)."""
    return {} if enabled() else None


def stamp(st: Optional[dict], name: str,
          t: Optional[float] = None) -> None:
    """Record boundary `name` ("start" closes queue-wait, then
    "prep"/"h2d"/"dispatch") at time `t` (now when omitted)."""
    if st is not None:
        st[name] = clock() if t is None else t


# ----------------------------------------------------------------------
# window finalize / delivery
# ----------------------------------------------------------------------
def on_window(lane, edges: int, st: Optional[dict] = None,
              ordinal: Optional[int] = None,
              defer: bool = False) -> Optional[dict]:
    """One window finalized on `lane` covering the lane's next
    `edges` admitted edges. Joins the window to the admission mark of
    its LAST edge, derives the stage waterfall from the boundary
    stamps, and either emits the record now (deliver = finalize — the
    engine/driver delivery shape) or defers it for `delivered()` (the
    serving front-end stamps the sink write). Returns the record."""
    if not enabled() or edges <= 0:
        return None
    p = _plane()
    now = clock()
    with p.lock:
        ln = p.lane(lane)
        lo = ln.done
        ln.done += edges
        mark = _mark_for_locked(ln, ln.done)
        if ln.done <= ln.evicted_to:
            mark = None  # true anchor evicted: report approximate
        if ordinal is None:
            ordinal = ln.windows
        ln.windows += 1
    if mark is None:
        # marks evicted or the plane was armed mid-stream: anchor at
        # the earliest boundary we do have, flagged approximate
        base = min([v for v in (st or {}).values()] + [now])
        t0 = t1 = base
        replayed, approx = False, True
    else:
        _end, t0, t1, replayed = mark
        approx = False
    stages = {"admission": max(0.0, t1 - t0)}
    prev = t1
    for stage_name, key in _BOUNDARIES:
        bt = (st or {}).get(key)
        if bt is None:
            continue
        stages[stage_name] = max(0.0, bt - prev)
        prev = max(prev, bt)
    stages["finalize"] = max(0.0, now - prev)
    rec = {
        "tenant": str(lane), "window": int(ordinal),
        "edges": int(edges), "lo": int(lo),
        "t_admit": t0, "t_done": now,
        "e2e_s": max(0.0, now - t0),
        "stages": stages,
        "replayed": replayed,
    }
    if approx:
        rec["approx"] = True
    if defer:
        evicted = None
        with p.lock:
            p.pending[(str(lane), int(ordinal))] = rec
            if len(p.pending) > pending_cap():
                _key, evicted = p.pending.popitem(last=False)
        if evicted is not None:
            _emit(p, evicted)
    else:
        _emit(p, rec)
    return rec


def delivered(lane, ordinal, t: Optional[float] = None
              ) -> Optional[dict]:
    """Close one deferred window record at its DELIVERY boundary (the
    results-sink write): stamps the `deliver` stage, finalizes e2e,
    and emits. Returns the record (the serving layer copies
    `e2e_s` into the sink row as `latency_s`); None when nothing is
    pending (plane disarmed, or the record was already evicted)."""
    p = _plane()
    with p.lock:
        rec = p.pending.pop((str(lane), int(ordinal)), None)
    if rec is None:
        return None
    t = clock() if t is None else t
    rec["stages"]["deliver"] = max(0.0, t - rec["t_done"])
    rec["t_done"] = t
    rec["e2e_s"] = max(0.0, t - rec["t_admit"])
    _emit(p, rec)
    return rec


def settle(lane=None) -> int:
    """Emit every still-pending record (deliver = finalize) — the
    teardown path of callers that deferred but will never deliver.
    Returns records settled."""
    p = _plane()
    with p.lock:
        keys = [k for k in p.pending
                if lane is None or k[0] == str(lane)]
        recs = [p.pending.pop(k) for k in keys]
    for rec in recs:
        _emit(p, rec)
    return len(recs)


def _mark_for_locked(ln: _Lane, hi: int):
    """The admission mark covering cumulative edge offset `hi` (the
    window's LAST edge), pruning marks wholly below `done` — called
    under the plane lock."""
    found = None
    for mark in ln.marks:
        if mark[0] >= hi:
            found = mark
            break
    while ln.marks and ln.marks[0][0] <= ln.done:
        ln.marks.popleft()
    return found


def _emit(p: _Plane, rec: dict) -> None:
    """Record one finished window: reservoirs, metrics histograms,
    the `latency.window` ledger event, and SLO accounting. Called
    OUTSIDE the plane lock's critical path where possible (metrics
    and telemetry hold their own locks)."""
    e2e = rec["e2e_s"]
    lane = rec["tenant"]
    with p.lock:
        p.lane(lane).e2e.append(e2e)
        for stage_name, dur in rec["stages"].items():
            p.stage_samples.setdefault(
                stage_name,
                collections.deque(maxlen=_RESERVOIR)).append(dur)
        p.recent.append(rec)
    metrics.observe("gs_latency_e2e_seconds", e2e, tenant=lane)
    for stage_name, dur in rec["stages"].items():
        metrics.observe("gs_latency_stage_seconds", dur,
                        stage=stage_name)
    telemetry.event(
        "latency.window", tenant=lane, window=rec["window"],
        edges=rec["edges"], e2e_s=round(e2e, 9),
        stages={k: round(v, 9) for k, v in rec["stages"].items()},
        replayed=rec["replayed"] or None,
        approx=rec.get("approx"))
    _slo_account(p, e2e)


# ----------------------------------------------------------------------
# watermark-lag twin: oldest-unfinalized-edge age
# ----------------------------------------------------------------------
def _queue_age_locked(ln: _Lane, now: float) -> Optional[float]:
    for mark in ln.marks:
        if mark[0] > ln.done:
            return max(0.0, now - mark[2])
    return None


def note_watermark(lane, lag_s: float, held: int = 0) -> None:
    """Record one lane's event-time watermark lag: seconds of event time
    between the newest stamp the stream has seen and the oldest edge
    still held in its reorder buffer (`held` edges; the cohort's
    GS_OOO_BOUND hold). While a lane is armed this repoints its
    contribution to `gs_latency_oldest_edge_age_s`: an event-time
    stream reports how far its watermark trails its frontier, not how
    long a released edge has sat in the ingest queue."""
    if not enabled():
        return
    p = _plane()
    now = clock()
    lag = max(0.0, float(lag_s))
    with p.lock:
        ln = p.lane(lane)
        ln.wm_armed = True
        ln.wm_lag = lag
        ln.wm_held = int(held)
    metrics.gauge_set("gs_tenant_watermark_lag_s", round(lag, 6),
                      tenant=str(lane))
    _age_gauge(p, now)


def _lane_age_locked(ln: _Lane, now: float) -> Optional[float]:
    """One lane's age-gauge contribution: the event-time watermark lag
    when armed (note_watermark), else the ingestion-time queue age.
    Caller holds the plane lock."""
    if ln.wm_armed:
        return ln.wm_lag
    return _queue_age_locked(ln, now)


def queue_age(lane, now: Optional[float] = None) -> Optional[float]:
    """Age (seconds) of `lane`'s oldest admitted-but-unfinalized
    edge — the ingestion-time watermark-lag twin. None when the lane
    is fully finalized (or the plane is disarmed)."""
    if not enabled():
        return None
    p = _plane()
    now = clock() if now is None else now
    with p.lock:
        ln = p.lanes.get(str(lane))
        return None if ln is None else _queue_age_locked(ln, now)


def oldest_age(now: Optional[float] = None) -> Optional[float]:
    """The worst per-lane age across every lane (the global
    `gs_latency_oldest_edge_age_s` gauge body): watermark-armed lanes
    contribute their event-time watermark lag (note_watermark), the
    rest their ingestion-time queue age."""
    if not enabled():
        return None
    p = _plane()
    now = clock() if now is None else now
    ages = []
    with p.lock:
        for ln in p.lanes.values():
            age = _lane_age_locked(ln, now)
            if age is not None:
                ages.append(age)
    return max(ages) if ages else None


def _age_gauge(p: _Plane, now: float) -> None:
    if not metrics.enabled():
        return
    age = oldest_age(now)
    metrics.gauge_set("gs_latency_oldest_edge_age_s",
                      0.0 if age is None else age)


# ----------------------------------------------------------------------
# SLO burn rate
# ----------------------------------------------------------------------
def _slo_account(p: _Plane, e2e: float) -> None:
    target = slo_target_s()
    if target <= 0:
        return
    budget = knobs.get_float("GS_SLO_BUDGET")
    window = knobs.get_float("GS_SLO_WINDOW_S")
    threshold = knobs.get_float("GS_SLO_BURN")
    now = clock()
    bad = e2e > target
    flipped = None
    with p.lock:
        if len(p.slo_results) == p.slo_results.maxlen:
            # maxlen eviction would silently skew the running count
            if p.slo_results.popleft()[1]:
                p.slo_bad -= 1
        p.slo_results.append((now, bad))
        if bad:
            p.slo_bad += 1
        while p.slo_results and p.slo_results[0][0] < now - window:
            if p.slo_results.popleft()[1]:
                p.slo_bad -= 1
        total = len(p.slo_results)
        nbad = p.slo_bad
        burn = (nbad / total) / budget if total else 0.0
        p.slo_burn = burn
        p.slo_windows = total
        if p.slo_status == "ok" and burn >= threshold \
                and total >= _SLO_MIN_WINDOWS:
            p.slo_status = "degraded"
            flipped = ("slo_burn", burn, nbad, total)
        elif p.slo_status == "degraded" and burn < threshold:
            p.slo_status = "ok"
            flipped = ("slo_recovered", burn, nbad, total)
    metrics.counter_inc("gs_slo_windows_total")
    if bad:
        metrics.counter_inc("gs_slo_bad_windows_total")
    metrics.gauge_set("gs_slo_burn_rate", round(burn, 4))
    if flipped is not None:
        name, burn, nbad, total = flipped
        # durable: an SLO episode is exactly the post-mortem evidence
        # class the run ledger exists for
        telemetry.event(name, durable=True, burn_rate=round(burn, 4),
                        bad=nbad, windows=total, target_p99_s=target,
                        budget=budget)
        if name == "slo_burn":
            metrics.counter_inc("gs_slo_burn_episodes_total")


# ----------------------------------------------------------------------
# snapshots (/healthz `latency` section)
# ----------------------------------------------------------------------
def health_section(now: Optional[float] = None) -> dict:
    """The `/healthz` `latency` section (registered below with
    metrics.register_health_section): SLO status + burn, the oldest
    unfinalized-edge age, per-lane e2e percentiles and queue age, and
    per-stage percentiles. `{"enabled": False}` disarmed."""
    if not enabled():
        return {"enabled": False}
    p = _plane()
    now = clock() if now is None else now
    target = slo_target_s()
    with p.lock:
        sec = {
            "enabled": True,
            "status": p.slo_status if target > 0 else "ok",
            "oldest_unfinalized_age_s": None,
            "slo": None if target <= 0 else {
                "target_p99_s": target,
                "budget": knobs.get_float("GS_SLO_BUDGET"),
                "window_s": knobs.get_float("GS_SLO_WINDOW_S"),
                "burn_threshold": knobs.get_float("GS_SLO_BURN"),
                "burn_rate": round(p.slo_burn, 4),
                "windows": p.slo_windows,
                "bad": p.slo_bad,
            },
            "tenants": {},
            "stages": {},
        }
        for name, ln in p.lanes.items():
            pct = telemetry.percentiles(ln.e2e)
            row = {
                "windows": ln.windows,
                "unfinalized_edges": ln.fed - ln.done,
                "queue_age_s": _round_opt(
                    _queue_age_locked(ln, now)),
                "e2e_p50_s": round(pct[50], 6),
                "e2e_p95_s": round(pct[95], 6),
                "e2e_p99_s": round(pct[99], 6),
            }
            if ln.wm_armed:
                # an event-time lane: its watermark lag and the depth
                # of its reorder hold beside the ingestion-time age
                row["watermark_lag_s"] = _round_opt(ln.wm_lag)
                row["watermark_held"] = ln.wm_held
            sec["tenants"][name] = row
        for stage_name, samples in p.stage_samples.items():
            pct = telemetry.percentiles(samples)
            sec["stages"][stage_name] = {
                "p50_s": round(pct[50], 6),
                "p99_s": round(pct[99], 6),
            }
    age = oldest_age(now)
    sec["oldest_unfinalized_age_s"] = _round_opt(age)
    return sec


def _round_opt(v, nd: int = 6):
    return None if v is None else round(v, nd)


def percentile_fields(prefix: str = "e2e") -> dict:
    """The pooled end-to-end percentiles of every lane as flat
    `<prefix>_p{50,95,99}_s` fields (the shape of a bench row); empty
    when nothing was recorded."""
    p = _plane()
    with p.lock:
        pool: List[float] = []
        for ln in p.lanes.values():
            pool.extend(ln.e2e)
    if not pool:
        return {}
    pct = telemetry.percentiles(pool)
    return {"%s_p%d_s" % (prefix, q): round(pct[q], 6)
            for q in (50, 95, 99)}


def recent() -> List[dict]:
    """Snapshot of the emitted-record ring."""
    p = _plane()
    with p.lock:
        return [dict(r, stages=dict(r["stages"])) for r in p.recent]


# conservation contract: |sum(stages) − e2e| must stay within
# `tolerance` of the end-to-end, with an absolute floor for µs-scale
# windows (the JAX package's constants).
RECONCILE_TOLERANCE = 0.05
RECONCILE_FLOOR_S = 50e-6


def reconcile(rec: dict, tolerance: float = RECONCILE_TOLERANCE):
    """(ok, gap_seconds) of one window record against the
    conservation contract."""
    e2e = float(rec["e2e_s"])
    gap = abs(sum(float(v) for v in rec["stages"].values()) - e2e)
    return gap <= max(tolerance * e2e, RECONCILE_FLOOR_S), gap


# the /healthz `latency` section rides the provider hook, registered at
# import
metrics.register_health_section("latency", health_section)
