"""Streaming metrics registry: counters, gauges and bounded histograms,
the live half of the observability plane (utils/telemetry.py is the
post-mortem half).

Port of the JAX package's `utils/metrics.py`, with the same metric
names, labels and values on equal input. A process-global, thread-safe
registry keyed by label sets (engine, tier, stage, tenant), fed two
ways:

- by a sink on the telemetry hooks (`telemetry.register_sink`), so the
  spans and events the layers already emit (the ingress stages, stage
  retries and errors, injected faults, checkpoints, resumes, the tuner
  rounds) land here with no call site of their own, even with
  `GS_TELEMETRY=0`;
- by explicit marks: `mark_window()` at every window-finalize owner
  (SummaryEngineBase's finalize, count_stream's entry; never the chunk
  loops underneath) drives window and edge throughput and the staleness
  clock `/healthz` reads; `on_stream_start()` at an engine's entry; the
  ingress pipeline and the resident ring set the in-flight gauges.

Plus the shape watch: `wrap_dispatch(name, fn)` (the JAX `wrap_jit`)
wraps an engine's dispatch and counts each new abstract shape signature
of its arguments (a new shape sizes new scratch or captures new CUDA
graphs in the port) against the envelope `GS_METRICS_COMPILE_BASE +
log2(max/min observed size) + 1`; past it a durable `recompile_storm`
event fires.

And the memory watch: `sample_memory()` returns the live tensor bytes the
caching allocator holds on each card (`torch.cuda.memory_stats`:
allocations and bytes in use, and the card's total as its limit), and
sets their gauges when armed; on a host with no card it reports no
device rows and no live counts (the allocator tracks only the card's).

`attribute_dispatch` splits one dispatch's seconds (and, with the cost
observatory armed, its modeled bytes) across rows by valid edges; the
last nonzero row takes the residue of the left-to-right running sum, so
that sum, taken left to right, reconciles to the total exactly.

With `GS_METRICS=0` (the default) every entry point is a guarded no-op
and the sink reports inactive.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import costmodel
from . import knobs
from . import telemetry

clock = time.monotonic  # health/staleness clock (injectable per call)

_HIST_CAP = 512  # per-series duration reservoir (percentile source)

# telemetry stage spans → the per-stage latency histogram's label
_STAGE_SPANS = {
    "ingress.prep": "prep",
    "ingress.h2d": "h2d",
    "ingress.dispatch": "dispatch",
    "ingress.finalize": "finalize",
}

# durable/notable telemetry events → counters (the bounded event
# vocabulary of the instrumented layers; anything else lands in the
# generic gs_events_total{event=...} under the series bound)
_EVENT_COUNTERS = {
    "stage_retry": "gs_stage_retries_total",
    "stage_timeout": "gs_stage_errors_total",
    "stage_failed": "gs_stage_errors_total",
    "tier_demotion": "gs_tier_demotions_total",
    "fault_injected": "gs_faults_injected_total",
    "checkpoint_saved": "gs_checkpoints_total",
    "resume": "gs_resumes_total",
    "fatal": "gs_fatal_events_total",
}


def enabled() -> bool:
    """GS_METRICS arms the registry; off (the default) every entry
    point — including the telemetry sink — is a guarded no-op."""
    return knobs.get_bool("GS_METRICS")


def max_series() -> int:
    return knobs.get_int("GS_METRICS_SERIES")


def stale_after_s() -> float:
    return knobs.get_float("GS_HEALTH_STALE_S")


# ----------------------------------------------------------------------
# the process-global registry
# ----------------------------------------------------------------------
_OVERFLOW_KEY = (("overflow", "true"),)


class _Registry:
    """All mutable state behind one lock. One instance per process
    (rebuilt by reset())."""

    def __init__(self):
        self.lock = threading.RLock()
        self.counters: Dict[Tuple[str, tuple], float] = {}
        self.gauges: Dict[Tuple[str, tuple], float] = {}
        self.hists: Dict[Tuple[str, tuple], dict] = {}
        self.series: Dict[str, set] = {}   # name → label keys seen
        self.dropped_seen: set = set()     # (name, labels) collapsed
        self.dropped_series = 0
        # compile watch: fn name → {count, sizes, allowed, storm}
        self.compiles: Dict[str, dict] = {}
        # health state (the staleness watchdog's substrate)
        self.health = "ok"
        self.last_finalize: Optional[float] = None
        # (status, t, age_s) — bounded: an episodic stream flips
        # twice per idle gap forever, and only the tail is served
        self.transitions = deque(maxlen=64)
        self.windows_total = 0
        self.edges_total = 0
        self.edges_per_s_ema: Optional[float] = None
        self.engines: Dict[str, dict] = {}   # engine → tier/mesh info
        # per-tenant window/edge counters + staleness clocks (the
        # /healthz `tenants` section), bounded exactly like label
        # sets: past the cardinality bound new tenants collapse into
        # one `overflow` row (tenant_key below)
        self.tenants: Dict[str, dict] = {}

    def series_key(self, name: str, labels: tuple) -> tuple:
        """Admit `labels` under the per-metric cardinality bound;
        past the bound, new label sets collapse into one `overflow`
        series so a tenant-shaped label can never grow the registry
        without bound. `dropped_series` counts DISTINCT collapsed
        label sets (first rejection only — a recurring over-bound
        series marked every window must not inflate it), remembered
        in a set itself bounded at 4x the series bound: past that the
        counter saturates (undercounts) rather than grow memory."""
        seen = self.series.setdefault(name, set())
        if labels in seen:
            return labels
        if len(seen) >= max_series():
            dropped = (name, labels)
            if dropped not in self.dropped_seen \
                    and len(self.dropped_seen) < 4 * max_series():
                self.dropped_seen.add(dropped)
                self.dropped_series += 1
            seen.add(_OVERFLOW_KEY)
            return _OVERFLOW_KEY
        seen.add(labels)
        return labels

    def tenant_key(self, tenant: str) -> str:
        """Admit one tenant id into the bounded per-tenant table —
        the same collapse-don't-grow policy as series_key: past the
        GS_METRICS_SERIES bound, new tenants share one `overflow` row
        (each DISTINCT collapsed tenant counts once in
        `dropped_series`, remembered in the same bounded set)."""
        tenant = str(tenant)
        if tenant in self.tenants:
            return tenant
        if len(self.tenants) >= max_series():
            dropped = ("__tenants__", tenant)
            if dropped not in self.dropped_seen \
                    and len(self.dropped_seen) < 4 * max_series():
                self.dropped_seen.add(dropped)
                self.dropped_series += 1
            return "overflow"
        return tenant


_REG: Optional[_Registry] = None
_REG_LOCK = threading.Lock()

# extra /healthz sections from providers (utils/latency registers
# "latency"): name -> zero-arg callable returning a JSON-able dict,
# merged into health_snapshot() under the name. Mutated only under
# _REG_LOCK.
_HEALTH_SECTIONS: Dict[str, object] = {}


def register_health_section(name: str, provider) -> None:
    """Attach a named section to the `/healthz` body: `provider()` is
    called per snapshot (its failure is reported in-place, never
    raised into the probe). Idempotent per name — the latest provider
    wins, so a restarted server re-registers cleanly."""
    with _REG_LOCK:
        _HEALTH_SECTIONS[name] = provider


def unregister_health_section(name: str) -> None:
    """Drop the named `/healthz` section (a closed server's)."""
    with _REG_LOCK:
        _HEALTH_SECTIONS.pop(name, None)


def _reg() -> _Registry:
    global _REG
    if _REG is None:
        with _REG_LOCK:
            if _REG is None:
                _REG = _Registry()
    return _REG


def reset() -> None:
    """Test/tool hook: drop all recorded series and health state."""
    global _REG
    with _REG_LOCK:
        _REG = None


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# ----------------------------------------------------------------------
# recording API
# ----------------------------------------------------------------------
def counter_inc(name: str, value: float = 1, **labels) -> None:
    if not enabled():
        return
    reg = _reg()
    with reg.lock:
        key = (name, reg.series_key(name, _labelkey(labels)))
        reg.counters[key] = reg.counters.get(key, 0.0) + value


def gauge_set(name: str, value: float, **labels) -> None:
    if not enabled():
        return
    reg = _reg()
    with reg.lock:
        key = (name, reg.series_key(name, _labelkey(labels)))
        reg.gauges[key] = float(value)


def observe(name: str, value: float, **labels) -> None:
    """One histogram observation (bounded reservoir + count/sum)."""
    if not enabled():
        return
    reg = _reg()
    with reg.lock:
        key = (name, reg.series_key(name, _labelkey(labels)))
        h = reg.hists.get(key)
        if h is None:
            h = reg.hists[key] = {
                "count": 0, "sum": 0.0,
                "samples": deque(maxlen=_HIST_CAP)}
        h["count"] += 1
        h["sum"] += value
        h["samples"].append(value)


# ----------------------------------------------------------------------
# snapshots (tests, /healthz, /metrics)
# ----------------------------------------------------------------------
def counters() -> Dict[Tuple[str, tuple], float]:
    reg = _reg()
    with reg.lock:
        return dict(reg.counters)


def gauges() -> Dict[Tuple[str, tuple], float]:
    reg = _reg()
    with reg.lock:
        return dict(reg.gauges)


def histogram(name: str, **labels) -> Optional[dict]:
    """(count, sum, p50/p95/p99) of one histogram series, or None."""
    reg = _reg()
    with reg.lock:
        h = reg.hists.get((name, _labelkey(labels)))
        if h is None:
            return None
        pct = telemetry.percentiles(h["samples"])
        return {"count": h["count"], "sum": h["sum"],
                "p50": pct[50], "p95": pct[95], "p99": pct[99]}


def _fmt(v: float) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return "%.9g" % v


def _series(name: str, labels: tuple, extra: tuple = ()) -> str:
    pairs = labels + extra
    if not pairs:
        return name
    return "%s{%s}" % (name, ",".join(
        '%s="%s"' % (k, v) for k, v in pairs))


def render_prometheus() -> str:
    """The registry in Prometheus text exposition format (counters,
    gauges, histograms as summaries with nearest-rank quantiles),
    deterministically ordered — the `/metrics` endpoint body and the
    golden-file surface tests/test_metrics.py pins."""
    reg = _reg()
    lines: List[str] = []
    with reg.lock:
        for kind, table in (("counter", reg.counters),
                            ("gauge", reg.gauges)):
            by_name: Dict[str, list] = {}
            for (name, labels), val in table.items():
                by_name.setdefault(name, []).append((labels, val))
            for name in sorted(by_name):
                lines.append("# TYPE %s %s" % (name, kind))
                for labels, val in sorted(by_name[name]):
                    lines.append("%s %s"
                                 % (_series(name, labels), _fmt(val)))
        by_name = {}
        for (name, labels), h in reg.hists.items():
            by_name.setdefault(name, []).append((labels, h))
        for name in sorted(by_name):
            lines.append("# TYPE %s summary" % name)
            for labels, h in sorted(by_name[name],
                                    key=lambda x: x[0]):
                pct = telemetry.percentiles(h["samples"])
                for q, p in (("0.5", 50), ("0.95", 95), ("0.99", 99)):
                    lines.append("%s %s" % (
                        _series(name, labels, (("quantile", q),)),
                        _fmt(pct[p])))
                lines.append("%s %s" % (_series(name + "_sum", labels),
                                        _fmt(h["sum"])))
                lines.append("%s %d" % (
                    _series(name + "_count", labels), h["count"]))
        lines.append("# TYPE gs_metrics_dropped_series_total counter")
        lines.append("gs_metrics_dropped_series_total %d"
                     % reg.dropped_series)
        lines.append("# TYPE gs_health_degraded gauge")
        lines.append("gs_health_degraded %d"
                     % (1 if reg.health == "degraded" else 0))
    return "\n".join(lines) + "\n"


# ----------------------------------------------------------------------
# the telemetry sink: the existing span/counter/event hooks feed the
# registry (registered at import time; self-gated on GS_METRICS)
# ----------------------------------------------------------------------
def _sink(rec: dict) -> None:
    kind = rec.get("t")
    name = rec.get("name", "")
    if kind == "span":
        dur = rec.get("dur")
        if dur is None:
            return
        stage = _STAGE_SPANS.get(name)
        if stage is not None:
            observe("gs_stage_seconds", dur, stage=stage)
            return
        attrs = rec.get("a") or {}
        edges = attrs.get("edges")
        if edges:
            observe("gs_round_seconds", dur, span=name)
            counter_inc("gs_round_edges_total", edges, span=name)
    elif kind == "event":
        cname = _EVENT_COUNTERS.get(name)
        attrs = rec.get("a") or {}
        if cname is not None:
            labels = {}
            if cname == "gs_stage_errors_total":
                labels["kind"] = name
            if "stage" in attrs:
                labels["stage"] = attrs["stage"]
            counter_inc(cname, 1, **labels)
        else:
            counter_inc("gs_events_total", 1, event=name)
    elif kind == "counter":
        counter_inc("gs_" + name.replace(".", "_"),
                    rec.get("value", 1))
    elif kind == "gauge":
        gauge_set("gs_" + name.replace(".", "_"),
                  rec.get("value", 0))


telemetry.register_sink(_sink, enabled)


# ----------------------------------------------------------------------
# window-finalize marks + health state (the staleness detector)
# ----------------------------------------------------------------------
def on_stream_start(engine: str = "driver",
                    tenant: Optional[str] = None) -> None:
    """Stream entry mark: re-anchors the staleness clock (a stream
    that never finalizes its FIRST window is just as wedged as one
    that stops mid-way — and a stream starting long after the
    previous one finalized must not inherit that stale clock and get
    flagged before its first window is even due), registers `engine`
    on /healthz before its first finalize, and brings up the endpoint
    when GS_METRICS_PORT asks for one."""
    if not enabled():
        return
    reg = _reg()
    now = clock()
    with reg.lock:
        reg.engines.setdefault(engine, {})
        reg.last_finalize = now
        if tenant is not None:
            # anchor the tenant's own staleness clock at admission so
            # a stream admitted long after the cohort's last finalize
            # is not flagged stale before its first window is due
            info = reg.tenants.setdefault(reg.tenant_key(tenant), {})
            info.setdefault("windows", 0)
            info.setdefault("edges", 0)
            info["last_finalize"] = now
    _maybe_serve()


def mark_tenant(tenant: str, windows: int, edges: int,
                tier: Optional[str] = None,
                now: Optional[float] = None) -> None:
    """Per-tenant finalize mark ONLY (the bounded tenants table +
    tenant-labeled counters) — for window-finalize owners that already
    fired the global mark_window themselves (a demoted tenant's
    single-tenant engine marks globally inside process()); the cohort
    dispatch path uses mark_window(tenant=...) which does both."""
    if not enabled() or tenant is None:
        return
    reg = _reg()
    now = clock() if now is None else now
    with reg.lock:
        key = reg.tenant_key(tenant)
        info = reg.tenants.setdefault(key, {})
        info["windows"] = info.get("windows", 0) + windows
        info["edges"] = info.get("edges", 0) + edges
        info["last_finalize"] = now
        if tier is not None:
            info["tier"] = tier
    labels = {"tenant": key}
    if tier is not None:
        labels["tier"] = tier
    counter_inc("gs_tenant_windows_total", windows, **labels)
    counter_inc("gs_tenant_edges_total", edges, **labels)


def mark_window(windows: int, edges: int, engine: str = "driver",
                tier: Optional[str] = None,
                mesh_shape: Optional[list] = None,
                tenant: Optional[str] = None,
                now: Optional[float] = None) -> None:
    """One window-finalize boundary: `windows` windows covering
    `edges` edges were finalized by `engine` on `tier` (for `tenant`
    when the finalize owner serves one — the multi-tenant cohort marks
    once per tenant whose windows the dispatch covered). Drives the
    throughput counters/gauges AND resets the staleness clock; a
    finalize arriving while health is `degraded` is the recovery
    signal (durable `health_recovered` event)."""
    if not enabled():
        return
    reg = _reg()
    now = clock() if now is None else now
    recovered_age = None
    with reg.lock:
        prev = reg.last_finalize
        reg.last_finalize = now
        reg.windows_total += windows
        reg.edges_total += edges
        if prev is not None and now > prev:
            rate = edges / (now - prev)
            ema = reg.edges_per_s_ema
            reg.edges_per_s_ema = (rate if ema is None
                                   else 0.7 * ema + 0.3 * rate)
        info = reg.engines.setdefault(engine, {})
        if tier is not None:
            info["tier"] = tier
        if mesh_shape is not None:
            info["mesh_shape"] = list(mesh_shape)
        info["windows"] = info.get("windows", 0) + windows
        if reg.health == "degraded":
            reg.health = "ok"
            recovered_age = (now - prev) if prev is not None else 0.0
            reg.transitions.append(("ok", now, round(recovered_age, 3)))
    labels = {"engine": engine}
    if tier is not None:
        labels["tier"] = tier
    if tenant is not None:
        mark_tenant(tenant, windows, edges, tier=tier, now=now)
        labels["tenant"] = str(tenant)
    counter_inc("gs_windows_finalized_total", windows, **labels)
    counter_inc("gs_edges_total", edges, **labels)
    if recovered_age is not None:
        telemetry.event("health_recovered", durable=True,
                        engine=engine, gap_s=round(recovered_age, 3))
    _maybe_serve()


def attribute_dispatch(seconds: float, rows,
                       program: Optional[str] = None,
                       sig: Optional[str] = None):
    """Per-tenant cost attribution of ONE cohort dispatch: split the
    span's measured wall `seconds` (and, when the cost observatory is
    armed, the dispatched program's modeled bytes) across `rows` —
    `[(tenant, valid_edges), ...]`, one row per tenant the vmapped
    dispatch carried — proportionally by per-row valid-edge counts.

    The split reconciles exactly under its own summation: pad/invalid
    rows (edges == 0) attribute zero, and the last nonzero row absorbs
    the residue of the LEFT-TO-RIGHT running sum of the rows before it,
    so adding the shares left to right (`functools.reduce` over `+`, not
    a compensated sum such as Python 3.12's builtin `sum()`) gives
    `seconds` bit for bit.

    Feeds `gs_tenant_device_seconds` / `gs_tenant_attributed_bytes`
    counters and the bounded per-tenant table the /healthz hot-tenant
    scoring reads, all under the existing tenant cardinality collapse.
    Returns `[(tenant, seconds_share, bytes_share), ...]` (the armed
    introspection surface; None disarmed)."""
    if not enabled():
        return None
    rows = [(str(t), int(n)) for t, n in rows]
    total = sum(n for _t, n in rows)
    seconds = float(seconds)
    if total <= 0 or seconds < 0:
        return None
    bytes_total = None
    if program is not None and costmodel.enabled():
        progs = costmodel.programs()
        entry = progs.get((program, sig)) if sig is not None else None
        if entry is None:
            # the dispatch tags may be unavailable at this boundary
            # (popped by an inner pipeline) — any captured signature
            # of the same program models the same per-call traffic
            # shape at this cohort's fixed padding
            for (p, _s), e in sorted(progs.items()):
                if p == program:
                    entry = e
                    break
        if entry is not None and entry.get("bytes_accessed"):
            bytes_total = float(entry["bytes_accessed"])
    nz = [i for i, (_t, n) in enumerate(rows) if n > 0]
    last = nz[-1]
    out = []
    acc_s = 0.0
    acc_b = 0.0
    for i, (t, n) in enumerate(rows):
        if n == 0:
            out.append((t, 0.0, 0.0))
            continue
        if i == last:
            s = seconds - acc_s
            b = (bytes_total - acc_b) if bytes_total else 0.0
        else:
            s = seconds * (n / total)
            acc_s += s
            b = bytes_total * (n / total) if bytes_total else 0.0
            acc_b += b
        out.append((t, s, b))
    reg = _reg()
    with reg.lock:
        for t, s, b in out:
            if s == 0.0 and b == 0.0:
                continue
            key = reg.tenant_key(t)
            info = reg.tenants.setdefault(key, {})
            info["device_s"] = info.get("device_s", 0.0) + s
            if b:
                info["attr_bytes"] = info.get("attr_bytes", 0.0) + b
            counter_inc("gs_tenant_device_seconds", s, tenant=key)
            if b:
                counter_inc("gs_tenant_attributed_bytes", b,
                            tenant=key)
    return out


def check_staleness(now: Optional[float] = None) -> str:
    """The staleness watchdog body (called by the utils/healthz
    watchdog thread; `now` injectable for tests): no finalize within
    GS_HEALTH_STALE_S of the last one flips health to `degraded` and
    stamps a durable `health_degraded` event — once per episode."""
    if not enabled():
        return "ok"
    stale = stale_after_s()
    reg = _reg()
    flipped_age = None
    with reg.lock:
        if stale > 0 and reg.last_finalize is not None \
                and reg.health == "ok":
            now = clock() if now is None else now
            age = now - reg.last_finalize
            if age > stale:
                reg.health = "degraded"
                flipped_age = age
                reg.transitions.append(
                    ("degraded", now, round(age, 3)))
        status = reg.health
    if flipped_age is not None:
        telemetry.event("health_degraded", durable=True,
                        age_s=round(flipped_age, 3), stale_s=stale)
    return status


def health_snapshot(now: Optional[float] = None) -> dict:
    """The `/healthz` JSON body: current status, per-engine tier and
    mesh shape, last-finalized-window age, backlog, throughput, the
    demotion log tail, and the run-ledger status."""
    from . import resilience

    reg = _reg()
    now = clock() if now is None else now
    with reg.lock:
        age = (None if reg.last_finalize is None
               else round(now - reg.last_finalize, 3))
        backlog = reg.gauges.get(("gs_inflight_chunks", ()), 0.0)
        snap = {
            "status": reg.health,
            "last_finalize_age_s": age,
            "stale_after_s": stale_after_s(),
            "windows_finalized": reg.windows_total,
            "edges_total": reg.edges_total,
            "edges_per_s_ema": (None if reg.edges_per_s_ema is None
                                else round(reg.edges_per_s_ema)),
            "backlog_chunks": backlog,
            "engines": {k: dict(v) for k, v in reg.engines.items()},
            "transitions": [list(t)
                            for t in list(reg.transitions)[-8:]],
            "compiles": {
                name: {"count": c["count"],
                       "allowed": c.get("allowed"),
                       "storm": c["storm"]}
                for name, c in reg.compiles.items()},
            # per-tenant liveness: window/edge counters + the age of
            # each tenant's OWN last finalize (bounded table — see
            # tenant_key; a stale tenant is flagged per-row so one
            # wedged stream is visible while the cohort stays ok)
            "tenants": {
                tid: {
                    "windows": info.get("windows", 0),
                    "edges": info.get("edges", 0),
                    "tier": info.get("tier"),
                    # per-tenant cost attribution (attribute_dispatch)
                    "device_s": round(info.get("device_s", 0.0), 6),
                    "attr_bytes": round(info.get("attr_bytes", 0.0)),
                    "last_finalize_age_s": (
                        None if info.get("last_finalize") is None
                        else round(now - info["last_finalize"], 3)),
                    "stale": bool(
                        stale_after_s() > 0
                        and info.get("last_finalize") is not None
                        and now - info["last_finalize"]
                        > stale_after_s()),
                }
                for tid, info in reg.tenants.items()},
        }
    snap["demotions"] = resilience.demotion_events()[-5:]
    snap["trace"] = telemetry.trace_id()
    snap["ledger"] = telemetry.ledger_path()
    with _REG_LOCK:
        sections = dict(_HEALTH_SECTIONS)
    for name, provider in sections.items():
        try:
            snap[name] = provider()
        except Exception as e:
            snap[name] = {"error": "%s: %s" % (type(e).__name__, e)}
    snap["hot_tenants"] = hot_tenants(snap)
    return snap


def hot_tenants(snap: dict, k: int = 8) -> list:
    """Ranked top-K hot-tenant rows off one health snapshot: each
    tenant's device-seconds SHARE (attribute_dispatch's table) joined
    with the latency plane's per-tenant p99 against the SLO target —
    `score = device_share + min(p99 / target, 1)` (the SLO term is 0
    when the plane or the target is disarmed), so a tenant burning
    the device OR burning the error budget surfaces first. This is
    the placement-advisor signal the fleet router consumes
    (served in the `/healthz` body)."""
    tens = snap.get("tenants") or {}
    lat = snap.get("latency")
    lanes = (lat.get("tenants") or {}) if isinstance(lat, dict) else {}
    slo = lat.get("slo") if isinstance(lat, dict) else None
    target = (slo or {}).get("target_p99_s") or 0.0
    total_s = sum(row.get("device_s") or 0.0 for row in tens.values())
    rows = []
    for tid, row in tens.items():
        share = ((row.get("device_s") or 0.0) / total_s
                 if total_s > 0 else 0.0)
        lane = lanes.get(tid) or {}
        p99 = lane.get("e2e_p99_s")
        score = share
        if target > 0 and p99:
            score += min(p99 / target, 1.0)
        rows.append({
            "tenant": tid,
            "score": round(score, 6),
            "device_share": round(share, 6),
            "device_s": row.get("device_s", 0.0),
            "attr_bytes": row.get("attr_bytes", 0),
            "tier": row.get("tier"),
            "e2e_p99_s": p99,
            "queue_age_s": lane.get("queue_age_s"),
            "burn_rate": (slo or {}).get("burn_rate"),
            "stale": row.get("stale"),
        })
    rows.sort(key=lambda r: (-r["score"], r["tenant"]))
    return rows[:k]


def _maybe_serve() -> None:
    """Bring up the health endpoint once GS_METRICS_PORT asks for one
    (lazy import: healthz imports this module)."""
    if knobs.get_int("GS_METRICS_PORT") > 0:
        from . import healthz

        healthz.maybe_start()


# ----------------------------------------------------------------------
# compile watch
# ----------------------------------------------------------------------
def _leaf_sig(x):
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(int(s) for s in shape), str(dtype))
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(_leaf_sig(e) for e in x)
    if isinstance(x, dict):
        return ("map",) + tuple((k, _leaf_sig(v))
                                for k, v in sorted(x.items()))
    return ("py", type(x).__name__)


def _sig_size(sig) -> int:
    """Total array elements under one signature — the 'V' of the
    O(log V) envelope."""
    if not isinstance(sig, tuple):
        return 0
    if sig and sig[0] == "arr":
        n = 1
        for d in sig[1]:
            n *= max(d, 1)
        return n
    return sum(_sig_size(s) for s in sig)


def abstract_sig(args, kwargs=None) -> tuple:
    """Abstract shape signature of one call: array leaves reduce to
    (shape, dtype) — the identity the shape watch counts."""
    sig = tuple(_leaf_sig(a) for a in args)
    if kwargs:
        sig += tuple((k, _leaf_sig(v))
                     for k, v in sorted(kwargs.items()))
    return sig


def note_compile(name: str, sig: tuple) -> None:
    """Count one (re)compile of `name` at `sig` and enforce the
    O(log V) bucket-growth envelope; the first compile past it stamps
    a durable `recompile_storm` event (sticky per function)."""
    if not enabled():
        return
    reg = _reg()
    base = knobs.get_int("GS_METRICS_COMPILE_BASE")
    size = max(1, _sig_size(sig))
    storm = None
    with reg.lock:
        c = reg.compiles.setdefault(
            name, {"count": 0, "lo": size, "hi": size, "storm": False})
        c["count"] += 1
        c["lo"] = min(c["lo"], size)
        c["hi"] = max(c["hi"], size)
        growth = math.log2(c["hi"] / c["lo"])
        c["allowed"] = base + int(growth) + 1
        if c["count"] > c["allowed"] and not c["storm"]:
            c["storm"] = True
            storm = (c["count"], c["allowed"])
    counter_inc("gs_compiles_total", 1, fn=name)
    if storm is not None:
        counter_inc("gs_recompile_storms_total", 1, fn=name)
        telemetry.event("recompile_storm", durable=True, fn=name,
                        compiles=storm[0], allowed=storm[1])


_SIG_CAP = 4096  # per-wrapper distinct-signature memory bound


def wrap_dispatch(name: str, fn):
    """Wrap an engine's dispatch: each call whose abstract shape
    signature was not seen before counts as one new shape of `name`
    (the JAX `wrap_jit`'s compile count); armed, the cost observatory
    tags the dispatch span with (name, signature). Disarmed, two knob
    reads and a passthrough; results are identical either way. The
    signature set is bounded at _SIG_CAP: past it a churner keeps
    counting but stops being remembered."""
    seen = set()

    def wrapped(*args, **kwargs):
        cm = costmodel.enabled()
        if enabled() or cm:
            sig = abstract_sig(args, kwargs)
            if enabled() and sig not in seen:
                if len(seen) < _SIG_CAP:
                    seen.add(sig)
                note_compile(name, sig)
            if cm:
                telemetry.tag_dispatch(program=name,
                                       sig=costmodel.sig_key(sig))
        return fn(*args, **kwargs)

    wrapped.__name__ = getattr(fn, "__name__", name)
    wrapped.__wrapped__ = fn
    return wrapped


def compile_report() -> Dict[str, dict]:
    reg = _reg()
    with reg.lock:
        return {name: dict(c) for name, c in reg.compiles.items()}


# ----------------------------------------------------------------------
# memory watch
# ----------------------------------------------------------------------
def sample_memory() -> dict:
    """A snapshot of the live tensors on the cards: {"live_buffers":
    allocations in use, "live_buffer_bytes": their bytes, both summed
    over the cards (None with no card), "devices": one row a card
    {"device", "bytes_in_use", "bytes_limit"}}. Always returned; the
    gauges are set only when armed."""
    out = {"live_buffers": None, "live_buffer_bytes": None,
           "devices": []}
    try:
        import torch

        if torch.cuda.is_available():
            count = total = 0
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                in_use = int(stats.get("allocated_bytes.all.current",
                                       torch.cuda.memory_allocated(i)))
                count += int(stats.get("allocation.all.current", 0))
                total += in_use
                out["devices"].append({
                    "device": "cuda:%d" % i, "bytes_in_use": in_use,
                    "bytes_limit": int(torch.cuda.get_device_properties(
                        i).total_memory)})
            out["live_buffers"] = count
            out["live_buffer_bytes"] = total
    except Exception as e:
        telemetry.event("memory_sample_failed",
                        error="%s: %s" % (type(e).__name__, e))
        return out
    if enabled():
        if out["live_buffers"] is not None:
            gauge_set("gs_live_buffers", out["live_buffers"])
            gauge_set("gs_live_buffer_bytes", out["live_buffer_bytes"])
        for row in out["devices"]:
            gauge_set("gs_device_bytes_in_use", row["bytes_in_use"],
                      device=row["device"])
    return out
