"""Flight recorder: spans, events, counters and gauges with a crash-safe
run ledger.

Port of the JAX package's `utils/telemetry.py`, record for record: the
same record kinds and fields, the same span and event names (the
ingress pipeline's `ingress.chunk`, `ingress.prep`, `ingress.h2d`,
`ingress.dispatch`, `ingress.finalize`; the engines' `fused_scan.round`,
`triangles.round`, `sliding.emit`; the events of `utils/faults.py`,
`resilience.py`, `wal.py`, `sanitize.py` and the engines), the same
ledger format and `chunk_key`. The port adds four spans of its own,
all on the dispatching thread: `engine.call` (a summary engine's whole
`process()`), `engine.admit` (its admission, up to the chunk loop),
`engine.chunks` (the chunk loop: the round plan, the pipeline and its
unwinding) and `ingress.wait` (the pipeline's wait for a chunk's staged
payload: the pool's future, or the inline prep and h2d of the
synchronous form).

- Spans (named timed intervals with attributes), events, counters and
  gauges carry the process's run trace id and the correlation attributes
  the caller binds (`context`). Nesting is tracked per thread; the
  ingress pool's stages attach to their chunk's span through an explicit
  handle (`chunk_ctx`/`close_chunk`).
- A bounded ring buffer (`GS_TRACE_RING` records) keeps the recent
  history.
- A crash-safe JSONL ledger (`GS_TRACE_DIR`, `trace_<id>.jsonl`):
  durable events are appended and fsync'd as they happen
  (`GS_TRACE_DURABLE=0` drops the fsync); spans ride the ring and are
  flushed by `flush()`, at exit, by SIGTERM or by a fatal injected fault.
  Readers skip a torn last line.
- Sinks (`register_sink`): the metrics registry and the cost observatory
  see every record while they are armed, even with the recorder off.
- Per span name, the recorder keeps a count, a total and a bounded
  reservoir of the last `_SAMPLE_CAP` durations; `summary(top)` renders
  them as rows (count, total, p50/p95/p99 in ms), the most time first.
- `stopwatch(name)` is a span whose interval crosses scopes: started
  when made, recorded once by its first `stop()`, never when unstopped.

With `GS_TELEMETRY=0` (the default) and no armed sink every call is a
guarded no-op and `span()` is a bare perf_counter stopwatch. Every time
here is the host's `time.perf_counter`: the recorder reads no device
clock and waits for no device work.

The device trace: a span made with `profile=True` also enters a
`torch.profiler.record_function` of its name for its interval, so that
a running `torch.profiler` capture shows it as a `user_annotation` on
the card's timeline, whether or not the recorder or a sink is armed.
`profiling()` says whether a capture is recording (one flag read); the
hot paths read it once a call and make no such span while it is off.
The profiler keeps annotations of the thread that runs the capture
only, so the spans made so are the dispatching thread's; the pool's
stages reach the timeline through that thread's `ingress.wait`, and
through the clock anchor that utils/tracing.py `device_trace` stamps.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from . import knobs

_SAMPLE_CAP = 2048  # per-span-name duration reservoir for summary()

clock = time.perf_counter  # the one monotonic clock every record uses


# ----------------------------------------------------------------------
# env knobs (read per call through the utils/knobs registry: tests and
# tools flip them mid-process)
# ----------------------------------------------------------------------
def enabled() -> bool:
    """GS_TELEMETRY arms the recorder; off (the default) every hook is
    a guarded no-op and span() is a bare stopwatch."""
    return knobs.get_bool("GS_TELEMETRY")


def trace_dir() -> Optional[str]:
    """Ledger directory (GS_TRACE_DIR); None = ring only."""
    return knobs.get_path("GS_TRACE_DIR")


def ring_size() -> int:
    return knobs.get_int("GS_TRACE_RING")


def durable_sync() -> bool:
    """GS_TRACE_DURABLE=0 drops the per-durable-event fsync (append
    still happens; only the power-loss window widens)."""
    return knobs.get_bool("GS_TRACE_DURABLE")


# ----------------------------------------------------------------------
# the process-global recorder
# ----------------------------------------------------------------------
class _Recorder:
    """All mutable state behind one lock: the ring, the per-name span
    aggregates summary() renders, the ledger file and the span-id
    counter. One instance per process (rebuilt by reset())."""

    def __init__(self):
        self.lock = threading.RLock()
        self.trace = "%x-%x" % (os.getpid(),
                                int(time.time() * 1e3) & 0xFFFFFFFF)
        self.epoch = time.time()
        self.mono = clock()
        self.ring = collections.deque(maxlen=ring_size())
        self.next_sid = 1
        self.agg: Dict[str, dict] = {}
        self.ledger = None        # open file object, lazily created
        self.ledger_path = None
        self.ledger_failed = False  # sticky: disk broke, stop trying

    # -- ledger --------------------------------------------------------
    def _ensure_ledger(self):
        """Open (once) the append-only JSONL ledger under
        GS_TRACE_DIR, writing the meta anchor line readers use to map
        monotonic span timestamps back to wall time."""
        if self.ledger is not None:
            return self.ledger
        if self.ledger_failed:
            return None
        d = trace_dir()
        if d is None:
            return None
        # an unwritable/full trace dir degrades to ring-only recording:
        # the flight recorder must never take down the stream it traces
        try:
            os.makedirs(d, exist_ok=True)
            self.ledger_path = os.path.join(
                d, "trace_%s.jsonl" % self.trace)
            self.ledger = open(self.ledger_path, "a")
            self.ledger.write(json.dumps({
                "t": "meta", "trace": self.trace, "pid": os.getpid(),
                "epoch": self.epoch, "mono": self.mono,
                "ring": self.ring.maxlen}) + "\n")
            self.ledger.flush()
        except OSError:
            self._ledger_broke()
            return None
        _install_exit_hooks()
        return self.ledger

    def _ledger_broke(self) -> None:
        self.ledger_failed = True
        self.ledger_path = None
        if self.ledger is not None:
            try:
                self.ledger.close()
            except OSError:
                pass
            self.ledger = None

    def _append(self, rec: dict, sync: bool) -> None:
        f = self._ensure_ledger()
        if f is None:
            return
        try:
            f.write(json.dumps(rec, default=str) + "\n")
            rec["_w"] = True  # private written mark, stripped on flush
            if sync:
                f.flush()
                if durable_sync():
                    try:
                        os.fsync(f.fileno())
                    except OSError:
                        pass
        except OSError:
            self._ledger_broke()

    def flush(self) -> None:
        """Drain every not-yet-written ring record to the ledger (the
        atexit / fatal-fault / operator path)."""
        with self.lock:
            f = self._ensure_ledger()
            if f is None:
                return
            try:
                for rec in self.ring:
                    if not rec.get("_w"):
                        f.write(json.dumps(
                            {k: v for k, v in rec.items() if k != "_w"},
                            default=str) + "\n")
                        rec["_w"] = True
                f.flush()
                try:
                    os.fsync(f.fileno())
                except OSError:
                    pass
            except OSError:
                self._ledger_broke()

    # -- recording -----------------------------------------------------
    def add(self, rec: dict, durable: bool = False) -> None:
        with self.lock:
            self.ring.append(rec)
            if rec["t"] == "span":
                a = self.agg.setdefault(rec["name"], {
                    "count": 0, "total": 0.0,
                    "samples": collections.deque(maxlen=_SAMPLE_CAP)})
                a["count"] += 1
                a["total"] += rec["dur"]
                a["samples"].append(rec["dur"])
            if durable:
                self._append(rec, sync=True)

    def sid(self) -> int:
        with self.lock:
            s = self.next_sid
            self.next_sid += 1
            return s


_REC: Optional[_Recorder] = None
_REC_LOCK = threading.Lock()
_TLS = threading.local()
_HOOKS_INSTALLED = False

# Downstream consumers of the record stream (the metrics registry,
# utils/metrics.py): each entry is (sink_fn, active_fn). A sink sees
# every record the hooks produce while ITS active_fn says so, even
# with GS_TELEMETRY=0 — the flight-recorder hooks are the one
# instrumentation surface every layer already feeds, so the metrics
# plane rides them instead of duplicating call sites. With telemetry
# AND every sink disarmed the hooks stay guarded no-ops.
_SINKS: List[tuple] = []


def register_sink(sink, active) -> None:
    """Attach `sink(record_dict)` to the record stream, consulted
    while `active()` is true. Idempotent per (sink, active) pair."""
    with _REC_LOCK:
        if (sink, active) not in _SINKS:
            _SINKS.append((sink, active))


def _sinks_active() -> bool:
    for _fn, active in _SINKS:
        if active():
            return True
    return False


def _active() -> bool:
    """True when anything consumes records: the recorder itself
    (GS_TELEMETRY) or an armed sink (the metrics registry)."""
    return enabled() or _sinks_active()


def active() -> bool:
    """Whether a span or event recorded now is consumed at all: what a
    hot loop reads once a call, to skip its records while nothing
    listens."""
    return _active()


def _rec() -> _Recorder:
    global _REC
    if _REC is None:
        with _REC_LOCK:
            if _REC is None:
                _REC = _Recorder()
    return _REC


def _install_exit_hooks() -> None:
    """atexit + SIGTERM flush, installed once on first ledger open (a
    ring-only recorder has nothing to save). SIGTERM chains any prior
    handler; SIGKILL is of course uncatchable — the durable-class
    immediate appends are what bound that loss to the ring."""
    global _HOOKS_INSTALLED
    if _HOOKS_INSTALLED:
        return
    _HOOKS_INSTALLED = True
    atexit.register(flush)
    try:
        import signal

        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            flush()
            # preserve the prior disposition EXACTLY: chain a callable
            # handler, die the default way for SIG_DFL, and keep the
            # process alive when it deliberately ignored SIGTERM
            # (SIG_IGN / unknown) — the flush must never change
            # whether SIGTERM is survivable
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_DFL:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass  # non-main thread / exotic platform: atexit still covers


def reset() -> None:
    """Test/tool hook: drop all recorded state and start a fresh trace
    (closes the current ledger; a new one opens on the next record)."""
    global _REC
    with _REC_LOCK:
        if _REC is not None and _REC.ledger is not None:
            try:
                _REC.flush()
                _REC.ledger.close()
            except (OSError, ValueError):
                pass
        _REC = None
    _TLS.__dict__.clear()


def trace_id() -> str:
    """The process-wide run trace ID every record carries."""
    return _rec().trace


def ledger_path() -> Optional[str]:
    """Path of this run's ledger file (None when GS_TRACE_DIR is
    unset or nothing has been recorded to disk yet)."""
    r = _rec()
    if r.ledger_path is None and trace_dir() is not None:
        with r.lock:
            r._ensure_ledger()
    return r.ledger_path


def flush() -> None:
    """Drain the ring to the ledger (no-op without GS_TRACE_DIR)."""
    if _REC is not None:
        _REC.flush()


# ----------------------------------------------------------------------
# context / correlation
# ----------------------------------------------------------------------
def _ctx_attrs() -> dict:
    return getattr(_TLS, "ctx", None) or {}


def _parent_sid() -> Optional[int]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def context(**attrs):
    """Bind correlation attributes (chunk=..., window=...) to every
    record made by THIS thread inside the scope; explicit per-record
    attrs win on collision. Thread-local — pool workers need their
    chunk identity passed explicitly (see chunk_ctx)."""
    prev = getattr(_TLS, "ctx", None)
    merged = dict(prev or {})
    merged.update(attrs)
    _TLS.ctx = merged
    try:
        yield
    finally:
        _TLS.ctx = prev


def _record(kind: str, name: str, durable: bool = False,
            **fields) -> Optional[dict]:
    rec = {"t": kind, "name": name, "trace": _rec().trace,
           "tid": threading.get_ident()}
    ctx = _ctx_attrs()
    if ctx:
        a = dict(ctx)
        a.update(fields.pop("a", None) or {})
        fields["a"] = a
    rec.update({k: v for k, v in fields.items() if v is not None})
    if not rec.get("a"):
        rec.pop("a", None)
    if enabled():
        if not _HOOKS_INSTALLED and trace_dir() is not None:
            # a ledger-destined run must flush its ring at exit even if
            # no durable event ever opens the file earlier
            _install_exit_hooks()
        _rec().add(rec, durable=durable)
    dropped = []
    for sink, active in list(_SINKS):
        if active():
            try:
                sink(rec)
            except Exception as exc:
                with _REC_LOCK:
                    if (sink, active) in _SINKS:
                        _SINKS.remove((sink, active))
                        dropped.append(exc)
    for exc in dropped:
        # the armed plane going dark must leave a visible scar, not
        # silently freeze its gauges: stamp a durable event (the
        # failed sink is already removed, so this re-entry terminates)
        # AND a registry counter — with GS_TELEMETRY=0 the event
        # no-ops (no ledger), but /metrics still shows the drop
        event("metrics_sink_dropped", durable=True,
              error=repr(exc)[:200])
        try:
            from . import metrics as _metrics

            _metrics.counter_inc("gs_metrics_sink_dropped_total")
        except Exception:
            pass
    return rec


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------
_PROFILER = None    # torch.autograd.profiler, imported at first use


def profiling() -> bool:
    """Whether a torch.profiler capture is recording now: one read of
    the profiler's own flag, what a hot loop reads once a call to decide
    whether its spans enter the device trace (`span(profile=True)`)."""
    global _PROFILER
    if _PROFILER is None:
        import torch.autograd.profiler as _PROFILER
    return _PROFILER._is_profiler_enabled


class _Span:
    """Context manager AND stopwatch. Always measures (callers like
    the autotune round loops need `.elapsed` whether or not telemetry
    is armed); records only when armed at __exit__ time. Nesting is
    tracked per thread via the span-id stack; an explicit `parent`
    (a chunk's span id, whose stages cross threads) wins over it. With
    `profile`, the interval is also a torch.profiler `record_function`
    of the span's name."""

    __slots__ = ("name", "attrs", "t0", "elapsed", "sid", "parent",
                 "profile", "_pushed", "_rf")

    def __init__(self, name: str, attrs: dict, parent: Optional[int] = None,
                 profile: bool = False):
        self.name = name
        self.attrs = attrs
        self.t0 = clock()
        self.elapsed = 0.0
        self.sid = None
        self.parent = parent
        self.profile = profile
        self._pushed = False
        self._rf = None

    def __enter__(self):
        if self.profile:
            from torch.profiler import record_function

            self._rf = record_function(self.name)
            self._rf.__enter__()
        self.t0 = clock()
        if enabled():
            self.sid = _rec().sid()
            stack = getattr(_TLS, "stack", None)
            if stack is None:
                stack = _TLS.stack = []
            stack.append(self.sid)
            self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = clock() - self.t0
        try:
            if self._pushed:
                _TLS.stack.pop()
                self._pushed = False
            if _active():
                par = self.parent if self.parent is not None \
                    else _parent_sid()
                a = dict(self.attrs) if self.attrs else {}
                if exc_type is not None:
                    a["error"] = exc_type.__name__
                _record("span", self.name, ts=self.t0, dur=self.elapsed,
                        sid=self.sid, par=par, a=a or None)
        finally:
            # last: the annotation covers the span's own bookkeeping
            if self._rf is not None:
                self._rf.__exit__(exc_type, exc, tb)
                self._rf = None
        return False


def span(name: str, *, parent: Optional[int] = None, profile: bool = False,
         **attrs) -> _Span:
    """A named span: `with telemetry.span("step.intern", records=n)
    as sp: ...`; sp.elapsed holds the measured seconds either way.
    `parent` names the parent span's id where thread nesting cannot
    (see chunk_ctx); `profile=True` (where `profiling()` said so) puts
    the interval on a running torch.profiler capture's timeline too."""
    return _Span(name, attrs, parent, profile)


class _Stopwatch:
    """A deferred span: started at construction, recorded by its first
    stop(); an unstopped stopwatch records nothing."""

    __slots__ = ("name", "attrs", "t0", "_done")

    def __init__(self, name: Optional[str], attrs: dict):
        self.name = name
        self.attrs = attrs
        self.t0 = clock()
        self._done = False

    def stop(self, **extra) -> float:
        """Close the interval and return its seconds. Idempotent: a later
        call returns the first measurement and records nothing."""
        if self._done:
            return self.attrs.get("_elapsed", 0.0)
        self._done = True
        elapsed = clock() - self.t0
        self.attrs["_elapsed"] = elapsed
        if self.name is not None and _active():
            a = dict(self.attrs)
            a.pop("_elapsed", None)
            a.update(extra)
            _record("span", self.name, ts=self.t0, dur=elapsed,
                    sid=_rec().sid() if enabled() else None,
                    par=_parent_sid(), a=a or None)
        return elapsed


def stopwatch(name: Optional[str] = None, **attrs) -> _Stopwatch:
    """A span recorded when it is stopped (`sw.stop()`), for intervals
    that cross scopes; with no name, a bare stopwatch."""
    return _Stopwatch(name, attrs)


def record_span(name: str, t0: float, dur: float,
                parent: Optional[int] = None,
                sid: Optional[int] = None, **attrs) -> None:
    """Record an already-measured interval (the worker-side ingress
    stages and the engines' tuner rounds time themselves and report
    after the fact)."""
    if not _active():
        return
    if sid is None and enabled():
        sid = _rec().sid()
    _record("span", name, ts=t0, dur=dur, sid=sid,
            par=parent if parent is not None else _parent_sid(),
            a=attrs or None)


# -- program-signature dispatch tags (the cost observatory) ------------
def tag_dispatch(**tags) -> None:
    """Bind program-identity attributes (program=..., sig=...) to THIS
    thread's next dispatch-span record. Set by the launch wrappers
    through utils/costmodel (they run inside the dispatch call, on the
    dispatching thread), consumed by the ingress pipeline's dispatch
    span via pop_dispatch_tags — so ledger spans carry the program and
    shape signature the cost registry is keyed by."""
    _TLS.dispatch_tags = tags


def pop_dispatch_tags() -> dict:
    """Take (and clear) the pending dispatch tags of this thread; {}
    when none are bound. Cheap enough for disarmed hot paths: one
    thread-local read."""
    tags = getattr(_TLS, "dispatch_tags", None)
    if tags is None:
        return {}
    _TLS.dispatch_tags = None
    return tags


# -- cross-thread chunk correlation (the ingress pipeline) -------------
def chunk_ctx(chunk) -> Optional[dict]:
    """Open a chunk span handle the pool workers can parent their
    stage spans to (thread-local nesting cannot cross the pool). The
    span itself is recorded by close_chunk once the chunk's finalize
    lands."""
    if not enabled():
        return None
    return {"sid": _rec().sid(), "chunk": chunk, "t0": clock()}


def close_chunk(ctx: Optional[dict], **attrs) -> None:
    if ctx is None or not enabled():
        return
    _record("span", "ingress.chunk", ts=ctx["t0"],
            dur=clock() - ctx["t0"], sid=ctx["sid"],
            par=_parent_sid(),
            a=dict(attrs, chunk=ctx["chunk"]))


def chunk_key(item):
    """A compact correlation id for a pipeline chunk descriptor: ints
    (window starts) pass through, a chunk of an autotune.RoundPlan gives
    its first window (`at`), a tuple its first int; anything else is
    opaque."""
    import numbers

    at = getattr(item, "at", None)
    if isinstance(at, numbers.Integral):
        return int(at)
    if isinstance(item, numbers.Integral):
        return int(item)
    if isinstance(item, tuple) and item \
            and isinstance(item[0], numbers.Integral):
        return int(item[0])
    return None


# ----------------------------------------------------------------------
# events / counters / gauges
# ----------------------------------------------------------------------
def event(name: str, durable: bool = False, **attrs) -> None:
    """A discrete happening. durable=True appends + fsyncs the record
    to the ledger immediately (demotions, kills, checkpoints, resumes
    — the post-mortem class that must survive a wedge)."""
    if not _active():
        return
    _record("event", name, ts=clock(), durable=durable,
            a=attrs or None)


def counter(name: str, value: float = 1, **attrs) -> None:
    if not _active():
        return
    _record("counter", name, ts=clock(), value=value, a=attrs or None)


def gauge(name: str, value: float, **attrs) -> None:
    if not _active():
        return
    _record("gauge", name, ts=clock(), value=value, a=attrs or None)


def on_fatal(site: str = "") -> None:
    """The simulated-hard-kill hook (utils/faults fatal InjectedFault):
    stamp a durable event and flush the ring, so the ledger left behind
    still holds the spans before the kill."""
    if not enabled():
        return
    event("fatal", durable=True, site=site)
    flush()


# ----------------------------------------------------------------------
# shared histogram math
# ----------------------------------------------------------------------
def percentiles(samples, ps=(50, 95, 99)) -> Dict[int, float]:
    """Nearest-rank percentiles over `samples` (exact, no
    interpolation: the p-th percentile is the ceil(p/100*n)-th
    smallest sample) — the one histogram definition the recorder, the
    metrics registry and the latency plane share."""
    xs = sorted(samples)
    if not xs:
        return {p: 0.0 for p in ps}
    n = len(xs)
    out = {}
    for p in ps:
        rank = max(1, -(-p * n // 100))  # ceil(p*n/100), 1-based
        out[p] = float(xs[min(rank, n) - 1])
    return out


def summary(top: int = 0) -> List[dict]:
    """Per-span-name latency rows (count, total, p50/p95/p99 over the
    bounded sample reservoir, in ms), the most total time first; the
    first `top` of them where top > 0."""
    r = _rec()
    with r.lock:
        rows = []
        for name, a in r.agg.items():
            pct = percentiles(a["samples"])
            rows.append({
                "span": name,
                "count": a["count"],
                "total_ms": round(a["total"] * 1e3, 3),
                "p50_ms": round(pct[50] * 1e3, 3),
                "p95_ms": round(pct[95] * 1e3, 3),
                "p99_ms": round(pct[99] * 1e3, 3),
            })
    rows.sort(key=lambda x: -x["total_ms"])
    return rows[:top] if top else rows


def records() -> List[dict]:
    """Snapshot of the ring (tests / diagnostics), private marks
    stripped."""
    r = _rec()
    with r.lock:
        return [{k: v for k, v in rec.items() if k != "_w"}
                for rec in r.ring]
