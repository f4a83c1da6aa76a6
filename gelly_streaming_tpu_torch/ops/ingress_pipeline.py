"""The three-stage host-ingress pipeline: chunk prep on a worker pool ‖
the h2d on the same worker ‖ device work dispatched in chunk order.

Port of the JAX package's `ops/ingress_pipeline.py` (`StageTimers`
:107-143, `PrepError` :145, the pool :158-245, `forced_sync` :185-214,
`run_pipeline` :460-650, `submit_prep` :653, `map_ordered` :666). Both
stream engines (ops/triangles.TriangleWindowKernel and the summary and
GNN engines of ops/scan_analytics.py and ops/gnn_window.py) build their
chunks through `run_pipeline`. Per chunk:

  1. PREP     the padded host stacks of the chunk; runs on the process's
              worker pool, several chunks at once (numpy copies drop the
              GIL). Results are consumed strictly in chunk order, so they
              never depend on the pool's width.
  2. H2D      on the same worker, right after that chunk's prep: the
              stacks into a pinned slot of the engine's ChunkStager ring
              and one copy on its copy stream (ops/staging.py).
  3. DISPATCH on the caller's thread, in chunk order, without blocking:
              the kernels of the chunk on the compute stream and the
              enqueued copy back of its outputs. FINALIZE, which waits
              for those outputs (and recounts what overflowed), runs one
              chunk behind, then once at the end, so the round trip of
              chunk i hides behind chunk i+1's kernels.

Knobs (the JAX package's :49-62, utils/knobs.py):
  GS_PIPELINE_WORKERS=N   the pool's width (default min(4, cpus - 1));
                          0 runs the synchronous form. A `workers=`
                          given to `run_pipeline` or `prep_pool` wins.
  GS_PIPELINE_INFLIGHT=N  prepped and copied chunks ahead of dispatch
                          (default 3). It narrows an `inflight=` given
                          to `run_pipeline`, as the JAX twin does: the
                          engines pass their own `INFLIGHT` (3), the
                          depth their staging ring of INFLIGHT + 1 slots
                          is built for, and a narrower look-ahead holds
                          fewer of those slots.
  GS_STREAM_PREFETCH=0    the synchronous form everywhere.
`forced_sync` pins the synchronous form for a scope (prep and h2d inline
on the caller's thread; dispatch keeps its one-behind finalize): the
same results, the A/B lever. `pipeline_enabled()` is False under any of
the three.

When a prep fails, the chunk already dispatched is drained (its finalize
runs) before the error re-raises as a PrepError carrying the worker's
traceback.

The stage guard (the JAX twin's `_guarded_prep_h2d`, :355-440 there):
with GS_STAGE_TIMEOUT_S or GS_STAGE_RETRIES set, each chunk's prep and
h2d run under a per-stage deadline and a bounded retry with
deterministic backoff, and fail as a typed StageTimeout / StageFailed
naming the chunk and stage. Only these host stages are guarded: dispatch
and finalize run on the caller's thread, unguarded, as they launch and
wait on the card. Three rules hold whether the guard is armed or not:
- A fatal injected fault (faults.InjectedFault(fatal=True)) and a
  device error (resilience.is_device_error: a kernel's build or launch,
  a CUDA call) pass through as they were raised: never retried, never
  wrapped in a PrepError or a StageFailed.
- A retried h2d runs on another thread, but writes the chunk's own
  staging slot on the stager's copy stream and records the event the
  dispatch waits on (ops/staging.ChunkStager.put sets the device and
  the stream itself, not the thread's current ones).
- An attempt the deadline abandoned never writes a slot after a later
  attempt of its chunk began: each chunk's attempts hold a gate, and an
  attempt reaches its h2d only while it is the chunk's live attempt
  (a later attempt waits for one already inside its h2d, and
  ChunkStager.put hands the later attempt the slot the earlier one
  filled).

Hooks (each a no-op disarmed): the `prep` and `h2d` fault sites
(utils/faults.py) on the worker before each stage; the flight recorder's
`ingress.chunk` span with `ingress.prep`, `ingress.h2d`, `ingress.wait`
(the caller's thread getting the chunk's staged payload: blocked on the
pool's future, or the inline prep and h2d of the synchronous form),
`ingress.dispatch` (tagged with the launch's program and signature when
the cost observatory is armed) and `ingress.finalize` children, which
also feed the metrics registry's stage histograms; each carries the
chunk's `chunk` id and, where the caller gives them, its absolute first
`window` and the caller's `call` ordinal; the `gs_inflight_chunks` and
`gs_inflight_oldest_s` gauges. While a torch.profiler capture records,
the caller's thread's spans (wait, dispatch, finalize) also enter it as
`record_function` annotations, recorder armed or not
(utils/telemetry.py `profiling`); with neither, a chunk makes no span.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from collections import deque
from contextlib import nullcontext
from concurrent.futures import ThreadPoolExecutor, wait
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Iterable, List, Optional

from ..utils import faults
from ..utils import knobs
from ..utils import metrics
from ..utils import resilience
from ..utils import telemetry
from ..utils.resilience import StageFailed, StageTimeout

__all__ = ["DEFAULT_INFLIGHT", "PrepError", "StageFailed", "StageTimeout",
           "StageTimers", "forced_sync",
           "forced_sync_active", "inflight_limit", "map_ordered",
           "pipeline_enabled",
           "prep_pool", "reset_pool", "run_pipeline", "submit_prep",
           "worker_count"]

_MAX_DEFAULT_WORKERS = 4
DEFAULT_INFLIGHT = 3
_POLL_S = 0.02   # the guard's wait tick, when a deadline is set
_OFF = nullcontext()    # a stage's scope while nothing traces it


class StageTimers:
    """Per-stage wall-time accumulators of pipelined runs: milliseconds
    in prep (summed across workers: CPU time, not critical-path time),
    h2d, and compute (the finalize stage: waiting for the device's
    outputs, then the host work on them). `snapshot()` gives the means
    per chunk."""

    __slots__ = ("chunks", "prep_ms", "h2d_ms", "compute_ms", "_lock")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self.chunks = 0
            self.prep_ms = 0.0
            self.h2d_ms = 0.0
            self.compute_ms = 0.0

    def add(self, stage: str, seconds: float) -> None:
        with self._lock:  # prep accumulates from several workers
            setattr(self, stage + "_ms",
                    getattr(self, stage + "_ms") + seconds * 1e3)

    def snapshot(self) -> dict:
        n = max(self.chunks, 1)
        return {
            "chunks": self.chunks,
            "prep_ms_per_chunk": round(self.prep_ms / n, 3),
            "h2d_ms_per_chunk": round(self.h2d_ms / n, 3),
            "compute_ms_per_chunk": round(self.compute_ms / n, 3),
        }


class PrepError(RuntimeError):
    """A prep or h2d stage failed on a worker. The message carries the
    worker's formatted traceback; the original exception rides as
    __cause__; `stage` names the stage ('prep' / 'h2d')."""

    def __init__(self, message: str, stage: Optional[str] = None):
        super().__init__(message)
        self.stage = stage


_POOLS: dict = {}
_POOL_LOCK = threading.Lock()
_FORCE_SYNC = 0  # nesting depth of forced_sync() contexts


def worker_count() -> int:
    """The default pool width: GS_PIPELINE_WORKERS where set, else
    min(4, cpus - 1), at least 1 (one core stays with the dispatching
    thread)."""
    env = knobs.get_int("GS_PIPELINE_WORKERS")
    if env is not None:
        return env
    return max(1, min(_MAX_DEFAULT_WORKERS, (os.cpu_count() or 2) - 1))


def inflight_limit() -> int:
    """The default look-ahead: prepped and copied chunks in flight ahead
    of dispatch (GS_PIPELINE_INFLIGHT, default DEFAULT_INFLIGHT)."""
    return knobs.get_int("GS_PIPELINE_INFLIGHT")


def pipeline_enabled() -> bool:
    """False where the synchronous form is pinned: forced_sync,
    GS_STREAM_PREFETCH=0 or GS_PIPELINE_WORKERS=0."""
    if _FORCE_SYNC or not knobs.get_bool("GS_STREAM_PREFETCH"):
        return False
    return worker_count() > 0


def forced_sync_active() -> bool:
    """True while any forced_sync() context is live."""
    return _FORCE_SYNC > 0


class forced_sync:
    """Context manager pinning the synchronous single-threaded form, the
    lever that measures the pipeline against its own baseline. Process
    wide: while any context is active, every pipelined call in the
    process runs synchronously."""

    def __enter__(self):
        global _FORCE_SYNC
        with _POOL_LOCK:
            _FORCE_SYNC += 1
        return self

    def __exit__(self, *exc):
        global _FORCE_SYNC
        with _POOL_LOCK:
            _FORCE_SYNC -= 1
        return False


def prep_pool(workers: Optional[int] = None):
    """The process's prep ThreadPoolExecutor of `workers` threads
    (default `worker_count()`), built at first use; None under
    forced_sync, GS_STREAM_PREFETCH=0 or at zero workers."""
    w = worker_count() if workers is None else int(workers)
    if _FORCE_SYNC or w <= 0 or not knobs.get_bool("GS_STREAM_PREFETCH"):
        return None
    with _POOL_LOCK:
        pool = _POOLS.get(w)
        if pool is None:
            pool = _POOLS[w] = ThreadPoolExecutor(
                max_workers=w, thread_name_prefix="gs-ingress-prep")
        return pool


def reset_pool() -> None:
    """Test hook: drop the memoized pools. A dropped pool is not shut
    down, so a run still holding it finishes; its threads exit once it
    is garbage collected."""
    with _POOL_LOCK:
        _POOLS.clear()


def _mark(cell: Optional[dict], stage: str) -> None:
    """Record which stage a worker task is in, and since when, so the
    guard can hold each stage to its own deadline and name the hung
    one."""
    if cell is not None:
        cell["since"] = time.perf_counter()
        cell["stage"] = stage


def _span_cell(cell: Optional[dict], item):
    """(parent span id, correlation attributes) of a chunk's stage: the
    chunk's span handle and ids ride the cell (thread-local nesting
    cannot cross the pool)."""
    if cell and cell.get("ids") is not None:
        ctx = cell["tctx"]
        return (ctx["sid"] if ctx is not None else None), cell["ids"]
    return None, {"chunk": telemetry.chunk_key(item)}


def _passes_through(exc: BaseException) -> bool:
    """A fatal injected fault or a device error: raised as it is, never
    wrapped or retried."""
    return (isinstance(exc, faults.InjectedFault) and exc.fatal) \
        or resilience.is_device_error(exc)


class _Abandoned(Exception):
    """An attempt the guard gave up on reached its h2d after a later
    attempt of its chunk began: it writes nothing."""


def _timed_prep(prep: Callable, item, timers: Optional[StageTimers],
                cell: Optional[dict] = None):
    """Worker-side prep: the `prep` fault site, then prep, timed; a
    failure wrapped in a PrepError with the worker's traceback
    (Exception only: interrupts, fatal faults and device errors pass
    through)."""
    _mark(cell, "prep")
    t0 = time.perf_counter()
    try:
        faults.fire("prep")
        out = prep(item)
    except Exception as e:
        if _passes_through(e):
            raise
        raise PrepError("ingress prep stage failed for chunk %r:\n%s"
                        % (item, traceback.format_exc()), "prep") from e
    dt = time.perf_counter() - t0
    if timers is not None:
        timers.add("prep", dt)
    if cell.get("spans") if cell else telemetry.active():
        par, ids = _span_cell(cell, item)
        telemetry.record_span("ingress.prep", t0, dt, parent=par, **ids)
    return out


def _prep_then_h2d(prep: Callable, h2d: Callable, item,
                   timers: Optional[StageTimers],
                   cell: Optional[dict] = None):
    """One worker task: prep, then h2d of one chunk, each timed. Under
    the guard (a `gate` in the cell) the h2d runs only while this
    attempt is its chunk's live one, holding the chunk's gate."""
    payload = _timed_prep(prep, item, timers, cell)
    _mark(cell, "h2d")
    t0 = time.perf_counter()
    try:
        faults.fire("h2d")
        gate = cell.get("gate") if cell else None
        if gate is None:
            dev = h2d(payload)
        else:
            with gate["lock"]:
                if gate["live"] != cell["attempt"]:
                    raise _Abandoned()
                dev = h2d(payload)
    except Exception as e:
        if _passes_through(e) or isinstance(e, _Abandoned):
            raise
        raise PrepError("ingress h2d stage failed for chunk %r:\n%s"
                        % (item, traceback.format_exc()), "h2d") from e
    dt = time.perf_counter() - t0
    if timers is not None:
        timers.add("h2d", dt)
    if cell.get("spans") if cell else telemetry.active():
        par, ids = _span_cell(cell, item)
        telemetry.record_span("ingress.h2d", t0, dt, parent=par, **ids)
    _mark(cell, "done")
    return dev


def _await_attempt(wait_tick: Callable, outcome: Callable, cell: dict,
                   timeout: float, queued_since: float):
    """The wait loop of one guarded prep+h2d attempt. `wait_tick(t)`
    blocks up to t seconds and returns True once the attempt finished;
    `outcome()` then returns its value or raises. Holds each stage to
    `timeout` through the worker-updated cell; a task no worker picked
    up yet counts its queue wait (since `queued_since`). Returns
    (True, value, None), (False, exception, stage), or (False, None,
    stage) when a deadline expired (the attempt's thread is
    abandoned)."""
    while True:
        if wait_tick(_POLL_S if timeout > 0 else None):
            try:
                return True, outcome(), None
            except BaseException as e:  # the caller raises or retries it
                return False, e, cell.get("stage")
        stage = cell.get("stage", "queued")
        since = cell.get("since", queued_since)
        if (timeout > 0 and stage in ("queued", "prep", "h2d")
                and time.perf_counter() - since > timeout):
            return False, None, stage


def _future_wait(fut, t: Optional[float]) -> bool:
    """Event.wait-shaped adapter over a Future: True once done."""
    try:
        fut.exception(timeout=t)
    except _FutureTimeout:
        return fut.done()
    except BaseException:  # wait only: outcome() re-raises the error
        pass
    return True


def _guarded_prep_h2d(prep: Callable, h2d: Callable, item,
                      timers: Optional[StageTimers], cell0: dict,
                      first_future=None):
    """One chunk's prep+h2d under the stage guard: a per-stage deadline
    (GS_STAGE_TIMEOUT_S) and bounded retry with deterministic backoff
    (GS_STAGE_RETRIES, GS_STAGE_BACKOFF_S). `cell0` is the chunk's
    cell, its gate in it (run_pipeline's `_cell`); attempt 1 is
    `first_future` (already on the pool) when given; a retry with a
    deadline runs on a thread of its own, so a hung pool worker is left
    behind. Every attempt shares the chunk's gate (see _prep_then_h2d):
    an attempt given up on is retired before the next starts. Fatal
    faults, device errors and interrupts pass through unretried."""
    retries = resilience.stage_retries()
    timeout = resilience.stage_timeout_s()
    attempts: List[dict] = []
    last_stage = "prep"
    gate = cell0["gate"]
    for attempt in range(retries + 1):
        t0 = time.perf_counter()
        if attempt == 0 and first_future is not None:
            cell = cell0
            ok, res, stage = _await_attempt(
                lambda t: _future_wait(first_future, t),
                first_future.result, cell, timeout,
                cell.get("submitted", t0))
        else:
            cell = cell0 if attempt == 0 else {
                "tctx": cell0.get("tctx"), "spans": cell0.get("spans"),
                "ids": cell0.get("ids"), "gate": gate, "attempt": attempt}
            if timeout > 0:
                box, done = {}, threading.Event()

                def _runner(cell=cell, box=box, done=done):
                    try:
                        box["value"] = _prep_then_h2d(prep, h2d, item,
                                                      timers, cell)
                    except BaseException as e:  # re-raised by _outcome
                        box["error"] = e
                    finally:
                        done.set()

                threading.Thread(target=_runner, daemon=True,
                                 name="gs-ingress-retry").start()

                def _outcome(box=box):
                    if "error" in box:
                        raise box["error"]
                    return box["value"]

                ok, res, stage = _await_attempt(done.wait, _outcome, cell,
                                                timeout, t0)
            else:
                try:
                    return _prep_then_h2d(prep, h2d, item, timers, cell)
                except Exception as e:
                    ok, res, stage = False, e, cell.get("stage")
        if ok:
            return res
        if res is not None and (not isinstance(res, Exception)
                                or _passes_through(res)):
            raise res
        # retire this attempt before another may start
        gate["live"] = attempt + 1
        last_stage = stage or last_stage
        attempts.append({
            "stage": last_stage,
            "outcome": "timeout" if res is None else type(res).__name__,
            "elapsed_s": round(time.perf_counter() - t0, 6)})
        if attempt >= retries:
            if res is None:
                raise StageTimeout(
                    "%s stage of chunk %r exceeded its %.3gs deadline "
                    "(GS_STAGE_TIMEOUT_S) on %d attempt(s)"
                    % (last_stage, item, timeout, len(attempts)),
                    last_stage, item, attempts)
            raise StageFailed(
                "%s stage of chunk %r failed after %d attempt(s): %s"
                % (last_stage, item, len(attempts), res),
                last_stage, item, attempts) from res
        telemetry.event("stage_retry", stage=last_stage,
                        chunk=telemetry.chunk_key(item),
                        attempt=attempt + 1,
                        outcome=attempts[-1]["outcome"])
        time.sleep(resilience.backoff_s(attempt))


def run_pipeline(items: Iterable, prep: Callable, h2d: Callable,
                 dispatch: Callable, finalize: Callable,
                 timers: Optional[StageTimers] = None,
                 inflight: Optional[int] = None,
                 workers: Optional[int] = None,
                 call: Optional[int] = None,
                 first_window: Optional[int] = None) -> None:
    """Run `items` (ordered chunk descriptors, drawn one at a time as the
    look-ahead admits them: a lazy iterable may decide item k while the
    items before it are in flight) through the three stages:

      prep(item)     -> host payload (pure; any worker; consumed in item
                        order)
      h2d(payload)   -> device payload (the same worker, right after its
                        prep; must be thread-safe)
      dispatch(dev)  -> raw outputs (caller's thread, item order; must not
                        block on device results)
      finalize(raw)  -> None (waits for the outputs; one item behind
                        dispatch, then once at the end)

    `inflight` caps the prepped and copied look-ahead, which bounds host
    and device memory: a caller whose h2d writes into a ring of slots
    holds `inflight + 1` of them. GS_PIPELINE_INFLIGHT (default 3) is
    the cap where none is given and narrows one that is. `workers` is the pool's width
    (default min(4, cpus - 1)). A prep or h2d failure surfaces as
    PrepError, or with the stage guard armed as StageTimeout /
    StageFailed once the attempts are spent (a fatal fault or a device
    error as itself), after the already-dispatched chunk is drained;
    preps not yet started are cancelled and those running are waited
    for.

    `call` and `first_window` are correlation ids for the chunks' spans:
    the caller's call ordinal, and the absolute window of the call's
    first (each chunk's `window` is it plus the chunk's `chunk_key`)."""
    it = iter(items)
    head = list(itertools.islice(it, 2))    # one item: nothing to overlap
    limit = (inflight_limit() if inflight is None
             else min(int(inflight), inflight_limit()))
    pool = prep_pool(workers) if len(head) > 1 else None
    it = itertools.chain(head, it)
    pending = None          # (item, raw, cell) one behind dispatch
    futures: deque = deque()
    guard = resilience.guard_active()
    gauges = metrics.enabled()
    # read once a call: with neither, a chunk makes no span
    spans = telemetry.active()
    profile = telemetry.profiling()
    traced = spans or profile

    def _stage(name, cell):
        # a stage on this thread, live around its work, so that a
        # profiler capture can hold it too; the capture alone needs
        # only its name
        if not spans:
            return telemetry.span(name, profile=True)
        par, ids = _span_cell(cell, None)
        return telemetry.span(name, parent=par, profile=profile, **ids)

    def _finalize(item, raw, cell):
        t0 = time.perf_counter()
        with _stage("ingress.finalize", cell) if traced else _OFF:
            finalize(raw)
        dt = time.perf_counter() - t0
        if timers is not None:
            timers.add("compute", dt)
            timers.chunks += 1
        if spans:
            telemetry.close_chunk(cell["tctx"], **cell["ids"])

    def _consume(item, dev, cell):
        nonlocal pending
        if spans:
            telemetry.pop_dispatch_tags()   # drop a stale tag
        with _stage("ingress.dispatch", cell) if traced else _OFF as sp:
            raw = dispatch(dev)
            if spans:
                sp.attrs.update(telemetry.pop_dispatch_tags())
        if pending is not None:
            done, pending = pending, None
            _finalize(*done)
        pending = (item, raw, cell)

    def _cell(item) -> dict:
        # the chunk's span handle and ids (None disarmed); under the
        # guard, when it was submitted (the queue deadline) and its
        # attempts' gate, there before any attempt runs
        cell = {"submitted": time.perf_counter(), "spans": spans,
                "tctx": None, "ids": None}
        if spans:
            ck = telemetry.chunk_key(item)
            cell["tctx"] = telemetry.chunk_ctx(ck)
            cell["ids"] = ids = {"chunk": ck}
            if call is not None:
                ids["call"] = call
            if first_window is not None and ck is not None:
                ids["window"] = first_window + ck
        if guard:
            cell.update(gate={"lock": threading.Lock(), "live": 0},
                        attempt=0)
        return cell

    def _submit(item):
        cell = _cell(item)
        return item, cell, pool.submit(_prep_then_h2d, prep, h2d, item,
                                       timers, cell)

    try:
        if pool is None:
            for item in it:
                cell = _cell(item)
                with _stage("ingress.wait", cell) if traced else _OFF:
                    dev = (_guarded_prep_h2d(prep, h2d, item, timers, cell)
                           if guard
                           else _prep_then_h2d(prep, h2d, item, timers,
                                               cell))
                _consume(item, dev, cell)
        else:
            width = worker_count() if workers is None else int(workers)
            lookahead = max(1, min(width + 1, limit))
            futures.extend(_submit(item)
                           for item in itertools.islice(it, lookahead))
            while futures:
                item, cell, fut = futures.popleft()
                with _stage("ingress.wait", cell) if traced else _OFF:
                    dev = (_guarded_prep_h2d(prep, h2d, item, timers, cell,
                                             first_future=fut) if guard
                           else fut.result())
                for nxt in itertools.islice(it, 1):
                    futures.append(_submit(nxt))
                if gauges:
                    # prepped and copied chunks waiting on dispatch, and
                    # how long the oldest has waited
                    metrics.gauge_set("gs_inflight_chunks", len(futures))
                    metrics.gauge_set(
                        "gs_inflight_oldest_s",
                        time.perf_counter() - futures[0][1]["submitted"]
                        if futures else 0.0)
                _consume(item, dev, cell)
    except Exception:
        # drain the chunk already dispatched before the failure surfaces,
        # so its outputs (and any recount) are not abandoned mid-stream
        if pending is not None:
            done, pending = pending, None
            try:
                _finalize(*done)
            except Exception as drain_err:
                # the original failure is the one to report
                telemetry.event(
                    "drain_failed", durable=True,
                    component="ingress_pipeline",
                    error="%s: %s" % (type(drain_err).__name__,
                                      drain_err))
        raise
    finally:
        # cancel what has not started and wait for what has, so no worker
        # still runs a stage of this call once it returns or raises
        for _item, _cell, f in futures:
            f.cancel()
        wait([f for _item, _cell, f in futures])
    if pending is not None:
        _finalize(*pending)


def submit_prep(fn: Callable, item, timers: Optional[StageTimers] = None,
                workers: Optional[int] = None):
    """Submit one prep task to the pool, or None under forced_sync (the
    caller then preps inline). The future's result() raises PrepError
    with the worker's traceback on failure."""
    pool = prep_pool(workers)
    if pool is None:
        return None
    return pool.submit(_timed_prep, fn, item, timers)


def map_ordered(fn: Callable, items: Iterable,
                workers: Optional[int] = None) -> List:
    """Ordered parallel map over the prep pool: results in item order
    whatever the workers' schedule, the sequential form under
    forced_sync, so outputs are identical at every pool width."""
    items = list(items)
    pool = prep_pool(workers) if len(items) > 1 else None
    if pool is None:
        return [_timed_prep(fn, it, None) for it in items]
    futures = [pool.submit(_timed_prep, fn, it, None) for it in items]
    try:
        return [f.result() for f in futures]
    finally:
        for f in futures:
            f.cancel()
