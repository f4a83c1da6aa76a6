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

The pool's width (default min(4, cpus - 1)) and the look-ahead (default
3 prepped and copied chunks ahead of dispatch) are arguments of
`run_pipeline`, not environment knobs. `forced_sync` pins the
synchronous form (prep and h2d inline on the caller's thread; dispatch
keeps its one-behind finalize): the same results, the A/B lever.

When a prep fails, the chunk already dispatched is drained (its finalize
runs) before the error re-raises as a PrepError carrying the worker's
traceback.

Not ported yet (ROADMAP.md step 1.8, with the utils/ hooks): the stage
guard (GS_STAGE_TIMEOUT_S / GS_STAGE_RETRIES: per-stage deadlines and
retries), the telemetry spans, the fault-injection points and the
metrics gauges.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Iterable, List, Optional

__all__ = ["DEFAULT_INFLIGHT", "PrepError", "StageTimers", "forced_sync",
           "forced_sync_active", "inflight_limit", "map_ordered",
           "prep_pool", "reset_pool", "run_pipeline", "submit_prep",
           "worker_count"]

_MAX_DEFAULT_WORKERS = 4
DEFAULT_INFLIGHT = 3


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
    __cause__."""


_POOLS: dict = {}
_POOL_LOCK = threading.Lock()
_FORCE_SYNC = 0  # nesting depth of forced_sync() contexts


def worker_count() -> int:
    """The default pool width: min(4, cpus - 1), at least 1 (one core
    stays with the dispatching thread)."""
    return max(1, min(_MAX_DEFAULT_WORKERS, (os.cpu_count() or 2) - 1))


def inflight_limit() -> int:
    """The default look-ahead: prepped and copied chunks in flight ahead
    of dispatch."""
    return DEFAULT_INFLIGHT


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
    forced_sync or at zero workers."""
    w = worker_count() if workers is None else int(workers)
    if _FORCE_SYNC or w <= 0:
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


def _timed_prep(prep: Callable, item, timers: Optional[StageTimers]):
    """Worker-side prep: timed, a failure wrapped in a PrepError with the
    worker's traceback (Exception only: an interrupt passes through)."""
    t0 = time.perf_counter()
    try:
        out = prep(item)
    except Exception as e:
        raise PrepError("ingress prep stage failed for chunk %r:\n%s"
                        % (item, traceback.format_exc())) from e
    if timers is not None:
        timers.add("prep", time.perf_counter() - t0)
    return out


def _prep_then_h2d(prep: Callable, h2d: Callable, item,
                   timers: Optional[StageTimers]):
    """One worker task: prep, then h2d of one chunk, each timed."""
    payload = _timed_prep(prep, item, timers)
    t0 = time.perf_counter()
    try:
        dev = h2d(payload)
    except Exception as e:
        raise PrepError("ingress h2d stage failed for chunk %r:\n%s"
                        % (item, traceback.format_exc())) from e
    if timers is not None:
        timers.add("h2d", time.perf_counter() - t0)
    return dev


def run_pipeline(items: Iterable, prep: Callable, h2d: Callable,
                 dispatch: Callable, finalize: Callable,
                 timers: Optional[StageTimers] = None,
                 inflight: Optional[int] = None,
                 workers: Optional[int] = None) -> None:
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

    `inflight` (default 3) caps the prepped and copied look-ahead, which
    bounds host and device memory: a caller whose h2d writes into a ring
    of slots holds `inflight + 1` of them. `workers` is the pool's width
    (default min(4, cpus - 1)). A prep or h2d failure surfaces as
    PrepError after the already-dispatched chunk is drained; preps not
    yet started are cancelled and those running are waited for."""
    it = iter(items)
    head = list(itertools.islice(it, 2))    # one item: nothing to overlap
    limit = inflight_limit() if inflight is None else int(inflight)
    pool = prep_pool(workers) if len(head) > 1 else None
    it = itertools.chain(head, it)
    pending = None          # raw outputs of the chunk one behind dispatch
    futures: deque = deque()

    def _finalize(raw):
        t0 = time.perf_counter()
        finalize(raw)
        if timers is not None:
            timers.add("compute", time.perf_counter() - t0)
            timers.chunks += 1

    def _consume(dev):
        nonlocal pending
        raw = dispatch(dev)
        if pending is not None:
            done, pending = pending, None
            _finalize(done)
        pending = raw

    try:
        if pool is None:
            for item in it:
                _consume(_prep_then_h2d(prep, h2d, item, timers))
        else:
            width = worker_count() if workers is None else int(workers)
            lookahead = max(1, min(width + 1, limit))
            futures.extend(pool.submit(_prep_then_h2d, prep, h2d, item,
                                       timers)
                           for item in itertools.islice(it, lookahead))
            while futures:
                dev = futures.popleft().result()
                for item in itertools.islice(it, 1):
                    futures.append(pool.submit(_prep_then_h2d, prep, h2d,
                                               item, timers))
                _consume(dev)
    except Exception:
        # drain the chunk already dispatched before the failure surfaces,
        # so its outputs (and any recount) are not abandoned mid-stream
        if pending is not None:
            done, pending = pending, None
            try:
                _finalize(done)
            except Exception:
                pass        # the original failure is the one to report
        raise
    finally:
        # cancel what has not started and wait for what has, so no worker
        # still runs a stage of this call once it returns or raises
        for f in futures:
            f.cancel()
        wait(futures)
    if pending is not None:
        _finalize(pending)


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
