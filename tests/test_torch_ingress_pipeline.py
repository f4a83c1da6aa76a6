"""The port's ingress pipeline (gelly_streaming_tpu_torch/ops/
ingress_pipeline.py), held to the contracts the JAX package's
tests/operations/test_ingress_pipeline.py pins for its original: chunk
order and the one-behind finalize, PrepError with the worker's
traceback, the same results at every pool width and under forced_sync,
the look-ahead cap, interrupts unwrapped, map_ordered. Then the three
stream engines of the port on device="cpu": pipelined over several
chunks at pool widths 1, 2 and 4 equal to the same engine under
forced_sync, outputs and carries bit for bit.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch import (GnnSummaryEngine, StreamSummaryEngine,
                                       TriangleWindowKernel)
from gelly_streaming_tpu_torch.ops import ingress_pipeline as ip
from gelly_streaming_tpu_torch.utils.streams import make_stream


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _fresh_pools():
    ip.reset_pool()
    yield
    ip.reset_pool()


def test_run_pipeline_orders_and_lags_finalize():
    """Finalize sees chunks in order and lags dispatch by exactly one;
    the timers count every chunk once."""
    events = []
    timers = ip.StageTimers()
    ip.run_pipeline(
        range(5),
        prep=lambda i: ("prep", i),
        h2d=lambda p: ("dev", p[1]),
        dispatch=lambda d: (events.append(("dispatch", d[1]))
                            or ("raw", d[1])),
        finalize=lambda r: events.append(("finalize", r[1])),
        timers=timers, workers=2)
    assert [e for e in events if e[0] == "finalize"] == [
        ("finalize", i) for i in range(5)]
    d_at = [i for i, e in enumerate(events) if e[0] == "dispatch"]
    f_at = [i for i, e in enumerate(events) if e[0] == "finalize"]
    for i in range(4):              # chunk i finalizes after i+1 dispatches
        assert f_at[i] > d_at[i + 1]
    assert timers.chunks == 5
    assert set(timers.snapshot()) == {"chunks", "prep_ms_per_chunk",
                                      "h2d_ms_per_chunk",
                                      "compute_ms_per_chunk"}


def test_run_pipeline_prep_error_carries_worker_traceback():
    """A prep failure surfaces as PrepError (a RuntimeError) carrying the
    worker's formatted traceback, the original chained as __cause__, and
    the chunk already dispatched is drained first."""
    finalized = []

    def bad_prep(i):
        if i == 2:
            raise ValueError("prep exploded here")
        return i

    with pytest.raises(RuntimeError) as ei:
        ip.run_pipeline(range(4), bad_prep, lambda p: p, lambda d: d,
                        finalized.append, workers=1)
    assert isinstance(ei.value, ip.PrepError)
    msg = str(ei.value)
    assert "prep exploded here" in msg and "bad_prep" in msg
    assert "Traceback" in msg
    assert isinstance(ei.value.__cause__, ValueError)
    assert finalized == [0, 1]
    with pytest.raises(ip.PrepError, match="h2d stage failed"):
        with ip.forced_sync():
            ip.run_pipeline(range(2), lambda i: i, lambda p: 1 // 0,
                            lambda d: d, lambda r: None)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_run_pipeline_sync_and_parallel_identical(workers):
    """The same finalize stream at every pool width and in forced_sync;
    forced_sync runs prep on the caller's thread."""

    def run():
        out, threads = [], set()

        def prep(i):
            threads.add(threading.current_thread().name)
            return i * 10

        ip.run_pipeline(range(7), prep, lambda p: p + 1, lambda d: d * 2,
                        out.append, workers=workers)
        return out, threads

    with ip.forced_sync():
        assert ip.forced_sync_active()
        want, sync_threads = run()
    assert not ip.forced_sync_active()
    assert sync_threads == {threading.current_thread().name}
    got, threads = run()
    assert got == want == [(i * 10 + 1) * 2 for i in range(7)]
    assert all(t.startswith("gs-ingress-prep") for t in threads)


def test_run_pipeline_inflight_cap_and_interrupts():
    """`inflight` bounds the look-ahead without changing results (at most
    `inflight` chunks prepped ahead of dispatch), and a KeyboardInterrupt
    in prep aborts unwrapped."""
    for cap in (1, 2):
        lock = threading.Lock()
        state = {"ahead": 0, "most": 0}

        def prep(i):
            with lock:
                state["ahead"] += 1
                state["most"] = max(state["most"], state["ahead"])
            return i

        def dispatch(d):
            with lock:
                state["ahead"] -= 1
            return d

        out = []
        ip.run_pipeline(range(8), prep, lambda p: p, dispatch, out.append,
                        inflight=cap, workers=4)
        assert out == list(range(8))
        assert state["most"] <= cap + 1

    def interrupt(i):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        with ip.forced_sync():
            ip.run_pipeline(range(2), interrupt, lambda p: p,
                            lambda d: d, lambda r: None)
    with pytest.raises(KeyboardInterrupt):
        ip.run_pipeline(range(3), interrupt, lambda p: p, lambda d: d,
                        lambda r: None, workers=2)


def test_run_pipeline_stress_more_workers_than_cores():
    """16 workers (more than the cores) over 300 chunks with a shortened
    switch interval: every chunk finalized once and in order, the timers
    counting each; bounded by a join timeout."""
    out, timers, errors = [], ip.StageTimers(), []

    def run():
        try:
            ip.run_pipeline(range(300), lambda i: i * 3, lambda p: p + 1,
                            lambda d: d, out.append, timers=timers,
                            inflight=8, workers=16)
        except BaseException as e:      # surfaced by the assert below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not t.is_alive() and not errors
    assert out == [i * 3 + 1 for i in range(300)]
    assert timers.chunks == 300


def test_map_ordered_submit_prep_and_pool():
    assert ip.map_ordered(lambda x: x * x, range(20), workers=4) == [
        x * x for x in range(20)]
    with pytest.raises(ip.PrepError, match="boom"):
        ip.map_ordered(
            lambda x: (_ for _ in ()).throw(RuntimeError("boom")),
            range(3), workers=2)
    fut = ip.submit_prep(lambda x: x + 1, 41, workers=2)
    assert fut.result() == 42
    assert ip.prep_pool(2) is ip.prep_pool(2)
    assert ip.prep_pool(0) is None
    with ip.forced_sync():
        assert ip.submit_prep(lambda x: x, 1) is None
        assert ip.prep_pool() is None
        assert ip.map_ordered(str, range(3)) == ["0", "1", "2"]
    assert ip.worker_count() >= 1 and ip.inflight_limit() == 3


# ----------------------------------------------------------------------
# the engines: pipelined ≡ forced_sync
# ----------------------------------------------------------------------

def _engine_runs(make, run, monkeypatch):
    """run(make()) under forced_sync, then pipelined at pool widths 1, 2
    and 4 (the module default is swapped for each width)."""
    with ip.forced_sync():
        want = run(make())
    for w in (1, 2, 4):
        monkeypatch.setattr(ip, "worker_count", lambda w=w: w)
        assert run(make()) == want
    return want


@pytest.mark.parametrize("ingress", ["standard", "compact"])
def test_triangle_stream_pipelined_equals_forced_sync(ingress, monkeypatch):
    """11 windows in 2-window chunks (a ragged last window, the K14
    clique overflowing kb=8 and recounted inside a finalize)."""
    src, dst = make_stream(10 * 128 + 77, 128, seed=3)
    u, v = np.triu_indices(14, k=1)
    src[256:256 + len(u)], dst[256:256 + len(v)] = u, v

    def make():
        k = TriangleWindowKernel(128, 128, k_bucket=8, device="cpu",
                                 ingress=ingress)
        k.MAX_STREAM_WINDOWS = 2
        return k

    def run(k):
        counts = k.count_stream(src, dst)
        assert k.stage_timers.chunks == 6
        return counts

    counts = _engine_runs(make, run, monkeypatch)
    assert counts[2] >= 364 and len(counts) == 11


@pytest.mark.parametrize("ingress", ["standard", "compact"])
def test_summary_engine_pipelined_equals_forced_sync(ingress, monkeypatch):
    """9 windows in 2-window chunks over two calls (eb multiples, then a
    ragged close): summaries, the cursor and the carry bit-equal."""
    src, dst = make_stream(9 * 64 - 13, 100, seed=5)

    def make():
        e = StreamSummaryEngine(64, 128, k_bucket=8, device="cpu",
                                ingress=ingress)
        e.MAX_WINDOWS = 2
        return e

    def run(e):
        out = e.process(src[:256], dst[:256]) + e.process(src[256:],
                                                         dst[256:])
        state = e.state_dict()
        return out, state["windows_done"], [c.tolist()
                                            for c in state["carry"]]

    out, done, _carry = _engine_runs(make, run, monkeypatch)
    assert done == 9 and len(out) == 9


def test_gnn_engine_pipelined_equals_forced_sync(monkeypatch):
    """The GNN engine (standard wire only) over 9 windows in 2-window
    chunks: summaries and the final slab bit-equal."""
    src, dst = make_stream(9 * 64 - 13, 100, seed=6)

    def make():
        e = GnnSummaryEngine(64, 128, feature_dim=8, device="cpu")
        e.MAX_WINDOWS = 2
        e.load_feature_units(np.random.default_rng(1).integers(
            0, 8, (129, 8)).astype(np.float32))
        return e

    def run(e):
        return e.process(src, dst), e.state_dict()["carry"][0].tolist()

    out, _slab = _engine_runs(make, run, monkeypatch)
    assert len(out) == 9 and any(o["active_vertices"] for o in out)
