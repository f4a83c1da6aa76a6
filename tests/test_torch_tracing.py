"""Tracing in the port (gelly_streaming_tpu_torch/utils/tracing.py and
its callers) against the JAX package's, on the CPU.

- `device_trace` on torch.profiler (tests/test_tracing.py:71-200): the
  log directory created, one start and one stop however the captures
  nest (across threads too), a start the profiler refuses degrading to a
  no-op with a `device_trace_failed` event, a body exception still
  stopping the capture, and a real CPU capture written as a Chrome trace
  and stamped with a durable `device_trace_captured` event carrying the
  cost observatory's program inventory;
- `StepTimer` (the span it yields, its accumulation disarmed);
- `trace_report()` of the driver (`tracing=True`) and of the graph API
  (`StreamEnvironment.enable_tracing`): the same step names, calls and
  records as the JAX package for the same job (only the seconds differ);
- the runtime's `op.<kind>` spans and metrics marks, and
  `WindowedEdgeReduce`'s `reduce.stream` / `reduce.sliding` spans.
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as J
from gelly_streaming_tpu.core.driver import \
    StreamingAnalyticsDriver as JaxDriver
from gelly_streaming_tpu.utils import metrics as jax_metrics
import gelly_streaming_tpu_torch as P
from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch.ops.windowed_reduce import WindowedEdgeReduce
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils import tracing

EB, VB = 256, 512


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in ("GS_TELEMETRY", "GS_TRACE_DIR", "GS_METRICS",
              "GS_COSTMODEL"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    yield
    for m in (telemetry, metrics, costmodel, jax_metrics):
        m.reset()
    torch.set_num_threads(threads)


@pytest.fixture
def armed(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / "ledger"))
    telemetry.reset()
    yield
    telemetry.reset()


class _FakeProfile:
    """A stand-in for torch.profiler.profile: counts its starts and
    stops, optionally refuses to start."""

    starts = stops = 0
    fail_start = False

    def __init__(self, activities=None):
        pass

    def start(self):
        if _FakeProfile.fail_start:
            raise RuntimeError("profiler unavailable on this backend")
        _FakeProfile.starts += 1

    def stop(self):
        _FakeProfile.stops += 1

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            f.write('{"traceEvents": [{"cat": "kernel", "name": "k"}, '
                    '{"cat": "cpu_op", "name": "op"}]}')


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.starts = _FakeProfile.stops = 0
    _FakeProfile.fail_start = False
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile


def _events(name):
    return [r for r in telemetry.records()
            if r["t"] == "event" and r["name"] == name]


# ----------------------------------------------------------------------
# device_trace (tests/test_tracing.py:71-200)
# ----------------------------------------------------------------------
def test_device_trace_creates_log_dir(tmp_path, fake_profiler):
    log_dir = str(tmp_path / "traces" / "run0")
    with tracing.device_trace(log_dir) as cap:
        assert os.path.isdir(log_dir)
    assert (fake_profiler.starts, fake_profiler.stops) == (1, 1)
    assert cap.kernel_events == 1 and os.path.isfile(cap.path)
    assert cap.kernels == {"k": 1}


def test_device_trace_nested_is_noop(tmp_path, fake_profiler):
    log_dir = str(tmp_path / "t")
    with tracing.device_trace(log_dir):
        with tracing.device_trace(log_dir) as inner:
            with tracing.device_trace(log_dir):
                pass
        assert fake_profiler.stops == 0
    assert (fake_profiler.starts, fake_profiler.stops) == (1, 1)
    assert inner.path is None


def test_device_trace_nested_across_threads(tmp_path, fake_profiler):
    log_dir = str(tmp_path / "t")
    entered, release = threading.Event(), threading.Event()

    def inner():
        with tracing.device_trace(log_dir):
            entered.set()
            release.wait(timeout=10)

    with tracing.device_trace(log_dir):
        t = threading.Thread(target=inner)
        t.start()
        assert entered.wait(timeout=10)
        assert fake_profiler.starts == 1
        release.set()
        t.join()
    assert (fake_profiler.starts, fake_profiler.stops) == (1, 1)


def test_device_trace_failed_start_degrades_to_noop(tmp_path, armed,
                                                    fake_profiler):
    fake_profiler.fail_start = True
    with tracing.device_trace(str(tmp_path / "t")) as cap:
        pass
    assert fake_profiler.stops == 0 and cap.path is None
    (fail,) = _events("device_trace_failed")
    assert "profiler unavailable" in fail["a"]["error"]
    assert not _events("device_trace_captured")


def test_device_trace_body_exception_still_stops(tmp_path, fake_profiler):
    with pytest.raises(ValueError):
        with tracing.device_trace(str(tmp_path / "t")):
            raise ValueError("stream died mid-capture")
    assert (fake_profiler.starts, fake_profiler.stops) == (1, 1)


def test_device_trace_cpu_capture_stamps_durable_event(tmp_path, armed,
                                                       monkeypatch):
    """The real torch.profiler on the CPU: the capture is written, and
    the durable event carries its file, its kernel events and the cost
    observatory's program count; the traced driver's windows equal an
    untraced run's."""
    monkeypatch.setenv("GS_COSTMODEL", "1")
    costmodel.reset()
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 300, 3 * EB), rng.integers(0, 300, 3 * EB)
    want = StreamingAnalyticsDriver(window_ms=0, edge_bucket=EB,
                                    vertex_bucket=VB, device="cpu"
                                    ).run_arrays(src, dst)
    log_dir = str(tmp_path / "prof")
    with tracing.device_trace(log_dir) as cap:
        got = StreamingAnalyticsDriver(window_ms=0, edge_bucket=EB,
                                       vertex_bucket=VB, device="cpu"
                                       ).run_arrays(src, dst)
    assert [r.triangles for r in got] == [r.triangles for r in want]
    assert all(np.array_equal(a.cc_labels, b.cc_labels)
               for a, b in zip(got, want))
    assert os.path.isfile(cap.path) and cap.kernel_events == 0
    (ev,) = _events("device_trace_captured")
    assert ev["a"]["log_dir"] == log_dir and ev["a"]["path"] == cap.path
    assert ev["a"]["programs"] >= 1
    assert any(k[0] == "window_snapshot" for k in costmodel.programs())


# ----------------------------------------------------------------------
# StepTimer
# ----------------------------------------------------------------------
def test_steptimer_step_yields_span_for_attrs(armed):
    timer = tracing.StepTimer()
    with timer.step("snapshot_scan", num_records=4) as sp:
        sp.attrs.update(program="window_snapshot", sig="i32[4]")
    rec = next(r for r in telemetry.records()
               if r.get("name") == "step.snapshot_scan")
    assert rec["a"]["program"] == "window_snapshot"
    rows = {r["op"]: r for r in timer.report()}
    assert (rows["snapshot_scan"]["records"],
            rows["snapshot_scan"]["calls"]) == (4, 1)


def test_steptimer_disarmed_report_unchanged(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "0")
    telemetry.reset()
    timer = tracing.StepTimer()
    for _ in range(3):
        with timer.step("intern", num_records=10):
            pass
    timer.event("tier_demotion", {"to": "host"})
    assert telemetry.records() == []
    rows = {r["op"]: r for r in timer.report()}
    assert (rows["intern"]["calls"], rows["intern"]["records"]) == (3, 30)
    assert timer.event_log() == [{"event": "tier_demotion", "to": "host"}]
    assert "intern" in str(timer)


# ----------------------------------------------------------------------
# (h) trace_report parity: the driver
# ----------------------------------------------------------------------
def _steps(report):
    return {r["op"]: (r["calls"], r["records"]) for r in report}


def _drive(make, how, tmp):
    rng = np.random.default_rng(21)
    n = 150 * EB + 41
    src, dst = rng.integers(0, 700, n), rng.integers(0, 700, n)
    drv = make()
    if how == "checkpoint":
        drv.enable_auto_checkpoint(os.path.join(tmp, "ckpt"),
                                   every_n_windows=32)
    if how == "timed":
        ts = np.arange(n, dtype=np.int64) // 9
        drv.run_arrays(src[:n // 2], dst[:n // 2], ts[:n // 2])
        drv.run_arrays(src[n // 2:], dst[n // 2:], ts[n // 2:])
    else:
        for lo, hi in ((0, EB), (EB, 70 * EB), (70 * EB, 71 * EB),
                       (71 * EB, n)):
            drv.run_arrays(src[lo:hi], dst[lo:hi])
    return _steps(drv.trace_report())


DRIVERS = {
    "scan": ({}, "calls"),
    "checkpoint": ({}, "checkpoint"),
    "event_time": ({"window_ms": 30}, "timed"),
    "sliding": ({"slide": EB // 4}, "calls"),
    "delta": ({"egress": "delta", "emit_deltas": True}, "calls"),
    "native": ({"snapshot_tier": "native"}, "calls"),
    "host": ({"snapshot_tier": "host"}, "calls"),
    "triangles_only": ({"analytics": ("triangles",)}, "calls"),
    "resident": ({"snapshot_tier": "resident"}, "calls"),
}


@pytest.mark.parametrize("case", sorted(DRIVERS))
def test_driver_trace_report_equals_jax(tmp_path, case):
    kw, how = DRIVERS[case]
    base = dict(window_ms=0, edge_bucket=EB, vertex_bucket=VB,
                tracing=True, snapshot_tier="scan")
    base.update(kw)
    os.makedirs(str(tmp_path / "j"))
    os.makedirs(str(tmp_path / "p"))
    want = _drive(lambda: JaxDriver(**base), how, str(tmp_path / "j"))
    got = _drive(lambda: StreamingAnalyticsDriver(device="cpu", **base),
                 how, str(tmp_path / "p"))
    assert got == want and "intern" in got


def test_per_window_rows_are_marked_apportioned():
    """A one-window call reports the JAX per-window path's steps, which
    the port ran as one chunk: the rows that share its seconds say so,
    and the measured rows do not."""
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 300, 3 * EB), rng.integers(0, 300, 3 * EB)
    drv = StreamingAnalyticsDriver(window_ms=0, edge_bucket=EB,
                                   vertex_bucket=VB, tracing=True,
                                   snapshot_tier="scan", device="cpu")
    drv.run_arrays(src, dst)                      # batched: measured
    assert not any("apportioned" in r for r in drv.trace_report())
    drv.run_arrays(src[:EB], dst[:EB])            # one window
    rows = {r["op"]: r for r in drv.trace_report()}
    for step in ("degrees", "cc", "bipartite"):
        assert rows[step]["apportioned"] is True
    assert "apportioned" not in rows["intern"]
    assert "apportioned" not in rows["triangles"]


def test_untraced_driver_reports_nothing():
    drv = StreamingAnalyticsDriver(window_ms=0, device="cpu")
    drv.run_arrays(np.arange(10), np.arange(1, 11))
    assert drv.trace_report() == [] and drv.timer is None


# ----------------------------------------------------------------------
# (h) trace_report parity: the graph API
# ----------------------------------------------------------------------
def _api_edges(n=600, seed=3):
    rng = np.random.default_rng(seed)
    s, d = rng.integers(0, 50, n), rng.integers(0, 50, n)
    return [(int(a), int(b), int(t)) for a, b, t in
            zip(s, d, np.arange(n) * 3)]


def _api_job(pkg, env, job):
    edges = _api_edges()
    stream = env.from_collection([pkg.Edge(*e) for e in edges])
    g = pkg.SimpleEdgeStream(
        stream, env, timestamp_extractor=pkg.AscendingTimestampExtractor(
            lambda e: e.value))
    if job == "degrees":
        out = g.get_degrees()
    elif job == "reduce":
        red = (P.TorchEdgesReduce(name="sum") if pkg is P
               else J.JaxEdgesReduce(name="sum"))
        out = g.slice(pkg.Time.milliseconds_of(200),
                      pkg.EdgeDirection.ALL).reduce_on_edges(red)
    else:
        out = g.filter_edges(lambda e: e.source != e.target) \
            .map_edges(lambda e: e.value % 7).get_vertices()
    out.collect()
    env.enable_tracing()
    env.execute()
    report = env.trace_report()
    ids = sorted({int(r["op"].split("#")[1]) for r in report})
    rank = {i: k for k, i in enumerate(ids)}
    return {re.sub(r"#\d+", "#%d" % rank[int(r["op"].split("#")[1])],
                   r["op"]): (r["calls"], r["records"]) for r in report}


@pytest.mark.parametrize("job", ["degrees", "reduce", "map_filter"])
def test_graph_api_trace_report_equals_jax(job):
    got = _api_job(P, P.StreamEnvironment(clock=P.ManualClock(0),
                                          device="cpu"), job)
    want = _api_job(J, J.StreamEnvironment(clock=J.ManualClock(0)), job)
    assert got == want and len(got) >= 2


def test_runtime_spans_and_marks(armed, monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    counts = {}
    for pkg, mmod, env in (
            (P, metrics, P.StreamEnvironment(clock=P.ManualClock(0),
                                             device="cpu")),
            (J, jax_metrics, J.StreamEnvironment(clock=J.ManualClock(0)))):
        mmod.reset()
        _api_job(pkg, env, "reduce")
        counts[pkg.__name__] = {k: v for k, v in mmod.counters().items()
                                if "runtime" in str(k)}
    assert counts["gelly_streaming_tpu_torch"] \
        == counts["gelly_streaming_tpu"]
    assert counts["gelly_streaming_tpu_torch"]
    ops = [r for r in telemetry.records() if r.get("t") == "span"
           and r["name"].startswith("op.")]
    assert {r["name"] for r in ops} >= {"op.source", "op.window_batch"}


# ----------------------------------------------------------------------
# WindowedEdgeReduce's spans
# ----------------------------------------------------------------------
def test_reduce_spans_per_tier(armed):
    rng = np.random.default_rng(5)
    n = 5 * 128 + 17
    src, dst = rng.integers(0, 200, n), rng.integers(0, 200, n)
    val = rng.integers(-50, 50, n).astype(np.int32)
    outs = {}
    for tier in ("device", "host", "native"):
        eng = WindowedEdgeReduce(256, 128, "sum", "out", tier=tier,
                                 device="cpu")
        outs[tier] = eng.process_stream(src, dst, val)
        if tier == "device":
            assert eng.stage_timers.snapshot()["chunks"] > 0
    slide = WindowedEdgeReduce(256, 128, "sum", "out", slide=32,
                               device="cpu")
    slide.process_stream(src, dst, val)
    for tier in ("host", "native"):
        assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                   for a, b in zip(outs[tier], outs["device"]))
    spans = [r for r in telemetry.records() if r.get("t") == "span"]
    streams = [r["a"]["tier"] for r in spans if r["name"] == "reduce.stream"]
    assert streams[:3] == ["device", "host", "native"]
    (sl,) = [r for r in spans if r["name"] == "reduce.sliding"]
    assert sl["a"]["edges"] == n and sl["a"]["slide"] == 32
