"""The host API the port took last from the JAX package, held to its JAX
counterpart: `telemetry.summary` and `telemetry.stopwatch`,
`latency.percentile_fields`, the ingress pipeline's knobs
(GS_PIPELINE_WORKERS, GS_PIPELINE_INFLIGHT, GS_STREAM_PREFETCH) and
`pipeline_enabled`, the egress knobs (GS_EGRESS, GS_EGRESS_CAP),
`metrics.sample_memory` and `native.triangles_available` /
`snapshot_available`."""

import threading

import numpy as np
import pytest
import torch

from gelly_streaming_tpu import native as jax_native
from gelly_streaming_tpu.ops import ingress_pipeline as jax_pipeline
from gelly_streaming_tpu.utils import knobs as jax_knobs
from gelly_streaming_tpu.utils import latency as jax_latency
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu_torch import TriangleWindowKernel, native
from gelly_streaming_tpu_torch.ops import ingress_pipeline
from gelly_streaming_tpu_torch.utils import knobs
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils.streams import make_stream

NEW_KNOBS = ("GS_PIPELINE_WORKERS", "GS_PIPELINE_INFLIGHT",
             "GS_STREAM_PREFETCH", "GS_EGRESS", "GS_EGRESS_CAP")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in NEW_KNOBS + ("GS_TELEMETRY", "GS_TRACE_DIR", "GS_LATENCY"):
        monkeypatch.delenv(name, raising=False)
    for mod in (telemetry, jax_telemetry, latency, jax_latency):
        mod.reset()
    yield
    for mod in (telemetry, jax_telemetry, latency, jax_latency):
        mod.reset()


SPANS = [("ingress.prep", 0.004), ("ingress.h2d", 0.001),
         ("ingress.prep", 0.002), ("triangles.round", 0.030),
         ("ingress.prep", 0.009), ("ingress.h2d", 0.003)]


@pytest.mark.parametrize("top", [0, 1, 2, 5])
def test_summary_rows_equal_jax(monkeypatch, top):
    """The same spans in both recorders give the same summary rows: by
    record_span (durations given, so the times agree too) and by live
    spans (counts and order of names; the times are each clock's)."""
    monkeypatch.setenv("GS_TELEMETRY", "1")
    for mod in (telemetry, jax_telemetry):
        for name, dur in SPANS:
            mod.record_span(name, 0.0, dur)
    assert telemetry.summary(top) == jax_telemetry.summary(top)
    assert [r["span"] for r in telemetry.summary()] == [
        "triangles.round", "ingress.prep", "ingress.h2d"]
    for mod in (telemetry, jax_telemetry):
        mod.reset()
        for name, _dur in SPANS:
            with mod.span(name):
                pass
    mine, theirs = telemetry.summary(top), jax_telemetry.summary(top)
    assert sorted((r["span"], r["count"]) for r in mine) == sorted(
        (r["span"], r["count"]) for r in theirs)
    assert set(mine[0]) == set(theirs[0]) == {
        "span", "count", "total_ms", "p50_ms", "p95_ms", "p99_ms"}


def test_summary_reservoir_is_bounded(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    n = telemetry._SAMPLE_CAP + 10
    for mod in (telemetry, jax_telemetry):
        for i in range(n):
            mod.record_span("x", 0.0, i * 1e-3)
    assert telemetry._SAMPLE_CAP == jax_telemetry._SAMPLE_CAP
    (row,) = telemetry.summary()
    assert row == jax_telemetry.summary()[0]
    assert row["count"] == n
    assert len(telemetry._rec().agg["x"]["samples"]) == telemetry._SAMPLE_CAP


def test_stopwatch_records_once_and_only_when_stopped(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    sw = telemetry.stopwatch("reduce.stream", tier="native", edges=5)
    dropped = telemetry.stopwatch("reduce.stream", tier="host")
    assert telemetry.summary() == []          # nothing until stopped
    first = sw.stop(extra=1)
    assert first >= 0.0 and sw.stop() == first == sw.stop(extra=2)
    spans = [r for r in telemetry.records() if r["t"] == "span"]
    assert len(spans) == 1 and spans[0]["name"] == "reduce.stream"
    assert spans[0]["a"] == {"tier": "native", "edges": 5, "extra": 1}
    assert telemetry.summary()[0]["count"] == 1
    del dropped                                # never stopped: no record
    assert telemetry.summary()[0]["count"] == 1
    bare = telemetry.stopwatch()               # no name: a bare timer
    assert bare.stop() >= 0.0
    assert len([r for r in telemetry.records() if r["t"] == "span"]) == 1
    # the same record shape in the JAX recorder
    jsw = jax_telemetry.stopwatch("reduce.stream", tier="native", edges=5)
    jsw.stop(extra=1)
    (jspan,) = [r for r in jax_telemetry.records() if r["t"] == "span"]
    assert set(jspan) == set(spans[0]) and jspan["a"] == spans[0]["a"]


def test_stopwatch_disarmed_is_a_timer():
    sw = telemetry.stopwatch("x")
    assert sw.stop() >= 0.0
    assert telemetry.records() == [] and telemetry.summary() == []


@pytest.mark.parametrize("lanes", [
    {}, {"a": [0.5]}, {"a": [0.1, 0.3, 0.2], "b": [0.05, 0.9]},
    {"t%d" % i: list(np.random.default_rng(i).random(40))
     for i in range(5)}])
@pytest.mark.parametrize("prefix", ["e2e", "tenant"])
def test_percentile_fields_equal_jax(lanes, prefix):
    for mod in (latency, jax_latency):
        plane = mod._plane()
        for name, samples in lanes.items():
            plane.lane(name).e2e.extend(samples)
    got = latency.percentile_fields(prefix)
    assert got == jax_latency.percentile_fields(prefix)
    if lanes:
        assert sorted(got) == ["%s_p%d_s" % (prefix, q)
                               for q in (50, 95, 99)]
    else:
        assert got == {}


@pytest.mark.parametrize("name,raw", [
    ("GS_PIPELINE_WORKERS", None), ("GS_PIPELINE_WORKERS", "0"),
    ("GS_PIPELINE_WORKERS", "3"), ("GS_PIPELINE_WORKERS", "-2"),
    ("GS_PIPELINE_INFLIGHT", None), ("GS_PIPELINE_INFLIGHT", "0"),
    ("GS_PIPELINE_INFLIGHT", "6"), ("GS_STREAM_PREFETCH", None),
    ("GS_STREAM_PREFETCH", "0"), ("GS_STREAM_PREFETCH", "yes"),
    ("GS_EGRESS", None), ("GS_EGRESS", "delta"), ("GS_EGRESS", "auto"),
    ("GS_EGRESS_CAP", None), ("GS_EGRESS_CAP", "0"),
    ("GS_EGRESS_CAP", "512")])
def test_new_knobs_read_and_resolve_as_jax(monkeypatch, name, raw):
    if raw is not None:
        monkeypatch.setenv(name, raw)
    get = {"int": "get_int", "bool": "get_bool",
           "str": "get_str"}[knobs.REGISTRY[name].kind]
    assert getattr(knobs, get)(name) == getattr(jax_knobs, get)(name)
    assert ingress_pipeline.worker_count() == jax_pipeline.worker_count()
    assert ingress_pipeline.inflight_limit() == \
        jax_pipeline.inflight_limit()
    assert ingress_pipeline.pipeline_enabled() == \
        jax_pipeline.pipeline_enabled()


@pytest.mark.parametrize("name,raw", [
    ("GS_PIPELINE_WORKERS", "four"), ("GS_PIPELINE_INFLIGHT", "2.5"),
    ("GS_STREAM_PREFETCH", "maybe"), ("GS_EGRESS", "compact"),
    ("GS_EGRESS_CAP", "lots")])
def test_new_knobs_refuse_as_jax(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    get = {"int": "get_int", "bool": "get_bool",
           "str": "get_str"}[knobs.REGISTRY[name].kind]
    with pytest.raises(knobs.KnobError, match=name):
        getattr(knobs, get)(name)
    with pytest.raises(jax_knobs.KnobError, match=name):
        getattr(jax_knobs, get)(name)


def test_pipeline_enabled_follows_the_sync_levers(monkeypatch):
    """pipeline_enabled() is False under forced_sync, GS_STREAM_PREFETCH=0
    and GS_PIPELINE_WORKERS=0, as in JAX; the stream tiers give the same
    counts either way, and the pool is None where it is off."""
    src, dst = make_stream(8 * 128, 200, seed=5)
    tiers = ["device", "host"] + (["native"] if native.available() else [])
    kernels = {t: TriangleWindowKernel(128, 256, device="cpu",
                                       stream_tier=t) for t in tiers}
    kernels["device"].MAX_STREAM_WINDOWS = 2
    want = kernels["host"].count_stream(src, dst)
    assert ingress_pipeline.pipeline_enabled() is True
    for lever in ("forced_sync", "GS_STREAM_PREFETCH", "GS_PIPELINE_WORKERS"):
        with pytest.MonkeyPatch.context() as mp:
            if lever == "forced_sync":
                ctx, jctx = (ingress_pipeline.forced_sync(),
                             jax_pipeline.forced_sync())
            else:
                mp.setenv(lever, "0")
                ctx = jctx = None
            if ctx is not None:
                ctx.__enter__()
                jctx.__enter__()
            try:
                assert ingress_pipeline.pipeline_enabled() is False
                assert jax_pipeline.pipeline_enabled() is False
                assert ingress_pipeline.prep_pool() is None
                for k in kernels.values():
                    assert k.count_stream(src, dst) == want
            finally:
                if ctx is not None:
                    ctx.__exit__(None, None, None)
                    jctx.__exit__(None, None, None)
    assert ingress_pipeline.pipeline_enabled() is True
    for k in kernels.values():
        assert k.count_stream(src, dst) == want


@pytest.mark.parametrize("knob, arg, most", [
    ("1", None, 2), ("1", 3, 2), ("6", 2, 3), (None, 6, 4)])
def test_run_pipeline_knob_narrows_the_argument(monkeypatch, knob, arg,
                                                most):
    """GS_PIPELINE_INFLIGHT is the look-ahead where no `inflight=` is
    given and narrows one that is (the JAX twin's min(inflight,
    inflight_limit())): at look-ahead L, L + 1 chunks are copied ahead
    of the first dispatch and never more; results are the same at every
    depth."""
    if knob is None:
        monkeypatch.delenv("GS_PIPELINE_INFLIGHT", raising=False)
    else:
        monkeypatch.setenv("GS_PIPELINE_INFLIGHT", knob)
    monkeypatch.setenv("GS_PIPELINE_WORKERS", "4")
    lock, filled = threading.Lock(), threading.Event()
    live, peak, first = [0], [0], [True]

    def h2d(x):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            if live[0] >= most:
                filled.set()
        return x

    def dispatch(x):
        if first[0]:    # let the look-ahead fill before the first dispatch
            first[0] = False
            filled.wait(5.0)
        with lock:
            live[0] -= 1
        return x

    out = []
    ingress_pipeline.run_pipeline(range(12), lambda x: x, h2d, dispatch,
                                  out.append,
                                  **({} if arg is None else {"inflight": arg}))
    assert out == list(range(12))
    assert peak[0] == most


def test_sample_memory_keeps_its_keys_on_the_cpu(monkeypatch):
    got, want = metrics.sample_memory(), jax_metrics.sample_memory()
    assert set(got) == set(want) == {"live_buffers", "live_buffer_bytes",
                                     "devices"}
    if not torch.cuda.is_available():
        assert got == {"live_buffers": None, "live_buffer_bytes": None,
                       "devices": []}
    monkeypatch.setenv("GS_METRICS", "1")
    metrics.reset()
    try:
        assert set(metrics.sample_memory()) == set(want)
    finally:
        metrics.reset()


def test_native_availability_equals_jax():
    assert native.triangles_available() == jax_native.triangles_available()
    assert native.snapshot_available() == jax_native.snapshot_available()
    assert native.triangles_available() == native.available()
    assert native.snapshot_available() == native.available()
