"""The summary engines' own spans on the dispatching thread, on the CPU.

- Under a torch.profiler capture (the recorder off), one
  `GnnSummaryEngine.process()` call exports `engine.call`, `engine.admit`,
  `engine.chunks` and, a chunk, `ingress.wait`, `ingress.dispatch` and
  `ingress.finalize` as `user_annotation` events nested in `engine.call`
  (the chunks' in `engine.chunks`): a 256-window call (four chunks, the
  pool's form) and an 8-window one (one chunk, the synchronous form).
- With no capture and the recorder off, a call makes no span object and
  enters no `record_function`, and its summaries and slab equal a
  captured run's bit for bit.
- With GS_TELEMETRY=1 the ring holds the spans with the call ordinal and
  the absolute window id, which a chunk's worker stages share.
- `device_trace`'s clock anchor: the `gs.clock_anchor` annotation in the
  exported trace, the recorder's clock reading in the durable
  `device_trace_captured` event, and one offset from it that maps the
  ring's spans onto the trace's timeline.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gelly_streaming_tpu_torch.ops.gnn_window import GnnSummaryEngine
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils import tracing

EB, VB, F = 64, 100, 8
MAX_W = 64          # the engine's windows a chunk
CHUNK_SPANS = ("ingress.wait", "ingress.dispatch", "ingress.finalize")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("GS_TELEMETRY", "GS_TRACE_DIR", "GS_METRICS", "GS_COSTMODEL",
              "GS_LATENCY", "GS_PROVENANCE", "GS_STREAM_PREFETCH",
              "GS_PIPELINE_WORKERS"):
        monkeypatch.delenv(k, raising=False)
    telemetry.reset()
    yield
    for m in (telemetry, metrics, costmodel):
        m.reset()


def _stream(windows: int, seed: int):
    rng = np.random.default_rng(seed)
    n = windows * EB
    return rng.integers(0, VB, n), rng.integers(0, VB, n)


def _engine():
    return GnnSummaryEngine(EB, VB, feature_dim=F, device="cpu")


def _annotations(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
            for e in events if e.get("cat") == "user_annotation"]


def _captured(tmp_path, eng, src, dst):
    """One process() call under a CPU capture: (summaries, annotations)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = eng.process(src, dst)
    finally:
        prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    return out, _annotations(path)


@pytest.mark.parametrize("windows", [256, 8])
def test_capture_holds_the_dispatching_threads_spans(tmp_path, windows):
    src, dst = _stream(windows, seed=windows)
    out, ann = _captured(tmp_path, _engine(), src, dst)
    assert len(out) == windows
    chunks = -(-windows // MAX_W)
    names = [n for n, _, _ in ann]
    for name in ("engine.call", "engine.admit", "engine.chunks"):
        assert names.count(name) == 1, name
    for name in CHUNK_SPANS:
        assert names.count(name) == chunks, name
    (_, c0, cdur), = [a for a in ann if a[0] == "engine.call"]
    for name, ts, dur in ann:
        if name != "engine.call":
            assert c0 <= ts and ts + dur <= c0 + cdur, name
    # admission ends before the chunk loop starts, which holds every
    # chunk's stages; each chunk's payload is in hand before its
    # dispatch starts
    (_, a0, adur), = [a for a in ann if a[0] == "engine.admit"]
    (_, l0, ldur), = [a for a in ann if a[0] == "engine.chunks"]
    assert a0 + adur <= l0
    for name, ts, dur in ann:
        if name in CHUNK_SPANS:
            assert l0 <= ts and ts + dur <= l0 + ldur, name
    waits = sorted(ts for n, ts, _ in ann if n == "ingress.wait")
    dispatches = sorted(ts for n, ts, _ in ann if n == "ingress.dispatch")
    assert all(w <= d for w, d in zip(waits, dispatches))


class _CountingRF(torch.profiler.record_function):
    made = 0

    def __init__(self, *args, **kwargs):
        _CountingRF.made += 1
        super().__init__(*args, **kwargs)


@pytest.mark.parametrize("windows", [256, 8])
def test_off_path_makes_no_span_and_changes_nothing(tmp_path, monkeypatch,
                                                    windows):
    made = []

    class _CountingSpan(telemetry._Span):
        def __init__(self, *args, **kwargs):
            made.append(args[0])
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(telemetry, "_Span", _CountingSpan)
    monkeypatch.setattr(torch.profiler, "record_function", _CountingRF)
    _CountingRF.made = 0
    src, dst = _stream(windows, seed=7)
    assert not telemetry.active() and not telemetry.profiling()
    eng = _engine()
    want = eng.process(src, dst)
    assert made == [] and _CountingRF.made == 0
    want_slab = eng.state()

    traced = _engine()
    got, ann = _captured(tmp_path, traced, src, dst)
    # the counters see the traced run: the off run's zeros are not blind
    assert _CountingRF.made == len(ann) > 0
    assert "engine.call" in made
    assert got == want
    np.testing.assert_array_equal(traced.state(), want_slab)


def test_ring_spans_carry_call_and_window_ids(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    telemetry.reset()
    eng = _engine()
    calls = [(1, 0, 256), (2, 256, 128)]    # ordinal, first window, windows
    for k, _, windows in calls:
        eng.process(*_stream(windows, seed=k))
    spans = [r for r in telemetry.records() if r["t"] == "span"]
    by_sid = {r["sid"]: r for r in spans}
    for k, first, windows in calls:
        (call,) = [r for r in spans if r["name"] == "engine.call"
                   and r["a"]["call"] == k]
        assert call["a"] == {"call": k, "window": first,
                             "windows": windows, "edges": windows * EB}
        (admit,) = [r for r in spans if r["name"] == "engine.admit"
                    and r["a"]["call"] == k]
        assert admit["a"] == {"call": k, "window": first}
        assert admit["par"] == call["sid"]
        (loop,) = [r for r in spans if r["name"] == "engine.chunks"
                   and r["a"]["call"] == k]
        assert loop["a"] == call["a"]
        assert loop["par"] == call["sid"]
        chunks = [r for r in spans if r["name"] == "ingress.chunk"
                  and r["a"]["call"] == k]
        assert sorted(r["a"]["window"] for r in chunks) == \
            list(range(first, first + windows, MAX_W))
        for ch in chunks:
            assert ch["par"] == loop["sid"]
            assert ch["a"]["window"] == first + ch["a"]["chunk"]
            stages = [r for r in spans if r.get("par") == ch["sid"]]
            assert sorted(r["name"] for r in stages) == sorted(
                ("ingress.prep", "ingress.h2d") + CHUNK_SPANS)
            for r in stages:
                # the pool's form: prep and h2d on a worker, the rest on
                # the dispatching thread
                assert (r["tid"] == call["tid"]) == (r["name"] in CHUNK_SPANS)
                assert r["a"]["call"] == k
                assert r["a"]["window"] == ch["a"]["window"]
                assert r["a"]["chunk"] == ch["a"]["chunk"]
    # every engine and pipeline span but the calls hangs in the tree
    assert all(r.get("par") in by_sid for r in spans
               if r["name"].startswith(("engine.", "ingress."))
               and r["name"] != "engine.call")


def test_device_trace_clock_anchor(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / "ledger"))
    telemetry.reset()
    before = telemetry.clock()
    with tracing.device_trace(str(tmp_path / "prof")) as cap:
        after = telemetry.clock()
        _engine().process(*_stream(8, seed=3))
    (ev,) = [r for r in telemetry.records()
             if r["t"] == "event" and r["name"] == "device_trace_captured"]
    anchor = ev["a"]["clock_anchor"]
    assert before <= anchor <= after
    ann = _annotations(cap.path)
    (_, anchor_ts, _), = [a for a in ann if a[0] == "gs.clock_anchor"]
    # one offset maps the ring's spans (on the recorder's clock) onto the
    # trace's timeline
    offset_us = anchor_ts - anchor * 1e6
    (call,) = [r for r in telemetry.records() if r["t"] == "span"
               and r["name"] == "engine.call"]
    (_, call_ts, _), = [a for a in ann if a[0] == "engine.call"]
    assert abs(call["ts"] * 1e6 + offset_us - call_ts) < 20e3
