"""The port's flight recorder, metrics registry and health endpoint
(gelly_streaming_tpu_torch/utils/telemetry.py, metrics.py, healthz.py)
against the JAX package's, on the cases of tests/test_telemetry.py and
tests/test_metrics.py: the same record kinds, span and event names and
fields, the same Prometheus text for the same marks, the same health
transitions, the shape watch's envelope, the sink's mapping of spans and
events, and the engines' marks and stage spans (metric names and counter
values equal to the JAX engine's on the same stream). `metrics.
attribute_dispatch` reconciles under the left-to-right summation it
defines. `/healthz` servers bind port 0."""

import functools
import json
import operator
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch import TriangleWindowKernel
from gelly_streaming_tpu_torch.ops import ingress_pipeline as ip
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import healthz
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import telemetry

PAIRS = {"jax": (jax_telemetry, jax_metrics), "torch": (telemetry, metrics)}
_KNOBS = ("GS_TELEMETRY", "GS_TRACE_DIR", "GS_TRACE_RING",
          "GS_TRACE_DURABLE", "GS_METRICS", "GS_METRICS_PORT",
          "GS_METRICS_SERIES", "GS_METRICS_COMPILE_BASE",
          "GS_HEALTH_STALE_S", "GS_COSTMODEL", "GS_LATENCY")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    for tel, met in PAIRS.values():
        tel.reset()
        met.reset()
    yield
    healthz.stop()
    for tel, met in PAIRS.values():
        tel.reset()
        met.reset()
    torch.set_num_threads(threads)


def _strip(rec):
    """A record without its times, ids and thread."""
    return {k: v for k, v in rec.items()
            if k not in ("ts", "dur", "sid", "par", "tid", "trace")}


# ----------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------
def _record_sequence(tel, faults_mod=None):
    with tel.context(chunk=3):
        with tel.span("outer", a=1):
            with tel.span("inner"):
                pass
        tel.event("resume", durable=True, component="engine")
        tel.counter("rounds", 2)
        tel.gauge("depth", 5.5)
    ctx = tel.chunk_ctx(7)
    t = threading.Thread(target=lambda: tel.record_span(
        "ingress.prep", tel.clock(), 0.001, parent=ctx["sid"], chunk=7))
    t.start()
    t.join()
    tel.close_chunk(ctx, windows=4)


def test_records_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    recs = {}
    for name, (tel, _met) in PAIRS.items():
        monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / name))
        tel.reset()
        _record_sequence(tel)
        recs[name] = tel.records()
        by = {r["name"]: r for r in recs[name]}
        assert by["inner"]["par"] == by["outer"]["sid"]
        assert by["ingress.prep"]["par"] == by["ingress.chunk"]["sid"]
        # the durable event reached the ledger at once
        lines = [json.loads(x) for x in open(tel.ledger_path())]
        assert [x["name"] for x in lines if x["t"] == "event"] == \
            ["resume"]
    assert [_strip(r) for r in recs["torch"]] == \
        [_strip(r) for r in recs["jax"]]


def test_disarmed_records_nothing_and_span_still_times():
    with telemetry.span("x") as sp:
        pass
    assert sp.elapsed >= 0.0
    telemetry.event("e", durable=True)
    assert telemetry.records() == [] and telemetry.chunk_ctx(1) is None
    assert not telemetry.active()


def test_ring_bound_and_fatal_flush(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_TRACE_RING", "16")
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path))
    telemetry.reset()
    for i in range(40):
        with telemetry.span("s%d" % i):
            pass
    assert len(telemetry.records()) == 16
    with faults.inject(faults.FaultSpec(site="prep", fatal=True)):
        with pytest.raises(faults.InjectedFault):
            faults.fire("prep")
    names = [json.loads(x)["name"] for x in open(telemetry.ledger_path())
             if '"t": "meta"' not in x]
    assert names[-1] == "fatal" or "fatal" in names
    assert "s39" in names and "fault_injected" in names


def test_percentiles_summary_and_chunk_key_match_jax():
    samples = [0.004, 0.001, 0.003, 0.002, 0.010]
    for ps in ((50, 95, 99), (1, 100)):
        assert telemetry.percentiles(samples, ps) == \
            jax_telemetry.percentiles(samples, ps)
    for item in (5, (6, "x"), "opaque", None):
        assert telemetry.chunk_key(item) == jax_telemetry.chunk_key(item)
    from gelly_streaming_tpu_torch.ops.autotune import Chunk
    assert telemetry.chunk_key(Chunk(3, 192, 256, {}, 0)) == 192


def test_pipeline_spans_match_jax(monkeypatch):
    """The pipeline's span tree: ingress.chunk parents prep, h2d,
    dispatch and finalize of its chunk, the names and chunk attributes
    the JAX pipeline records for the same items; the port's own
    ingress.wait, one a chunk, hangs under its chunk too."""
    monkeypatch.setenv("GS_TELEMETRY", "1")
    from gelly_streaming_tpu.ops import ingress_pipeline as jax_ip

    got = {}
    for name, pip in (("jax", jax_ip), ("torch", ip)):
        tel = PAIRS[name][0]
        tel.reset()
        pip.run_pipeline(range(3), lambda i: i, lambda p: p,
                         lambda d: d, lambda r: None)
        spans = [r for r in tel.records() if r["t"] == "span"]
        got[name] = sorted((r["name"], r["a"]["chunk"]) for r in spans)
        chunk_sid = {r["a"]["chunk"]: r["sid"] for r in spans
                     if r["name"] == "ingress.chunk"}
        for r in spans:
            if r["name"] != "ingress.chunk":
                assert r["par"] == chunk_sid[r["a"]["chunk"]]
    waits = [x for x in got["torch"] if x[0] == "ingress.wait"]
    assert waits == [("ingress.wait", c) for c in range(3)]
    assert [x for x in got["torch"] if x[0] != "ingress.wait"] == got["jax"]


# ----------------------------------------------------------------------
# the metrics registry
# ----------------------------------------------------------------------
def _marks(met, tel):
    met.counter_inc("gs_edges_total", 524288, engine="driver", tier="scan")
    met.counter_inc("gs_windows_finalized_total", 16, engine="driver",
                    tier="scan")
    met.gauge_set("gs_inflight_chunks", 3)
    for ms in (10, 20, 30, 40):
        met.observe("gs_stage_seconds", ms / 1e3, stage="prep")
    # through the telemetry sink: spans, events, counters, gauges
    tel.record_span("ingress.h2d", 0.0, 0.002)
    tel.record_span("fused_scan.round", 0.0, 0.5, edges=4096)
    tel.event("stage_retry", stage="h2d")
    tel.event("stage_failed", stage="prep")
    tel.event("checkpoint_saved", path="x")
    tel.event("something_else")
    tel.counter("rounds.done", 3)
    tel.gauge("ring.depth", 2)
    met.mark_window(4, 4096, engine="StreamSummaryEngine",
                    tier="fused_scan", tenant="t1", now=5.0)


@pytest.mark.parametrize("series", [64, 3])
def test_prometheus_text_matches_jax(monkeypatch, series):
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_METRICS_SERIES", str(series))
    text = {}
    for name, (tel, met) in PAIRS.items():
        met.reset()
        _marks(met, tel)
        for i in range(6):
            met.counter_inc("gs_edges_total", 1, tenant="t%d" % i)
        text[name] = met.render_prometheus()
        assert met.histogram("gs_stage_seconds", stage="prep")["p50"] \
            == 0.02
    assert text["torch"] == text["jax"]


def test_disarmed_registry_is_inert():
    metrics.counter_inc("gs_edges_total", 1)
    metrics.mark_window(1, 10)
    metrics.note_compile("f", ())
    assert metrics.counters() == {} and metrics.gauges() == {}
    assert metrics.health_snapshot()["windows_finalized"] == 0


def test_staleness_transitions_match_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_HEALTH_STALE_S", "5")
    monkeypatch.setenv("GS_TELEMETRY", "1")
    out = {}
    for name, (tel, met) in PAIRS.items():
        monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / name))
        tel.reset()
        met.reset()
        met.mark_window(1, 100, now=100.0)
        seq = [met.check_staleness(now=t) for t in (104.0, 106.0, 200.0)]
        met.mark_window(1, 100, now=201.0)
        snap = met.health_snapshot(now=202.0)
        names = [json.loads(x).get("name") for x in open(tel.ledger_path())]
        out[name] = (seq, snap["status"], snap["transitions"],
                     names.count("health_degraded"),
                     names.count("health_recovered"),
                     {k: snap[k] for k in ("windows_finalized",
                                           "edges_total", "engines",
                                           "tenants", "compiles")})
        for _i in range(100):
            met.mark_window(1, 1, now=1000.0 + 10 * _i)
            met.check_staleness(now=1000.0 + 10 * _i + 6)
        assert len(met._reg().transitions) <= 64
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == ["ok", "degraded", "degraded"]


def test_shape_watch_envelope_matches_jax(monkeypatch):
    """wrap_dispatch counts new shapes like the JAX wrap_jit counts
    compiles: doubling buckets stay inside the envelope, churn trips one
    durable recompile_storm; the signature memory is bounded."""
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_METRICS_COMPILE_BASE", "2")
    calls = []
    fn = metrics.wrap_dispatch("prog", lambda *a: calls.append(a) or 7)
    for n in (8, 16, 16, 32, 64):
        assert fn(np.zeros(n), torch.zeros(2, n)) == 7
    for n in (8, 16, 32, 64):
        jax_metrics.note_compile("prog", jax_metrics.abstract_sig(
            (np.zeros(n), np.zeros((2, n), np.float32))))
    assert metrics.compile_report()["prog"] == \
        jax_metrics.compile_report()["prog"]
    assert not metrics.compile_report()["prog"]["storm"]
    for n in range(3, 12):
        fn(np.zeros((n, 5)))
    assert metrics.compile_report()["prog"]["storm"]
    assert len(calls) == 14 and fn.__wrapped__ is not None


def test_broken_sink_dropped_with_a_scar(monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    armed = [True]

    def bad(_rec):
        raise ValueError("boom")

    telemetry.register_sink(bad, lambda: armed[0])
    telemetry.event("x")
    telemetry.event("y")
    assert metrics.counters()[("gs_metrics_sink_dropped_total", ())] == 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def test_healthz_endpoint_schema_and_codes(monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    metrics.mark_window(4, 4096, engine="driver", tier="scan")
    srv = healthz.start(port=0)
    base = "http://127.0.0.1:%d" % srv.port
    code, body, _h = _get(base + "/healthz")
    snap = json.loads(body)
    assert code == 200 and snap["status"] == "ok"
    want = jax_metrics.health_snapshot()
    assert set(snap) >= set(want) - {"serve"}
    assert "latency" in snap
    code, body, headers = _get(base + "/metrics")
    assert code == 200 and headers["Content-Type"].startswith("text/plain")
    assert "gs_windows_finalized_total" in body.decode()
    assert _get(base + "/nope")[0] == 404
    monkeypatch.setenv("GS_HEALTH_STALE_S", "0.000001")
    code, body, _h = _get(base + "/healthz")
    assert code == 503 and json.loads(body)["status"] == "degraded"
    assert healthz.maybe_start() is srv


def test_attribution_reconciles_left_to_right(monkeypatch):
    """attribute_dispatch's last nonzero row takes the residue of the
    left-to-right running sum: summed left to right (functools.reduce,
    not the compensated builtin sum of Python 3.12) the shares give the
    dispatch's seconds bit for bit; pad rows get zero."""
    monkeypatch.setenv("GS_METRICS", "1")
    rng = np.random.default_rng(0)
    for trial in range(50):
        rows = [("t%d" % i, int(n)) for i, n in
                enumerate(rng.integers(0, 1000, rng.integers(2, 40)))]
        rows.append(("pad", 0))
        seconds = float(rng.random() * 10.0 ** rng.integers(-6, 3))
        out = metrics.attribute_dispatch(seconds, rows)
        if sum(n for _t, n in rows) == 0:
            assert out is None
            continue
        shares = [s for _t, s, _b in out]
        assert functools.reduce(operator.add, shares, 0.0) == seconds
        assert out[-1][1] == 0.0 and len(out) == len(rows)
    monkeypatch.setenv("GS_METRICS", "0")
    assert metrics.attribute_dispatch(1.0, [("a", 1)]) is None


def test_attribution_shares_equal_jax(monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    rows = [("a", 3), ("b", 0), ("c", 7), ("d", 1)]
    assert metrics.attribute_dispatch(0.123, rows) == \
        jax_metrics.attribute_dispatch(0.123, rows)


# ----------------------------------------------------------------------
# the engines' marks against the JAX engines'
# ----------------------------------------------------------------------
def _stream(n, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


COMMON = ("gs_windows_finalized_total", "gs_edges_total",
          "gs_compiles_total", "gs_faults_injected_total",
          "gs_stage_retries_total")


def test_engine_metrics_match_jax(monkeypatch):
    """A summary stream and a triangle stream through both packages,
    armed: equal window and edge counters, equal stage-span counts, and
    the shape watch's count of the fused scan's shapes."""
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    monkeypatch.setenv("GS_STAGE_BACKOFF_S", "0")
    src, dst = _stream(200 * 32, 64, seed=1)
    port_s = StreamSummaryEngine(32, 64, k_bucket=16, device="cpu")
    jax_s = jax_scan.StreamSummaryEngine(32, 64, k_bucket=16,
                                         ingress="standard")
    port_t = TriangleWindowKernel(32, 64, k_bucket=16, device="cpu")
    jax_t = jax_tri.TriangleWindowKernel(32, 64, k_bucket=16)
    out = {}
    from gelly_streaming_tpu.utils import faults as jax_faults
    for name, s_eng, t_eng, fl in (("torch", port_s, port_t, faults),
                                   ("jax", jax_s, jax_t, jax_faults)):
        met = PAIRS[name][1]
        met.reset()
        with fl.inject(fl.FaultSpec(site="prep", on_call=2)):
            s_eng.process(src, dst)
        t_eng._count_stream_device(src, dst) if name == "jax" \
            else t_eng.count_stream(src, dst)
        if name == "jax":
            jax_metrics.mark_window(200, len(src),
                                    engine="triangle_stream",
                                    tier="device")
        c = met.counters()
        out[name] = {k: v for k, v in c.items() if k[0] in COMMON}
        h = met.histogram("gs_stage_seconds", stage="finalize")
        out[name]["finalize spans"] = h["count"]
    assert out["torch"] == out["jax"]
    assert out["torch"][("gs_windows_finalized_total",
                         (("engine", "StreamSummaryEngine"),
                          ("tier", "fused_scan")))] == 200
