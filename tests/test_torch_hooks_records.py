"""The port's latency plane, provenance ledger and cost observatory
(gelly_streaming_tpu_torch/utils/latency.py, provenance.py, costmodel.py)
against the JAX package's, on the cases of tests/test_latency.py,
tests/test_provenance.py and tests/test_costmodel.py.

Latency and provenance records of the port's engines equal the JAX
engines' on the same stream in their keys and in every value but the
times (latency) and the knob fingerprint (provenance: each package
fingerprints its own registry). The cost observatory's rows are the
port's own (analytic bytes and operations per launch wrapper call, the
card's peaks): held against the work formulas, with the report ordered
by recorded durations (no real sleeps)."""

import glob
import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import gnn_window as jax_gnn
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.utils import latency as jax_latency
from gelly_streaming_tpu.utils import provenance as jax_prov
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch.ops.gnn_window import GnnSummaryEngine
from gelly_streaming_tpu_torch.ops.resident_engine import \
    ResidentSummaryEngine
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import provenance

_KNOBS = ("GS_LATENCY", "GS_LAT_MARKS", "GS_LAT_PENDING", "GS_SLO_P99_S",
          "GS_SLO_BUDGET", "GS_SLO_WINDOW_S", "GS_SLO_BURN",
          "GS_PROVENANCE", "GS_PROVENANCE_DIR", "GS_PROVENANCE_RETAIN",
          "GS_WAL_SEGMENT_BYTES", "GS_COSTMODEL", "GS_METRICS",
          "GS_METRICS_SERIES", "GS_TELEMETRY")
LAT = {"jax": jax_latency, "torch": latency}
PROV = {"jax": jax_prov, "torch": provenance}
EB, VB = 64, 128


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    for m in list(LAT.values()) + list(PROV.values()) + [costmodel]:
        m.reset()
    yield
    for m in list(LAT.values()) + list(PROV.values()) + [costmodel]:
        m.reset()
    torch.set_num_threads(threads)


def _edges(n, v=VB, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


def _untimed(rec):
    """A latency record's keys and values but its times."""
    out = {k: v for k, v in rec.items()
           if k not in ("t_admit", "t_done", "e2e_s")}
    out["stages"] = sorted(rec["stages"])
    return out


# ----------------------------------------------------------------------
# latency
# ----------------------------------------------------------------------
def test_latency_disarmed_is_inert():
    latency.on_admit("t", 10)
    assert latency.on_window("t", edges=10) is None
    assert latency.stamps() is None and latency.recent() == []
    assert latency.health_section() == {"enabled": False}


@pytest.mark.parametrize("name", sorted(LAT))
def test_latency_plane_cases(monkeypatch, name):
    """Waterfall sums, joins to the completing batch, queue age,
    deferral and settle, the mark bound, and replayed marks."""
    monkeypatch.setenv("GS_LATENCY", "1")
    lat = LAT[name]
    t0 = lat.clock()
    lat.on_admit("t", 100, t0=t0)
    st = lat.stamps()
    for key in ("start", "prep", "h2d", "dispatch"):
        lat.stamp(st, key)
    rec = lat.on_window("t", edges=100, st=st, ordinal=0)
    assert set(rec["stages"]) == {"admission", "queue_wait", "prep",
                                  "h2d", "dispatch", "finalize"}
    assert lat.reconcile(rec)[0]
    t1, t2 = lat.clock() - 1.0, lat.clock() - 0.2
    lat.on_admit("u", 6, t0=t1, t1=t1)
    lat.on_admit("u", 4, t0=t2, t1=t2)
    assert lat.queue_age("u") == pytest.approx(1.0, abs=0.2)
    w1, w2 = lat.on_window("u", edges=5), lat.on_window("u", edges=5)
    assert w1["e2e_s"] > 0.9 > w2["e2e_s"]
    assert lat.queue_age("u") is None
    lat.on_admit("v", 10)
    rec = lat.on_window("v", edges=10, ordinal=7, defer=True)
    assert lat.delivered("v", 7) is rec and lat.delivered("v", 7) is None
    lat.on_admit("v", 5)
    lat.on_window("v", edges=5, ordinal=8, defer=True)
    assert lat.settle() == 1
    old = lat.clock() - 3.0
    lat.on_replay("w", 10, np.array([int(old * 1e9)] * 10))
    rec = lat.on_window("w", edges=10)
    assert rec["replayed"] and rec["e2e_s"] == pytest.approx(3.0, abs=0.2)
    monkeypatch.setenv("GS_LAT_MARKS", "16")
    lat.reset()
    for _ in range(100):
        lat.on_admit("t", 1)
    assert lat.on_window("t", edges=1).get("approx") is True


def test_admit_ns_is_the_perf_counter_ns_clock():
    a = latency.admit_ns()
    b = int(latency.clock() * 1e9)
    assert isinstance(a, int) and 0 <= b - a < 10 ** 9
    assert latency.admit_ns(1.5) == jax_latency.admit_ns(1.5)


def test_slo_burn_matches_jax(monkeypatch):
    monkeypatch.setenv("GS_LATENCY", "1")
    monkeypatch.setenv("GS_SLO_P99_S", "0.5")
    monkeypatch.setenv("GS_SLO_BUDGET", "0.1")
    out = {}
    for name, lat in LAT.items():
        lat.reset()
        for i in range(20):
            t = lat.clock() - (1.0 if i % 2 else 0.0)
            lat.on_admit("t", 1, t0=t, t1=t)
            lat.on_window("t", edges=1)
        sec = lat.health_section()
        out[name] = (sec["status"], sec["slo"]["windows"],
                     sec["slo"]["bad"], sorted(sec["tenants"]))
    assert out["torch"] == out["jax"] and out["torch"][0] == "degraded"


def _engine_pair(kind):
    if kind == "summary":
        return (StreamSummaryEngine(EB, VB, k_bucket=16, device="cpu"),
                jax_scan.StreamSummaryEngine(EB, VB, k_bucket=16,
                                             ingress="standard"))
    return (GnnSummaryEngine(EB, VB, feature_dim=8, device="cpu"),
            jax_gnn.GnnSummaryEngine(EB, VB, feature_dim=8))


@pytest.mark.parametrize("kind", ["summary", "gnn"])
def test_engine_latency_records_match_jax(monkeypatch, kind):
    monkeypatch.setenv("GS_LATENCY", "1")
    src, dst = _edges(70 * EB + 9)
    port, jeng = _engine_pair(kind)
    recs = {}
    for name, eng in (("torch", port), ("jax", jeng)):
        LAT[name].reset()
        eng.process(src, dst)
        recs[name] = LAT[name].recent()
        assert all(LAT[name].reconcile(r)[0] for r in recs[name])
    assert len(recs["torch"]) == 71
    assert [_untimed(r) for r in recs["torch"]] == \
        [_untimed(r) for r in recs["jax"]]


def test_journal_ts_column_only_when_armed(monkeypatch, tmp_path):
    from gelly_streaming_tpu_torch.utils import wal

    src, dst = _edges(3 * EB)
    for armed in ("0", "1"):
        monkeypatch.setenv("GS_LATENCY", armed)
        eng = StreamSummaryEngine(EB, VB, device="cpu")
        eng.enable_wal(str(tmp_path / armed))
        eng.process(src, dst)
        eng._wal.close()
        (_t, _s, _a, _b, ts), = wal.replay(eng._wal_dir)
        assert (ts is None) == (armed == "0")
        if ts is not None:
            assert len(set(ts.tolist())) == 1


# ----------------------------------------------------------------------
# provenance
# ----------------------------------------------------------------------
def _prov_records(d):
    return provenance.scan(d)["records"]


def test_provenance_disarmed_is_inert(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "p"))
    assert not provenance.armed()
    StreamSummaryEngine(EB, VB, device="cpu").process(*_edges(2 * EB))
    provenance.emit(tenant="t", window=0, wal_lo=0, wal_hi=1, tier="x",
                    program="x", summary={})
    assert not os.path.exists(tmp_path / "p")


@pytest.mark.parametrize("name", sorted(PROV))
def test_provenance_ledger_cases(monkeypatch, tmp_path, name):
    """Framing, rotation with retention, a torn tail tolerated and cut
    on reopen, damage mid-ledger typed."""
    prov = PROV[name]
    d = str(tmp_path / "p")
    monkeypatch.setenv("GS_PROVENANCE", "1")
    monkeypatch.setenv("GS_PROVENANCE_DIR", d)
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    monkeypatch.setenv("GS_PROVENANCE_RETAIN", "2")
    for w in range(64):
        prov.emit(tenant="t", window=w, wal_lo=w * EB, wal_hi=(w + 1) * EB,
                  tier="fused_scan", program="fused_scan",
                  summary={"triangles": w})
    segs = sorted(glob.glob(os.path.join(d, "prov_*.seg")))
    assert 1 < len(segs) <= 3
    got = prov.scan(d)
    assert got["torn"] is None and got["records"][-1]["window"] == 63
    prov.reset()
    with open(segs[-1], "ab") as f:
        f.write(b"\x01\x02\x03")
    assert prov.scan(d)["torn"] is not None
    prov.ProvenanceLedger(d).close()
    assert prov.scan(d)["torn"] is None
    data = bytearray(open(segs[-2], "rb").read())
    data[12] ^= 0xFF
    open(segs[-2], "wb").write(bytes(data))
    with pytest.raises(prov.ProvenanceCorrupt):
        prov.scan(d)


def test_digest_and_fingerprint(monkeypatch, tmp_path):
    s = {"max_degree": 3, "num_components": np.int64(5),
         "odd_cycle": False, "triangles": 0}
    assert provenance.summary_digest(s) == jax_prov.summary_digest(s)
    fp = provenance.knob_fingerprint()
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path))
    assert provenance.knob_fingerprint() == fp          # a path knob
    monkeypatch.setenv("GS_SANITIZE", "on")
    assert provenance.knob_fingerprint() != fp


@pytest.mark.parametrize("kind", ["summary", "gnn"])
def test_engine_provenance_records_match_jax(monkeypatch, tmp_path, kind):
    monkeypatch.setenv("GS_PROVENANCE", "1")
    src, dst = _edges(40 * EB + 3, seed=2)
    port, jeng = _engine_pair(kind)
    recs = {}
    for name, eng in (("torch", port), ("jax", jeng)):
        monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / name))
        PROV[name].reset()
        out = eng.process(src, dst)
        PROV[name].reset()
        recs[name] = PROV[name].scan(str(tmp_path / name))["records"]
        assert [r["digest"] for r in recs[name]] == \
            [PROV[name].summary_digest(o) for o in out]
    strip = [{k: v for k, v in r.items() if k != "knobs"}
             for r in recs["torch"]]
    assert len(strip) == 41
    assert strip == [{k: v for k, v in r.items() if k != "knobs"}
                     for r in recs["jax"]]
    assert recs["torch"][-1]["wal_hi"] == len(src)


def test_kill_replay_reemits_identical_provenance(monkeypatch, tmp_path):
    """A journal replay after a kill re-emits byte-identical payloads
    for the replayed windows (on the resident engine)."""
    monkeypatch.setenv("GS_PROVENANCE", "1")
    src, dst = _edges(32 * 32, v=64, seed=3)

    def make():
        return ResidentSummaryEngine(32, 64, device="cpu", superbatch=8)

    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "ref"))
    make().process(src, dst)
    provenance.reset()
    ref = [provenance._encode_payload(r)
           for r in provenance.scan(str(tmp_path / "ref"))["records"]]
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "run"))
    eng = make()
    eng.enable_wal(str(tmp_path / "wal"))
    ck = str(tmp_path / "ck")
    eng.process(src[:16 * 32], dst[:16 * 32])
    from gelly_streaming_tpu_torch.utils import checkpoint
    checkpoint.save(ck, eng.state_dict())
    with faults.inject(faults.FaultSpec(site="h2d", on_call=2,
                                        fatal=True)):
        with pytest.raises(faults.InjectedFault):
            eng.process(src[16 * 32:], dst[16 * 32:])
    rec = make()
    rec.enable_wal(str(tmp_path / "wal"))
    rec.resume_and_replay(ck)
    provenance.reset()
    got = [provenance._encode_payload(r)
           for r in provenance.scan(str(tmp_path / "run"))["records"]]
    assert sorted(set(got)) == sorted(set(ref)) and got[-16:] == ref[16:]


# ----------------------------------------------------------------------
# the cost observatory
# ----------------------------------------------------------------------
def test_sig_rendering_matches_jax():
    from gelly_streaming_tpu.utils import costmodel as jax_cm
    from gelly_streaming_tpu_torch.utils import metrics

    args = (np.zeros((4, 8), np.int32), [np.zeros(3, bool)], {"k": 2})
    assert costmodel.sig_key(metrics.abstract_sig(args)) == \
        jax_cm.sig_key(jax_cm_sig(args))
    t = torch.zeros(64, 32768, dtype=torch.int32)
    assert costmodel.tensor_sig((t,)) == "i32[64,32768]"
    assert costmodel.sig_key(metrics.abstract_sig((t,))) == \
        "i32[64,32768]"


def jax_cm_sig(args):
    from gelly_streaming_tpu.utils import metrics as jax_metrics

    return jax_metrics.abstract_sig(args)


def test_work_and_bound_formulas():
    """The per-call counts (what chip_smoke.py's kernels line computes
    its bound from) and the card's roofline."""
    assert costmodel.counter_work(64, 32768) == (
        64 * 32768 * 9 + 64 * 8, 64 * 32768, "scalar")
    assert costmodel.counter_work(64, 32768, "compact", 7)[:2] == (
        64 * 32768 * 4 + 64 * 4 + 64 * 8, 64 * 32768 + 7)
    nb, ops, kind = costmodel.summary_work(64, 32768, 65536)
    assert nb == 64 * 32768 * 9 + 32 * 65537 + 20 * 64
    assert ops == 3 * 65537 + 64 * 32768 and kind == "scalar"
    nb, ops, kind = costmodel.gnn_work(64, 32768, 65536, 64)
    assert kind == "fp16_tc" and ops == 64 * 2 * 65537 * 64 * 64
    ms, by = costmodel.bound(3.35e9, 1.0)
    assert (ms, by) == (1.0, "bytes")
    ms, by = costmodel.bound(1.0, 989e9, "fp16_tc")
    assert by == "operations" and ms == pytest.approx(1.0)
    row = costmodel.classify({"flops": 64 * 32768, "bytes_accessed":
                              64 * 32768 * 9, "kind": "scalar",
                              "card": costmodel.H100})
    assert row["bound"] == "bytes" and row["bound_by"] == "bytes"
    assert row["bound_ms"] == costmodel.bound(64 * 32768 * 9,
                                              64 * 32768)[0]
    assert costmodel.classify({"flops": 1, "bytes_accessed": 1,
                               "card": None})["bound"] == "unknown"


def test_disarmed_observatory_records_nothing():
    StreamSummaryEngine(EB, VB, device="cpu").process(*_edges(3 * EB))
    assert costmodel.report() == []
    assert costmodel.launch("x", (), None, "cpu").__class__.__name__ \
        == "_NoScope"


@pytest.mark.parametrize("wire", ["standard", "compact"])
def test_armed_engine_rows(monkeypatch, wire):
    """Armed, each summary call is one launch of its wrapper's row (its
    nested counter records nothing of its own), keyed by the carry and
    stack shapes, its stated work `summary_work`'s; on the CPU the time
    is the host clock's and the bound unknown."""
    monkeypatch.setenv("GS_COSTMODEL", "1")
    eng = StreamSummaryEngine(EB, VB, k_bucket=16, device="cpu",
                              ingress=wire)
    eng.process(*_edges(130 * EB))
    rows = costmodel.report()
    name = "window_summary" + ("_compact" if wire == "compact" else "")
    assert {r["program"] for r in rows} == {name}    # no counter rows
    stack = torch.int32 if wire == "standard" else torch.uint16
    r, = [r for r in rows if r["sig"] == costmodel.shape_sig(
        (torch.int32, (VB + 1,)), (stack, (64, EB)))]
    nb, ops, _k = costmodel.summary_work(64, EB, VB, wire)
    assert (r["bytes_accessed"], r["flops"]) == (nb, ops)
    assert r["dispatches"] == 2 and r["measured_total_s"] > 0
    assert r["bound"] == "unknown" and r["card"] is None
    gnn = GnnSummaryEngine(EB, VB, feature_dim=8, device="cpu")
    gnn.process(*_edges(64 * EB))
    g = {x["program"]: x for x in costmodel.report()}["gnn_round"]
    assert g["dispatches"] == 1 and g["kind"] == "fp16_tc"


def test_report_ordered_by_recorded_durations(monkeypatch):
    """Rows sort by measured total, then program and signature; the
    durations are recorded, not slept."""
    monkeypatch.setenv("GS_COSTMODEL", "1")
    reg = costmodel._reg()
    for prog, sig, total in (("b", "s1", 0.5), ("a", "s2", 2.0),
                             ("c", "s0", 0.5), ("d", "s3", 0.0)):
        costmodel.record_analytic(prog, sig, 10, 100)
        if total:
            costmodel._add_measure(reg, (prog, sig), total)
    got = [(r["program"], r["measured_total_s"])
           for r in costmodel.report()]
    assert got == [("a", 2.0), ("b", 0.5), ("c", 0.5), ("d", 0.0)]


def test_graph_capture_collects_outermost_work(monkeypatch):
    """A capture scope sums the work of each outermost wrapper call made
    inside it, armed or not (a replay's row then states it)."""
    from gelly_streaming_tpu_torch.ops.window_summary import WindowSummary
    from gelly_streaming_tpu_torch.ops.window_summary import fresh_carry

    summ = WindowSummary(VB, 16, torch.device("cpu"))
    s = torch.full((8, EB), VB, dtype=torch.int32)
    v = torch.zeros(8, EB, dtype=torch.bool)
    with costmodel.collect() as coll:
        summ(fresh_carry(VB, "cpu"), s, s, v)
        summ(fresh_carry(VB, "cpu"), s, s, v)
    nb, ops, kind = costmodel.summary_work(8, EB, VB)
    assert coll.work == [2 * nb, 2 * ops, kind]
    assert costmodel.report() == []
