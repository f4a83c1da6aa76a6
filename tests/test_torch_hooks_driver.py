"""The columnar driver's host hooks (gelly_streaming_tpu_torch/core/
driver.py) against the JAX driver's, on the CPU.

Admission (the metrics stream mark, the latency stamp, the `admit` fault
site, the sanitizer, the journal after validation and before the cut),
finalize (latency records on each WindowResult, a provenance record a
window with the JAX driver's `result_digest`, the metrics marks), the
journal (`enable_wal`, `seal_wal`, `resume_and_replay`, a journal
written by either package's driver replayed by the other's, retention at
flushed checkpoints, `stream_file` refused), `tenant=`, GS_SLIDE, every
hook armed against the disarmed pass, and the snapshot kernel's row of
the cost observatory (`costmodel.snapshot_work`)."""

import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.driver import \
    StreamingAnalyticsDriver as JaxDriver
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import latency as jax_latency
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import provenance as jax_provenance
from gelly_streaming_tpu.utils import sanitize as jax_sanitize
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch.ops import delta_egress
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils import wal

EB, VB = 256, 512
HOOK_KNOBS = ("GS_TELEMETRY", "GS_TRACE_DIR", "GS_METRICS", "GS_LATENCY",
              "GS_PROVENANCE", "GS_PROVENANCE_DIR", "GS_SANITIZE",
              "GS_DLQ_DIR", "GS_COSTMODEL", "GS_WAL", "GS_WAL_RETAIN",
              "GS_WAL_SEGMENT_BYTES", "GS_SLIDE", "GS_RESIDENT",
              "GS_STAGE_RETRIES", "GS_STAGE_TIMEOUT_S")
RESETS = (latency, metrics, provenance, sanitize, telemetry, costmodel,
          jax_latency, jax_metrics, jax_provenance, jax_sanitize,
          jax_telemetry)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in HOOK_KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    for m in RESETS:
        m.reset()
    yield
    for m in RESETS:
        m.reset()
    torch.set_num_threads(threads)


def _stream(n, seed=0, hi=VB - 12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, n).astype(np.int64),
            rng.integers(0, hi, n).astype(np.int64))


def _port(**kw):
    kw.setdefault("window_ms", 0)
    kw.setdefault("edge_bucket", EB)
    kw.setdefault("vertex_bucket", VB)
    kw.setdefault("snapshot_tier", "scan")
    return StreamingAnalyticsDriver(device="cpu", **kw)


def _jax(**kw):
    kw.setdefault("window_ms", 0)
    kw.setdefault("edge_bucket", EB)
    kw.setdefault("vertex_bucket", VB)
    kw.setdefault("snapshot_tier", "scan")
    return JaxDriver(**kw)


def _key(results):
    """Every analytic field of every window (latency left out: it is a
    clock reading)."""
    return [(r.window_start, r.num_edges, r.triangles,
             r.vertex_ids.tolist(),
             *(None if a is None else np.asarray(a).tolist() for a in (
                 r.degrees, r.cc_labels, r.bipartite_odd)),
             *(None if d is None else [x.tolist() for x in d] for d in (
                 r.delta_degrees, r.delta_cc, r.delta_bipartite)))
            for r in results]


def _segments(directory):
    return [open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))]


# ----------------------------------------------------------------------
# latency (tests/test_latency.py:262, :297)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("windows", [1, 4])
def test_window_records_attach_as_in_jax(monkeypatch, windows):
    monkeypatch.setenv("GS_LATENCY", "1")
    src, dst = _stream(windows * EB, seed=4)
    keys = {}
    for name, drv in (("jax", _jax(window_ms=1000)),
                      ("torch", _port(window_ms=1000))):
        results = drv.run_arrays(src, dst)
        assert len(results) == windows
        for res in results:
            assert res.latency is not None
            assert sum(res.latency["stages"].values()) == pytest.approx(
                res.latency["e2e_s"], abs=1e-9)
        keys[name] = [(sorted(r.latency), sorted(r.latency["stages"]),
                       r.latency["replayed"]) for r in results]
    assert keys["torch"] == keys["jax"]


def test_disarmed_driver_has_no_latency_field():
    src, dst = _stream(2 * EB, seed=6)
    for res in _port(window_ms=1000).run_arrays(src, dst):
        assert res.latency is None
    assert latency.recent() == []


# ----------------------------------------------------------------------
# provenance (tests/test_provenance.py:281) and the digests across
# packages
# ----------------------------------------------------------------------
def test_provenance_emits_and_rerun_ledger_is_identical(monkeypatch,
                                                        tmp_path):
    src, dst = _stream(2 * EB, seed=9)
    ledgers = []
    for run in ("a", "b"):
        d = str(tmp_path / ("prov_" + run))
        monkeypatch.setenv("GS_PROVENANCE", "1")
        monkeypatch.setenv("GS_PROVENANCE_DIR", d)
        provenance.reset()
        drv = _port(window_ms=1000, analytics=("degrees", "cc"))
        results = drv.run_arrays(src, dst)
        recs = provenance.scan(d)["records"]
        assert len(recs) == len(results) == 2
        for w, r in enumerate(recs):
            assert r["program"] == "driver" and r["window"] == w
            assert (r["wal_lo"], r["wal_hi"]) == (w * EB, (w + 1) * EB)
            assert r["digest"] == provenance.result_digest(results[w])
        ledgers.append(_segments(d))
        provenance.reset()
    assert ledgers[0] == ledgers[1]


FEEDS = {
    # case -> (driver kwargs, how _feed feeds it)
    "count_based": ({}, "calls"),
    "one_window_calls": ({}, "singles"),
    "event_time": ({"window_ms": 40}, "timed"),
    "sliding": ({"slide": EB // 4}, "calls"),
    "deltas": ({"emit_deltas": True, "egress": "delta"}, "calls"),
    "native": ({"snapshot_tier": "native"}, "calls"),
}


def _feed(drv, how, src, dst):
    out = []
    if how == "calls":
        for lo, hi in ((0, 5 * EB), (5 * EB, 6 * EB), (6 * EB, len(src))):
            out += drv.run_arrays(src[lo:hi], dst[lo:hi])
    elif how == "singles":
        for lo in range(0, 3 * EB, EB):
            out += drv.run_arrays(src[lo:lo + EB], dst[lo:lo + EB])
    else:
        ts = np.arange(len(src), dtype=np.int64) // 7
        half = len(src) // 2
        out += drv.run_arrays(src[:half], dst[:half], ts[:half])
        out += drv.run_arrays(src[half:], dst[half:], ts[half:])
    return out


@pytest.mark.parametrize("case", sorted(FEEDS))
def test_provenance_records_equal_jax(monkeypatch, tmp_path, case):
    """Each window's record, digest included, equals the JAX driver's
    in every field but `knobs` (each package fingerprints its own
    registry)."""
    kw, how = FEEDS[case]
    src, dst = _stream(9 * EB + 37, seed=11)
    monkeypatch.setenv("GS_PROVENANCE", "1")
    recs, keys = {}, {}
    for name, make, reset in (("jax", _jax, jax_provenance.reset),
                              ("torch", _port, provenance.reset)):
        d = str(tmp_path / name)
        monkeypatch.setenv("GS_PROVENANCE_DIR", d)
        reset()
        keys[name] = _key(_feed(make(tenant="acme", **kw), how, src, dst))
        reset()
        recs[name] = [{k: v for k, v in r.items() if k != "knobs"}
                      for r in jax_provenance.scan(d)["records"]]
    assert keys["torch"] == keys["jax"]
    assert recs["torch"] == recs["jax"] and len(recs["torch"]) > 2
    assert {r["tenant"] for r in recs["torch"]} == {"acme"}


# ----------------------------------------------------------------------
# the journal (tests/test_wal.py:374, :395) and recovery across packages
# ----------------------------------------------------------------------
def test_rejected_batch_leaves_no_journal_record(tmp_path):
    drv = _port(window_ms=100, edge_bucket=64, vertex_bucket=128)
    assert drv.enable_wal(str(tmp_path / "wal"))
    with pytest.raises(ValueError, match="ascending"):
        drv.run_arrays(np.array([1, 2]), np.array([3, 4]),
                       ts=np.array([500, 100]))
    assert wal.scan(str(tmp_path / "wal"))["records"] == 0
    drv.run_arrays(np.array([1, 2]), np.array([3, 4]),
                   ts=np.array([100, 500]))
    (_t, _s, _src, _dst, ts), = wal.replay(str(tmp_path / "wal"))
    np.testing.assert_array_equal(ts, [100, 500])


def test_stream_file_refused_on_journal_armed_driver(tmp_path):
    p = str(tmp_path / "edges.txt")
    with open(p, "w") as f:
        f.write("1 2\n")
    drv = _port(edge_bucket=64, vertex_bucket=128)
    assert drv.enable_wal(str(tmp_path / "wal"))
    with pytest.raises(ValueError, match="journal-armed"):
        list(drv.stream_file(p))
    drv.seal_wal()
    assert wal.scan(str(tmp_path / "wal"))["sealed"]


def test_journal_off_by_knob(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_WAL", "0")
    drv = _port()
    assert not drv.enable_wal(str(tmp_path / "wal"))
    assert drv.resume_and_replay(str(tmp_path / "none")) == []


def test_journal_bytes_equal_jax(tmp_path):
    """The same feeds journal the same bytes in both packages (the
    tenant label included)."""
    src, dst = _stream(6 * EB + 9, seed=2)
    for name, make in (("jax", _jax), ("torch", _port)):
        drv = make(tenant="t7")
        assert drv.enable_wal(str(tmp_path / name))
        _feed(drv, "calls", src, dst)
        drv.seal_wal()
    assert _segments(str(tmp_path / "torch")) \
        == _segments(str(tmp_path / "jax"))
    assert {r[0] for r in wal.replay(str(tmp_path / "torch"))} == {"t7"}


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_kill_recovers_across_packages(tmp_path, writer, reader):
    """A driver checkpointing at call boundaries is killed inside its
    third call, after the journal append (a fatal fault at
    `wal_enqueue`); a fresh driver of the other package recovers from
    checkpoint + journal the windows of the uninterrupted run."""
    makes = {"jax": _jax, "torch": _port}
    fmods = {"jax": jax_faults, "torch": faults}
    src, dst = _stream(12 * EB, seed=5)
    want = _key(_port().run_arrays(src, dst))
    ckpt, jdir = str(tmp_path / "ckpt"), str(tmp_path / "wal")
    drv = makes[writer]()
    assert drv.enable_wal(jdir)
    drv.enable_auto_checkpoint(ckpt, every_n_windows=4)
    got = drv.run_arrays(src[:4 * EB], dst[:4 * EB])
    got += drv.run_arrays(src[4 * EB:8 * EB], dst[4 * EB:8 * EB])
    fm = fmods[writer]
    with fm.inject(fm.FaultSpec(site="wal_enqueue", fatal=True)):
        with pytest.raises(fm.InjectedFault):
            drv.run_arrays(src[8 * EB:], dst[8 * EB:])
    drv._wal.close()
    assert _key(got) == want[:8]
    rec = makes[reader]()
    assert rec.enable_wal(jdir)
    lost = rec.resume_and_replay(ckpt)
    assert rec.windows_done == 12 and rec.edges_done == len(src)
    assert _key(lost) == want[8:]


def test_retention_moves_only_at_flushed_checkpoints(monkeypatch,
                                                     tmp_path):
    """GS_WAL_RETAIN truncates the journal behind the older of the last
    two flushed checkpoints, as the JAX driver does (the same segments
    stay), and recovery still finds its suffix."""
    monkeypatch.setenv("GS_WAL_RETAIN", "1")
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    src, dst = _stream(16 * EB, seed=8)
    for name, make in (("jax", _jax), ("torch", _port)):
        drv = make()
        assert drv.enable_wal(str(tmp_path / name))
        drv.enable_auto_checkpoint(str(tmp_path / (name + ".ckpt")),
                                   every_n_windows=2)
        for lo in range(0, 16 * EB, 2 * EB):
            drv.run_arrays(src[lo:lo + 2 * EB], dst[lo:lo + 2 * EB])
        drv._wal.close()
    kept = _segments(str(tmp_path / "torch"))
    assert kept == _segments(str(tmp_path / "jax"))
    first = min(r[1] for r in wal.replay(str(tmp_path / "torch")))
    assert 0 < first <= 14 * EB
    rec = _port()
    rec.enable_wal(str(tmp_path / "torch"))
    assert rec.resume_and_replay(str(tmp_path / "torch.ckpt")) == []
    assert rec.windows_done == 16


# ----------------------------------------------------------------------
# the sanitizer, tenant=, GS_SLIDE, metrics, the tracing file run
# ----------------------------------------------------------------------
def test_sanitizer_equal_to_jax(monkeypatch, tmp_path):
    """Strict mode drops self-loops and duplicate floods before the
    journal; both packages accept the same edges, journal the same
    bytes and dead-letter the same records, ts kept aligned."""
    monkeypatch.setenv("GS_SANITIZE", "strict")
    src, dst = _stream(4 * EB, seed=3, hi=40)
    src[::9] = dst[::9]
    ts = np.arange(len(src), dtype=np.int64) // 5
    out = {}
    for name, make, smod in (("jax", _jax, jax_sanitize),
                             ("torch", _port, sanitize)):
        monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / ("dlq_" + name)))
        smod.reset()
        drv = make(window_ms=30)
        drv.enable_wal(str(tmp_path / ("wal_" + name)))
        res = drv.run_arrays(src, dst, ts)
        drv._wal.close()
        smod.reset()
        out[name] = (_key(res), drv._fed_edges,
                     _segments(str(tmp_path / ("wal_" + name))),
                     [(r["tenant"], r["reason"], r["offsets"].tolist())
                      for r in jax_sanitize.replay(
                          str(tmp_path / ("dlq_" + name)))])
    assert out["torch"] == out["jax"]
    assert out["torch"][3] and out["torch"][1] == len(src)


def test_tenant_labels_every_record(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_LATENCY", "1")
    monkeypatch.setenv("GS_METRICS", "1")
    src, dst = _stream(3 * EB, seed=1)
    drv = _port(tenant="acme")
    drv.enable_wal(str(tmp_path / "wal"))
    drv.run_arrays(src, dst)
    assert {r[0] for r in wal.replay(str(tmp_path / "wal"))} == {"acme"}
    assert {r["tenant"] for r in latency.recent()} == {"acme"}
    snap = metrics.health_snapshot()
    assert "acme" in str(snap)


def test_gs_slide_knob_reads_where_slide_is_none(monkeypatch):
    monkeypatch.setenv("GS_SLIDE", str(EB // 4))
    assert _port().slide == EB // 4 == _jax().slide
    assert _port(slide=0).slide is None
    src, dst = _stream(3 * EB, seed=12)
    monkeypatch.delenv("GS_SLIDE")
    want = _key(_port(slide=EB // 4).run_arrays(src, dst))
    monkeypatch.setenv("GS_SLIDE", str(EB // 4))
    assert _key(_port().run_arrays(src, dst)) == want
    assert _key(_jax().run_arrays(src, dst)) == want


def test_metrics_marks_count_every_window(monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    src, dst = _stream(7 * EB, seed=13)
    totals = {}
    for name, make, mmod in (("jax", _jax, jax_metrics),
                             ("torch", _port, metrics)):
        mmod.reset()
        _feed(make(), "calls", src, dst)
        totals[name] = {k: v for k, v in mmod.counters().items()
                        if k[0].startswith(("gs_windows", "gs_edges"))}
    assert totals["torch"] == totals["jax"] and totals["torch"]


def test_driver_tracing_and_file(tmp_path):
    """tests/test_driver.py:120 on the port."""
    p = tmp_path / "edges.txt"
    p.write_text("1 2 100\n2 3 150\n1 3 180\n3 4 300\n")
    drv = StreamingAnalyticsDriver(window_ms=200, tracing=True,
                                   device="cpu")
    assert [r.triangles for r in drv.run_file(str(p))] == [1, 0]
    assert {row["op"] for row in drv.trace_report()} >= {"intern",
                                                         "triangles"}


def test_resume_stamps_a_durable_event(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / "ledger"))
    telemetry.reset()
    src, dst = _stream(4 * EB, seed=14)
    drv = _port()
    drv.enable_auto_checkpoint(str(tmp_path / "ckpt"), every_n_windows=2)
    drv.run_arrays(src, dst)
    assert _port().try_resume(str(tmp_path / "ckpt"))
    ev = [r for r in telemetry.records() if r.get("name") == "resume"]
    assert ev and ev[-1]["a"]["windows_done"] == 4


# ----------------------------------------------------------------------
# every hook armed against the disarmed pass
# ----------------------------------------------------------------------
ALL_HOOKS = {"GS_TELEMETRY": "1", "GS_METRICS": "1", "GS_LATENCY": "1",
             "GS_PROVENANCE": "1", "GS_SANITIZE": "on",
             "GS_COSTMODEL": "1"}


@pytest.mark.parametrize("tier,egress", [("scan", "full"),
                                         ("scan", "delta"),
                                         ("resident", "full"),
                                         ("native", "full"),
                                         ("host", "full")])
def test_every_hook_armed_equals_disarmed(monkeypatch, tmp_path, tier,
                                          egress):
    src, dst = _stream(70 * EB + 11, seed=15)
    want = _key(_port(snapshot_tier=tier, egress=egress,
                      emit_deltas=True).run_arrays(src, dst))
    for k, v in ALL_HOOKS.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "prov"))
    drv = _port(snapshot_tier=tier, egress=egress, emit_deltas=True,
                tracing=True, tenant="t")
    drv.enable_wal(str(tmp_path / "wal"))
    drv.enable_auto_checkpoint(str(tmp_path / "ckpt"), every_n_windows=16)
    got = drv.run_arrays(src, dst)
    assert _key(got) == want
    assert all(r.latency is not None for r in got)
    assert len(provenance.scan(str(tmp_path / "prov"))["records"]) \
        == len(got)
    assert drv.demotion_log() == [] and drv.trace_report()


# ----------------------------------------------------------------------
# row S of the cost observatory
# ----------------------------------------------------------------------
def test_snapshot_work_is_row_s_bound():
    """The 64-window chunk at eb=32768, vb=65536: on full rows the
    bound is PERF.md §6 row S's (the slab, the carry read and written,
    three rows of 4 + 4 + 1 bytes a slot), on the delta wire the slab,
    the carry and each field's count and rows at the cap."""
    w, eb, vb = 64, 32768, 65536
    nbytes, ops, kind = costmodel.snapshot_work(w, eb, vb)
    assert nbytes == w * eb * 9 + 2 * 16 * (vb + 1) + w * vb * 9
    assert (ops, kind) == (3 * vb * w, "scalar")
    ms, by = costmodel.bound(nbytes, ops, kind)
    assert by == "bytes" and round(ms, 4) == 0.0175
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    cap = delta_egress.egress_cap(eb, vb)
    nd, _o, _k = costmodel.snapshot_work(w, eb, vb, "delta", cap)
    assert nd == (w * eb * 9 + 2 * 16 * (vb + 1)
                  + w * (3 * 4 + cap * (8 + 8 + 5)))
    masked, _o, _k = costmodel.snapshot_work(w, eb, vb, masks=True)
    assert masked == nbytes + 3 * w * vb
    only_deg, _o, _k = costmodel.snapshot_work(
        w, eb, vb, fields=(True, False, False))
    assert only_deg == w * eb * 9 + 2 * 4 * (vb + 1) + w * vb * 4


def test_snapshot_launches_are_cost_rows(monkeypatch):
    """Armed, each snapshot call is one launch of its row, keyed by the
    wire, its bytes snapshot_work's (no bound on the CPU)."""
    monkeypatch.setenv("GS_COSTMODEL", "1")
    src, dst = _stream(3 * EB, seed=16)
    for egress in ("full", "delta"):
        _port(egress=egress).run_arrays(src, dst)
    _port(emit_deltas=True).run_arrays(src, dst)
    rows = {r["program"]: r for r in costmodel.report()}
    cap = delta_egress.egress_cap(EB, VB)
    for prog, kw in (("window_snapshot", {}),
                     ("window_snapshot_delta", {"egress": "delta",
                                                "cap": cap}),
                     ("window_snapshot_masks", {"masks": True})):
        r = rows[prog]
        assert r["dispatches"] == 1 and r["bound_ms"] is None
        assert r["bytes_accessed"] == costmodel.snapshot_work(
            3, EB, VB, **kw)[0]
