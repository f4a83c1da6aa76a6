"""The port cohort's hooks (gelly_streaming_tpu_torch/core/tenancy.py
`TenantCohort`, `GnnTenantCohort`): the GS_TENANT_* knobs, admission
with the sanitizer and the dead-letter journal, the write-ahead journal
and per-tenant checkpoints, the GS_OOO_BOUND reorder buffer, and the
observation hooks (latency, provenance, metrics, telemetry spans, the
cost observatory), held against the JAX package's cohorts on the CPU.

Each cross-package case runs one numpy-seeded scenario through both
packages and compares per-tenant summaries, returns, `tenant_state_dict`
carries, dead-letter and journal contents, provenance fields (all but
`knobs`, each package's own registry, and `sig`, each package's own
dispatch signature), latency records, metric counters and span
attributes. The JAX cohort runs its XLA form (GS_COHORT_RESIDENT and
GS_COHORT_PALLAS off, GS_AUTOTUNE=0), K given to both. Journals and
checkpoints written by either package recover in the other. The cases
mirror tests/test_tenancy.py :176-330, tests/test_sanitize.py :312-440,
tests/test_wal.py :492, tests/test_checkpoint_roundtrip.py :200-315 and
:638-740, tests/test_latency.py :211-330, tests/test_provenance.py :309
and tests/test_serve_pump.py :294-358."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu.ops import resident_engine
from gelly_streaming_tpu.utils import checkpoint as jax_checkpoint
from gelly_streaming_tpu.utils import costmodel as jax_costmodel
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import latency as jax_latency
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import provenance as jax_provenance
from gelly_streaming_tpu.utils import resilience as jax_resilience
from gelly_streaming_tpu.utils import sanitize as jax_sanitize
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu.utils import wal as jax_wal
from gelly_streaming_tpu_torch import (GnnSummaryEngine, GnnTenantCohort,
                                       StreamSummaryEngine, kernels)
from gelly_streaming_tpu_torch.core import tenancy
from gelly_streaming_tpu_torch.ops import cohort_summary as cs
from gelly_streaming_tpu_torch.ops import gnn_window as gw
from gelly_streaming_tpu_torch.utils import checkpoint
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import resilience
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils import wal

EB, VB, KB = 64, 128, 16
F = 8
PKGS = {
    "jax": SimpleNamespace(
        tenancy=jax_tenancy, faults=jax_faults, latency=jax_latency,
        metrics=jax_metrics, provenance=jax_provenance,
        sanitize=jax_sanitize, telemetry=jax_telemetry, wal=jax_wal,
        checkpoint=jax_checkpoint, resilience=jax_resilience),
    "torch": SimpleNamespace(
        tenancy=tenancy, faults=faults, latency=latency, metrics=metrics,
        provenance=provenance, sanitize=sanitize, telemetry=telemetry,
        wal=wal, checkpoint=checkpoint, resilience=resilience),
}
_KNOBS = ("GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS", "GS_TENANT_ADMISSION",
          "GS_TENANT_TPD", "GS_QUARANTINE_WINDOWS", "GS_OOO_BOUND",
          "GS_SANITIZE", "GS_DLQ_DIR", "GS_MAX_BATCH_EDGES", "GS_LATENCY",
          "GS_METRICS", "GS_METRICS_PORT", "GS_PROVENANCE",
          "GS_PROVENANCE_DIR", "GS_COSTMODEL", "GS_TELEMETRY",
          "GS_TRACE_DIR", "GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES", "GS_WAL",
          "GS_WAL_RETAIN", "GS_WAL_SEGMENT_BYTES", "GS_WAL_FSYNC_S",
          "GS_GNN_F", "GS_GNN_ACT")
_RESETS = (telemetry, metrics, latency, provenance, sanitize, costmodel,
           jax_telemetry, jax_metrics, jax_latency, jax_provenance,
           jax_sanitize, jax_costmodel)


def _reset():
    for m in _RESETS:
        m.reset()
    resilience.reset_demotions()
    jax_resilience.reset_demotions()
    resident_engine._reset_resident_cohort()
    pallas_window._reset_pallas_window()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in (("GS_AUTOTUNE", "0"), ("GS_COHORT_RESIDENT", "off"),
                 ("GS_COHORT_PALLAS", "off")):
        monkeypatch.setenv(k, v)
    _reset()
    yield
    _reset()
    torch.set_num_threads(threads)


def make(pkg: str, **kw):
    if pkg == "jax":
        return jax_tenancy.TenantCohort(EB, VB, k_bucket=KB, **kw)
    return tenancy.TenantCohort(EB, VB, k_bucket=KB, device="cpu", **kw)


def streams_for(n, windows, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        m = windows * EB - (EB // 3 if ragged and i % 2 else 0)
        out["t%d" % i] = (rng.integers(0, VB, m).astype(np.int32),
                          rng.integers(0, VB, m).astype(np.int32))
    return out


def oracle(streams):
    return {tid: StreamSummaryEngine(EB, VB, k_bucket=KB,
                                     device="cpu").process(s, d)
            for tid, (s, d) in streams.items()}


def serve(co, streams, piece=EB, close=True):
    """Admit what is new, feed every tenant `piece` edges a round and
    pump, until the streams are in; close them. {tenant: summaries}."""
    for tid in streams:
        if tid not in co.tenants:
            co.admit(tid)
    out = {tid: [] for tid in streams}
    at = 0
    while any(at < len(s) for s, _d in streams.values()):
        for tid, (s, d) in streams.items():
            if at < len(s):
                co.feed(tid, s[at:at + piece], d[at:at + piece])
        for tid, res in co.pump().items():
            out.setdefault(tid, []).extend(res)
        at += piece
    if close:
        for tid in streams:
            out[tid] += co.close(tid)
    return out


def by_window(co, got, res):
    """File a pump's summaries under each tenant's window ordinal."""
    for tid, rows in res.items():
        base = co.windows_done(tid) - len(rows)
        for i, r in enumerate(rows):
            got.setdefault(tid, {})[base + i] = r


def both(scenario):
    got = {}
    for pkg, p in PKGS.items():
        _reset()
        got[pkg] = scenario(p, pkg)
    assert got["torch"] == got["jax"]
    return got["torch"]


def events(p, names):
    return [(r["name"], (r.get("a") or {}).get("tenant"),
             (r.get("a") or {}).get("kind"))
            for r in p.telemetry.records()
            if r["t"] == "event" and r["name"] in names]


# ----------------------------------------------------------------------
# the knobs
# ----------------------------------------------------------------------
def test_knob_readers_follow_the_registry(monkeypatch):
    for fn, name, raw, want in (
            (tenancy.max_tenants, "GS_TENANT_MAX", "3", 3),
            (tenancy.queue_windows, "GS_TENANT_QUEUE_WINDOWS", "0", 1),
            (tenancy.admission_policy, "GS_TENANT_ADMISSION", "drop",
             "drop"),
            (tenancy.quarantine_windows, "GS_QUARANTINE_WINDOWS", "0", 0),
            (tenancy.ooo_bound, "GS_OOO_BOUND", "250", 250)):
        jax_fn = getattr(jax_tenancy, fn.__name__)
        assert fn() == jax_fn()
        monkeypatch.setenv(name, raw)
        assert fn() == jax_fn() == want


def test_cohort_knobs_are_read_live(monkeypatch):
    """GS_TENANT_MAX, GS_TENANT_QUEUE_WINDOWS and GS_TENANT_ADMISSION
    are read at each admission and feed, as in the JAX cohort."""
    s, d = streams_for(1, 3, seed=1)["t0"]

    def scenario(p, pkg):
        co = make(pkg)
        monkeypatch.setenv("GS_TENANT_MAX", "2")
        co.admit("a")
        co.admit("b")
        with pytest.raises(p.tenancy.TenantRejected) as ei:
            co.admit("c")
        assert "GS_TENANT_MAX" in str(ei.value)
        monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
        took = [co.feed("a", s[:EB], d[:EB])]
        with pytest.raises(p.tenancy.TenantBackpressure) as bp:
            co.feed("a", s[EB:EB + 1], d[EB:EB + 1])
        assert (bp.value.queued, bp.value.capacity) == (EB, EB)
        monkeypatch.setenv("GS_TENANT_ADMISSION", "drop")
        took.append(co.feed("a", s[EB:], d[EB:]))
        monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "3")
        took.append(co.feed("a", s[EB:], d[EB:]))
        monkeypatch.setenv("GS_TENANT_MAX", "3")
        co.admit("c")
        for k in ("GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS",
                  "GS_TENANT_ADMISSION"):
            monkeypatch.delenv(k)
        return took, co.tenants["a"].dropped_edges, co.pump()

    took, dropped, out = both(scenario)
    assert took == [EB, 0, 2 * EB] and dropped == 2 * EB
    assert out["a"] == oracle({"a": (s, d)})["a"]


def test_constructor_arguments_override_the_knobs(monkeypatch):
    monkeypatch.setenv("GS_TENANT_MAX", "1")
    monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
    monkeypatch.setenv("GS_TENANT_ADMISSION", "drop")
    co = make("torch", max_tenants=2, queue_windows=2, admission="reject")
    co.admit("a")
    co.admit("b")
    s, d = streams_for(1, 3, seed=2)["t0"]
    assert co.feed("a", s[:2 * EB], d[:2 * EB]) == 2 * EB
    with pytest.raises(tenancy.TenantBackpressure):
        co.feed("a", s[2 * EB:], d[2 * EB:])
    knob = make("torch")
    knob.admit("a")
    with pytest.raises(tenancy.TenantRejected):
        knob.admit("b")
    assert knob.feed("a", s, d) == EB
    with pytest.raises(ValueError):
        make("torch", queue_windows=0)


# ----------------------------------------------------------------------
# typed errors: events and counters
# ----------------------------------------------------------------------
def test_rejections_stamp_events_and_counters(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
    s, d = streams_for(1, 1, seed=3)["t0"]

    def scenario(p, pkg):
        co = make(pkg, max_tenants=1) if pkg == "torch" else make(pkg)
        if pkg == "jax":
            monkeypatch.setenv("GS_TENANT_MAX", "1")
        co.admit("a")
        for call in (lambda: co.admit("a"), lambda: co.admit("b"),
                     lambda: co.feed("ghost", [0], [1])):
            with pytest.raises(p.tenancy.TenantRejected):
                call()
        with pytest.raises(p.tenancy.TenantRejected):
            co.tenant_tier("ghost")      # introspection records nothing
        co.feed("a", s, d)
        for _ in range(3):
            with pytest.raises(p.tenancy.TenantBackpressure):
                co.feed("a", s[:1], d[:1])
        stamped = co.tenants["a"].bp_stamped
        co.pump()
        monkeypatch.delenv("GS_TENANT_MAX", raising=False)
        counts = {k: v for k, v in p.metrics.counters().items()
                  if k[0] == "gs_tenant_rejections_total"}
        return (events(p, ("tenant_admitted", "tenant_rejected")), counts,
                stamped, co.tenants["a"].bp_stamped)

    evs, counts, stamped, after = both(scenario)
    assert stamped is True and after is False
    assert [e[2] for e in evs if e[0] == "tenant_rejected"] == [
        "TenantRejected"] * 3 + ["TenantBackpressure"] * 3
    assert sum(counts.values()) == 6


# ----------------------------------------------------------------------
# admission with the sanitizer
# ----------------------------------------------------------------------
def _arm_sanitizer(monkeypatch, tmp_path, pkg):
    monkeypatch.setenv("GS_SANITIZE", "on")
    monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / ("dlq_" + pkg)))
    return str(tmp_path / ("dlq_" + pkg))


def test_sanitized_feed_matches_jax(monkeypatch, tmp_path):
    rng = np.random.default_rng(4)
    s = rng.integers(-3, VB + 3, 3 * EB).astype(np.int64)
    d = rng.integers(0, VB, 3 * EB).astype(np.int64)
    d[::17] = 2 ** 40

    def scenario(p, pkg):
        dlq = _arm_sanitizer(monkeypatch, tmp_path, pkg)
        co = make(pkg)
        co.admit("t")
        took = [co.feed("t", s[i:i + 50], d[i:i + 50])
                for i in range(0, len(s), 50)]
        rep = co.tenants["t"].last_report
        out = co.pump()["t"] + co.close("t")
        p.sanitize.reset()
        info = p.sanitize.scan(dlq)
        recs = [(r["tenant"], r["reason"], r["offsets"].tolist())
                for r in p.sanitize.replay(dlq)]
        return (took, out, co.tenants["t"].fed_offset,
                dict(rep.reasons), info["records"], info["edges"],
                info["by_reason"], recs)

    took, out, offset, reasons, *_dlq = both(scenario)
    keep = (s >= 0) & (s < VB) & (d >= 0) & (d < VB)
    assert sum(took) == int(keep.sum()) and offset == len(s)
    assert out == oracle({"t": (s[keep].astype(np.int32),
                                d[keep].astype(np.int32))})["t"]


def test_batch_rejected_advances_the_offsets(monkeypatch, tmp_path):
    def scenario(p, pkg):
        dlq = _arm_sanitizer(monkeypatch, tmp_path, pkg)
        monkeypatch.setenv("GS_MAX_BATCH_EDGES", "4")
        co = make(pkg)
        co.admit("t")
        with pytest.raises(p.sanitize.BatchRejected):
            co.feed("t", [1] * 5, [2] * 5)
        co.feed("t", [500, 1], [2, 3])
        p.sanitize.reset()
        return co.tenants["t"].fed_offset, p.sanitize.scan(dlq)["by_reason"]

    assert both(scenario) == (7, {"batch_overflow": 5, "id_out_of_range": 1})


def test_backpressure_reject_journals_nothing(monkeypatch, tmp_path):
    """A backpressure refusal accepts nothing, so it journals nothing:
    neither the sanitizer's rejects (the retry journals them once, at
    offsets contiguous with the domain) nor the journal's edges."""
    def scenario(p, pkg):
        dlq = _arm_sanitizer(monkeypatch, tmp_path, pkg)
        monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
        co = make(pkg)
        wdir = str(tmp_path / ("wal_" + pkg))
        assert co.enable_wal(wdir)
        co.admit("t")
        co.feed("t", np.zeros(EB, np.int64), np.ones(EB, np.int64))
        off = co.tenants["t"].fed_offset
        batch = (np.array([1, 500, 2], np.int64),
                 np.array([2, 3, 4], np.int64))
        with pytest.raises(p.tenancy.TenantBackpressure):
            co.feed("t", *batch)
        p.sanitize.reset()
        refused = (p.sanitize.scan(dlq)["records"],
                   co.tenants["t"].fed_offset,
                   p.wal.scan(wdir)["offsets"])
        co.pump()
        co.feed("t", *batch)
        p.sanitize.reset()
        rec = next(p.sanitize.replay(dlq))
        return (off, refused, rec["offsets"].tolist(),
                p.wal.scan(wdir)["offsets"])

    off, refused, offsets, journal = both(scenario)
    assert refused == (0, off, {"t": EB})
    assert offsets == [off + 1] and journal == {"t": EB + 2}


def test_admit_fault_site_poisons_upstream_of_sanitizer(monkeypatch,
                                                        tmp_path):
    def scenario(p, pkg):
        dlq = _arm_sanitizer(monkeypatch, tmp_path, pkg)
        co = make(pkg)
        co.admit("t")

        def garble(payload):
            tid, src, dst = payload
            src = np.asarray(src).copy()
            src[0] = 10 ** 9
            return tid, src, dst

        with p.faults.inject(p.faults.FaultSpec(site="admit", action="call",
                                                fn=garble)):
            take = co.feed("t", np.array([1, 2]), np.array([2, 3]))
        p.sanitize.reset()
        return take, p.sanitize.scan(dlq)["by_reason"]

    assert both(scenario) == (1, {"id_out_of_range": 1})


def test_the_disarmed_cast_is_the_jax_cohorts(monkeypatch, tmp_path):
    """Disarmed, both packages cast ids to int32 before the range check
    (an int64 id 2^32 + 3 reads 3); armed, both reject it as
    id_overflow."""
    s = np.array([2 ** 32 + 3, 1, 2], np.int64)
    d = np.array([1, 2, 3], np.int64)

    def disarmed(p, pkg):
        co = make(pkg)
        co.admit("t")
        took = co.feed("t", s, d)
        return took, co.close("t")

    took, out = both(disarmed)
    assert took == 3 and out == oracle({"t": (s.astype(np.int32),
                                              d.astype(np.int32))})["t"]

    def armed(p, pkg):
        _arm_sanitizer(monkeypatch, tmp_path, pkg)
        co = make(pkg)
        co.admit("t")
        return co.feed("t", s, d), dict(co.tenants["t"].last_report.reasons)

    assert both(armed) == (2, {"id_overflow": 1})


# ----------------------------------------------------------------------
# the journal and the checkpoints
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_journal_and_checkpoints_recover_across_packages(tmp_path, writer,
                                                         reader):
    """One package's cohort journals and checkpoints, is killed after
    three rounds; the other recovers (checkpoint + journal suffix) and
    continues: every window equals the uninterrupted run."""
    streams = streams_for(3, 8, seed=5)
    want = oracle(streams)
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ck")
    a = make(writer)
    assert a.enable_wal(wdir)
    a.enable_auto_checkpoint(cdir, every_n_windows=2)
    got = {}
    for w in range(3):
        for tid, (s, d) in sorted(streams.items()):
            if w == 0:
                a.admit(tid)
            a.feed(tid, s[w * 2 * EB:(w + 1) * 2 * EB],
                   d[w * 2 * EB:(w + 1) * 2 * EB])
        by_window(a, got, a.pump(max_rounds=1))
    a._wal.close()                                  # the kill
    b = make(reader)
    assert b.enable_wal(wdir)
    b.enable_auto_checkpoint(cdir, every_n_windows=2)
    info = b.recover()
    assert sorted(b.tenants) == sorted(streams)
    assert all(info["resumed"].values())
    by_window(b, got, b.pump())
    for w in range(3, 4):
        for tid, (s, d) in sorted(streams.items()):
            b.feed(tid, s[w * 2 * EB:], d[w * 2 * EB:])
        by_window(b, got, b.pump())
    for tid in streams:
        assert [got[tid][k] for k in sorted(got[tid])] == want[tid], tid


def test_checkpoint_files_equal_the_jax_cohorts(tmp_path):
    """The per-tenant checkpoints the port stages at its dispatches (the
    due tenants' carry rows ride the dispatch's copy back) hold what
    the JAX cohort's do, key for key, bit for bit."""
    streams = streams_for(3, 5, seed=6, ragged=True)
    for pkg in PKGS:
        co = make(pkg)
        co.enable_auto_checkpoint(str(tmp_path / pkg), every_n_windows=2)
        serve(co, streams, piece=3 * EB // 2)
    for tid in streams:
        for gen in ("", ".prev"):
            name = "tenant_%s.npz%s" % (tid, gen)
            mine = checkpoint.restore(str(tmp_path / "torch" / name))
            theirs = jax_checkpoint.restore(str(tmp_path / "jax" / name))
            assert {k: v for k, v in mine.items() if k != "carry"} == {
                k: v for k, v in theirs.items() if k != "carry"}
            for x, y in zip(mine["carry"], theirs["carry"]):
                np.testing.assert_array_equal(x, y)


def test_kill_between_append_and_enqueue(tmp_path):
    """The journal holds a batch the kill kept out of the queue:
    recover() replays it and the windows equal the fault-free run."""
    s, d = streams_for(1, 4, seed=7)["t0"]
    want = oracle({"t": (s, d)})["t"]
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ck")
    a = make("torch")
    assert a.enable_wal(wdir)
    a.enable_auto_checkpoint(cdir, every_n_windows=2)
    a.admit("t")
    a.feed("t", s[:2 * EB], d[:2 * EB])
    got = a.pump()["t"]
    with pytest.raises(faults.InjectedFault):
        with faults.inject(faults.FaultSpec(site="wal_enqueue", on_call=1,
                                            fatal=True)):
            a.feed("t", s[2 * EB:], d[2 * EB:])
    b = make("torch")
    assert b.enable_wal(wdir)
    b.enable_auto_checkpoint(cdir, every_n_windows=2)
    info = b.recover()
    assert info["resumed"]["t"] is True
    assert info["replayed_edges"]["t"] == 2 * EB
    assert got + b.pump()["t"] == want


def test_kill_mid_dispatch_replays_exactly(tmp_path):
    """A fatal `cohort_dispatch` fault kills the cohort mid-round: it
    passes the bulkhead untouched, and recover() plus the rest of the
    stream equals the fault-free run, window for window."""
    streams = streams_for(2, 8, seed=8)
    want = oracle(streams)
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ck")
    a = make("torch")
    assert a.enable_wal(wdir)
    a.enable_auto_checkpoint(cdir, every_n_windows=2)
    for tid in streams:
        a.admit(tid)
    got = {}
    killed = None
    try:
        with faults.inject(faults.FaultSpec(site="cohort_dispatch",
                                            on_call=5, fatal=True)):
            for w in range(8):
                for tid, (s, d) in sorted(streams.items()):
                    a.feed(tid, s[w * EB:(w + 1) * EB],
                           d[w * EB:(w + 1) * EB])
                by_window(a, got, a.pump())
    except faults.InjectedFault:
        killed = w
    assert killed is not None and a.quarantined() == []
    b = make("torch")
    assert b.enable_wal(wdir)
    b.enable_auto_checkpoint(cdir, every_n_windows=2)
    assert any(b.recover()["resumed"].values())
    by_window(b, got, b.pump())
    for w in range(killed + 1, 8):
        for tid, (s, d) in sorted(streams.items()):
            b.feed(tid, s[w * EB:(w + 1) * EB], d[w * EB:(w + 1) * EB])
        by_window(b, got, b.pump())
    for tid in streams:
        assert [got[tid][k] for k in sorted(got[tid])] == want[tid], tid


def test_checkpoint_all_truncates_the_shared_journal(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_WAL_RETAIN", "1")
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ck")
    rng = np.random.default_rng(13)
    fed = {"a": [], "b": []}
    co = make("torch")
    co.enable_auto_checkpoint(cdir)
    assert co.enable_wal(wdir)
    for t in fed:
        co.admit(t)
    outs = {"a": [], "b": []}
    for _ in range(4):
        for t in fed:
            s = rng.integers(0, VB, 512).astype(np.int32)
            d = rng.integers(0, VB, 512).astype(np.int32)
            co.feed(t, s, d)
            fed[t].append((s, d))
        for t, res in co.pump().items():
            outs[t] += res
        assert co.checkpoint_all() == 2
    segs = sorted(f for f in os.listdir(wdir) if f.endswith(".seg"))
    assert segs and int(segs[0][4:12]) > 0
    co2 = make("torch")
    co2.enable_auto_checkpoint(cdir)
    assert co2.enable_wal(wdir)
    co2.recover()
    for t, res in co2.pump().items():
        outs[t] += res
    for t in fed:
        want = oracle({t: (np.concatenate([s for s, _ in fed[t]]),
                           np.concatenate([d for _, d in fed[t]]))})[t]
        assert outs[t][:len(want)] == want


def test_seal_wal_and_a_disabled_journal(tmp_path, monkeypatch):
    co = make("torch")
    assert co.enable_wal(str(tmp_path / "wal"))
    co.admit("t")
    co.feed("t", [1, 2], [2, 3])
    co.seal_wal()
    assert wal.scan(str(tmp_path / "wal"))["sealed"] is True
    monkeypatch.setenv("GS_WAL", "0")
    off = make("torch")
    assert off.enable_wal(str(tmp_path / "off")) is False
    with pytest.raises(ValueError, match="enable_wal"):
        off.recover()
    assert off.checkpoint_all() == 0 and off.try_resume is not None


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_resume_all_across_packages(tmp_path, writer, reader):
    """Per-tenant checkpoint files written by one package's cohort
    resume every tenant in the other's (resume_all), which re-feeds each
    from its own offset to the uninterrupted run's windows."""
    streams = streams_for(3, 6, seed=9, ragged=True)
    want = oracle(streams)
    co = make(writer)
    for tid in streams:
        co.admit(tid)
    co.enable_auto_checkpoint(str(tmp_path / "ck"), every_n_windows=2)
    head = {}
    for w in range(4):
        for tid, (s, d) in streams.items():
            co.feed(tid, s[w * EB:(w + 1) * EB], d[w * EB:(w + 1) * EB])
        for tid, res in co.pump().items():
            head.setdefault(tid, []).extend(res)
    co2 = make(reader)
    for tid in streams:
        co2.admit(tid)
    co2.enable_auto_checkpoint(str(tmp_path / "ck"), every_n_windows=2)
    assert all(co2.resume_all().values())
    final = {}
    for tid, (s, d) in streams.items():
        off = co2.resume_offset(tid)
        assert 0 < off <= len(head[tid]) * EB
        final[tid] = head[tid][:off // EB]
        co2.feed(tid, s[off:], d[off:])
    for tid, res in co2.pump().items():
        final[tid] += res
    for tid in streams:
        final[tid] += co2.close(tid)
    assert final == want


# ----------------------------------------------------------------------
# the GS_OOO_BOUND reorder buffer
# ----------------------------------------------------------------------
def test_ooo_within_bound_reorders_to_the_sorted_stream(monkeypatch):
    rng = np.random.default_rng(10)
    n = 3 * EB
    src = rng.integers(0, VB, n).astype(np.int32)
    dst = rng.integers(0, VB, n).astype(np.int32)
    ts = np.arange(n, dtype=np.int64) * 1000 + rng.integers(-40, 40, n) * 1000
    order = np.argsort(ts, kind="stable")

    def scenario(p, pkg):
        plain = make(pkg)
        plain.admit("t")
        plain.feed("t", src[order], dst[order], ts=ts[order])
        want = plain.pump().get("t", []) + plain.close("t")
        monkeypatch.setenv("GS_OOO_BOUND", str(100 * 1000))
        co = make(pkg)
        co.admit("t")
        took = [co.feed("t", src[i:i + 40], dst[i:i + 40], ts=ts[i:i + 40])
                for i in range(0, n, 40)]
        held = int(co.tenants["t"].ooo_ts.size)
        got = co.pump().get("t", []) + co.close("t")
        monkeypatch.delenv("GS_OOO_BOUND")
        return want, got, took, held

    want, got, took, held = both(scenario)
    assert got == want and sum(took) + held == n and held > 0


def test_ooo_beyond_bound_refused_atomically(monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", "100")

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("t")
        took = co.feed("t", [1, 2], [2, 3], ts=[1000, 2000])
        held = co.tenants["t"].ooo_ts.copy()
        with pytest.raises(ValueError, match="regression past"):
            co.feed("t", [3, 4], [4, 5], ts=[1500, 500])
        return took, held.tolist(), co.tenants["t"].ooo_ts.tolist()

    took, held, after = both(scenario)
    assert took == 1 and held == after == [2000]


def test_ooo_released_prefix_returns_on_backpressure(monkeypatch, tmp_path):
    """A backpressure refusal puts the released prefix back at the front
    of the hold; held edges are journaled only once released."""
    monkeypatch.setenv("GS_OOO_BOUND", "10")
    monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
    s, d = streams_for(1, 2, seed=11)["t0"]
    ts = np.arange(2 * EB, dtype=np.int64) * 100

    def scenario(p, pkg):
        co = make(pkg)
        wdir = str(tmp_path / ("wal_" + pkg))
        assert co.enable_wal(wdir)
        co.admit("t")
        took = [co.feed("t", s[:EB + 1], d[:EB + 1], ts=ts[:EB + 1])]
        journal = [p.wal.scan(wdir)["offsets"]]
        with pytest.raises(p.tenancy.TenantBackpressure):
            co.feed("t", s[EB + 1:], d[EB + 1:], ts=ts[EB + 1:])
        hold = co.tenants["t"].ooo_ts.tolist()
        journal.append(p.wal.scan(wdir)["offsets"])
        got = co.pump()["t"]
        took.append(co.feed("t", s[:0], d[:0], ts=ts[:0]))
        got += co.close("t")
        journal.append(p.wal.scan(wdir)["offsets"])
        return took, hold, journal, got

    took, hold, journal, got = both(scenario)
    assert took == [EB, EB - 1] and hold == ts[EB:].tolist()
    assert journal == [{"t": EB}, {"t": EB}, {"t": 2 * EB}]
    assert got == oracle({"t": (s, d)})["t"]


def test_ooo_close_flushes_the_hold(monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", str(10 ** 12))
    s, d = streams_for(1, 3, seed=12)["t0"]

    def scenario(p, pkg):
        monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
        co = make(pkg)
        co.admit("t")
        co.feed("t", s, d, ts=np.arange(len(s), dtype=np.int64))
        held = (int(co.tenants["t"].ooo_ts.size), co.tenants["t"].queued)
        return held, co.close("t")

    held, out = both(scenario)
    assert held == (3 * EB, 0) and out == oracle({"t": (s, d)})["t"]


def test_ooo_watermark_lag_reaches_the_latency_plane(monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", str(10 ** 12))
    monkeypatch.setenv("GS_LATENCY", "1")

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("t")
        co.feed("t", [1, 2], [2, 3], ts=[0, 2_000_000_000])
        row = p.latency.health_section()["tenants"]["t"]
        got = (row["watermark_held"], row["watermark_lag_s"],
               p.latency.oldest_age())
        co.close("t")
        return got

    assert both(scenario) == (2, 2.0, 2.0)


# ----------------------------------------------------------------------
# observation: latency, provenance, metrics, spans
# ----------------------------------------------------------------------
def test_latency_records_and_ordinals(monkeypatch):
    monkeypatch.setenv("GS_LATENCY", "1")
    streams = streams_for(2, 3, seed=14)

    def scenario(p, pkg):
        co = make(pkg)
        serve(co, streams, piece=2 * EB, close=False)
        recs = p.latency.recent()
        for rec in recs:
            assert {"admission", "queue_wait", "prep", "h2d", "dispatch",
                    "finalize"} <= set(rec["stages"])
            assert sum(rec["stages"].values()) == pytest.approx(
                rec["e2e_s"], abs=1e-9)
        return sorted((r["tenant"], r["window"], r["edges"], r["lo"])
                      for r in recs)

    recs = both(scenario)
    assert len(recs) == 6


def test_latency_replay_keeps_the_admission_time(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_LATENCY", "1")
    s, d = streams_for(1, 2, seed=15)["t0"]
    co = make("torch")
    assert co.enable_wal(str(tmp_path))
    co.admit("t")
    co.feed("t", s, d)
    co._wal.close()                 # the kill, before any pump
    import time
    time.sleep(0.2)
    latency.reset()
    co2 = make("torch")
    assert co2.enable_wal(str(tmp_path))
    co2.recover()
    assert len(co2.pump()["t"]) == 2
    recs = latency.recent()
    assert recs and all(r["replayed"] and r["e2e_s"] >= 0.2 for r in recs)


def test_demoted_tenant_keeps_its_lane(monkeypatch):
    monkeypatch.setenv("GS_LATENCY", "1")
    s, d = streams_for(1, 2, seed=16)["t0"]

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("t")
        co.feed("t", s, d)
        co.demote("t", reason="test")
        out = co.pump()
        recs = p.latency.recent()
        return (len(out["t"]), [(r["tenant"], r["window"]) for r in recs],
                p.latency.queue_age("t"))

    assert both(scenario) == (2, [("t", 0), ("t", 1)], None)


def test_disarmed_journal_has_no_ts_column(tmp_path):
    s, d = streams_for(1, 1, seed=17)["t0"]

    def scenario(p, pkg):
        co = make(pkg)
        wdir = str(tmp_path / pkg)
        assert co.enable_wal(wdir)
        co.admit("t")
        co.feed("t", s, d)
        co._wal.close()
        return [ts is None for *_x, ts in p.wal.replay(wdir)]

    assert both(scenario) == [True]


def test_provenance_records_match_jax(monkeypatch, tmp_path):
    """One record a tenant window, in the JAX cohort's fields: tier,
    program, tenant, window, journal span and digest equal."""
    streams = streams_for(3, 3, seed=18, ragged=True)
    monkeypatch.setenv("GS_PROVENANCE", "1")

    def scenario(p, pkg):
        pdir = str(tmp_path / ("prov_" + pkg))
        monkeypatch.setenv("GS_PROVENANCE_DIR", pdir)
        p.provenance.reset()
        out = serve(make(pkg), streams, piece=2 * EB)
        p.provenance.reset()
        recs = p.provenance.scan(pdir)["records"]
        for tid, rows in out.items():
            mine = [r for r in recs if r["tenant"] == tid]
            assert [r["digest"] for r in mine] == [
                p.provenance.summary_digest(x) for x in rows]
        return [{k: v for k, v in r.items() if k not in ("knobs", "sig")}
                for r in recs]

    recs = both(scenario)
    assert {(r["tier"], r["program"]) for r in recs} == {("cohort",
                                                          "cohort_scan")}
    assert len(recs) == sum(len(v) for v in oracle(streams).values())


def test_metrics_marks_and_gauges_match_jax(monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")
    streams = streams_for(3, 3, seed=19, ragged=True)

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("t9")
        co.demote("t9", reason="test")
        co.feed("t9", *streams["t0"])
        serve(co, streams, piece=2 * EB)
        co.close("t9")
        keep = ("gs_tenant_windows_total", "gs_tenant_edges_total",
                "gs_windows_finalized_total", "gs_edges_total")
        counters = {k: v for k, v in p.metrics.counters().items()
                    if k[0] in keep}
        gauges = {k: v for k, v in p.metrics.gauges().items()
                  if k[0] == "gs_tenant_queue_edges"}
        seconds = {dict(k[1])["tenant"] for k in p.metrics.counters()
                   if k[0] == "gs_tenant_device_seconds"}
        snap = p.metrics.health_snapshot()["tenants"]
        return (counters, gauges, seconds,
                {t: (r["windows"], r["edges"]) for t, r in snap.items()})

    counters, gauges, seconds, snap = both(scenario)
    assert seconds == {"t0", "t1", "t2", "t9"}
    assert snap["t9"] == (3, 3 * EB)
    # a drained cohort tenant's queue gauge reads 0 (the demoted
    # tenant's is set at feed only, in both packages)
    assert {dict(k[1])["tenant"]: v for k, v in gauges.items()} == {
        "t0": 0, "t1": 0, "t2": 0, "t9": 3 * EB}


def test_spans_match_jax(monkeypatch):
    monkeypatch.setenv("GS_TELEMETRY", "1")
    streams = streams_for(3, 2, seed=20)

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("solo")
        co.demote("solo", reason="test")
        co.feed("solo", *streams["t0"])
        serve(co, streams, piece=2 * EB)
        return [(r["name"], r.get("a"))
                for r in p.telemetry.records() if r["t"] == "span"
                and r["name"] in ("cohort.dispatch", "cohort.round",
                                  "tenant.single")]

    spans = both(scenario)
    assert [n for n, _a in spans] == ["tenant.single", "cohort.dispatch",
                                      "cohort.round"]
    assert spans[1][1] == {"tenants": 3, "windows": 6, "edges": 6 * EB}
    assert spans[2][1] == {"vb": VB, "tenants": 3, "edges": 6 * EB}


def test_every_hook_armed_changes_no_result(monkeypatch, tmp_path):
    """(f): the cohort with every hook armed (telemetry, metrics,
    latency, costmodel, provenance, sanitizer, journal, checkpoints)
    gives the disarmed run's summaries, returns, states and launches."""
    streams = streams_for(4, 5, seed=21, ragged=True)

    def run(armed):
        _reset()
        env = {"GS_TELEMETRY": 1, "GS_METRICS": 1, "GS_LATENCY": 1,
               "GS_COSTMODEL": 1, "GS_PROVENANCE": 1, "GS_SANITIZE": "on"}
        for k, v in env.items():
            if armed:
                monkeypatch.setenv(k, str(v))
            else:
                monkeypatch.delenv(k, raising=False)
        if armed:
            monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "prov"))
            monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / "dlq"))
        co = make("torch")
        if armed:
            assert co.enable_wal(str(tmp_path / "wal"))
            co.enable_auto_checkpoint(str(tmp_path / "ck"),
                                      every_n_windows=2)
        kernels.reset_launches()
        took = []
        for tid in streams:
            co.admit(tid)
        for at in range(0, 5 * EB, 100):
            for tid, (s, d) in streams.items():
                took.append(co.feed(tid, s[at:at + 100], d[at:at + 100]))
        out = co.pump()
        for tid in streams:
            out[tid] = out.get(tid, []) + co.close(tid)
        return (out, took, {t: co.tenant_state_dict(t) for t in streams},
                dict(kernels.LAUNCHES))

    base, armed = run(False), run(True)
    assert armed[0] == base[0] == oracle(streams)
    assert armed[1] == base[1] and armed[3] == base[3]
    for tid in streams:
        a, b = armed[2][tid], base[2][tid]
        assert a["windows_done"] == b["windows_done"]
        for x, y in zip(a["carry"], b["carry"]):
            np.testing.assert_array_equal(x, y)
    assert os.listdir(str(tmp_path / "ck"))


# ----------------------------------------------------------------------
# the cost observatory's cohort row
# ----------------------------------------------------------------------
def test_cost_model_row_of_the_cohort_call(monkeypatch):
    """The cohort call's row is `summary_work(W, eb, vb, rows=nb)`: at
    PERF.md's shape (64 tenants × 8 windows of 4096 edges, vb=8192) its
    bound is 0.0106 ms on an H100. The plain version is stubbed: the
    row is analytic."""
    monkeypatch.setenv("GS_COSTMODEL", "1")
    monkeypatch.setattr(costmodel, "card_of", lambda dev: costmodel.H100)
    nb, w, eb, vb = 64, 8, 4096, 8192
    monkeypatch.setattr(cs, "summarize_cohort_plain",
                        lambda c, s, *a: tuple(torch.zeros(nb, w, dtype=t)
                                               for t in (torch.int32,) * 2
                                               + (torch.bool,)
                                               + (torch.int32,) * 2))
    summ = cs.CohortSummary(vb, 128, "cpu")
    carries = cs.fresh_cohort_carry(nb, vb, "cpu")
    slab = (torch.zeros(nb, w, eb, dtype=torch.int32),
            torch.zeros(nb, w, eb, dtype=torch.int32),
            torch.zeros(nb, w, eb, dtype=torch.bool))
    summ(carries, *slab)
    (row,) = costmodel.report()
    nbytes, ops, kind = costmodel.summary_work(w, eb, vb, rows=nb)
    assert (row["program"], row["bytes_accessed"], row["flops"],
            row["kind"]) == ("cohort_summary", nbytes, ops, kind)
    assert row["sig"] == costmodel.tensor_sig((carries[0], slab[0]))
    assert row["bound_by"] == "bytes" and round(row["bound_ms"], 4) == 0.0106
    assert row["dispatches"] == 1
    assert telemetry.pop_dispatch_tags() == {"program": "cohort_summary",
                                             "sig": row["sig"]}


# ----------------------------------------------------------------------
# the GNN cohort's hooks
# ----------------------------------------------------------------------
def _gnn_cohort(pkg):
    if pkg == "jax":
        return jax_tenancy.GnnTenantCohort(EB, VB, feature_dim=F,
                                           activation="relu")
    return GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")


def test_gnn_cohort_hooks_match_jax(monkeypatch, tmp_path):
    """The admission event, the dispatch span, one provenance record a
    tenant window (digests equal to the JAX cohort's), the health marks
    and the demotion record."""
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_METRICS", "1")
    monkeypatch.setenv("GS_PROVENANCE", "1")
    rng = np.random.default_rng(22)
    streams = {"g%d" % i: (rng.integers(0, VB, 2 * EB + 7).astype(np.int32),
                           rng.integers(0, VB, 2 * EB + 7).astype(np.int32))
               for i in range(3)}

    def scenario(p, pkg):
        pdir = str(tmp_path / ("prov_" + pkg))
        monkeypatch.setenv("GS_PROVENANCE_DIR", pdir)
        p.provenance.reset()
        co = _gnn_cohort(pkg)
        for i, tid in enumerate(streams):
            co.admit(tid, feature_units=gw.default_features(VB, F, seed=i))
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)
        out = co.pump()
        out["g0"] += co.close("g0")
        _eng, folded, rest = co.demote("g1")
        p.provenance.reset()
        recs = [{k: v for k, v in r.items() if k not in ("knobs", "sig")}
                for r in p.provenance.scan(pdir)["records"]]
        evs = [(r["name"], (r.get("a") or {}).get("tenant"))
               for r in p.telemetry.records()
               if r["t"] == "event" and r["name"] in ("tenant_admitted",
                                                      "tier_demotion")]
        spans = [r.get("a") for r in p.telemetry.records()
                 if r["t"] == "span" and r["name"] == "cohort.dispatch"]
        counters = {k: v for k, v in p.metrics.counters().items()
                    if k[0] in ("gs_tenant_windows_total",
                                "gs_tenant_edges_total")}
        return (out, recs, evs, spans, counters,
                p.resilience.demotion_events(), len(rest[0]))

    out, recs, evs, spans, counters, demotions, rest = both(scenario)
    assert len(recs) == sum(len(v) for v in out.values()) == 7
    assert {(r["tier"], r["program"]) for r in recs} == {("gnn_cohort",
                                                          "gnn_round")}
    assert [e for e, _t in evs] == ["tenant_admitted"] * 3 + ["tier_demotion"]
    assert spans == [{"tenants": 3, "windows": 6}, {"tenants": 1,
                                                    "windows": 1}]
    (rec,) = demotions
    assert (rec["component"], rec["from"], rec["to"]) == (
        "tenant:g1", "gnn_cohort", "gnn_scan") and rest == 7


def test_gnn_cohort_armed_equals_disarmed(monkeypatch, tmp_path):
    rng = np.random.default_rng(23)
    streams = {"g%d" % i: (rng.integers(0, VB, 3 * EB).astype(np.int32),
                           rng.integers(0, VB, 3 * EB).astype(np.int32))
               for i in range(3)}

    def run():
        co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")
        for i, tid in enumerate(streams):
            co.admit(tid, feature_units=gw.default_features(VB, F, seed=i))
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)
        return co.pump(), [co.state(t) for t in streams]

    base_out, base_state = run()
    for k in ("GS_TELEMETRY", "GS_METRICS", "GS_PROVENANCE", "GS_COSTMODEL",
              "GS_LATENCY"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path))
    out, state = run()
    assert out == base_out
    for a, b in zip(state, base_state):
        np.testing.assert_array_equal(a, b)
    eng = GnnSummaryEngine(EB, VB, feature_dim=F, device="cpu")
    eng.load_feature_units(gw.default_features(VB, F, seed=0))
    assert out["g0"] == eng.process(*streams["g0"])
