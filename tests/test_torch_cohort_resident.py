"""The port cohort's resident tier, its tenants-per-dispatch tuner arm and
the ingest ring feeding its dispatches (gelly_streaming_tpu_torch/core/
tenancy.py `TenantCohort`, ops/resident_engine.py
`resolve_resident_cohort`) on device="cpu", held against the JAX
package's `TenantCohort` with the same knobs pinned in both packages
(GS_COHORT_RESIDENT, GS_TENANT_TPD, GS_AUTOTUNE; GS_COHORT_PALLAS off,
the tuning cache in tmp_path) and against sequential engines.

Twins of tests/test_tenancy.py :438 (the tpd arm), :521 (resident
parity), :538 (defaults off), :553 (no stranded carry), :581 (the pins),
:600 (the re-key on the cohort bucket) and tests/test_provenance.py :309
(tier `cohort_resident`); then the port's own rules: a refused resident
dispatch leaves the committed stack bit-equal, evicted carries are
copies, tenant states move between the resident cohort, the scan cohort
and the JAX cohort, a round's failure drains the ring with the
undispatched queues kept, and feeder threads append to queues the ring's
preps read. Every summary and carry slot is an integer or a bool:
equality, no tolerance.
"""

import threading

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu.ops import resident_engine as jax_res
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.utils import provenance as jax_provenance
from gelly_streaming_tpu_torch import StreamSummaryEngine, TenantCohort
from gelly_streaming_tpu_torch.core import tenancy
from gelly_streaming_tpu_torch.ops import resident_engine
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import resilience
from gelly_streaming_tpu_torch.utils.streams import make_stream

EB, VB, KB = 128, 256, 16
_KNOBS = ("GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS", "GS_TENANT_ADMISSION",
          "GS_TENANT_TPD", "GS_AUTOTUNE", "GS_COHORT_RESIDENT",
          "GS_COHORT_PALLAS", "GS_OOO_BOUND", "GS_SANITIZE",
          "GS_QUARANTINE_WINDOWS", "GS_RESIDENT_SPB", "GS_RESIDENT_SLOTS",
          "GS_PROVENANCE", "GS_PROVENANCE_DIR", "GS_STAGE_RETRIES",
          "GS_STAGE_TIMEOUT_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    monkeypatch.setenv("GS_COHORT_PALLAS", "off")
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "tune"))
    resilience.reset_demotions()
    jax_res._reset_resident_cohort()
    resident_engine._reset_resident_cohort()
    pallas_window._reset_pallas_window()
    yield
    resilience.reset_demotions()
    jax_res._reset_resident_cohort()
    pallas_window._reset_pallas_window()
    torch.set_num_threads(threads)


def pin(monkeypatch, **knobs):
    """Set GS_* knobs for both packages (the JAX selection memo reset)."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, str(v))
    jax_res._reset_resident_cohort()


def streams_for(n, windows=4, seed=60, ragged=True):
    """n tenant streams; every odd one ends in a partial window."""
    out = {}
    for i in range(n):
        edges = windows * EB - (EB // 3 if ragged and i % 2 else 0)
        s, d = make_stream(edges, VB, seed=seed + i)
        out["t%d" % i] = (s.astype(np.int32), d.astype(np.int32))
    return out


def port_cohort(**kw):
    return TenantCohort(EB, VB, k_bucket=KB, device="cpu", **kw)


def jax_cohort():
    return jax_tenancy.TenantCohort(EB, VB, k_bucket=KB)


def run_cohort(co, streams, piece=2 * EB, close=True):
    """Admit, then feed every tenant `piece` edges a round and pump until
    the streams are in; close every tenant. {tenant: summaries}."""
    for tid in streams:
        if tid not in co.tenants:
            co.admit(tid)
    out = {tid: [] for tid in streams}
    cursor = dict.fromkeys(streams, 0)
    while any(cursor[t] < len(s) for t, (s, _d) in streams.items()):
        for tid, (s, d) in streams.items():
            c = cursor[tid]
            if c < len(s):
                co.feed(tid, s[c:c + piece], d[c:c + piece])
                cursor[tid] = min(len(s), c + piece)
        for tid, res in co.pump().items():
            out[tid].extend(res)
    if close:
        for tid in streams:
            out[tid].extend(co.close(tid))
    return out


def oracle(streams):
    return {tid: StreamSummaryEngine(EB, VB, k_bucket=KB,
                                     device="cpu").process(s, d)
            for tid, (s, d) in streams.items()}


def assert_states_equal(a, b, sentinel=True):
    """Equal states, carries bit for bit; `sentinel=False` leaves out
    the cover's slot 2vb+1, which records whether padded windows were
    folded (batching differs between a resumed and a whole run)."""
    assert {k: v for k, v in a.items() if k != "carry"} == {
        k: v for k, v in b.items() if k != "carry"}
    for i, (x, y) in enumerate(zip(a["carry"], b["carry"])):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.int32
        if i == 2 and not sentinel:
            x, y = np.delete(x, 2 * VB + 1), np.delete(y, 2 * VB + 1)
        np.testing.assert_array_equal(x, y)


def stack_rows(co, vb=VB, kb=KB) -> dict:
    """{tenant: host copies of its row} of the committed resident stack."""
    entry = co._res[(vb, kb)]
    return {tid: tuple(a[r].clone().numpy() for a in entry["carry"])
            for r, tid in enumerate(entry["rows"]) if tid}


# ----------------------------------------------------------------------
# twins of tests/test_tenancy.py
# ----------------------------------------------------------------------
@pytest.mark.parametrize("resident", ["off", "on"])
def test_tpd_arm_records_rounds(monkeypatch, tmp_path, resident):
    """GS_AUTOTUNE=1: the `tenant_cohort` family owns a tpd arm (and an
    spb arm on the resident tier); rounds record edges/s; summaries
    equal the JAX cohort's and the engines' at every arm (each package
    with a tuning cache of its own)."""
    pin(monkeypatch, GS_AUTOTUNE=1, GS_COHORT_RESIDENT=resident)
    streams = streams_for(4)
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "torch"))
    co = port_cohort()
    got = run_cohort(co, streams, piece=EB)
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "jax"))
    jax_co = jax_cohort()
    assert got == run_cohort(jax_co, streams, piece=EB) == oracle(streams)
    for c in (co, jax_co):
        summary = c._tuner(VB).summary()
        assert summary["rounds"] >= 1
        assert "tpd" in summary["chosen"]
        assert ("spb" in summary["chosen"]) == (resident == "on")
    assert co._tuner(VB).key == jax_co._tuner(VB).key \
        == "tenant_cohort:eb=%d:vb=%d:N=8" % (EB, VB)
    assert co._tuner(VB).space == jax_co._tuner(VB).space


@pytest.mark.parametrize("n_tenants", [1, 3, 8])
def test_resident_cohort_parity(monkeypatch, n_tenants):
    """Pinned on, the resident tier reproduces the JAX resident cohort
    and the sequential engines, window by window and carry by carry,
    and really dispatched through the tier."""
    pin(monkeypatch, GS_COHORT_RESIDENT="on")
    streams = streams_for(n_tenants)
    co, jax_co = port_cohort(), jax_cohort()
    got = run_cohort(co, streams, piece=EB)
    assert got == run_cohort(jax_co, streams, piece=EB) == oracle(streams)
    assert co.resident_dispatches > 0 and jax_co.resident_dispatches > 0
    for tid in streams:
        assert_states_equal(co.tenant_state_dict(tid),
                            jax_co.tenant_state_dict(tid))


def _plan(co):
    """Record each dispatch's (vb, nb, wb, tenants) through `co`."""
    plan = []
    real = co._dispatch_batch

    def spy(vb, kb, slab, out, staged):
        plan.append((vb, slab[0], slab[1],
                     tuple(t.tid for t, _r, _w, _n in slab[5])))
        return real(vb, kb, slab, out, staged)

    co._dispatch_batch = spy
    return plan


@pytest.mark.parametrize("knob", [None, "auto", "off"])
def test_resident_cohort_defaults_off(monkeypatch, knob):
    """GS_COHORT_RESIDENT unset (or auto, or off) is the scan form: no
    resident dispatch, the dispatch plan and the results of a scan
    cohort; pinned on, the same results."""
    streams = streams_for(3)
    if knob is not None:
        pin(monkeypatch, GS_COHORT_RESIDENT=knob)
    co = port_cohort()
    plan = _plan(co)
    base = run_cohort(co, streams)
    assert co.resident_dispatches == 0 and co._res == {}
    pin(monkeypatch, GS_COHORT_RESIDENT="off")
    scan = port_cohort()
    scan_plan = _plan(scan)
    assert run_cohort(scan, streams) == base and plan == scan_plan
    assert base == run_cohort(jax_cohort(), streams)
    pin(monkeypatch, GS_COHORT_RESIDENT="on")
    res = port_cohort()
    assert run_cohort(res, streams) == base
    assert res.resident_dispatches > 0


def test_resident_stack_replacement_never_strands_a_carry(monkeypatch):
    """Staggered streams churn the batch's rows across rounds, then each
    close dispatches a batch of one: every restack must first give the
    old stack's tenants their rows, or a later window folds onto another
    row's carry."""
    rng = np.random.default_rng(7)
    streams = {}
    for i in range(4):
        edges = EB * (3 + i) - (EB // 3 if i % 2 else 0)
        streams["t%d" % i] = (rng.integers(0, VB, edges).astype(np.int32),
                              rng.integers(0, VB, edges).astype(np.int32))
    pin(monkeypatch, GS_COHORT_RESIDENT="on")
    co, jax_co = port_cohort(), jax_cohort()
    got = run_cohort(co, streams, piece=2 * EB)
    assert co.resident_dispatches > 0 and co.resident_restacks > 1
    assert got == oracle(streams) == run_cohort(jax_co, streams,
                                                piece=2 * EB)
    for tid in streams:
        assert_states_equal(co.tenant_state_dict(tid),
                            jax_co.tenant_state_dict(tid))


def test_resolve_resident_cohort_pins_only(monkeypatch):
    """`on` selects the tier and `off` does not, in both packages; unset
    and `auto` are the port's scan form whatever evidence the JAX
    package would adopt it on."""
    for knob, want in (("on", True), ("off", False)):
        pin(monkeypatch, GS_COHORT_RESIDENT=knob)
        assert resident_engine.resolve_resident_cohort() is want
        assert jax_res.resolve_resident_cohort() is want
    winning = [{"probe": "cohort_resident", "parity": True, "tenants": 8,
                "tenant_edges_per_s": 2000,
                "sequential_edges_per_s": 1000, "speedup": 2.0}]
    monkeypatch.setattr(jax_tri, "_load_matching_perf",
                        lambda *a, **k: {"tenancy_ab": winning})
    for knob in (None, "auto"):
        if knob is None:
            monkeypatch.delenv("GS_COHORT_RESIDENT")
        else:
            monkeypatch.setenv("GS_COHORT_RESIDENT", knob)
        jax_res._reset_resident_cohort()
        resident_engine._reset_resident_cohort()
        assert jax_res.resolve_resident_cohort() is True
        assert resident_engine.resolve_resident_cohort() is False
    assert port_cohort()._window_ceiling() == port_cohort().wc


def test_tuner_rekeys_on_cohort_bucket(monkeypatch):
    """The family key holds the cohort bucket: a cohort grown past it
    re-keys the same tuner (not a new one) with the new bucket's arms,
    as the JAX cohort does."""
    pin(monkeypatch, GS_AUTOTUNE=1)
    streams = streams_for(2, ragged=False)
    keys = []
    for co in (port_cohort(), jax_cohort()):
        for tid, (s, d) in streams.items():
            co.admit(tid)
            co.feed(tid, s[:EB], d[:EB])
        co.pump()
        t1 = co._tuner(VB)
        first = (t1.key, max(t1.space["tpd"]))
        s, d = streams["t0"]
        for i in range(10, 18):
            co.admit("t%d" % i)
            co.feed("t%d" % i, s[:EB], d[:EB])
        co.pump()
        t2 = co._tuner(VB)
        assert t2 is t1 and t2 is co._tuner(VB)
        keys.append((first, (t2.key, max(t2.space["tpd"]))))
    assert keys[0] == keys[1]
    assert keys[0][0][0].endswith(":N=8") and keys[0][1] == (
        "tenant_cohort:eb=%d:vb=%d:N=16" % (EB, VB), 16)


def test_tpd_pins_and_the_constructor_override(monkeypatch):
    """GS_TENANT_TPD pins tenants per dispatch in both packages; the
    constructor's `tenants_per_dispatch` above 0 wins over it, 0 reads
    it; a pin leaves no tuner, whatever GS_AUTOTUNE says."""
    pin(monkeypatch, GS_AUTOTUNE=1, GS_TENANT_TPD=3)
    assert tenancy.pinned_tpd() == jax_tenancy.pinned_tpd() == 3
    co, jax_co = port_cohort(), jax_cohort()
    assert co._resolve_tpd(VB, 7) == jax_co._resolve_tpd(VB, 7) == (3, None)
    assert co._tuner(VB) is None
    assert port_cohort(tenants_per_dispatch=2)._resolve_tpd(VB, 7) \
        == (2, None)
    streams = streams_for(5)
    plan_co = port_cohort()
    plan = _plan(plan_co)
    assert run_cohort(plan_co, streams) == oracle(streams)
    assert max(len(p[3]) for p in plan) == 3
    with pytest.raises(ValueError):
        port_cohort(tenants_per_dispatch=-1)


# ----------------------------------------------------------------------
# provenance (twin of tests/test_provenance.py :309)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode,tier", [("off", "cohort"),
                                       ("on", "cohort_resident")])
def test_provenance_tier(monkeypatch, tmp_path, mode, tier):
    src, dst = make_stream(2 * EB, VB, seed=3)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    pin(monkeypatch, GS_PROVENANCE=1, GS_COHORT_RESIDENT=mode)
    seen = {}
    for pkg, prov, make in (("torch", provenance, port_cohort),
                            ("jax", jax_provenance, jax_cohort)):
        pdir = str(tmp_path / pkg)
        monkeypatch.setenv("GS_PROVENANCE_DIR", pdir)
        prov.reset()
        co = make()
        delivered = {}
        for tid in ("p0", "p1"):
            co.admit(tid)
            co.feed(tid, src.copy(), dst.copy())
        for tid, rows in co.pump().items():
            delivered.setdefault(tid, []).extend(rows)
        prov.reset()
        recs = prov.scan(pdir)["records"]
        assert recs and all(r["tier"] == tier for r in recs)
        assert all(r["program"] == "cohort_scan" for r in recs)
        for tid, rows in delivered.items():
            mine = [r for r in recs if r["tenant"] == tid]
            assert [r["window"] for r in mine] == list(range(len(rows)))
            assert [r["digest"] for r in mine] == [
                prov.summary_digest(x) for x in rows]
        seen[pkg] = [{k: v for k, v in r.items() if k not in ("knobs", "sig")}
                     for r in recs]
    assert seen["torch"] == seen["jax"]


# ----------------------------------------------------------------------
# the port's rules: the committed stack, copies, states across tiers
# ----------------------------------------------------------------------
def _poison_summary(co, hostile, armed):
    """Make the dispatches carrying `hostile` come back with max_degree
    -1 in its row (a PoisonOutput at the gate) while armed[0]."""
    real_batch = co._dispatch_batch

    def evil(vb, kb, slab, out, staged):
        rows = [r for t, r, _w, _n in slab[5]
                if t.tid == hostile and armed[0]]
        summ = tenancy.TenantCohort._summary(co, vb, kb)

        def poisoned(carries, src, dst, valid):
            outs = summ(carries, src, dst, valid)
            if not rows:
                return outs
            mdeg = outs[0].clone()
            mdeg[rows[0]] = -1
            return (mdeg,) + tuple(outs[1:])

        co._summary = lambda _vb, _kb: poisoned
        try:
            return real_batch(vb, kb, slab, out, staged)
        finally:
            del co._summary

    co._dispatch_batch = evil


def _dispatch_fault(hostile, armed):
    def poison(payload):
        if payload and hostile in payload and armed[0]:
            raise faults.InjectedFault("poisoned", "cohort_dispatch")
        return payload
    return faults.inject(faults.FaultSpec(
        site="cohort_dispatch", action="call", fn=poison, times=10 ** 6))


@pytest.mark.parametrize("refusal", ["poison_output", "dispatch_fault"])
def test_refused_resident_dispatch_keeps_the_committed_stack(monkeypatch,
                                                             refusal):
    """A dispatch refused on a resident hit (a PoisonOutput at the gate,
    or a `cohort_dispatch` fault the bulkhead bisects) leaves the
    committed stack bit-equal to what it was before it; exactly the
    hostile tenant is quarantined (and re-admitted after one clean
    probation window); every stream equals the engines'."""
    pin(monkeypatch, GS_COHORT_RESIDENT="on", GS_QUARANTINE_WINDOWS=1)
    streams = streams_for(4, windows=3, ragged=False)
    co = port_cohort()
    armed = [True]          # hostile until its first quarantine
    quarantine = co._quarantine

    def disarm(t, reason):
        armed[0] = False
        quarantine(t, reason)

    co._quarantine = disarm
    for tid in streams:
        co.admit(tid)
    out = {tid: [] for tid in streams}
    for tid, (s, d) in streams.items():
        co.feed(tid, s[:EB], d[:EB])
    for tid, rows in co.pump().items():
        out[tid].extend(rows)
    before = stack_rows(co)
    for tid, (s, d) in streams.items():
        co.feed(tid, s[EB:], d[EB:])
    at_refusal = []
    real_batch = co._dispatch_batch

    def watch(vb, kb, slab, o, staged):
        try:
            return real_batch(vb, kb, slab, o, staged)
        except (tenancy.PoisonOutput, faults.InjectedFault):
            if not at_refusal:
                at_refusal.append(stack_rows(co))
            raise

    co._dispatch_batch = watch
    if refusal == "poison_output":
        _poison_summary(co, "t1", armed)
        got = co.pump()
    else:
        with _dispatch_fault("t1", armed):
            got = co.pump()
    del co._dispatch_batch
    assert at_refusal, "no dispatch was refused"
    assert at_refusal[0].keys() == before.keys()
    for tid, rows in before.items():
        for x, y in zip(rows, at_refusal[0][tid]):
            np.testing.assert_array_equal(x, y)
    # exactly t1 was quarantined, then re-admitted by its probation
    assert [(e["component"], e["to"]) for e in
            resilience.demotion_events()] == [("tenant:t1", "quarantined")]
    assert co.quarantined() == [] and co.tenant_tier("t1") == "cohort"
    for tid, rows in got.items():
        out[tid].extend(rows)
    for tid in streams:
        out[tid].extend(co.close(tid))
    assert out == oracle(streams)


def test_evicted_carries_are_copies(monkeypatch):
    """The carries a restack evicts own their memory: folding the stack's
    buffers again leaves them as they were, and every stream stays
    exact."""
    pin(monkeypatch, GS_COHORT_RESIDENT="on")
    streams = streams_for(4, windows=4, ragged=False)
    co = port_cohort()
    out = {tid: [] for tid in streams}

    def feed_pump(tids, lo, hi):
        for tid in tids:
            s, d = streams[tid]
            co.feed(tid, s[lo:hi], d[lo:hi])
        for tid, rows in co.pump().items():
            out[tid].extend(rows)

    for tid in streams:
        co.admit(tid)
    feed_pump(streams, 0, 2 * EB)
    entry = co._res[(VB, KB)]
    base = {a.untyped_storage().data_ptr() for a in entry["carry"]}
    kept = {tid: co.tenant_state_dict(tid)["carry"] for tid in streams}
    co.demote("t3", reason="test")          # breaks residency: evicts all
    assert co._res == {}
    for tid in ("t0", "t1", "t2"):
        t = co.tenants[tid]
        assert t.res_row is None
        for x, want in zip(t.carry, kept[tid]):
            assert x.untyped_storage().data_ptr() not in base
            assert x.untyped_storage().nbytes() == x.nbytes
            np.testing.assert_array_equal(x.numpy(), want)
    snap = {tid: tuple(x.clone() for x in co.tenants[tid].carry)
            for tid in ("t1", "t2")}
    # t0 alone restacks into the same buffers and folds them again
    feed_pump(["t0"], 2 * EB, 3 * EB)
    assert co._res[(VB, KB)]["rows"][0] == "t0"
    assert {a.untyped_storage().data_ptr()
            for a in co._res[(VB, KB)]["carry"]} == base
    for tid in ("t1", "t2"):
        for x, y in zip(co.tenants[tid].carry, snap[tid]):
            assert torch.equal(x, y)
    feed_pump(["t1", "t2", "t3"], 2 * EB, 4 * EB)
    feed_pump(["t0"], 3 * EB, 4 * EB)
    assert out == oracle(streams)


@pytest.mark.parametrize("source,target", [
    ("resident", "scan"), ("resident", "jax"), ("scan", "resident"),
    ("jax", "resident"), ("resident", "resident")])
def test_tenant_states_move_between_tiers_and_packages(monkeypatch, source,
                                                       target):
    """Half of each stream through one cohort, its tenant_state_dicts
    loaded into another (the port's resident or scan form, or the JAX
    cohort), the rest there: the windows and final carries of one
    uninterrupted cohort."""
    streams = streams_for(3, windows=6)
    half = 3 * EB
    whole = oracle(streams)

    def make(form):
        pin(monkeypatch, GS_COHORT_RESIDENT="off" if form == "scan"
            else "on")
        return jax_cohort() if form == "jax" else port_cohort()

    first = make(source)
    got = run_cohort(first, {tid: (s[:half], d[:half])
                             for tid, (s, d) in streams.items()},
                     close=False)
    states = {tid: first.tenant_state_dict(tid) for tid in streams}
    second = make(target)
    for tid, state in states.items():
        second.admit(tid)
        second.load_tenant_state_dict(tid, state)
    rest = run_cohort(second, {tid: (s[half:], d[half:])
                               for tid, (s, d) in streams.items()})
    for tid in streams:
        assert got[tid] + rest[tid] == whole[tid], tid
    twin = make(target)
    run_cohort(twin, streams)
    for tid in streams:
        assert_states_equal(second.tenant_state_dict(tid),
                            twin.tenant_state_dict(tid), sentinel=False)


# ----------------------------------------------------------------------
# the ingest ring
# ----------------------------------------------------------------------
@pytest.mark.parametrize("resident", ["off", "on"])
def test_ring_failure_drains_and_keeps_the_queues(monkeypatch, resident):
    """GS_TENANT_TPD=2 over six tenants: three batches a round, the ring
    prepping ahead. A failed staging copy in the second batch raises
    with the ring drained: the first batch's queues are consumed, the
    second's and third's are not; the next pump finishes the streams
    exactly."""
    pin(monkeypatch, GS_TENANT_TPD=2, GS_COHORT_RESIDENT=resident)
    streams = streams_for(6, windows=2, ragged=False)
    co = port_cohort()
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    submitted = []
    submit = co._ring.submit
    co._ring.submit = lambda fn, key, item: (
        submitted.append(key), submit(fn, key, item))[1]
    with faults.inject(faults.FaultSpec(site="h2d", on_call=2)):
        with pytest.raises(faults.InjectedFault):
            co.pump()
    assert len(co._ring) == 0 and submitted[:2] == [0, 1]
    assert [co.queued_edges(t) for t in sorted(streams)] == \
        [0, 0] + [2 * EB] * 4
    assert co.quarantined() == [] and resilience.demotion_events() == []
    out = co.pump()
    for tid in streams:
        out.setdefault(tid, []).extend(co.close(tid))
    want = oracle(streams)
    assert {t: out[t] for t in ("t2", "t3", "t4", "t5")} == {
        t: want[t] for t in ("t2", "t3", "t4", "t5")}


def test_ring_prep_fault_demotes_exactly_the_failing_tenant(monkeypatch):
    """A `tenant_prep` failure on a ring worker demotes that tenant alone
    (its stream goes on exactly on its own engine); every other tenant
    stays on the cohort, exact, in either package."""
    pin(monkeypatch, GS_TENANT_TPD=2)
    streams = streams_for(6, windows=3)
    threads = set()

    def hostile(payload):
        threads.add(threading.current_thread().name)
        if payload == "t3":
            raise RuntimeError("corrupt slab input")
        return payload

    co = port_cohort()
    with faults.inject(faults.FaultSpec(site="tenant_prep", action="call",
                                        fn=hostile, times=10 ** 6)):
        got = run_cohort(co, streams)
    assert got == oracle(streams)
    assert [co.tenant_tier(t) for t in sorted(streams)] == \
        ["cohort"] * 3 + ["single"] + ["cohort"] * 2
    assert [e["component"] for e in resilience.demotion_events()] == \
        ["tenant:t3"]
    assert any(n.startswith("gs-ingress-prep") for n in threads)


def test_ring_and_stack_under_concurrent_feeds(monkeypatch):
    """More feeder threads than cores, a 1e-5 s switch interval: each
    feeds its tenant in half-window pieces, retrying on backpressure,
    while this thread pumps with two tenants a dispatch (the ring's
    preps snapshot queues the feeders append to) on the resident tier.
    Every window equals the engines': no lost or doubled edge."""
    import os
    import sys

    pin(monkeypatch, GS_TENANT_TPD=2, GS_COHORT_RESIDENT="on",
        GS_TENANT_QUEUE_WINDOWS=2)
    n = min(len(os.sched_getaffinity(0)) + 2, 16)
    streams = streams_for(n, windows=3, ragged=False)
    co = port_cohort()
    for tid in streams:
        co.admit(tid)
    out = {tid: [] for tid in streams}
    errs = []

    def feeder(tid, s, d):
        try:
            at = 0
            while at < len(s):
                try:
                    at += co.feed(tid, s[at:at + EB // 2],
                                  d[at:at + EB // 2])
                except tenancy.TenantBackpressure:
                    threading.Event().wait(1e-3)
        except Exception as e:          # raised after the join
            errs.append((tid, e))

    threads = [threading.Thread(target=feeder, args=(tid, s, d))
               for tid, (s, d) in streams.items()]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            for tid, rows in co.pump().items():
                out[tid].extend(rows)
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads) and not errs, errs
    finally:
        sys.setswitchinterval(switch)
    for tid, rows in co.pump().items():
        out[tid].extend(rows)
    for tid in streams:
        out[tid].extend(co.close(tid))
    assert out == oracle(streams)
    assert co.resident_dispatches > 0
