"""The port cohort's bulkhead (gelly_streaming_tpu_torch/core/tenancy.py:
bisect, the poison gate, quarantine, probation, the systemic-failure
revocation, demotion on a failed slab prep, quarantine across
checkpoints) held against the JAX package's `TenantCohort` on the CPU,
and the port's own rules, which the JAX bulkhead does not keep.

Each cross-package case runs one numpy-seeded scenario through both
packages, each with its own fault plan, and compares what a caller sees:
every tenant's summaries, `quarantined()`, each tenant's tier after each
pump, the demotion records and the cohort's telemetry events (names and
tenants, in order). The JAX cohort runs its XLA form (GS_COHORT_RESIDENT
and GS_COHORT_PALLAS off, GS_AUTOTUNE=0) with K given to both. The
scenarios mirror tests/test_sanitize.py's bulkhead cases and
tests/test_tenancy.py's demotion cases.

The port's rules: a device error (`resilience.is_device_error`: a
`KernelError`, a CUDA error, anything raised from one) out of the launch
or a probation probe, and a failed staging copy (h2d), raise to the
caller unwrapped or typed, with no bisect, quarantine or demotion; a
refused dispatch changes no tenant state; demoted and probation engines
run on the cohort's device."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu.ops import resident_engine
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import resilience as jax_resilience
from gelly_streaming_tpu.utils import sanitize as jax_sanitize
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu_torch import StreamSummaryEngine, kernels
from gelly_streaming_tpu_torch.core import tenancy
from gelly_streaming_tpu_torch.ops import ingress_pipeline
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import resilience
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry

EB, VB, KB = 64, 128, 16
PKGS = {
    "jax": SimpleNamespace(tenancy=jax_tenancy, faults=jax_faults,
                           resilience=jax_resilience,
                           telemetry=jax_telemetry),
    "torch": SimpleNamespace(tenancy=tenancy, faults=faults,
                             resilience=resilience, telemetry=telemetry),
}
# the cohort's own events (the JAX and port names), compared in order
COHORT_EVENTS = ("tenant_admitted", "tenant_rejected", "quarantine",
                 "quarantine_revoked", "quarantine_probe",
                 "quarantine_probe_failed", "quarantine_released",
                 "cohort_bisect", "tier_demotion", "fault_injected")
_KNOBS = ("GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS", "GS_TENANT_ADMISSION",
          "GS_TENANT_TPD", "GS_QUARANTINE_WINDOWS", "GS_OOO_BOUND",
          "GS_SANITIZE", "GS_DLQ_DIR", "GS_LATENCY", "GS_METRICS",
          "GS_PROVENANCE", "GS_PROVENANCE_DIR", "GS_COSTMODEL",
          "GS_TRACE_DIR", "GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES",
          "GS_STAGE_BACKOFF_S", "GS_WAL", "GS_WAL_RETAIN")
_RESETS = (telemetry, metrics, sanitize, jax_telemetry, jax_metrics,
           jax_sanitize)


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
                 ("GS_COHORT_PALLAS", "off"), ("GS_TELEMETRY", "1"),
                 ("GS_STAGE_BACKOFF_S", "0")):
        monkeypatch.setenv(k, v)
    _reset()
    yield
    _reset()
    torch.set_num_threads(threads)


def make(pkg: str, **kw):
    if pkg == "jax":
        return jax_tenancy.TenantCohort(EB, VB, k_bucket=KB, **kw)
    return tenancy.TenantCohort(EB, VB, k_bucket=KB, device="cpu", **kw)


def streams_for(n, windows, seed=0):
    rng = np.random.default_rng(seed)
    return {"t%d" % i: (rng.integers(0, VB, windows * EB).astype(np.int32),
                        rng.integers(0, VB, windows * EB).astype(np.int32))
            for i in range(n)}


def oracle(streams):
    return {tid: StreamSummaryEngine(EB, VB, k_bucket=KB,
                                     device="cpu").process(s, d)
            for tid, (s, d) in streams.items()}


def poison_plan(p, hostile):
    """A `cohort_dispatch` fault on every dispatch that carries
    `hostile`."""
    def poison(payload):
        if payload and hostile in payload:
            raise p.faults.InjectedFault("poisoned", "cohort_dispatch")
        return payload

    return p.faults.FaultSpec(site="cohort_dispatch", action="call",
                              fn=poison, times=10 ** 6)


def observed(p, co, out):
    """What a caller of either package sees after a scenario."""
    return {
        "out": {k: list(v) for k, v in sorted(out.items())},
        "quarantined": co.quarantined(),
        "tiers": {tid: co.tenant_tier(tid) for tid in sorted(co.tenants)},
        "demotions": p.resilience.demotion_events(),
        "events": [(r["name"], (r.get("a") or {}).get("tenant"))
                   for r in p.telemetry.records()
                   if r["t"] == "event" and r["name"] in COHORT_EVENTS],
    }


def both(scenario):
    """Run `scenario(p, pkg)` -> observed dict in each package; return
    the two after asserting they are equal."""
    got = {}
    for pkg, p in PKGS.items():
        _reset()
        got[pkg] = scenario(p, pkg)
    assert got["torch"] == got["jax"]
    return got["torch"]


def merge(into, out):
    for k, v in out.items():
        into.setdefault(k, []).extend(v)
    return into


# ----------------------------------------------------------------------
# bisect, poison gate, probation, systemic failure (against JAX)
# ----------------------------------------------------------------------
def test_bisect_isolates_exactly_the_poison_tenant():
    streams = streams_for(8, 1, seed=11)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        with p.faults.inject(poison_plan(p, "t5")):
            for tid, (s, d) in streams.items():
                co.feed(tid, s, d)
            out = co.pump()
        return observed(p, co, out)

    seen = both(scenario)
    assert seen["quarantined"] == ["t5"]
    want = oracle(streams)
    for tid in streams:
        if tid != "t5":
            assert seen["out"][tid] == want[tid], tid
    assert [e for e, _t in seen["events"]].count("cohort_bisect") == 3
    assert [d["to"] for d in seen["demotions"]] == ["quarantined"]


def _poison_rows(p, pkg, co, hostile):
    """Wrap the cohort's dispatch so the slab row of `hostile` comes back
    with max_degree -1 (the JAX package's test_poison_output_quarantines
    _by_row, on each package's own dispatch). Returns the undo."""
    if pkg == "jax":
        cls = jax_tenancy.TenantCohort
        real_batch = cls._dispatch_batch

        def evil(vb, kb, slab, out, staged):
            nb, wb, *_x = slab
            real = slab[5]
            orig = cls._program.__get__(co)

            def poisoned(stacked, sj, dj, vj):
                carries, outs = orig(vb, kb, nb, wb)(stacked, sj, dj, vj)
                rows = [r for t, r, _w, _n in real if t.tid == hostile]
                mdeg = outs[0]
                if rows:
                    mdeg = mdeg.at[rows[0]].set(-1)
                return carries, (mdeg,) + tuple(outs[1:])

            co._program = lambda *a: poisoned
            try:
                return real_batch(co, vb, kb, slab, out, staged)
            finally:
                del co._program
    else:
        real_batch = co._dispatch_batch

        def evil(vb, kb, slab, out, staged):
            rows = [r for t, r, _w, _n in slab[5] if t.tid == hostile]
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

    def undo():
        del co._dispatch_batch
    return undo


def test_poison_output_quarantines_by_row():
    streams = streams_for(3, 1, seed=12)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)
        undo = _poison_rows(p, pkg, co, "t1")
        got = co.pump()
        undo()
        tiers = [co.tenant_tier("t1")]
        merge(got, co.pump())
        tiers.append(co.tenant_tier("t1"))
        return dict(observed(p, co, got), t1_tiers=tiers)

    seen = both(scenario)
    want = oracle(streams)
    assert seen["t1_tiers"] == ["quarantined", "quarantined"]
    for tid in ("t0", "t2"):
        assert seen["out"][tid] == want[tid], tid
    # the probation window of the quarantined tenant is exact too
    assert seen["out"]["t1"] == want["t1"]
    assert "cohort_bisect" not in [e for e, _t in seen["events"]]


@pytest.mark.parametrize("qw", [2, 3])
def test_probation_readmits_after_clean_windows(monkeypatch, qw):
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", str(qw))
    streams = streams_for(2, 4, seed=13)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        with p.faults.inject(poison_plan(p, "t1")):
            for tid, (s, d) in streams.items():
                co.feed(tid, s[:EB], d[:EB])
            got = co.pump()
        tiers = [co.tenant_tier("t1")]
        for w in range(1, 4):
            for tid, (s, d) in streams.items():
                co.feed(tid, s[w * EB:(w + 1) * EB], d[w * EB:(w + 1) * EB])
            merge(got, co.pump())
            tiers.append(co.tenant_tier("t1"))
        for _ in range(4):
            merge(got, co.pump())
            tiers.append(co.tenant_tier("t1"))
        return dict(observed(p, co, got), t1_tiers=tiers)

    seen = both(scenario)
    assert seen["tiers"]["t1"] == "cohort"          # re-admitted
    assert seen["t1_tiers"][0] == "quarantined"
    assert seen["out"] == oracle(streams)
    names = [e for e, _t in seen["events"]]
    assert names.count("quarantine_probe") == qw
    assert names.count("quarantine_released") == 1


def test_probe_failure_resets_probation(monkeypatch):
    """A host-side failure of a probe (a prep fault inside the probe
    engine's pipeline) resets probation and drops the engine; the next
    probe starts again from the untouched carry and is exact."""
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "2")
    streams = streams_for(2, 3, seed=16)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)
        co.quarantine("t1", "operator")
        with p.faults.inject(p.faults.FaultSpec(site="prep", on_call=1)):
            got = co.pump(max_rounds=1)
        state = (co.tenants["t1"].probation, co.tenants["t1"].engine is None,
                 co.queued_edges("t1"))
        merge(got, co.pump())
        for tid in streams:
            merge(got, {tid: co.close(tid)})
        return dict(observed(p, co, got), after_failure=state)

    seen = both(scenario)
    assert seen["after_failure"] == (0, True, 3 * EB)
    assert seen["out"] == oracle(streams)
    assert ("quarantine_probe_failed", "t1") in seen["events"]


def test_systemic_failure_revokes_quarantines_and_raises():
    """A failure that follows every tenant alone is not poison: the
    quarantines are revoked, the fault raises, and the next pump gives
    the exact windows."""
    streams = streams_for(4, 1, seed=15)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)

        def always_fail(payload):
            raise p.faults.InjectedFault("device is gone", "cohort_dispatch")

        with p.faults.inject(p.faults.FaultSpec(
                site="cohort_dispatch", action="call", fn=always_fail,
                times=10 ** 6)):
            with pytest.raises(p.faults.InjectedFault):
                co.pump()
        assert co.quarantined() == []
        return observed(p, co, co.pump())

    seen = both(scenario)
    assert seen["out"] == oracle(streams)
    names = [e for e, _t in seen["events"]]
    assert names.count("quarantine") == names.count("quarantine_revoked") == 4


def test_permanent_quarantine_refuses_feeds(monkeypatch):
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "0")

    def scenario(p, pkg):
        co = make(pkg)
        co.admit("t")
        co.quarantine("t", "operator says no")
        with pytest.raises(p.tenancy.TenantQuarantined) as ei:
            co.feed("t", np.array([1]), np.array([2]))
        assert ei.value.probation_left == -1 and ei.value.tenant == "t"
        assert co.pump() == {}
        return observed(p, co, {})

    seen = both(scenario)
    assert seen["quarantined"] == ["t"]
    assert ("tenant_rejected", "t") in seen["events"]


@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch"),
                                           ("torch", "torch")])
def test_quarantine_state_survives_checkpoint(monkeypatch, writer, reader):
    """A quarantined tenant's state carries its bulkhead both ways
    across the packages (equal bit for bit); it restores still
    quarantined with its probation progress, and a generation saved
    before the quarantine rewinds the bulkhead."""
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "3")
    streams = streams_for(2, 3, seed=14)
    states = {}
    for pkg in PKGS:
        p = PKGS[pkg]
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        with p.faults.inject(poison_plan(p, "t1")):
            for tid, (s, d) in streams.items():
                co.feed(tid, s[:EB], d[:EB])
            co.pump()
        for tid, (s, d) in streams.items():
            co.feed(tid, s[EB:2 * EB], d[EB:2 * EB])
        co.pump()                     # the second clean probe of t1
        assert co.quarantined() == ["t1"] and co.tenants["t1"].probation == 2
        states[pkg] = co.state_dict()
    mine, theirs = (states["torch"]["tenants"]["t1"],
                    states["jax"]["tenants"]["t1"])
    assert mine["quarantine"] == theirs["quarantine"] \
        == {"probation": 2, "reason": mine["quarantine"]["reason"]}
    for a, b in zip(mine["carry"], theirs["carry"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    co2 = make(reader)
    co2.load_state_dict(states[writer])
    assert co2.tenant_tier("t1") == "quarantined"
    assert co2.tenants["t1"].probation == 2
    assert co2.tenants["t1"].quarantine_reason
    clean = make(reader)
    clean.admit("t1")
    co2.load_tenant_state_dict("t1", clean.tenant_state_dict("t1"))
    assert co2.tenant_tier("t1") == "cohort" and co2.quarantined() == []


def test_poisoned_prep_demotes_only_the_sick_tenant():
    streams = streams_for(3, 3, seed=17)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        for tid, (s, d) in streams.items():
            co.feed(tid, s, d)
        # the round preps tenants in sorted order: call 2 fails t1
        with p.faults.inject(p.faults.FaultSpec(site="tenant_prep",
                                                on_call=2)):
            got = co.pump()
        for tid in streams:
            merge(got, {tid: co.close(tid)})
        return observed(p, co, got)

    seen = both(scenario)
    assert seen["out"] == oracle(streams)
    assert seen["tiers"]["t1"] == "single"
    (rec,) = seen["demotions"]
    assert (rec["component"], rec["from"], rec["to"], rec["tenant"]) == (
        "tenant:t1", "cohort", "single", "t1")


@pytest.mark.parametrize("refusal", ["fault", "poison"])
def test_prep_demoted_tenant_is_not_folded_by_the_retry(refusal):
    """A tenant demoted by a failed slab prep is left out of the
    bulkhead's bisect and re-dispatch of the same batch: its own engine
    holds its state, so a retry that folded it in the cohort would move
    its queue and cursor past that engine (the port's rule; the JAX
    bulkhead retries the whole batch)."""
    streams = streams_for(4, 3, seed=26)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    undo = None
    plans = [faults.FaultSpec(site="tenant_prep", on_call=1)]
    if refusal == "fault":
        plans.append(poison_plan(PKGS["torch"], "t2"))
    else:
        undo = _poison_rows(PKGS["torch"], "torch", co, "t2")
    with faults.inject(*plans):
        got = co.pump(max_rounds=1)
    if undo is not None:
        undo()
    assert co.tenant_tier("t0") == "single"
    assert co.quarantined() == ["t2"]
    assert co.windows_done("t0") == 0 and co.queued_edges("t0") == 3 * EB
    assert "t0" not in got
    merge(got, co.pump())
    for tid in streams:
        merge(got, {tid: co.close(tid)})
    assert got == oracle(streams)
    assert [(d["tenant"], d["to"]) for d in resilience.demotion_events()] \
        == [("t0", "single"), ("t2", "quarantined")]


def test_demoted_tenant_runs_single_while_cohort_dispatches():
    streams = streams_for(3, 4, seed=18)

    def scenario(p, pkg):
        co = make(pkg)
        for tid in streams:
            co.admit(tid)
        for tid, (s, d) in streams.items():
            co.feed(tid, s[:2 * EB], d[:2 * EB])
        got = co.pump()
        co.demote("t1", reason="test drill")
        tiers = {tid: co.tenant_tier(tid) for tid in streams}
        for tid, (s, d) in streams.items():
            co.feed(tid, s[2 * EB:], d[2 * EB:])
        merge(got, co.pump())
        for tid in streams:
            merge(got, {tid: co.close(tid)})
        return dict(observed(p, co, got), mid=tiers)

    seen = both(scenario)
    assert seen["mid"] == {"t0": "cohort", "t1": "single", "t2": "cohort"}
    assert seen["out"] == oracle(streams)
    assert seen["demotions"][0]["reason"] == "test drill"


# ----------------------------------------------------------------------
# (d) a refused dispatch changes no state
# ----------------------------------------------------------------------
def _snapshot(co):
    return {tid: (tuple(x.clone() for x in co._carry_of(t)), t.src.copy(),
                  t.dst.copy(), t.windows_done, t.bp_stamped,
                  t.closed_partial)
            for tid, t in co.tenants.items()}


def _same(a, b):
    assert a.keys() == b.keys()
    for tid in a:
        (ca, *ra), (cb, *rb) = a[tid], b[tid]
        assert all(torch.equal(x, y) for x, y in zip(ca, cb)), tid
        assert all(np.array_equal(x, y) for x, y in zip(ra[:2], rb[:2]))
        assert ra[2:] == rb[2:], tid


def test_refused_dispatch_changes_no_state():
    """A PoisonOutput leaves every carry, queue, cursor and
    backpressure stamp as it was; no tenant's carry aliases the stack
    the kernel folds in place; the healthy rows' re-dispatch equals a
    cohort that never had the poisoned tenant, carries bit for bit."""
    streams = streams_for(3, 3, seed=19)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s[:EB], d[:EB])
    first = co.pump()
    for tid, t in co.tenants.items():
        for x in t.carry:
            # a carry of its own, not a row of the folded stack
            assert x.untyped_storage().nbytes() == x.nbytes
    for tid, (s, d) in streams.items():
        co.feed(tid, s[EB:], d[EB:])
    co.tenants["t2"].bp_stamped = True
    before = _snapshot(co)
    undo = _poison_rows(PKGS["torch"], "torch", co, "t1")
    batch = [co.tenants[t] for t in sorted(streams)]
    wins = [co._take_windows(t) for t in batch]
    out, staged = {}, []
    with pytest.raises(tenancy.PoisonOutput) as ei:
        co._dispatch_batch(VB, KB, co._prep_slab(batch, wins), out, staged)
    assert ei.value.tenants == ["t1"] and out == {} and staged == []
    _same(before, _snapshot(co))
    got = merge(dict(first), co.pump())     # the bulkhead, still poisoned
    undo()
    assert co.quarantined() == ["t1"]

    twin = make("torch")
    for tid in ("t0", "t2"):
        twin.admit(tid)
    for tid in ("t0", "t2"):
        s, d = streams[tid]
        twin.feed(tid, s[:EB], d[:EB])
    want = twin.pump()
    for tid in ("t0", "t2"):
        s, d = streams[tid]
        twin.feed(tid, s[EB:], d[EB:])
    merge(want, twin.pump())
    for tid in ("t0", "t2"):
        assert got[tid] == want[tid]
        a, b = co.tenant_state_dict(tid), twin.tenant_state_dict(tid)
        assert a["windows_done"] == b["windows_done"]
        for x, y in zip(a["carry"], b["carry"]):
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------------------
# the port's rules: device errors, h2d failures, the device
# ----------------------------------------------------------------------
def _device_errors():
    kerr = kernels.KernelError("injected: the cohort_summary launch failed")
    cuda = RuntimeError("CUDA error: an illegal memory access was "
                        "encountered")
    try:
        raise ValueError("wrapper gave up") from kernels.KernelError("x")
    except ValueError as e:
        caused = e
    return {"kernel_error": kerr, "cuda_error": cuda,
            "device_cause": caused}


@pytest.mark.parametrize("kind", sorted(_device_errors()))
def test_device_error_from_launch_propagates_unwrapped(kind):
    err = _device_errors()[kind]
    assert resilience.is_device_error(err)
    streams = streams_for(4, 2, seed=20)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    before = _snapshot(co)
    calls = []

    def broken(vb, kb):
        def launch(*args):
            calls.append(1)
            raise err
        return launch

    co._summary = broken
    with pytest.raises(type(err)) as ei:
        co.pump()
    assert ei.value is err and len(calls) == 1
    assert not isinstance(ei.value, resilience.StageError)
    assert co.quarantined() == [] and resilience.demotion_events() == []
    assert all(co.tenant_tier(t) == "cohort" for t in streams)
    _same(before, _snapshot(co))
    assert not any(r["name"] in ("cohort_bisect", "quarantine")
                   for r in telemetry.records())
    del co._summary
    got = co.pump()
    for tid in streams:
        got[tid] += co.close(tid)
    assert got == oracle(streams)


def test_injected_dispatch_fault_with_a_device_cause_is_not_bisected():
    streams = streams_for(4, 1, seed=21)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)

    def fail(payload):
        raise faults.InjectedFault("dispatch died", "cohort_dispatch") \
            from kernels.KernelError("the card is gone")

    with faults.inject(faults.FaultSpec(site="cohort_dispatch",
                                        action="call", fn=fail)):
        with pytest.raises(faults.InjectedFault) as ei:
            co.pump()
    assert isinstance(ei.value.__cause__, kernels.KernelError)
    assert co.quarantined() == [] and resilience.demotion_events() == []
    assert co.pump() == oracle(streams)


def test_device_error_in_probation_propagates(monkeypatch):
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "2")
    streams = streams_for(2, 2, seed=22)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    co.quarantine("t1", "operator")
    records = resilience.demotion_events()
    err = kernels.KernelError("injected: the probe's launch failed")
    real = co._tenant_engine

    def engine(t):
        eng = real(t)

        def process(src, dst):
            raise err
        eng.process = process
        return eng

    co._tenant_engine = engine
    with pytest.raises(kernels.KernelError) as ei:
        co.pump()
    assert ei.value is err
    t1 = co.tenants["t1"]
    assert (t1.tier, t1.probation, t1.queued) == ("quarantined", 0, 2 * EB)
    assert resilience.demotion_events() == records
    assert not any(r["name"] == "quarantine_probe_failed"
                   for r in telemetry.records())


@pytest.mark.parametrize("retries", [0, 1])
def test_h2d_failure_raises_typed_without_bisect(monkeypatch, retries):
    """A staging copy that keeps failing raises to the caller: the
    injected fault itself with the guard off, a typed StageFailed of
    stage h2d under it; nothing bisected, quarantined or changed."""
    monkeypatch.setenv("GS_STAGE_RETRIES", str(retries))
    streams = streams_for(4, 1, seed=23)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    before = _snapshot(co)
    with faults.inject(faults.FaultSpec(site="h2d", times=retries + 1)):
        with pytest.raises(resilience.StageFailed if retries
                           else faults.InjectedFault) as ei:
            co.pump()
    if retries:
        assert ei.value.stage == "h2d"
        assert len(ei.value.attempts) == retries + 1
    assert co.quarantined() == [] and resilience.demotion_events() == []
    assert not any(r["name"] == "cohort_bisect" for r in telemetry.records())
    _same(before, _snapshot(co))
    assert co.pump() == oracle(streams)


@pytest.mark.parametrize("retries", [0, 1])
def test_probe_h2d_failure_raises_without_resetting_probation(
        monkeypatch, retries):
    """A probation probe whose staging copy fails raises to the caller
    typed (a PrepError of stage h2d with the guard off, a StageFailed
    of stage h2d under it): probation, the queue and the last-good
    carry stay, no probe failure is stamped, and the next pump goes on
    from there to the exact result."""
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "3")
    monkeypatch.setenv("GS_STAGE_RETRIES", str(retries))
    streams = streams_for(2, 3, seed=27)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    co.quarantine("t1", "operator")
    got = co.pump(max_rounds=1)
    t1 = co.tenants["t1"]
    assert (t1.tier, t1.probation, t1.queued) == ("quarantined", 1, 2 * EB)
    records = resilience.demotion_events()
    carry = tuple(x.clone() for x in co._carry_of(t1))
    with faults.inject(faults.FaultSpec(site="h2d", times=retries + 1)):
        with pytest.raises(resilience.StageFailed if retries
                           else ingress_pipeline.PrepError) as ei:
            co.pump(max_rounds=1)
    assert ei.value.stage == "h2d"
    assert (t1.tier, t1.probation, t1.queued) == ("quarantined", 1, 2 * EB)
    assert t1.windows_done == 1
    assert all(torch.equal(x, y) for x, y in zip(co._carry_of(t1), carry))
    assert resilience.demotion_events() == records
    assert not any(r["name"] == "quarantine_probe_failed"
                   for r in telemetry.records())
    merge(got, co.pump())
    for tid in streams:
        merge(got, {tid: co.close(tid)})
    assert got == oracle(streams)
    assert co.tenant_tier("t1") == "cohort"


def test_retried_h2d_is_exact(monkeypatch):
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    streams = streams_for(3, 2, seed=24)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    with faults.inject(faults.FaultSpec(site="h2d", on_call=1)) as plan:
        got = co.pump()
    assert plan.fired == [("h2d", 1, "raise")]
    assert got == oracle(streams)


def test_single_and_probation_engines_run_on_the_cohort_device(
        monkeypatch):
    """The demoted and probation engines are StreamSummaryEngines on
    the cohort's device, on the tenant's latency lane, not stamping
    admission again."""
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "2")
    made = []
    real = tenancy.StreamSummaryEngine

    def recording(*args, **kw):
        made.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(tenancy, "StreamSummaryEngine", recording)
    streams = streams_for(2, 2, seed=25)
    co = make("torch")
    for tid in streams:
        co.admit(tid)
    for tid, (s, d) in streams.items():
        co.feed(tid, s, d)
    co.demote("t0", reason="test")
    co.quarantine("t1", "test")
    eng0 = co.tenants["t0"].engine
    got = co.pump(max_rounds=1)
    eng1 = co.tenants["t1"].engine
    assert made == [co.device, co.device]
    for eng, tid in ((eng0, "t0"), (eng1, "t1")):
        assert eng.device == co.device
        assert (eng._lat_lane, eng._lat_admit) == (tid, False)
    merge(got, co.pump())
    for tid in streams:
        merge(got, {tid: co.close(tid)})
    assert got == oracle(streams)
