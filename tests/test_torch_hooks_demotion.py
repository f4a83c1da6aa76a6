"""The columnar driver's demotion ladder (gelly_streaming_tpu_torch/core/
driver.py `_effective_tier`, `_maybe_demote`, `demotion_log`, the
triangle flush's ladder) on the CPU, against runs that were not
demoted and against the JAX driver.

The driver cases of tests/operations/test_faults.py (mid-stream
demotion bit-exact, the ladder falling through to host, demotion
disabled, semantic errors never demote, probation re-promotion, a retry
without demotion, a prefetch prep failure retried), then the port's own
rules and cases: the ladder never leaves the card (a driver pinned to
resident demotes to scan and no further, one pinned to scan never
demotes, one pinned to native demotes to host), an h2d failure never
demotes, and a kernel or CUDA error is never retried, wrapped or
demoted on; a failure while the next chunk is already dispatched
re-enters from the last finalized chunk with every window, cursor,
checkpoint, delta stream, pane ring and triangle count equal; a resident
call with a prep failure demotes to scan; the triangle flush recounts
only the windows it had not finalized, on the next rung."""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.driver import \
    StreamingAnalyticsDriver as JaxDriver
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import resilience as jax_resilience
from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch import kernels
from gelly_streaming_tpu_torch.ops import ingress_pipeline as ip
from gelly_streaming_tpu_torch.ops import segment as seg_ops
from gelly_streaming_tpu_torch.ops import triangles as tri_ops
from gelly_streaming_tpu_torch.ops import window_counter as wc
from gelly_streaming_tpu_torch.ops import window_snapshot as ws
from gelly_streaming_tpu_torch.utils import faults, resilience

_KNOBS = ("GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES", "GS_STAGE_BACKOFF_S",
          "GS_TIER_RETRY_WINDOWS", "GS_TIER_DEMOTE", "GS_RESIDENT_SPB")
# a driver pinned to a tier demotes to the rung below it, if any: on
# the card, resident -> scan; on the host, native -> host
BELOW = {"resident": "scan", "native": "host"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_STAGE_BACKOFF_S", "0.01")
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    resilience.reset_demotions()
    yield
    resilience.reset_demotions()
    ip.reset_pool()
    torch.set_num_threads(threads)


def _stream(n=4096, v=512, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, v, size=n), rng.integers(0, v, size=n)


def _snap_key(results):
    return [(r.window_start, r.num_edges, r.triangles,
             *(None if a is None else np.asarray(a).tolist() for a in (
                 r.vertex_ids, r.degrees, r.cc_labels, r.bipartite_odd)),
             *(None if d is None else [x.tolist() for x in d] for d in (
                 r.delta_degrees, r.delta_cc, r.delta_bipartite)))
            for r in results]


def _driver(**kw):
    kw.setdefault("analytics", ("degrees", "cc", "bipartite"))
    kw.setdefault("snapshot_tier", "scan")
    return StreamingAnalyticsDriver(window_ms=0, edge_bucket=512,
                                    vertex_bucket=1024, emit_deltas=True,
                                    device="cpu", **kw)


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def _tiers(drv):
    return [(e["from"], e["to"]) for e in drv.demotion_log()]


# ----------------------------------------------------------------------
# tests/operations/test_faults.py:269-375 on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("pinned", sorted(BELOW))
def test_mid_stream_demotion_preserves_state_bit_exactly(pinned):
    src, dst = _stream()
    want = _snap_key(_driver().run_arrays(src, dst))
    drv = _driver(tracing=True, tenant="acme", snapshot_tier=pinned)
    half = len(src) // 2
    got = drv.run_arrays(src[:half], dst[:half])
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1)):
        got += drv.run_arrays(src[half:], dst[half:])
    assert _snap_key(got) == want
    (event,) = drv.demotion_log()
    assert (event["from"], event["to"], event["tenant"]) \
        == (pinned, BELOW[pinned], "acme")
    assert any(e["event"] == "tier_demotion"
               for e in drv.timer.event_log())
    assert any(e["to"] == BELOW[pinned]
               for e in resilience.demotion_events())


def test_demotion_ladder_falls_through_to_host():
    """Below the card the ladder ends at host: a driver pinned to native
    falls through to it, bit-exactly."""
    src, dst = _stream()
    want = _snap_key(_driver().run_arrays(src, dst))
    drv = _driver(snapshot_tier="native")
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1)):
        got = drv.run_arrays(src, dst)
    assert _snap_key(got) == want
    assert _tiers(drv) == [("native", "host")]


@pytest.mark.parametrize("pinned,walk", [
    ("scan", []), ("resident", [("resident", "scan")])])
def test_device_ladder_never_leaves_the_card(pinned, walk):
    """Persistent host faults at dispatch: a driver on the card demotes
    at most to scan, and a failure there raises its typed StageFailed
    (the JAX driver walks on to native and host)."""
    src, dst = _stream()
    drv = _driver(snapshot_tier=pinned)
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1,
                                        times=2)):
        with pytest.raises(resilience.StageFailed) as ei:
            drv.run_arrays(src, dst)
    assert ei.value.stage == "dispatch"
    assert _tiers(drv) == walk and drv.windows_done == 0
    assert [(e["from"], e["to"])
            for e in resilience.demotion_events()] == walk


def test_h2d_failure_never_demotes(monkeypatch):
    """A failed copy to the card raises its typed StageFailed: no rung
    cures it."""
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    src, dst = _stream()
    drv = _driver(snapshot_tier="resident")
    with faults.inject(faults.FaultSpec(site="h2d", on_call=1, times=2)):
        with pytest.raises(resilience.StageFailed) as ei:
            drv.run_arrays(src, dst)
    assert ei.value.stage == "h2d"
    assert drv.demotion_log() == [] and resilience.demotion_events() == []


def test_demotion_ladders_equal_jax():
    """Below the card the same plan walks the same rungs in both
    packages (native -> host), with the same windows."""
    src, dst = _stream()
    walks = {}
    for name, make, fm in (
            ("jax", lambda: JaxDriver(
                window_ms=0, edge_bucket=512, vertex_bucket=1024,
                emit_deltas=True, snapshot_tier="native",
                analytics=("degrees", "cc", "bipartite")), jax_faults),
            ("torch", lambda: _driver(snapshot_tier="native"), faults)):
        drv = make()
        with fm.inject(fm.FaultSpec(site="dispatch", on_call=1)):
            got = drv.run_arrays(src, dst)
        walks[name] = (_tiers(drv), _snap_key(got))
    assert walks["torch"] == walks["jax"]
    assert walks["torch"][0] == [("native", "host")]
    jax_resilience.reset_demotions()


def test_demotion_disabled_raises_typed(monkeypatch):
    monkeypatch.setenv("GS_TIER_DEMOTE", "0")
    src, dst = _stream()
    drv = _driver(snapshot_tier="resident")
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1)):
        with pytest.raises(resilience.StageFailed):
            drv.run_arrays(src, dst)
    assert drv.demotion_log() == [] and drv.windows_done == 0


def test_semantic_errors_never_demote():
    src, dst = _stream()
    drv = _driver(snapshot_tier="resident")
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1,
                                        exc=TypeError)):
        with pytest.raises(resilience.StageFailed) as ei:
            drv.run_arrays(src, dst)
    assert isinstance(ei.value.__cause__, TypeError)
    assert drv.demotion_log() == []


def test_probation_repromotion(monkeypatch):
    monkeypatch.setenv("GS_TIER_RETRY_WINDOWS", "4")
    src, dst = _stream()
    want = _snap_key(_driver().run_arrays(src, dst))
    drv = _driver(tracing=True, snapshot_tier="resident")
    with faults.inject(faults.FaultSpec(site="dispatch", on_call=1)):
        got = drv.run_arrays(src, dst)
    assert _snap_key(got) == want
    assert drv._demoted_tier == "scan"
    drv.run_arrays(src, dst)
    assert drv._demoted_tier is None
    assert drv.demotion_log()[-1]["to"] == "resident"
    assert [e["event"] for e in drv.timer.event_log()] \
        == ["tier_demotion", "tier_repromotion"]


def test_retry_cures_transient_dispatch_fault_without_demotion(
        monkeypatch):
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    src, dst = _stream()
    want = _snap_key(_driver().run_arrays(src, dst))
    drv = _driver()
    with faults.inject(faults.FaultSpec(site="dispatch",
                                        on_call=1)) as plan:
        got = drv.run_arrays(src, dst)
    assert _snap_key(got) == want
    assert drv.demotion_log() == []
    assert plan.fired == [("dispatch", 1, "raise")]


def test_driver_prefetch_prep_failure_retried(monkeypatch):
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    rng = np.random.default_rng(7)
    w, eb = 66, 128                   # two chunks (64 + 2)
    src = rng.integers(0, 300, size=w * eb)
    dst = rng.integers(0, 300, size=w * eb)

    def run(specs):
        drv = StreamingAnalyticsDriver(
            window_ms=0, edge_bucket=eb, vertex_bucket=512,
            analytics=("degrees", "cc", "bipartite"), device="cpu")
        with ip.forced_sync(), faults.inject(*specs) as plan:
            out = drv.run_arrays(src, dst)
        return out, plan, drv

    want, clean, _ = run([])
    total = clean.calls["prep"]
    got, plan, drv = run([faults.FaultSpec(site="prep", on_call=total)])
    assert ("prep", total, "raise") in plan.fired
    assert _snap_key(got) == _snap_key(want)
    assert drv.demotion_log() == []


# ----------------------------------------------------------------------
# (a) a kernel or CUDA error is never retried, wrapped or demoted on
# ----------------------------------------------------------------------
@pytest.mark.parametrize("error", [
    lambda: kernels.KernelError("injected: window_snapshot failed"),
    lambda: RuntimeError("CUDA error: an illegal memory access was "
                         "encountered")])
def test_snapshot_device_error_raises_unwrapped(monkeypatch, error):
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise error()

    monkeypatch.setattr(ws, "snapshot_windows_plain", broken)
    src, dst = _stream()
    drv = _driver(tracing=True, snapshot_tier="resident")
    with pytest.raises(type(error())) as ei:
        drv.run_arrays(src, dst)
    assert not isinstance(ei.value, resilience.StageError)
    assert ei.value.__cause__ is None and len(calls) == 1
    assert drv.demotion_log() == [] and resilience.demotion_events() == []
    assert drv.timer.event_log() == [] and drv.windows_done == 0


def test_prep_device_error_passes_the_guard(monkeypatch):
    """A device error out of a guarded host stage is raised as it is:
    never retried into a StageFailed that could demote."""
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")
    real = seg_ops.stack_window_rows
    calls = []

    def broken(*a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise kernels.KernelError("injected: staging failed")
        return real(*a, **k)

    monkeypatch.setattr(seg_ops, "stack_window_rows", broken)
    src, dst = _stream()
    drv = _driver(snapshot_tier="resident")
    with pytest.raises(kernels.KernelError):
        drv.run_arrays(src, dst)
    assert len(calls) == 1 and drv.demotion_log() == []


def test_counter_kernel_error_in_the_flush_never_demotes(monkeypatch):
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")

    def broken(*a, **k):
        raise kernels.KernelError("injected: window_counter failed")

    monkeypatch.setattr(wc, "count_windows_plain", broken)
    src, dst = _stream()
    drv = _driver(analytics=StreamingAnalyticsDriver.ANALYTICS,
                  snapshot_tier="resident")
    with pytest.raises(kernels.KernelError):
        drv.run_arrays(src, dst)
    assert drv.demotion_log() == [] and resilience.demotion_events() == []


def test_maybe_demote_refuses_device_causes():
    drv = _driver(snapshot_tier="resident")
    for cause in (kernels.KernelError("k"), RuntimeError("CUDA error: x")):
        try:
            try:
                raise cause
            except Exception as e:
                raise resilience.StageFailed("dispatch", "dispatch", 0) \
                    from e
        except resilience.StageFailed as err:
            assert not drv._maybe_demote("resident", err)
    assert drv.demotion_log() == []


# ----------------------------------------------------------------------
# (c) a demotion is exact, with the next chunk already in flight
# ----------------------------------------------------------------------
# each on the resident tier, which demotes to scan
CASES = {
    "triangles": dict(analytics=StreamingAnalyticsDriver.ANALYTICS),
    "delta_wire": dict(egress="delta"),
    "sliding": dict(analytics=StreamingAnalyticsDriver.ANALYTICS,
                    slide=128),
    "resident": dict(),
}


@pytest.mark.parametrize("site,on_call", [("dispatch", 2),
                                          ("finalize", 1)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_failure_with_a_chunk_in_flight_is_exact(monkeypatch, tmp_path,
                                                 case, site, on_call):
    """A `dispatch` fault at chunk 2 (chunk 1 dispatched, drained) or a
    `finalize` fault at chunk 1 (chunk 2 already dispatched): the call
    re-enters from the last finalized chunk on the next rung, and every
    window, the cursors, the final state, the staged checkpoints, the
    delta streams, the pane ring and the triangles equal the run that
    was not demoted."""
    monkeypatch.setenv("GS_RESIDENT_SPB", "64")
    kw = dict(CASES[case], snapshot_tier="resident")
    src, dst = _stream(n=150 * 512 + 77, seed=9)
    ref = _driver(**kw)
    ref.enable_auto_checkpoint(str(tmp_path / "ref"), every_n_windows=16)
    want = ref.run_arrays(src, dst)
    drv = _driver(**kw)
    drv.enable_auto_checkpoint(str(tmp_path / "got"), every_n_windows=16)
    with faults.inject(faults.FaultSpec(site=site, on_call=on_call)):
        got = drv.run_arrays(src, dst)
    assert _snap_key(got) == _snap_key(want)
    (event,) = drv.demotion_log()
    assert event["window"] == (64 if site == "dispatch" else 0)
    assert (drv.windows_done, drv.edges_done) \
        == (ref.windows_done, ref.edges_done)
    sa, sb = drv.state_dict(), ref.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert _same(sa[k], sb[k]), k
    # the checkpoint it staged resumes to the same rest
    fresh = _driver(**kw)
    assert fresh.try_resume(str(tmp_path / "got"))
    assert fresh.windows_done == ref.windows_done


def test_resident_prep_failure_demotes_to_scan(monkeypatch):
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    src, dst = _stream(n=70 * 512, seed=3)
    want = _snap_key(_driver().run_arrays(src, dst))

    def run(specs):
        drv = _driver(snapshot_tier="resident")
        with ip.forced_sync(), faults.inject(*specs) as plan:
            out = drv.run_arrays(src, dst)
        return out, plan, drv

    _out, clean, _d = run([])
    total = clean.calls["prep"]       # the last: the super-batch's prep
    got, _plan, drv = run([faults.FaultSpec(site="prep", on_call=total,
                                            times=2)])
    assert _snap_key(got) == want
    assert _tiers(drv) == [("resident", "scan")]


def test_triangle_flush_recounts_only_what_it_had_not_finalized(
        monkeypatch):
    """A prep failure of the flush's second chunk (its first already
    finalized) demotes resident to scan; the next rung counts the rest
    alone."""
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    src, dst = _stream(n=70 * 512, seed=4)
    kw = dict(analytics=StreamingAnalyticsDriver.ANALYTICS,
              snapshot_tier="resident")
    want = _snap_key(_driver(**kw).run_arrays(src, dst))
    seen = []
    real = tri_ops.TriangleWindowKernel.count_windows

    drained = []

    def spy(self, windows):
        seen.append((self.stream_tier, len(windows)))
        try:
            return real(self, windows)
        except resilience.StageError:
            drained.append(list(self.drained_counts))
            raise

    def run(specs):
        drv = _driver(**kw)
        with ip.forced_sync(), faults.inject(*specs) as plan:
            out = drv.run_arrays(src, dst)
        return out, plan, drv

    _out, clean, _d = run([])
    total = clean.calls["prep"]       # the flush's second chunk
    monkeypatch.setattr(tri_ops.TriangleWindowKernel, "count_windows", spy)
    got, _plan, drv = run([faults.FaultSpec(site="prep", on_call=total,
                                            times=2)])
    assert _snap_key(got) == want
    assert _tiers(drv) == [("resident", "scan")]
    assert seen == [("device", 70), ("device", 6)]
    assert drained == [[r[2] for r in want[:64]]]
