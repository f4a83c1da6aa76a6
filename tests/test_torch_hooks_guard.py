"""The port's fault injection (utils/faults.py), stage guard
(utils/resilience.py) and the ingress pipeline's guarded host stages
(ops/ingress_pipeline.py) against the JAX package's, on the cases of
tests/operations/test_faults.py: retries of transient prep and h2d
faults, typed StageFailed / StageTimeout naming the chunk and stage, the
deadline on a hung stage and on a chunk queued behind a wedged worker,
fatal faults passed through unretried, and the drain of the chunk in
flight. Then the port's own rules: a device error (a kernel's, or a
CUDA call's) is never retried or wrapped, whether the guard is armed or
not; an attempt the deadline abandoned never runs its h2d after the
retry began; retried host faults leave the engines' results bit-equal;
and the checkpoint fault sites."""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import ingress_pipeline as jax_ip
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import resilience as jax_res
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch import TriangleWindowKernel
from gelly_streaming_tpu_torch import kernels
from gelly_streaming_tpu_torch.ops import ingress_pipeline as ip
from gelly_streaming_tpu_torch.ops import window_summary
from gelly_streaming_tpu_torch.ops.gnn_window import GnnSummaryEngine
from gelly_streaming_tpu_torch.utils import checkpoint
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import resilience

_KNOBS = ("GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES", "GS_STAGE_BACKOFF_S",
          "GS_PIPELINE_WORKERS", "GS_TELEMETRY", "GS_METRICS")
PKGS = {"jax": (jax_ip, jax_faults, jax_res),
        "torch": (ip, faults, resilience)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_STAGE_BACKOFF_S", "0.01")
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    yield
    ip.reset_pool()
    jax_ip.reset_pool()
    torch.set_num_threads(threads)


def _run(pkg, n_chunks=4, h2d=lambda p: p + 1):
    """chunk i -> prep doubles, h2d +1, finalize collects."""
    out = []
    PKGS[pkg][0].run_pipeline(range(n_chunks), lambda i: i * 2, h2d,
                              lambda d: d, out.append)
    return out


# ----------------------------------------------------------------------
# the cases of the JAX fault suite, on both packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("site,on_call,sync", [("prep", 2, False),
                                               ("h2d", 3, True),
                                               ("h2d", 1, False)])
def test_transient_fault_retried(monkeypatch, site, on_call, sync):
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")
    fired = {}
    for pkg, (pip, fl, _res) in PKGS.items():
        ctx = pip.forced_sync() if sync else contextlib.nullcontext()
        with ctx, fl.inject(fl.FaultSpec(site=site,
                                         on_call=on_call)) as plan:
            assert _run(pkg) == [1, 3, 5, 7]
        fired[pkg] = [f for f in plan.fired if f[0] == site]
    assert fired["torch"] == fired["jax"] == [(site, on_call, "raise")]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_exhausted_retries_typed(monkeypatch, pkg):
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    pip, fl, res = PKGS[pkg]
    with fl.inject(fl.FaultSpec(site="prep", on_call=2, times=99)):
        with pytest.raises(res.StageFailed) as ei:
            _run(pkg)
    err = ei.value
    assert (err.stage, err.chunk, len(err.attempts)) == ("prep", 1, 2)
    assert all(a["outcome"] == "PrepError" for a in err.attempts)
    assert isinstance(err.__cause__, pip.PrepError)


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("sync", [False, True])
def test_hung_h2d_times_out_typed_within_deadline(monkeypatch, pkg, sync):
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.15")
    pip, fl, res = PKGS[pkg]
    t0 = time.perf_counter()
    ctx = pip.forced_sync() if sync else contextlib.nullcontext()
    with ctx, fl.inject(fl.FaultSpec(site="h2d", on_call=2 - sync,
                                     action="hang", seconds=3.0)):
        with pytest.raises(res.StageTimeout) as ei:
            _run(pkg)
    assert time.perf_counter() - t0 < 2.5       # the hang was cut
    assert ei.value.stage == "h2d" and ei.value.chunk == 1 - sync
    assert ei.value.attempts[0]["outcome"] == "timeout"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_hang_then_retry_completes(monkeypatch, pkg):
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.15")
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    fl = PKGS[pkg][1]
    with fl.inject(fl.FaultSpec(site="h2d", on_call=2, action="hang",
                                seconds=0.6)):
        assert _run(pkg) == [1, 3, 5, 7]


def test_queued_chunk_behind_a_wedged_worker_times_out(monkeypatch):
    """One worker, wedged by a hang on chunk 0's h2d: every later
    chunk's queued attempt times out of the queue and retries on a
    thread of its own; the stream completes within its deadlines."""
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.2")
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    out = []
    t0 = time.perf_counter()
    with faults.inject(faults.FaultSpec(site="h2d", on_call=1,
                                        action="hang", seconds=1.2)):
        ip.run_pipeline(range(4), lambda i: i * 2, lambda p: p + 1,
                        lambda d: d, out.append, workers=1)
    assert out == [1, 3, 5, 7]
    assert time.perf_counter() - t0 < 3.0


@pytest.mark.parametrize("pkg", sorted(PKGS))
@pytest.mark.parametrize("sync", [False, True])
def test_failure_drains_the_chunk_in_flight(pkg, sync):
    pip, fl, _res = PKGS[pkg]
    out = []
    ctx = pip.forced_sync() if sync else contextlib.nullcontext()
    with ctx, fl.inject(fl.FaultSpec(site="prep", on_call=3)):
        with pytest.raises(pip.PrepError):
            pip.run_pipeline(range(4), lambda i: i * 2, lambda p: p + 1,
                             lambda d: d, out.append)
    assert out == [1, 3]


@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("site", ["prep", "h2d"])
def test_fatal_fault_passes_through_unretried(monkeypatch, armed, site):
    if armed:
        monkeypatch.setenv("GS_STAGE_RETRIES", "5")
        monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "5")
    with faults.inject(faults.FaultSpec(site=site, on_call=2,
                                        fatal=True)) as plan:
        with pytest.raises(faults.InjectedFault) as ei:
            _run("torch")
    assert ei.value.fatal and type(ei.value) is faults.InjectedFault
    assert [f for f in plan.fired if f[0] == site] == [(site, 2, "raise")]


def test_call_guarded_matches_jax(monkeypatch):
    """The generic guard: retry, exhaustion, timeout, fatal pass-through,
    the same outcomes in both packages."""
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")
    for pkg in PKGS:
        _ip, fl, res = PKGS[pkg]
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert res.call_guarded("prep", 7, flaky) == "ok"
        assert len(calls) == 3
        with pytest.raises(res.StageFailed) as ei:
            res.call_guarded("h2d", 8, lambda: 1 / 0)
        assert [a["outcome"] for a in ei.value.attempts] == \
            ["ZeroDivisionError"] * 3
        with pytest.raises(res.StageTimeout) as ei:
            res.call_guarded("h2d", 9, lambda: time.sleep(0.5),
                             retries=0, timeout=0.05)
        assert ei.value.chunk == 9
        with fl.inject(fl.FaultSpec(site="x", fatal=True)):
            with pytest.raises(fl.InjectedFault):
                res.call_guarded("prep", 1, lambda: fl.fire("x"))


def test_demotion_registry_matches_jax():
    for res in (jax_res, resilience):
        res.reset_demotions()
        res.record_demotion("driver", "scan", "host", 64, "x" * 600,
                            mesh_shape=[4], shard_id=2, tenant=7)
    assert resilience.demotion_events() == jax_res.demotion_events()
    assert len(resilience.demotion_events()[0]["reason"]) == 500
    assert resilience.tier_demotion_enabled() \
        and resilience.mesh_demotion_enabled()
    for res in (jax_res, resilience):
        res.reset_demotions()


# ----------------------------------------------------------------------
# the port's rules
# ----------------------------------------------------------------------
@pytest.mark.parametrize("armed", [False, True])
@pytest.mark.parametrize("exc", [
    kernels.KernelError("window_summary kernel: CUDA error 700 "
                        "(an illegal memory access was encountered)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory")])
def test_device_error_in_h2d_is_never_retried_or_wrapped(monkeypatch,
                                                        armed, exc):
    if armed:
        monkeypatch.setenv("GS_STAGE_RETRIES", "4")
        monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "5")
    calls = []

    def h2d(p):
        calls.append(p)
        if p == 4:
            raise exc
        return p + 1

    with pytest.raises(type(exc)) as ei:
        _run("torch", h2d=h2d)
    assert ei.value is exc
    assert calls.count(4) == 1
    assert resilience.is_device_error(exc)
    assert not resilience.is_device_error(RuntimeError("host error"))
    assert not resilience.is_device_error(ip.PrepError("wrapped"))


@pytest.mark.parametrize("engine", ["summary", "gnn"])
def test_stub_kernel_error_propagates_unretried(monkeypatch, engine):
    """An error raised by the launch wrapper before any launch goes up
    as it was raised, once, with the guard armed: no StageFailed, no
    retry, no plain fallback; and the engine serves the next call."""
    monkeypatch.setenv("GS_STAGE_RETRIES", "4")
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "5")
    rng = np.random.default_rng(3)
    src = rng.integers(0, 64, 6 * 32).astype(np.int32)
    dst = rng.integers(0, 64, 6 * 32).astype(np.int32)
    if engine == "summary":
        eng = StreamSummaryEngine(32, 64, device="cpu")
        target, attr = window_summary, "summarize_windows_plain"
    else:
        eng = GnnSummaryEngine(32, 64, feature_dim=8, device="cpu")
        from gelly_streaming_tpu_torch.ops import gnn_round as target
        attr = "gnn_rounds_plain"
    want = type(eng)(32, 64, **({} if engine == "summary" else
                                {"feature_dim": 8}),
                     device="cpu").process(src, dst)
    real = getattr(target, attr)
    calls = []

    def stub(*a, **k):
        calls.append(1)
        raise kernels.KernelError("stub launch error")

    monkeypatch.setattr(target, attr, stub)
    with pytest.raises(kernels.KernelError, match="stub launch"):
        eng.process(src, dst)
    assert len(calls) == 1
    monkeypatch.setattr(target, attr, real)
    eng.reset()
    assert eng.process(src, dst) == want


def test_abandoned_attempt_never_runs_its_h2d_late(monkeypatch):
    """The first attempt of chunk 1 hangs before its h2d; the deadline
    retires it and the retry stages the chunk. When the hang ends, the
    abandoned attempt must not run h2d: each chunk is staged once."""
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.1")
    monkeypatch.setenv("GS_STAGE_RETRIES", "1")
    staged = []
    lock = threading.Lock()

    def h2d(p):
        with lock:
            staged.append(p)
        return p + 1

    with faults.inject(faults.FaultSpec(site="h2d", on_call=2,
                                        action="hang", seconds=0.4)):
        assert _run("torch", h2d=h2d) == [1, 3, 5, 7]
    time.sleep(0.6)                  # the hang ends: it must stay silent
    assert sorted(staged) == [0, 2, 4, 6]


@pytest.mark.parametrize("site", ["prep", "h2d"])
@pytest.mark.parametrize("kind", ["summary", "triangles"])
def test_retried_host_faults_leave_results_bit_equal(monkeypatch, site,
                                                     kind):
    monkeypatch.setenv("GS_STAGE_RETRIES", "2")
    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.3")
    rng = np.random.default_rng(9)
    src = rng.integers(0, 64, 20 * 32).astype(np.int32)
    dst = rng.integers(0, 64, 20 * 32).astype(np.int32)

    def run():
        if kind == "summary":
            eng = StreamSummaryEngine(32, 64, device="cpu")
            eng.MAX_WINDOWS = 4
            return eng.process(src, dst), eng.state_dict()["carry"]
        k = TriangleWindowKernel(32, 64, device="cpu")
        k.MAX_STREAM_WINDOWS = 4
        return k.count_stream(src, dst), ()

    want, want_carry = run()
    with faults.inject(
            faults.FaultSpec(site=site, on_call=2),
            faults.FaultSpec(site=site, on_call=4, action="hang",
                             seconds=0.6)) as plan:
        got, carry = run()
    assert len([f for f in plan.fired if f[0] == site]) == 2
    assert got == want
    for a, b in zip(carry, want_carry):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_fault_sites_and_rotation_fallback(tmp_path):
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"a": np.arange(3)})
    with faults.inject(faults.FaultSpec(site="ckpt_save",
                                        action="truncate_file")) as plan:
        checkpoint.save(path, {"a": np.arange(4)})
    assert plan.fired == [("ckpt_save", 1, "truncate_file")]
    tree, used = checkpoint.load_latest(path)
    assert used == checkpoint.prev_path(path)
    np.testing.assert_array_equal(tree["a"], np.arange(3))
    with faults.inject(faults.FaultSpec(site="ckpt_restore")):
        with pytest.raises(faults.InjectedFault):
            checkpoint.restore(used)


def test_stress_many_hung_attempts_stage_each_chunk_once(monkeypatch):
    """More workers than cores, a short switch interval, and hangs on
    many h2d calls past a short deadline: every chunk is staged exactly
    once (no abandoned attempt runs its h2d late) and the results come
    in order."""
    import sys

    monkeypatch.setenv("GS_STAGE_TIMEOUT_S", "0.03")
    monkeypatch.setenv("GS_STAGE_RETRIES", "4")
    monkeypatch.setenv("GS_STAGE_BACKOFF_S", "0")
    staged, lock = [], threading.Lock()

    def h2d(p):
        with lock:
            staged.append(p)
        return p + 1

    out = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with faults.inject(*(faults.FaultSpec(site="h2d", on_call=c,
                                              action="hang", seconds=0.08)
                             for c in range(2, 60, 5))):
            ip.run_pipeline(range(40), lambda i: i * 2, h2d, lambda d: d,
                            out.append, workers=16, inflight=16)
        time.sleep(0.2)              # every hang over: none stages late
    finally:
        sys.setswitchinterval(interval)
    assert out == [2 * i + 1 for i in range(40)]
    assert sorted(staged) == [2 * i for i in range(40)]
