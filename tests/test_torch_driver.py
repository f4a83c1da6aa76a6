"""The port's columnar driver (gelly_streaming_tpu_torch/core/driver.py)
on device="cpu", held against the JAX package's StreamingAnalyticsDriver
pinned to its "scan" and "host" snapshot tiers: every WindowResult field
(values and dtypes) of count-based and event-time streams, vertex-bucket
growth, each subset of the analytics, deltas on both egress forms with a
delta-cap overflow that refolds the chunk on full rows, stream_file
across chunk boundaries, and checkpoints (inside a call too) resumed
across the two packages. The
analytics are integers: equality, no tolerance.

The JAX driver's defaults read evidence files, so its egress is pinned
and its autotuner off (GS_AUTOTUNE=0); its delta cap comes from
GS_EGRESS_CAP where a test narrows it."""

import itertools

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.driver import (
    StreamingAnalyticsDriver as JaxDriver)
from gelly_streaming_tpu.ops import delta_egress as jax_delta
from gelly_streaming_tpu_torch import StreamingAnalyticsDriver, WindowResult
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.ops import host_snapshot
from gelly_streaming_tpu_torch.ops import window_snapshot as snap_ops

ARRAYS = ("vertex_ids", "degrees", "cc_labels", "bipartite_odd")
DELTAS = ("delta_degrees", "delta_cc", "delta_bipartite")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    monkeypatch.delenv("GS_EGRESS_CAP", raising=False)
    jax_delta._reset_egress()
    # many small torch ops: one thread each beside the other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_delta._reset_egress()


def _stream(seed=0, n=700, v=120, spread=7):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, n) * spread + 3
    dst = rng.integers(0, v, n) * spread + 3
    ts = np.sort(rng.integers(0, 6000, n))
    return src, dst, ts


def _pair(port_tier="scan", jax_tier="scan", **kw):
    jkw = dict(kw)
    jkw.pop("egress_cap", None)
    jkw.setdefault("egress", "full")
    return (JaxDriver(snapshot_tier=jax_tier, **jkw),
            StreamingAnalyticsDriver(device="cpu", snapshot_tier=port_tier,
                                     **kw))


def assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert isinstance(g, WindowResult)
        assert (w.window_start, w.num_edges, w.triangles) == (
            g.window_start, g.num_edges, g.triangles)
        for f in ARRAYS:
            a, b = getattr(w, f), getattr(g, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
                np.testing.assert_array_equal(a, b, err_msg=f)
                assert not b.flags.writeable
        for f in DELTAS:
            a, b = getattr(w, f), getattr(g, f)
            assert (a is None) == (b is None), f
            if a is not None:
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
                    np.testing.assert_array_equal(x, y, err_msg=f)
        assert g.latency is None


def assert_state_equal(jax_drv, drv):
    want, got = jax_drv.state_dict(), drv.state_dict()
    for k, v in got.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        else:
            assert v == want[k], k


@pytest.mark.parametrize("port_tier,jax_tier", [
    ("scan", "scan"), ("native", "scan"), ("host", "scan"),
    ("scan", "host"), ("native", "host")])
@pytest.mark.parametrize("mode", ["event", "count"])
def test_results_match_jax(port_tier, jax_tier, mode):
    src, dst, ts = _stream()
    jd, pd = _pair(port_tier, jax_tier, window_ms=1000, vertex_bucket=16,
                   edge_bucket=64)
    if mode == "event":     # 6 windows of varying sizes; eb grows too
        args = (src, dst, ts)
    else:                   # 10 windows of 64, the last one of 60
        args = (src[:-4], dst[:-4])
    assert_same(jd.run_arrays(*args), pd.run_arrays(*args))
    assert_state_equal(jd, pd)
    assert pd.vb == jd.vb and pd.eb == jd.eb and pd.vb > 16


@pytest.mark.parametrize("analytics", [
    s for n in (1, 2, 3, 4)
    for s in itertools.combinations(StreamingAnalyticsDriver.ANALYTICS, n)])
def test_analytics_subsets_match_jax(analytics):
    src, dst, ts = _stream(1, n=400)
    jd, pd = _pair(window_ms=1000, analytics=analytics, vertex_bucket=32,
                   edge_bucket=32)
    assert_same(jd.run_arrays(src, dst, ts), pd.run_arrays(src, dst, ts))
    assert_state_equal(jd, pd)


@pytest.mark.parametrize("port_tier", ["scan", "native", "host"])
@pytest.mark.parametrize("egress", ["full", "delta"])
@pytest.mark.parametrize("emit_deltas", [False, True])
def test_deltas_and_egress_match_jax(port_tier, egress, emit_deltas):
    src, dst, ts = _stream(2, n=500)
    jd, pd = _pair(port_tier, window_ms=500, vertex_bucket=16,
                   edge_bucket=32, egress=egress, emit_deltas=emit_deltas)
    assert_same(jd.run_arrays(src, dst, ts), pd.run_arrays(src, dst, ts))
    assert_state_equal(jd, pd)


@pytest.mark.parametrize("emit_deltas", [False, True])
def test_delta_cap_overflow_refolds_on_the_host(emit_deltas, monkeypatch):
    """A cap of 2 changed slots a window: nearly every chunk overflows
    and is run again on full rows; a cap of 40 lets some chunks through
    on the wire. Both equal the JAX driver (whose refold is on the host)
    at the same cap."""
    src, dst, ts = _stream(3, n=900, v=60)
    for cap in (2, 40):
        monkeypatch.setenv("GS_EGRESS_CAP", str(cap))
        jd, pd = _pair(window_ms=300, vertex_bucket=64, edge_bucket=64,
                       egress="delta", egress_cap=cap,
                       emit_deltas=emit_deltas)
        assert_same(jd.run_arrays(src, dst, ts),
                    pd.run_arrays(src, dst, ts))
        assert_state_equal(jd, pd)


@pytest.mark.parametrize("emit_deltas", [False, True])
def test_delta_overflow_refolds_through_the_snapshot_program(emit_deltas,
                                                             monkeypatch):
    """An overflowing chunk of the scan tier is run again by the
    snapshot program on full rows (on the driver's device), never by the
    host folds; the results equal the full egress's."""
    src, dst, ts = _stream(3, n=900, v=60)
    kw = dict(window_ms=300, vertex_bucket=64, edge_bucket=64,
              emit_deltas=emit_deltas, device="cpu")
    want = StreamingAnalyticsDriver(**kw).run_arrays(src, dst, ts)
    calls = []
    real = snap_ops.WindowSnapshot.__call__

    def spy(self, carry, s, d, v):
        calls.append((self.egress, s.shape[0]))
        return real(self, carry, s, d, v)

    def no_host(*_a, **_k):
        raise AssertionError("the refold took a host fold")

    monkeypatch.setattr(snap_ops.WindowSnapshot, "__call__", spy)
    monkeypatch.setattr(host_snapshot, "snapshot_windows", no_host)
    monkeypatch.setattr(native, "snapshot_windows", no_host)
    pd = StreamingAnalyticsDriver(egress="delta", egress_cap=2, **kw)
    assert_same(want, pd.run_arrays(src, dst, ts))
    delta = [w for e, w in calls if e == "delta"]
    full = [w for e, w in calls if e == "full"]
    assert full and full == delta     # every chunk overflowed at cap 2


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_checkpoint_inside_a_call_resumes_exactly(tmp_path, resumer):
    """One count-based call of 100 windows, checkpointing every 64: the
    checkpoint at window 64 is taken inside the call, whose interner by
    then holds the vertices of all 100. It keeps the vertex table of
    window 64, so a driver of either package resumed from it gives the
    call's windows 64-99 exactly, and the call's final state."""
    rng = np.random.default_rng(9)
    eb = 8
    src = rng.integers(0, 400, 100 * eb) * 3
    dst = rng.integers(0, 400, 100 * eb) * 3
    ckpt = str(tmp_path / "c.npz")
    kw = dict(window_ms=1000, vertex_bucket=16, edge_bucket=eb,
              emit_deltas=True)
    jd, first = _pair(**kw)
    first.enable_auto_checkpoint(ckpt, every_n_windows=64)
    want = first.run_arrays(src, dst)
    assert len(first.interner) > len(want[63].vertex_ids)
    second = (StreamingAnalyticsDriver(device="cpu", **kw)
              if resumer == "port" else jd)
    assert second.try_resume(ckpt)
    assert second.windows_done == 64 and second.edges_done == 64 * eb
    rest = second.run_arrays(src[64 * eb:], dst[64 * eb:])
    if resumer == "port":
        assert_same(want[64:], rest)
    else:
        assert_same(rest, want[64:])
    want_state = first.state_dict()
    for k, v in second.state_dict().items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(want_state[k]), err_msg=k)


def test_vertex_bucket_grows_across_calls():
    """Count-based feeding in edge_bucket multiples, the vertex bucket
    doubling from 8 to 256 between calls (and inside the first)."""
    rng = np.random.default_rng(4)
    jd, pd = _pair(window_ms=1000, vertex_bucket=8, edge_bucket=64,
                   emit_deltas=True)
    seen = []
    for windows, ids in ((1, 6), (2, 30), (1, 60), (5, 250)):
        src = rng.integers(0, ids, 64 * windows) * 5
        dst = rng.integers(0, ids, 64 * windows) * 5
        assert_same(jd.run_arrays(src, dst), pd.run_arrays(src, dst))
        seen.append(pd.vb)
    assert seen[0] == 8 and seen[-1] == 256 and len(set(seen)) >= 4
    assert_state_equal(jd, pd)


def _write(path, src, dst, ts=None):
    with open(path, "w") as f:
        for i in range(len(src)):
            if ts is None:
                f.write("%d %d\n" % (src[i], dst[i]))
            else:
                f.write("%d %d %d\n" % (src[i], dst[i], ts[i]))


@pytest.mark.parametrize("timestamped", [True, False])
def test_stream_file_matches_jax(tmp_path, timestamped):
    src, dst, ts = _stream(5, n=900)
    path = str(tmp_path / "e.txt")
    _write(path, src, dst, ts if timestamped else None)
    jd, pd = _pair(window_ms=700, vertex_bucket=16, edge_bucket=64)
    want = list(jd.stream_file(path, chunk_bytes=2000))
    got = list(pd.stream_file(path, chunk_bytes=2000))
    assert len(got) > 3
    assert_same(want, got)
    assert_same(want, StreamingAnalyticsDriver(
        window_ms=700, vertex_bucket=16, edge_bucket=64,
        device="cpu").run_file(path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resume_across_packages(tmp_path, writer):
    """A stream_file run checkpointing every 2 windows is abandoned
    after 5 windows; the other package's driver resumes from the
    checkpoint and finishes; its windows equal the tail of an
    uninterrupted run, and its final state the uninterrupted one's."""
    src, dst, ts = _stream(6, n=900)
    path = str(tmp_path / "e.txt")
    ckpt = str(tmp_path / "ckpt.npz")
    _write(path, src, dst, ts)
    kw = dict(window_ms=500, vertex_bucket=16, edge_bucket=32)
    full_jax, full_port = _pair(**kw)
    want = list(full_jax.stream_file(path, chunk_bytes=1500))
    assert_same(want, list(full_port.stream_file(path, chunk_bytes=1500)))
    jd, pd = _pair(**kw)
    first, second = (jd, pd) if writer == "jax" else (pd, jd)
    first.enable_auto_checkpoint(ckpt, every_n_windows=2)
    stream = first.stream_file(path, chunk_bytes=1500)
    for _ in range(5):
        next(stream)
    stream.close()
    assert second.try_resume(ckpt)
    done = second.windows_done
    assert 0 < done <= 5
    rest = list(second.stream_file(path, chunk_bytes=1500, resume=True))
    if second is pd:
        assert_same(want[done:], rest)
        assert_state_equal(full_jax, pd)
    else:
        assert_same(rest, full_port_results(kw, path)[done:])
        assert_state_equal(jd, full_port)


def full_port_results(kw, path):
    drv = StreamingAnalyticsDriver(device="cpu", **kw)
    return list(drv.stream_file(path, chunk_bytes=1500))


def test_state_dict_loads_both_ways():
    src, dst, ts = _stream(7, n=600)
    jd, pd = _pair(window_ms=1000, vertex_bucket=16, edge_bucket=64,
                   emit_deltas=True)
    jd.run_arrays(src[:300], dst[:300], ts[:300])
    pd.run_arrays(src[:300], dst[:300], ts[:300])
    assert_state_equal(jd, pd)
    jd2, pd2 = _pair(window_ms=1000, vertex_bucket=16, edge_bucket=64,
                     emit_deltas=True)
    jd2.load_state_dict(pd.state_dict())
    pd2.load_state_dict(jd.state_dict())
    assert_same(jd2.run_arrays(src[300:], dst[300:], ts[300:]),
                pd2.run_arrays(src[300:], dst[300:], ts[300:]))
    assert_state_equal(jd2, pd2)
    with pytest.raises(ValueError, match="window size"):
        StreamingAnalyticsDriver(window_ms=7, device="cpu").load_state_dict(
            jd.state_dict())
    with pytest.raises(ValueError, match="analytics"):
        StreamingAnalyticsDriver(window_ms=1000, analytics=("cc",),
                                 device="cpu").load_state_dict(
            jd.state_dict())
    bad = dict(pd.state_dict(), wal_offset=1)
    with pytest.raises(ValueError, match="wal_offset"):
        pd2.load_state_dict(bad)


def test_try_resume_falls_back_and_warns(tmp_path):
    src, dst, ts = _stream(8, n=300)
    ckpt = str(tmp_path / "c.npz")
    pd = StreamingAnalyticsDriver(window_ms=500, device="cpu")
    assert not pd.try_resume(ckpt)
    pd.enable_auto_checkpoint(ckpt, every_n_windows=1)
    pd.run_arrays(src[:100], dst[:100], ts[:100])
    pd.run_arrays(src[100:], dst[100:], ts[100:])
    with open(ckpt, "wb") as f:
        f.write(b"junk")
    fresh = StreamingAnalyticsDriver(window_ms=500, device="cpu")
    with pytest.warns(UserWarning, match="previous generation"):
        assert fresh.try_resume(ckpt)
    assert 0 < fresh.windows_done < pd.windows_done


def test_refusals(monkeypatch):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingAnalyticsDriver(window_ms=10)
    with pytest.raises(NotImplementedError, match="1.10"):
        StreamingAnalyticsDriver(window_ms=10, device="cpu", mesh=object())
    # tenant= and tracing= are ported (tests/test_torch_hooks_driver.py)
    drv = StreamingAnalyticsDriver(window_ms=10, device="cpu", tenant=7,
                                   tracing=True)
    assert drv.tenant == "7" and drv.trace_report() == []
    assert drv.demotion_log() == []
    # the resident tier is ported (tests/test_torch_resident.py)
    assert StreamingAnalyticsDriver(
        window_ms=10, device="cpu",
        snapshot_tier="resident").snapshot_tier == "resident"
    for slide in (24, 2 * 4096):
        with pytest.raises(ValueError, match="power of two dividing"):
            StreamingAnalyticsDriver(window_ms=10, device="cpu",
                                     slide=slide)
    for kw in (dict(snapshot_tier="gpu"), dict(egress="wide"),
               dict(analytics=("pagerank",))):
        with pytest.raises(ValueError):
            StreamingAnalyticsDriver(window_ms=10, device="cpu", **kw)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError, match="native"):
        StreamingAnalyticsDriver(window_ms=10, device="cpu",
                                 snapshot_tier="native")


def test_stream_contracts():
    pd = StreamingAnalyticsDriver(window_ms=10, device="cpu",
                                  edge_bucket=8)
    assert pd.run_arrays(np.zeros(0), np.zeros(0)) == []
    with pytest.raises(ValueError, match="ascending"):
        pd.run_arrays([1, 2], [2, 3], [20, 5])
    with pytest.raises(ValueError, match="mixed"):
        pd.run_arrays([1, 2], [2, 3], [20, -1])
    pd.run_arrays(np.arange(11), np.arange(11) + 1)
    with pytest.raises(ValueError, match="partial"):
        pd.run_arrays([1], [2])
    pd.reset()
    (res,) = pd.run_arrays([5, 6], [6, 5])
    assert res.window_start == 0 and res.degrees.tolist() == [2, 2]
