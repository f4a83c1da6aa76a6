"""The port's driver with sliding windows (`slide=`,
gelly_streaming_tpu_torch/core/driver.py) on device="cpu", held against
the JAX driver's pane composition after tests/test_sliding_windows.py:
each emission's triangles against the sparse oracle over the raw
trailing slice, the cumulative fields equal to a tumbling driver cut at
the pane size, slide == edge_bucket as tumbling, kills and resumes mid
pane ring with the checkpoint loaded into the other package both ways,
and the refusals. Every WindowResult field equals the JAX driver's on
streams fed as calls that cross the port's chunk boundaries (64
windows), on each snapshot tier and egress. The analytics are integers:
equality, no tolerance."""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.driver import (
    StreamingAnalyticsDriver as JaxDriver)
from gelly_streaming_tpu.ops import delta_egress as jax_delta
from gelly_streaming_tpu.ops.triangles import triangle_count_sparse
from gelly_streaming_tpu.utils import checkpoint as jax_checkpoint

from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch.utils import checkpoint

EB, VB, SLIDE = 64, 64, 16
FIELDS = ("vertex_ids", "degrees", "cc_labels", "bipartite_odd")
DELTAS = ("delta_degrees", "delta_cc", "delta_bipartite")


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX driver's defaults read evidence files and GS_SLIDE: pin
    its autotuner off and its egress by argument. One torch thread a
    test: the suite's workers share the cores."""
    for k in ("GS_SLIDE", "GS_EGRESS_CAP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    jax_delta._reset_egress()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jax_delta._reset_egress()


def _edges(n, seed=0, ids=40):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, ids, n).astype(np.int64),
            rng.integers(0, ids, n).astype(np.int64))


def _port(slide=SLIDE, **kw):
    kw.setdefault("vertex_bucket", VB)
    kw.setdefault("edge_bucket", EB)
    return StreamingAnalyticsDriver(window_ms=1000, slide=slide,
                                    device="cpu", **kw)


def _jax(slide=SLIDE, **kw):
    kw.setdefault("vertex_bucket", VB)
    kw.setdefault("edge_bucket", EB)
    kw.setdefault("egress", "full")
    return JaxDriver(window_ms=1000, slide=slide, **kw)


def assert_same(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert (w.window_start, w.num_edges, w.triangles) == (
            g.window_start, g.num_edges, g.triangles), i
        for f in FIELDS:
            a, b = getattr(w, f), getattr(g, f)
            assert (a is None) == (b is None), (i, f)
            if a is not None:
                assert a.dtype == b.dtype, (i, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{i} {f}")
        for f in DELTAS:
            a, b = getattr(w, f), getattr(g, f)
            assert (a is None) == (b is None), (i, f)
            for x, y in zip(a or (), b or ()):
                assert x.dtype == y.dtype, (i, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{i} {f}")


def _feed(drv, src, dst, cuts):
    out = []
    for lo, hi in zip((0,) + cuts, cuts + (len(src),)):
        out += drv.run_arrays(src[lo:hi], dst[lo:hi])
    return out


def _oracle(src, dst, i, n):
    lo, hi = max(0, (i + 1) * SLIDE - EB), min((i + 1) * SLIDE, n)
    s, d = src[lo:hi], dst[lo:hi]
    ids = np.unique(np.concatenate([s, d]))
    return int(triangle_count_sparse(
        np.searchsorted(ids, s).astype(np.int32),
        np.searchsorted(ids, d).astype(np.int32), len(ids)))


@pytest.mark.parametrize("n", [300, 256, 17])
def test_sliding_triangles_vs_sparse_oracle(n):
    src, dst = _edges(n, seed=10)
    out = _port().run_arrays(src, dst)
    assert len(out) == -(-n // SLIDE)
    for i, res in enumerate(out):
        assert res.triangles == _oracle(src, dst, i, n), f"emission {i}"
        assert res.num_edges == min((i + 1) * SLIDE, n) - i * SLIDE
        assert res.window_start == i * SLIDE
    assert_same(_jax().run_arrays(src, dst), out)


def test_sliding_cumulative_equals_pane_tumbling():
    """degrees/cc/bipartite are running snapshots: pane-sized sliding
    emissions equal a tumbling driver cut at the pane size."""
    src, dst = _edges(240, seed=11)
    names = ("degrees", "cc", "bipartite")
    slid = _port(analytics=names).run_arrays(src, dst)
    pane = _port(slide=None, analytics=names,
                 edge_bucket=SLIDE).run_arrays(src, dst)
    assert len(slid) == len(pane) == 15
    for a, b in zip(slid, pane):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_slide_equals_eb_is_tumbling():
    """slide == edge_bucket is the tumbling driver: equal results, and a
    checkpoint that resumes in a driver of either slide (the JAX driver
    at slide == eb refuses its own: ROADMAP §3)."""
    src, dst = _edges(200, seed=12)
    a = _port(slide=None).run_arrays(src, dst)
    drv = _port(slide=EB)
    b = drv.run_arrays(src[:128], dst[:128])
    assert_same(_jax(slide=EB).run_arrays(src[:128], dst[:128]), b)
    for slide in (None, EB):
        resumed = _port(slide=slide)
        resumed.load_state_dict(drv.state_dict())
        b2 = b + resumed.run_arrays(src[128:], dst[128:])
        assert_same(a, b2)


@pytest.mark.parametrize("tier", ["scan", "native", "host"])
@pytest.mark.parametrize("egress,emit_deltas,cap", [
    ("full", False, None), ("full", True, None), ("delta", True, None),
    ("delta", False, 4)])
def test_results_match_jax_across_chunks(tier, egress, emit_deltas, cap):
    """150 emissions fed as calls of 70, 50 and 30 panes: the port's
    chunk boundaries (every 64 windows) fall inside calls, and every
    field equals the JAX driver's, as do the final states. At a delta
    cap of 4 slots every chunk overflows and runs again on full rows."""
    src, dst = _edges(150 * SLIDE, seed=4, ids=300)
    cuts = (70 * SLIDE, 120 * SLIDE)
    jd = _jax(emit_deltas=emit_deltas)
    pd = _port(snapshot_tier=tier, egress=egress, emit_deltas=emit_deltas,
               egress_cap=cap)
    assert_same(_feed(jd, src, dst, cuts), _feed(pd, src, dst, cuts))
    want, got = jd.state_dict(), pd.state_dict()
    assert set(want) >= set(got) >= {"slide", "pane_ring_src",
                                     "pane_ring_dst"}
    assert got["slide"] == want["slide"] == SLIDE
    for key in ("pane_ring_src", "pane_ring_dst"):
        assert len(got[key]) == len(want[key]) == EB // SLIDE - 1
        for x, y in zip(got[key], want[key]):
            np.testing.assert_array_equal(x, y)
    for key in ("windows_done", "edges_done", "degrees", "cc",
                "vertex_ids"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("writer,reader", [("port", "jax"),
                                           ("jax", "port"),
                                           ("port", "port")])
def test_kill_resume_mid_pane_ring(tmp_path, writer, reader):
    """A checkpoint after 7 panes (the ring full) resumes in either
    package to the uninterrupted run's emissions; a driver of another
    slide refuses it."""
    n = 240
    src, dst = _edges(n, seed=13)
    ref = _jax().run_arrays(src, dst)
    cut = 7 * SLIDE
    a = _port() if writer == "port" else _jax()
    head = a.run_arrays(src[:cut], dst[:cut])
    path = str(tmp_path / "ck")
    (checkpoint if writer == "port" else jax_checkpoint).save(
        path, a.state_dict())
    b = _port() if reader == "port" else _jax()
    assert b.try_resume(path)
    tail = b.run_arrays(src[cut:], dst[cut:])
    assert_same(ref, head + tail)
    state, _used = checkpoint.load_latest(path)
    for other in (None, SLIDE * 2):
        with pytest.raises(ValueError, match="slide mismatch"):
            _port(slide=other).load_state_dict(state)


@pytest.mark.parametrize("resumer", ["port", "jax"])
def test_checkpoint_inside_a_call_holds_its_ring(tmp_path, resumer):
    """An auto-checkpoint at window 64 of a 100-pane call holds the
    pane ring as it stood there (not at the call's end): a driver of
    either package resumed from it gives panes 64-99 exactly."""
    src, dst = _edges(100 * SLIDE, seed=9, ids=200)
    path = str(tmp_path / "c.npz")
    first = _port(emit_deltas=True)
    first.enable_auto_checkpoint(path, every_n_windows=64)
    want = first.run_arrays(src, dst)
    second = (_port(emit_deltas=True) if resumer == "port"
              else _jax(emit_deltas=True))
    assert second.try_resume(path)
    assert second.windows_done == 64 and second.edges_done == 64 * SLIDE
    rest = second.run_arrays(src[64 * SLIDE:], dst[64 * SLIDE:])
    assert_same(want[64:], rest)


def test_reset_clears_the_ring():
    src, dst = _edges(160, seed=5)
    drv = _port()
    first = drv.run_arrays(src, dst)
    drv.reset()
    assert drv.state_dict()["pane_ring_src"] == []
    assert_same(first, drv.run_arrays(src, dst))


def test_refusals():
    for bad in (24, 2 * EB, 12):
        with pytest.raises(ValueError, match="power of two dividing"):
            _port(slide=bad)
    drv = _port()
    with pytest.raises(ValueError, match="count-based"):
        drv.run_arrays(*_edges(10, seed=14), ts=np.arange(10))
    src, dst = _edges(40, seed=15)
    drv.run_arrays(src, dst)       # a short last pane closes the stream
    with pytest.raises(ValueError, match="partial window"):
        drv.run_arrays(src, dst)
    assert _port(slide=0).slide is None
