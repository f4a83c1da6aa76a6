"""The port's WindowedEdgeReduce (ops/windowed_reduce.py) held against the
JAX package's engine on the CPU: its tiers (device on the plain cell
reduce, host, native) against the JAX tiers, called directly
(`_device_process_stream`, `_host_process_stream`: its
`_resolve_reduce_impl` may route by evidence files here) and against
`numpy_reference`; `slide=` against `sliding_numpy_reference` and the JAX
sliding engine; `cohort_step`; the associative-fn tier; chunking
boundaries; refused ids. Integer values are bit-equal; a float32 sum is
held to 1e-5 · Σ|v| a cell.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import windowed_reduce as jw
from gelly_streaming_tpu_torch import forced_sync
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.ops import windowed_reduce as pw

NAMES = ("sum", "min", "max")
DIRS = ("out", "in", "all")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(n, vb, seed, dtype=np.int64):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vb, n)
    dst = rng.integers(0, vb, n)
    if np.issubdtype(dtype, np.floating):
        val = (rng.standard_normal(n) * 50).astype(dtype)
    else:
        val = rng.integers(-500, 500, n).astype(dtype)
    return src, dst, val


def _jax_device(src, dst, val, vb, eb, name, direction, **kw):
    eng = jw.WindowedEdgeReduce(vb, eb, name, direction, **kw)
    return [(np.asarray(c), np.asarray(n)) for c, n in
            eng._device_process_stream(src.astype(np.int64),
                                       dst.astype(np.int64), val)]


def _equal_rows(got, want, float_sum_tol=None):
    assert len(got) == len(want)
    for w, ((gc, gn), (wc, wn)) in enumerate(zip(got, want)):
        assert gc.dtype == wc.dtype, (gc.dtype, wc.dtype)
        np.testing.assert_array_equal(gn, wn)
        if float_sum_tol is not None:
            assert np.all(np.abs(gc.astype(np.float64) - wc)
                          <= 1e-5 * float_sum_tol[w] + 1e-30)
        else:
            np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("name,direction", itertools.product(NAMES, DIRS))
@pytest.mark.parametrize("ingress,egress", [("standard", "full"),
                                            ("compact", "full"),
                                            ("standard", "delta"),
                                            ("compact", "delta")])
def test_device_tier_matches_jax_device_tier(name, direction, ingress,
                                             egress):
    """A stream of 3 chunks (eb=64, 64-window chunks, the last ragged)
    at vb=300: every window bit-equal to the JAX device tier."""
    vb, eb = 300, 64
    src, dst, val = _stream(64 * 64 * 2 + 64 * 5 + 17, vb, seed=1)
    eng = pw.WindowedEdgeReduce(vb, eb, name, direction, ingress=ingress,
                                egress=egress, device="cpu")
    got = eng.process_stream(src, dst, val)
    want = _jax_device(src, dst, val, vb, eb, name, direction,
                       ingress=ingress, egress=egress)
    _equal_rows(got, want)
    with forced_sync():
        _equal_rows(eng.process_stream(src, dst, val), want)


@pytest.mark.parametrize("name,direction", itertools.product(NAMES, DIRS))
def test_float_values_device_tier(name, direction):
    vb, eb = 200, 128
    src, dst, val = _stream(1000, vb, seed=2, dtype=np.float64)
    got = pw.WindowedEdgeReduce(vb, eb, name, direction,
                                device="cpu").process_stream(src, dst, val)
    want = _jax_device(src, dst, val, vb, eb, name, direction)
    tol = None
    if name == "sum":
        tol = [c for c, _n in pw.WindowedEdgeReduce(
            vb, eb, "sum", direction, tier="host").process_stream(
            src, dst, np.abs(val))]
    _equal_rows(got, want, tol)


@pytest.mark.parametrize("name,direction", itertools.product(NAMES, DIRS))
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_host_tier_matches_jax_host_tier(name, direction, dtype):
    vb, eb = 150, 128
    src, dst, val = _stream(700, vb, seed=3, dtype=dtype)
    got = pw.WindowedEdgeReduce(vb, eb, name, direction,
                                tier="host").process_stream(src, dst, val)
    want = jw.WindowedEdgeReduce(vb, eb, name, direction)\
        ._host_process_stream(src, dst, val)
    _equal_rows(got, want)
    ref = pw.numpy_reference(src, dst, val, eb, direction, name)
    jref = jw.numpy_reference(src, dst, val, eb, direction, name)
    for (rc, rn), (jc, jn), (gc, gn) in zip(ref, jref, got):
        np.testing.assert_array_equal(rc, jc)
        np.testing.assert_array_equal(rn, jn)
        np.testing.assert_array_equal(gn[:len(rn)], rn)
        m = rn > 0
        np.testing.assert_array_equal(gc[:len(rn)][m], rc[m])


@pytest.mark.parametrize("name,direction", itertools.product(NAMES, DIRS))
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_native_tier_matches_jax_native_and_device(name, direction, dtype):
    if not native.windowed_reduce_available():
        pytest.fail("native library: %s" % native.build_error())
    vb, eb = 250, 128
    src, dst, val = _stream(1500, vb, seed=4, dtype=dtype)
    got = pw.WindowedEdgeReduce(vb, eb, name, direction,
                                tier="native").process_stream(src, dst, val)
    want = jw.WindowedEdgeReduce(vb, eb, name, direction)\
        ._native_process_stream(src, dst, val)
    assert want is not None
    _equal_rows(got, want)
    dev = pw.WindowedEdgeReduce(vb, eb, name, direction,
                                device="cpu").process_stream(src, dst, val)
    for (gc, gn), (dc, dn) in zip(got, dev):
        np.testing.assert_array_equal(gn, dn)
        np.testing.assert_array_equal(gc[gn > 0], dc[dn > 0])


def test_native_tier_refuses_floats():
    if not native.windowed_reduce_available():
        pytest.fail("native library: %s" % native.build_error())
    eng = pw.WindowedEdgeReduce(64, 32, tier="native")
    with pytest.raises(ValueError, match="signed integer"):
        eng.process_stream(np.arange(4), np.arange(4), np.ones(4))


@pytest.mark.parametrize("name,direction", itertools.product(NAMES, DIRS))
@pytest.mark.parametrize("tier", ["device", "host"])
def test_sliding_matches_oracle_and_jax(name, direction, tier):
    vb, eb, slide = 120, 256, 64
    src, dst, val = _stream(1500, vb, seed=5)
    kw = {"device": "cpu"} if tier == "device" else {}
    eng = pw.WindowedEdgeReduce(vb, eb, name, direction, slide=slide,
                                tier=tier, **kw)
    got = eng.process_stream(src, dst, val)
    ref = pw.sliding_numpy_reference(src, dst, val, eb, slide, direction,
                                     name)
    assert len(got) == len(ref) == -(-1500 // slide)
    for (gc, gn), (rc, rn) in zip(got, ref):
        np.testing.assert_array_equal(gn[:len(rn)], rn)
        assert not gn[len(rn):].any()
        m = rn > 0
        np.testing.assert_array_equal(gc[:len(rn)][m], rc[m])
    naive = eng.process_stream_naive(src, dst, val)
    for (gc, gn), (nc, nn) in zip(got, naive):
        np.testing.assert_array_equal(gn, nn)
        np.testing.assert_array_equal(gc[gn > 0], nc[nn > 0])
    if tier == "device":
        jeng = jw.WindowedEdgeReduce(vb, eb, name, direction, slide=slide)
        jeng._pane_engine = jw.WindowedEdgeReduce(vb, slide, name,
                                                  direction)
        jeng._pane_engine.process_stream = (
            lambda s, d, v: jeng._pane_engine._device_process_stream(
                s.astype(np.int64), d.astype(np.int64), v))
        _equal_rows(got, [(np.asarray(c), np.asarray(n)) for c, n in
                          jeng.process_stream(src, dst, val)])


@pytest.mark.parametrize("name", NAMES)
def test_cohort_step_matches_single_windows_and_jax(name):
    vb, eb = 200, 64
    rng = np.random.default_rng(6)
    rows = []
    for i in range(5):
        k = int(rng.integers(0, eb + 1)) if i != 2 else 0
        rows.append((rng.integers(0, vb, k), rng.integers(0, vb, k),
                     rng.integers(-50, 50, k)))
    eng = pw.WindowedEdgeReduce(vb, eb, name, "all", device="cpu")
    got = eng.cohort_step(rows)
    want = jw.WindowedEdgeReduce(vb, eb, name, "all").cohort_step(rows)
    _equal_rows(got, [(np.asarray(c), np.asarray(n)) for c, n in want])
    for (gc, gn), (s, d, v) in zip(got, rows):
        if len(s) == 0:
            assert not gn.any()
            continue
        (oc, on), = eng.process_stream(s, d, v)
        np.testing.assert_array_equal(gc, oc)
        np.testing.assert_array_equal(gn, on)
    with pytest.raises(ValueError):
        eng.cohort_step([(np.zeros(eb + 1, np.int64),) * 3])


@pytest.mark.parametrize("direction", DIRS)
def test_associative_fn_tier(direction):
    """fn=torch.maximum (associative) equals the JAX fn tier and the
    max monoid on every touched cell; counts equal."""
    vb, eb = 100, 64
    src, dst, val = _stream(600, vb, seed=7)
    got = pw.WindowedEdgeReduce(vb, eb, direction=direction,
                                fn=torch.maximum,
                                device="cpu").process_stream(src, dst, val)
    want = jw.WindowedEdgeReduce(vb, eb, direction=direction,
                                 fn=jnp.maximum)._device_process_stream(
        src, dst, val)
    mono = pw.WindowedEdgeReduce(vb, eb, "max", direction,
                                 device="cpu").process_stream(src, dst, val)
    for (gc, gn), (wc, wn), (mc, mn) in zip(got, want, mono):
        np.testing.assert_array_equal(gn, wn)
        np.testing.assert_array_equal(gn, mn)
        m = gn > 0
        np.testing.assert_array_equal(gc[m], np.asarray(wc)[m])
        np.testing.assert_array_equal(gc[m], mc[m])


@pytest.mark.parametrize("n", [1, 63, 64, 65, 64 * 64, 64 * 64 + 1,
                               64 * 64 * 2 + 3])
def test_window_chunking_boundaries(n):
    vb, eb = 50, 64
    src, dst, val = _stream(n, vb, seed=n)
    got = pw.WindowedEdgeReduce(vb, eb, "sum", "all",
                                device="cpu").process_stream(src, dst, val)
    assert len(got) == -(-n // eb)
    _equal_rows(got, _jax_device(src, dst, val, vb, eb, "sum", "all"))


@pytest.mark.parametrize("tier", ["device", "host", "native"])
@pytest.mark.parametrize("bad", [-1, 65])
def test_refused_ids(tier, bad):
    vb = 64
    kw = {"device": "cpu"} if tier == "device" else {}
    for ingress in (("standard", "compact") if tier == "device"
                    else ("standard",)):
        eng = pw.WindowedEdgeReduce(vb, 32, "sum", "out", tier=tier,
                                    ingress=ingress, **kw)
        src = np.array([0, 1, bad])
        with pytest.raises(ValueError, match="outside"):
            eng.process_stream(src, np.array([1, 2, 3]), np.ones(3, np.int64))


def test_constructor_contracts():
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, direction="up", device="cpu")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, egress="half", device="cpu")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, tier="gpu")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, fn=torch.add, tier="host")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, slide=48, device="cpu")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(64, 64, fn=torch.add, slide=16, device="cpu")
    with pytest.raises(ValueError):
        pw.WindowedEdgeReduce(1 << 17, 64, ingress="compact", device="cpu")
    assert pw.WindowedEdgeReduce(64, 64, device="cpu").process_stream(
        [], [], []) == []


def test_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pw.WindowedEdgeReduce(64, 64)
    pw.WindowedEdgeReduce(64, 64, tier="host")    # needs no card
