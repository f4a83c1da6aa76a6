"""The cell reduce (ops/cell_reduce.py: the plain version of
csrc/cell_reduce.cu, which the wrappers run on CPU tensors) held against
the JAX package's XLA segment programs, reached through its
`WindowedEdgeReduce._device_process_stream` (`_stack_fn`,
`_stack_fn_compact` and the delta tail), across monoid × direction ×
value type × wire × egress at small shapes, and on the edge cases the
chip's phase runs. Integer cases and float min/max are bit-equal; a
float32 sum is held to 1e-5 · Σ|v| a cell (the kernel's atomics reorder
it), counts exactly.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import delta_egress as j_delta
from gelly_streaming_tpu.ops import windowed_reduce as jw
from gelly_streaming_tpu_torch.ops import cell_reduce as cr
from gelly_streaming_tpu_torch.ops import compact_ingress
from gelly_streaming_tpu_torch.ops import segment as port_seg
from gelly_streaming_tpu_torch.ops import windowed_reduce as pw

GRID = list(itertools.product(("sum", "min", "max"), ("out", "in", "all"),
                              ("int32", "float32")))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(n, vb, dtype, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vb, n)
    dst = rng.integers(0, vb, n)
    src[::7] = 0
    dst[::11] = vb - 1
    if dtype == "int32":
        val = rng.integers(-1000, 1000, n).astype(np.int64)
    else:
        val = rng.standard_normal(n) * 100
    return src, dst, val


def _jax_rows(src, dst, val, vb, eb, name, direction, ingress, egress):
    eng = jw.WindowedEdgeReduce(vb, eb, name, direction, ingress=ingress,
                                egress=egress)
    return [(np.asarray(c), np.asarray(n))
            for c, n in eng._device_process_stream(src, dst, val)]


def _abs_rows(src, dst, val, vb, eb, direction):
    """Σ|v| a cell of each window (the float sum's tolerance)."""
    return [c for c, _n in pw.numpy_reference(
        np.append(src, vb), np.append(dst, vb),
        np.append(np.abs(val), 0.0), eb, direction, "sum")]


def _chunk_tensors(src, dst, val, vb, eb, direction, wire, wb):
    """The first chunk's wire, built as the port's engine builds it."""
    eng = pw.WindowedEdgeReduce(vb, eb, "sum", direction, device="cpu",
                                ingress=wire)
    kval = port_seg.x64_off_values(val)
    if wire == "compact":
        _w, s16, d16, nv = compact_ingress.window_stack(src, dst, eb)
        return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            s16[:wb], d16[:wb], nv[:wb],
            np.resize(kval, wb * eb).reshape(wb, eb)))
    ids, vals = eng._standard_chunk(src, dst, kval, 0, wb)
    return torch.from_numpy(ids), torch.from_numpy(vals)


def _call(wire, t, wb, eb, vbp, name, direction, egress="full", cap=0):
    if wire == "compact":
        return cr.cell_reduce_compact(*t, vbp, name, direction, egress, cap)
    return cr.cell_reduce(*t, wb, eb, vbp, name, egress, cap)


def _same(got, want, name, dtype, tol=None):
    gc, gn = got
    wc, wn = want
    assert gc.dtype == wc.dtype and gn.dtype == wn.dtype
    np.testing.assert_array_equal(gn, wn)
    if dtype == "float32" and name == "sum":
        assert np.all(np.abs(gc.astype(np.float64) - wc) <= 1e-5 * tol)
    else:
        np.testing.assert_array_equal(gc, wc)


@pytest.mark.parametrize("name,direction,dtype", GRID)
@pytest.mark.parametrize("wire", ["standard", "compact"])
def test_plain_matches_jax_stack_programs(name, direction, dtype, wire):
    """8 windows of eb=128 (the last ragged) at vb=512: the plain
    version's rows equal the JAX engine's device rows window for
    window."""
    eb, vb, wb = 128, 512, 8
    n = wb * eb - 37
    src, dst, val = _stream(n, vb, dtype, seed=len(name) + len(direction))
    want = _jax_rows(src, dst, val, vb, eb, name, direction, wire, "full")
    t = _chunk_tensors(src, dst, val, vb, eb, direction, wire, wb)
    cells, counts = _call(wire, t, wb, eb, vb + 1, name, direction)
    tol = _abs_rows(src, dst, val, vb, eb, direction)
    assert len(want) == wb
    for w in range(wb):
        _same((cells[w].numpy(), counts[w].numpy()), want[w], name, dtype,
              tol[w])


@pytest.mark.parametrize("name,direction,dtype", GRID)
def test_delta_wire_matches_jax_and_full_rows(name, direction, dtype):
    """The delta wire equals the JAX package's compact_touched encode of
    the same rows (bit for bit, padding slots included), and decodes to
    the full rows; the JAX engine's delta egress gives the same rows."""
    eb, vb, wb = 64, 256, 4
    src, dst, val = _stream(wb * eb - 5, vb, dtype, seed=3)
    for wire in ("standard", "compact"):
        t = _chunk_tensors(src, dst, val, vb, eb, direction, wire, wb)
        cap = min(eb * (2 if direction == "all" else 1), vb + 1)
        cells, counts = _call(wire, t, wb, eb, vb + 1, name, direction)
        cnt, idx, dc, dn = _call(wire, t, wb, eb, vb + 1, name, direction,
                                 "delta", cap)
        for w in range(wb):
            jc = j_delta.compact_touched(jnp.asarray(cells[w].numpy()),
                                         jnp.asarray(counts[w].numpy()),
                                         cap)
            for a, b in zip((cnt[w], idx[w], dc[w], dn[w]), jc):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            k = int(cnt[w])
            row = np.full(vb + 1, pw._device_cell_fill(name, dc.numpy()
                                                       .dtype))
            row = row.astype(dc.numpy().dtype)
            row[idx[w, :k].numpy()] = dc[w, :k].numpy()
            np.testing.assert_array_equal(row, cells[w].numpy())
    want = _jax_rows(src, dst, val, vb, eb, name, direction, "standard",
                     "delta")
    tol = _abs_rows(src, dst, val, vb, eb, direction)
    for w in range(wb):
        _same((cells[w].numpy(), counts[w].numpy()), want[w], name, dtype,
              tol[w])


def _edge_stack(case, eb, vb):
    """The chip phase's edge cases, as (src, dst, val) of one stream of
    whole windows."""
    rng = np.random.default_rng(5)
    if case == "empty_then_one":
        # window 0: one edge; window 1: nothing valid (a ragged stream
        # of eb + 0 edges is one window, so the empty one is built as
        # padding of the chunk)
        return (np.array([3]), np.array([vb - 1]), np.array([7]))
    if case == "ids_0_and_top":
        src = np.where(np.arange(eb) % 2 == 0, 0, vb - 1)
        return src, src[::-1].copy(), rng.integers(-5, 5, eb)
    if case == "hub":
        src = np.full(2 * eb, 17)
        return src, rng.integers(0, vb, 2 * eb), rng.integers(-9, 9, 2 * eb)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty_then_one", "ids_0_and_top", "hub"])
@pytest.mark.parametrize("name,direction", [("sum", "all"), ("min", "out"),
                                            ("max", "in")])
@pytest.mark.parametrize("wire", ["standard", "compact"])
def test_edge_cases(case, name, direction, wire):
    eb, vb = 64, 256
    src, dst, val = _edge_stack(case, eb, vb)
    num_w = -(-len(src) // eb)
    wb = num_w + 1          # an empty window past the stream
    kval = port_seg.x64_off_values(val)
    pad = wb * eb - len(src)
    s = np.concatenate([src, np.zeros(pad, np.int64)])
    d = np.concatenate([dst, np.zeros(pad, np.int64)])
    if wire == "compact":
        nv = np.zeros(wb, np.int32)
        nv[:num_w] = eb
        nv[num_w - 1] = len(src) - (num_w - 1) * eb
        t = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (
            s.astype(np.uint16).reshape(wb, eb),
            d.astype(np.uint16).reshape(wb, eb), nv,
            np.concatenate([kval, np.zeros(pad, kval.dtype)])
            .reshape(wb, eb)))
    else:
        eng = pw.WindowedEdgeReduce(vb, eb, name, direction, device="cpu")
        t = tuple(torch.from_numpy(x) for x in eng._standard_chunk(
            src, dst, kval, 0, wb))
    cells, counts = _call(wire, t, wb, eb, vb + 1, name, direction)
    want = pw.WindowedEdgeReduce(vb, eb, name, direction,
                                 tier="host").process_stream(src, dst, kval)
    for w in range(num_w):
        np.testing.assert_array_equal(counts[w].numpy(), want[w][1])
        m = want[w][1] > 0
        np.testing.assert_array_equal(cells[w].numpy()[m], want[w][0][m])
    assert not counts[num_w].any()
    fill = cr.cell_fill(name, torch.int32)
    assert (cells[num_w] == fill).all()


def test_fill_values():
    assert cr.cell_fill("sum", torch.float32) == 0
    assert cr.cell_fill("min", torch.float32) == float("inf")
    assert cr.cell_fill("max", torch.float32) == float("-inf")
    assert cr.cell_fill("min", torch.int32) == 2 ** 31 - 1
    assert cr.cell_fill("max", torch.int32) == -2 ** 31
    for name in ("sum", "min", "max"):
        for dt, tdt in ((np.int32, torch.int32), (np.float32, torch.float32)):
            assert pw._device_cell_fill(name, dt) == cr.cell_fill(name, tdt)
            assert jw._device_cell_fill(name, dt) == cr.cell_fill(name, tdt)


def test_int_sum_wraps_like_xla():
    """int32 sums wrap modulo 2^32, as the JAX package's segment_sum."""
    eb, vb = 8, 8
    src = np.zeros(8, np.int64)
    val = np.full(8, 2 ** 30, np.int64)
    want = _jax_rows(src, src, val, vb, eb, "sum", "out", "standard",
                     "full")
    eng = pw.WindowedEdgeReduce(vb, eb, "sum", "out", device="cpu")
    got = eng.process_stream(src, src, val)
    np.testing.assert_array_equal(got[0][0], want[0][0])
    assert int(got[0][0][0]) == 0


def test_wrappers_refuse_bad_input():
    ids = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError):
        cr.cell_reduce(ids, torch.zeros(16, dtype=torch.int64), 2, 8, 9,
                       "sum")
    with pytest.raises(ValueError):
        cr.cell_reduce(ids, torch.zeros(16, dtype=torch.int32), 2, 8, 9,
                       "mean")
    with pytest.raises(ValueError):
        cr.cell_reduce(ids.long(), torch.zeros(16, dtype=torch.int32), 2,
                       8, 9, "sum")
    with pytest.raises(ValueError):
        cr.cell_reduce(ids, torch.zeros(16, dtype=torch.int32), 2, 8, 9,
                       "sum", "delta", 0)
    s16 = torch.zeros(2, 8, dtype=torch.uint16)
    with pytest.raises(ValueError):
        cr.cell_reduce_compact(s16, s16, torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, 8, dtype=torch.int32), 9,
                               "sum", "sideways")
    with pytest.raises(ValueError):
        cr.cell_reduce_compact(s16, s16, torch.zeros(3, dtype=torch.int32),
                               torch.zeros(2, 8, dtype=torch.int32), 9,
                               "sum", "out")
