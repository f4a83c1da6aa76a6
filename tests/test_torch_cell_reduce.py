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
from gelly_streaming_tpu_torch.utils import tier_fixtures as tf

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


# ---- the redesigned kernel's plan and its risky inputs ---------------

# the room an H100 leaves a block of the kernel (232,448 bytes less an
# assumed static part of 512 and the 64 spare): the card reports its own,
# which chip_smoke.py feeds the mirror
H100_ROOM = cr.SMEM_OPTIN - 512 - 64
MAX_SPAN = ((H100_ROOM - cr.MIN_STAGES * cr.STAGE_BYTES - 64) // 8) & ~31

# (kind, wb, eb, vb, cluster, span): the plan a fixture places its
# edges by; the plain version does not depend on it
CELL_CASES = [
    ("boundaries", 3, 64, 4 * 126 - 1, 4, 126),
    ("boundaries", 2, 64, MAX_SPAN * 2 - 2, 2, MAX_SPAN),
    ("uniform", 2, 64, MAX_SPAN * 2 - 1, 2, MAX_SPAN),
    ("uniform", 2, 64, MAX_SPAN * 2, 4, MAX_SPAN // 2 + 1),
    ("one_block", 3, 64, 1000, 4, 251),
    ("ragged", 4, 61, 300, 1, None),
    ("nvalid", 6, 64, 300, 1, None),
    ("uniform", 40, 32, 200, 1, None),
    ("uniform", 2, 64, 1 << 18, 8, MAX_SPAN),
    ("hub", 3, 64, 300, 1, None),
    ("zipf", 4, 128, 1000, 2, 501),
]
COMBOS = (("sum", "all", "float32"), ("min", "out", "int32"),
          ("max", "in", "float32"))


def _case_id(case):
    kind, wb, eb, vb = case[:4]
    return "%s-%dx%d-vb%d" % (kind, wb, eb, vb)


@pytest.mark.parametrize("case,wire", [
    (c, w) for c in CELL_CASES for w in ("standard", "compact")
    if w == "standard" or c[3] < 65536],
    ids=lambda x: x if isinstance(x, str) else _case_id(x))
def test_fixture_against_jax_stack_programs(case, wire):
    """Each cell-reduce fixture on both egress forms: the port's wrappers
    (the plain version on the CPU) against the JAX engine's `_stack_fn`
    / `_stack_fn_compact` and its delta tail on the same stack; counts,
    indices, integer cells and float min/max equal, float sums within
    1e-5 · Σ|v| a cell."""
    kind, wb, eb, vb, cluster, span = case
    vbp = vb + 1
    for k, (name, direction, dtype) in enumerate(COMBOS):
        src, dst, nvalid = tf.cell_stack(kind, wb, eb, vb, 11 + k, cluster,
                                         span)
        val = tf.cell_values(dtype, wb, eb, 17 + k)
        wires = tf.cell_wires(src, dst, nvalid, val, vb, direction)
        eng = jw.WindowedEdgeReduce(vb, eb, name, direction)
        eng.vb, eng.eb = vb, eb   # the stack's own widths, not buckets
        cap = eng._delta_cap()
        ids, vals = wires["standard"]
        tol = cr.cell_reduce_plain(torch.from_numpy(ids),
                                   torch.from_numpy(np.abs(vals)), wb, eb,
                                   vbp, "sum")[0].numpy()
        if wire == "standard":
            args = wires["standard"]
            jfull, jdelta = (eng._stack_fn(wb, d)(*args) for d in (0, 1))
            t = tuple(torch.from_numpy(a) for a in args)
        else:
            args = wires["compact"]
            jfull, jdelta = (eng._stack_fn_compact(wb, d)(*args)
                             for d in (0, 1))
            t = tuple(torch.from_numpy(np.ascontiguousarray(a))
                      for a in args)
        cells, counts = _call(wire, t, wb, eb, vbp, name, direction)
        _same((cells.numpy(), counts.numpy()),
              tuple(np.asarray(x) for x in jfull), name, dtype, tol)
        cnt, idx, dc, dn = _call(wire, t, wb, eb, vbp, name, direction,
                                 "delta", cap)
        jc, ji, jdc, jdn = (np.asarray(x) for x in jdelta)
        for a, b in ((cnt, jc), (idx, ji), (dn, jdn)):
            np.testing.assert_array_equal(a.numpy(), b)
        _same((dc.numpy(), dn.numpy()), (jdc, jdn), name, dtype,
              np.take_along_axis(tol, ji.astype(np.int64), 1))


# a window the ring streams (the north-star chunk's, 32768 slots "all")
# and one read straight from device memory (the reduce stream's)
RING_WINDOW, DIRECT_WINDOW = 32768 * 16, 8192 * 8


@pytest.mark.parametrize("window_bytes", [RING_WINDOW, DIRECT_WINDOW])
@pytest.mark.parametrize("wb,vbp", [
    (64, 16385), (64, 65537), (2, 262145), (1, 9), (1, 1025), (8, 16385),
    (300, 4097), (64, 8193), (3, MAX_SPAN * 2 - 1), (3, MAX_SPAN * 2),
    (3, MAX_SPAN * 2 + 1), (1, MAX_SPAN * 8 + 1), (200, 65537)])
def test_plan_mirror_invariants(wb, vbp, window_bytes):
    """The Python mirror of csrc/cell_reduce.cu `plan`: every vertex
    owned by one (pass, block) range; ring plus row within the room (and
    so within 232,448 bytes); a ring of 2-4 stages for a window of
    RING_MIN_BYTES or more, none below; each wire's tile a multiple of
    8 slots, every array of it a 16-byte multiple inside one stage;
    C = 1-8 blocks, more passes only at 8."""
    for room in (H100_ROOM, H100_ROOM - 4096):
        p = cr.plan_mirror(wb, vbp, 132, room, window_bytes)
        owners = np.zeros(vbp, np.int64)
        for lo, hi in tf.block_ranges(vbp, p["cluster"], p["span"],
                                      p["passes"]):
            owners[lo:hi] += 1
        assert (owners == 1).all()
        assert p["smem"] == cr.plan_smem(p["span"], p["stages"])
        assert p["smem"] <= room < cr.SMEM_OPTIN
        assert p["cluster"] in (1, 2, 4, 8)
        if window_bytes >= cr.RING_MIN_BYTES:
            assert cr.MIN_STAGES <= p["stages"] <= cr.MAX_STAGES
        else:
            assert p["stages"] == 0
        assert p["passes"] == 1 or p["cluster"] == cr.MAX_CLUSTER
        for wire in ("standard", "compact"):
            for direction in ("out", "all"):
                per = cr.slot_bytes(wire, direction)
                tile = cr.tile_slots(per)
                assert tile % cr.SLOT_ALIGN == 0
                assert tile * per <= cr.STAGE_BYTES
                sizes = ([4] * (per // 4) if wire == "standard"
                         else [2] * (per // 2 - 2) + [4])
                assert sum(sizes) == per
                assert all(tile * e % 16 == 0 for e in sizes)


def test_plan_mirror_capacity():
    """At C blocks' capacity beside the ring the row fills them in one
    pass; one vertex more takes twice the blocks (or, at 8, a second
    pass); a window read straight from memory has the ring's room for
    its row."""
    for c in (1, 2, 4):
        below, full, above = tf.capacity_vbps(MAX_SPAN, c)
        for vbp in (below, full):
            p = cr.plan_mirror(132, vbp, 132, H100_ROOM, RING_WINDOW)
            assert (p["cluster"], p["passes"]) == (c, 1)
        p = cr.plan_mirror(132, above, 132, H100_ROOM, RING_WINDOW)
        assert (p["cluster"], p["passes"]) == (2 * c, 1)
        assert cr.plan_mirror(132, above, 132, H100_ROOM,
                              DIRECT_WINDOW)["cluster"] == c
    p = cr.plan_mirror(1, 8 * MAX_SPAN + 1, 132, H100_ROOM, RING_WINDOW)
    assert (p["cluster"], p["passes"], p["stages"]) == (8, 2, 2)
