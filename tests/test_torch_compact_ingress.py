"""The port's compact wire (gelly_streaming_tpu_torch/ops/compact_ingress.py)
on device="cpu": its numpy helpers against the JAX package's
`ops/compact_ingress.py`, `widen_stack` against the JAX decode, the
counter and summary wrappers on both wires, and the two stream paths
pinned to the compact wire (`TriangleWindowKernel.count_stream` /
`count_windows`, `StreamSummaryEngine.process`) against the JAX package
pinned to compact (K pinned, GS_AUTOTUNE=0, the XLA bodies, the device
tier of the triangle stream) and against the port's own standard wire.

Every output is an integer or a bool: equality, no tolerance, the
`state_dict` carries bit for bit. Inputs come from numpy seeds and are
copied before they reach both packages.
"""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import compact_ingress as jax_ci
from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch import StreamSummaryEngine, TriangleWindowKernel
from gelly_streaming_tpu_torch.ops import compact_ingress as ci
from gelly_streaming_tpu_torch.ops import host_triangles
from gelly_streaming_tpu_torch.ops import segment as seg
from gelly_streaming_tpu_torch.ops import window_counter as wc
from gelly_streaming_tpu_torch.ops import window_summary as ws
from gelly_streaming_tpu_torch.ops.staging import ChunkStager


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    """The JAX side's evidence-driven choices pinned: no autotuner, the
    XLA summary body, the device tier of the triangle stream. The port's
    plain versions run on one thread: at vb=65536 their many small ops
    gain nothing from more, and lose much when test workers share the
    cores."""
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    monkeypatch.delenv("GS_PALLAS_WINDOW", raising=False)
    pw._reset_pallas_window()
    monkeypatch.setattr(jax_tri, "_STREAM_IMPL", "device")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pw._reset_pallas_window()


def _stream(n, v, seed, lo=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(lo, v, n).astype(np.int32)
    dst = rng.integers(lo, v, n).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def _top_stream():
    """test_compact_parity_at_vb_65536_boundary's stream: ids clustered at
    the top of the uint16 range, and a triangle on 65533-65535."""
    rng = np.random.default_rng(44)
    src = np.concatenate([rng.integers(65000, 65536, 200),
                          [65535, 65534, 65533]]).astype(np.int32)
    dst = np.concatenate([rng.integers(65000, 65536, 200),
                          [65534, 65533, 65535]]).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


# ----------------------------------------------------------------------
# the numpy helpers and the decode
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,eb", [(0, 64), (1, 64), (64, 64), (100, 64),
                                  (4096, 512)])
def test_window_stack_matches_jax(n, eb):
    src, dst = _stream(n, 256, seed=n)
    _equal(ci.window_stack(src.copy(), dst.copy(), eb),
           jax_ci.window_stack(src.copy(), dst.copy(), eb))


def test_stack_window_list_and_pad_chunk_match_jax():
    rng = np.random.default_rng(3)
    wins = [(rng.integers(0, 65536, k).astype(np.int32),
             rng.integers(0, 65536, k).astype(np.int32))
            for k in (0, 1, 17, 64, 40)]
    got = ci.stack_window_list(wins, 64)
    _equal(got, jax_ci.stack_window_list(wins, 64))
    with pytest.raises(ValueError, match="exceeds edge bucket"):
        ci.stack_window_list(wins + [(np.zeros(65), np.zeros(65))], 64)
    for at, hi, max_w in [(0, 4, 4), (4, 5, 4), (0, 5, 8), (1, 4, 8)]:
        _equal(ci.pad_chunk(*got, at, hi, max_w, 64),
               jax_ci.pad_chunk(*got, at, hi, max_w, 64))


@pytest.mark.parametrize("vb", [4, 65536, 65537, 1 << 20])
def test_supports_and_validate_ids_match_jax(vb):
    assert ci.supports(vb) == jax_ci.supports(vb)
    assert ci.MAX_U16_VB == jax_ci.MAX_U16_VB
    for src, dst in ((np.array([0, vb - 1]), np.array([1, 2])),
                     (np.array([-1, 3]), np.array([1, 2])),
                     (np.array([0, 65536]), np.array([1, 2])),
                     (np.array([], np.int32), np.array([], np.int32))):
        errs = []
        for fn in (ci.validate_ids, jax_ci.validate_ids):
            try:
                fn(src, dst, vb, "test")
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("eb,vb", [(64, 256), (64, 65536)])
def test_widen_stack_matches_jax(eb, vb):
    """The plain decode equals the JAX decode and the standard wire of the
    same windows, id 65535 included."""
    src, dst = _stream(5 * eb - 21, min(vb, 65536), seed=eb)
    src[:3] = 65535 if vb == 65536 else vb - 1
    num_w, s16, d16, nv = ci.window_stack(src, dst, eb)
    got = ci.widen_stack(torch.from_numpy(s16), torch.from_numpy(d16),
                         torch.from_numpy(nv), eb, vb)
    want = jax_ci.widen_stack(s16.copy(), d16.copy(), nv.copy(), eb, vb)
    std = seg.window_stack(src, dst, eb, sentinel=vb)[1:]
    for g, w, s in zip(got, want, std):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert np.array_equal(g.numpy(), s)


def test_wrappers_take_both_wires_on_cpu():
    """WindowCounter and WindowSummary give the same outputs and carries
    on the compact wire as on the standard one; the CPU stager hands out
    zero-copy views of either wire."""
    eb, vb, kb = 128, 128, 8
    src, dst = _stream(6 * eb - 9, vb, seed=5)
    u, v = np.triu_indices(14, k=1)                 # K14 overflows kb=8
    src[eb:eb + len(u)], dst[eb:eb + len(v)] = u, v
    std = seg.window_stack(src, dst, eb, sentinel=vb)[1:]
    cmp_ = ci.window_stack(src, dst, eb)[1:]
    stager = ChunkStager(torch.device("cpu"), slots=4)
    staged = stager.put(cmp_, 7)
    tc = stager.take(staged)
    stager.done(staged)
    assert tc[0].dtype == torch.uint16 and tc[2].dtype == torch.int32
    assert np.shares_memory(tc[0].numpy(), cmp_[0])
    ts = stager(*std)
    counter = wc.WindowCounter(vb, kb, torch.device("cpu"))
    a = counter(*ts)
    b = counter(*tc, wire="compact")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1][1]) > 0
    summ = ws.WindowSummary(vb, kb, torch.device("cpu"))
    c1, c2 = ws.fresh_carry(vb, "cpu"), ws.fresh_carry(vb, "cpu")
    o1, o2 = summ(c1, *ts), summ(c2, *tc, wire="compact")
    assert all(torch.equal(x, y) for x, y in zip(o1, o2))
    assert all(torch.equal(x, y) for x, y in zip(c1, c2))
    assert int(c1[2][2 * vb + 1]) == vb             # the sentinel join
    with pytest.raises(ValueError, match="unknown wire"):
        counter(*ts, wire="narrow")


# ----------------------------------------------------------------------
# the triangle stream pinned to the compact wire
# ----------------------------------------------------------------------

def _tri_pair(eb, vb, kb=0):
    port = TriangleWindowKernel(eb, vb, k_bucket=kb, device="cpu",
                                ingress="compact")
    std = TriangleWindowKernel(eb, vb, k_bucket=kb, device="cpu")
    jax_k = jax_tri.TriangleWindowKernel(eb, vb, k_bucket=port.kb,
                                         ingress="compact")
    assert port.ingress == jax_k.ingress == "compact"
    return port, std, jax_k


def test_compact_stream_ragged_tail_matches_jax():
    """10 windows with a 96-edge ragged tail, in 4-window chunks on the
    port (three pipelined chunks, the last padded to 2)."""
    src, dst = _stream(2400, 128, seed=21)
    port, std, jax_k = _tri_pair(256, 128)
    port.MAX_STREAM_WINDOWS = 4
    want = jax_k._count_stream_device(src.copy(), dst.copy())
    assert port.count_stream(src, dst) == want
    assert std.count_stream(src, dst) == want
    assert want == host_triangles.count_stream(src, dst, 256)
    assert sum(want) > 0


def test_compact_stream_id_65535_at_vb_65536():
    """vb=65536, the last bucket the wire supports: id 65535 is real, so
    the triangle on 65533-65535 counts."""
    src, dst = _top_stream()
    port, std, jax_k = _tri_pair(64, 65536)
    want = jax_k._count_stream_device(src.copy(), dst.copy())
    assert port.count_stream(src, dst) == want
    assert std.count_stream(src, dst) == want
    assert want[-1] >= 1 and sum(want) > 0
    wins = [(np.array([65535, 65534, 65533]), np.array([65534, 65533,
                                                        65535]))]
    assert port.count_windows(wins) == [1]


def test_compact_count_windows_partial_windows():
    """count_windows on windows of every length, empty and partial ones
    among them, through 8-window chunks (a ragged chunk padded to 4)."""
    rng = np.random.default_rng(2)
    wins = []
    for _ in range(12):
        n = int(rng.integers(0, 33))
        wins.append((rng.integers(0, 12, n).astype(np.int32),
                     rng.integers(0, 12, n).astype(np.int32)))
    wins[3] = (wins[3][0][:0], wins[3][1][:0])
    port, std, jax_k = _tri_pair(32, 64)
    port.MAX_STREAM_WINDOWS = 8
    want = host_triangles.count_windows(wins)
    assert port.count_windows(wins) == want
    assert std.count_windows(wins) == want
    assert jax_k.count_windows([(s.copy(), d.copy()) for s, d in wins]) \
        == want


def test_compact_stream_k14_overflow_recounted():
    """The K14 clique at kb=8 overflows on the compact wire and is
    recounted exactly (364 triangles of the clique), equal to the JAX
    kernel's recount."""
    u, v = np.triu_indices(14, k=1)
    src, dst = _stream(3 * 128, 128, seed=5)
    src[128:128 + len(u)], dst[128:128 + len(v)] = u, v
    port, std, jax_k = _tri_pair(128, 128, kb=8)
    recounts = []
    count = port.count
    port.count = lambda s, d, min_k=0: (recounts.append(len(s))
                                        or count(s, d, min_k))
    got = port.count_stream(src, dst)
    assert recounts == [128]
    assert got == jax_k._count_stream_device(src.copy(), dst.copy())
    assert got == std.count_stream(src, dst)
    assert got[1] >= 364


def test_compact_pin_rejects_wide_vertex_bucket():
    with pytest.raises(ValueError, match="lossy"):
        TriangleWindowKernel(256, 1 << 17, device="cpu", ingress="compact")
    with pytest.raises(ValueError, match="unknown ingress"):
        TriangleWindowKernel(256, 256, device="cpu", ingress="narrow")


# ----------------------------------------------------------------------
# the summary engine pinned to the compact wire
# ----------------------------------------------------------------------

def _assert_state_equal(a, b):
    assert {k: v for k, v in a.items() if k != "carry"} == {
        k: v for k, v in b.items() if k != "carry"}
    for x, y in zip(a["carry"], b["carry"]):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chunk", [64, 2])
def test_compact_summary_engine_matches_jax(chunk):
    """A ragged last window and the K14 overflow window: summaries and
    state_dict equal to the JAX engine pinned compact (XLA body) and to
    the port's standard wire, in one chunk and in 2-window chunks."""
    eb, vb = 128, 256
    src, dst = _stream(7 * eb - 37, 200, seed=8)
    u, v = np.triu_indices(14, k=1)
    src[eb:eb + len(u)], dst[eb:eb + len(v)] = u, v
    port = StreamSummaryEngine(eb, vb, k_bucket=8, device="cpu",
                               ingress="compact")
    port.MAX_WINDOWS = chunk
    std = StreamSummaryEngine(eb, vb, k_bucket=8, device="cpu")
    jax_eng = jax_scan.StreamSummaryEngine(eb, vb, k_bucket=8,
                                           ingress="compact")
    assert jax_eng.ingress == "compact" and not jax_eng._pallas
    out = port.process(src, dst)
    assert out == jax_eng.process(src.copy(), dst.copy())
    assert out == std.process(src, dst)
    assert out[1]["triangles"] >= 364 and any(s["odd_cycle"] for s in out)
    _assert_state_equal(port.state_dict(), jax_eng.state_dict())
    _assert_state_equal(port.state_dict(), std.state_dict())
    assert port.state_dict()["carry"][2][2 * vb + 1] == vb


def test_compact_summary_engine_id_65535_and_resume():
    """vb=65536 with ids at the top of the range: equal to the JAX
    compact engine and the port's standard wire; a compact engine's
    state_dict resumes in a standard one; ids the uint16 cast would wrap
    are refused on the main thread."""
    src, dst = _top_stream()
    eb, vb = 128, 65536
    port = StreamSummaryEngine(eb, vb, device="cpu", ingress="compact")
    std = StreamSummaryEngine(eb, vb, device="cpu")
    jax_eng = jax_scan.StreamSummaryEngine(eb, vb, k_bucket=port.kb,
                                           ingress="compact")
    head = port.process(src[:eb], dst[:eb])
    state = port.state_dict()
    whole = std.process(src, dst)
    assert head + port.process(src[eb:], dst[eb:]) == whole
    assert whole == jax_eng.process(src.copy(), dst.copy())
    _assert_state_equal(port.state_dict(), jax_eng.state_dict())
    _assert_state_equal(port.state_dict(), std.state_dict())
    assert whole[-1]["triangles"] >= 1
    resumed = StreamSummaryEngine(eb, vb, device="cpu")
    resumed.load_state_dict(state)
    assert head + resumed.process(src[eb:], dst[eb:]) == whole
    _assert_state_equal(resumed.state_dict(), std.state_dict())
    for bad in ((np.array([0, 65536]), np.array([1, 2])),
                (np.array([-1, 3]), np.array([1, 2]))):
        with pytest.raises(ValueError, match="outside"):
            port.reset()
            port.process(*bad)
