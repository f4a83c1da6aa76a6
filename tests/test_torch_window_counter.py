"""The port's window counter (gelly_streaming_tpu_torch/ops/
window_counter.py) held against the JAX package's
`triangles.build_window_counter` with the Pallas gate unset (the XLA
body) and with GS_PALLAS_WINDOW=on (the `_counter_call` kernel in
interpret mode, as tests/operations/test_pallas_window.py runs it).

On the CPU the port's wrapper runs the plain PyTorch version, which
keeps the JAX sort's row order, so `count` matches even where a window
overflows K; `overflow` must match exactly everywhere. K is pinned on
both sides. Counts are integers: equality, no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch.ops import segment as seg
from gelly_streaming_tpu_torch.ops import window_counter as wc
from gelly_streaming_tpu_torch.utils.streams import make_stream


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_counter(request, monkeypatch):
    """build(vb, kb) -> the JAX package's jitted one-window counter."""
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    if request.param == "xla":
        monkeypatch.delenv("GS_PALLAS_WINDOW", raising=False)
    else:
        monkeypatch.setenv("GS_PALLAS_WINDOW", "on")
    pw._reset_pallas_window()

    def build(vb, kb):
        fn = jax_tri.build_window_counter(vb, kb)
        assert bool(getattr(fn, "pallas_window", False)) == (
            request.param == "pallas_interpret")
        return jax.jit(fn)

    yield build
    pw._reset_pallas_window()


def _jax_counts(fn, s, d, v):
    out = [fn(jnp.asarray(s[w]), jnp.asarray(d[w]), jnp.asarray(v[w]))
           for w in range(s.shape[0])]
    return (np.array([int(c) for c, _ in out], np.int32),
            np.array([int(o) for _, o in out], np.int32))


def _port_counts(s, d, v, vb, kb):
    c, o = wc.count_windows_device(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (s, d, v)),
        vb, kb)
    assert c.dtype == o.dtype == torch.int32
    return c.numpy(), o.numpy()


@pytest.mark.parametrize("eb,vb,kb,seed,dense", [(512, 1024, 8, 1, False),
                                                 (512, 1024, 32, 2, False),
                                                 (256, 256, 16, 3, False),
                                                 (512, 64, 8, 4, True)])
def test_zipf_windows_match_jax(jax_counter, eb, vb, kb, seed, dense):
    """Zipf windows (bench.make_stream), and dense uniform windows on 40
    vertices whose oriented out-degrees outrun kb=8."""
    n = 3 * eb - 37
    if dense:
        rng = np.random.default_rng(seed)
        src, dst = rng.integers(0, 40, n), rng.integers(0, 40, n)
    else:
        src, dst = make_stream(n, vb, seed=seed)
    _w, s, d, v = seg.window_stack(src, dst, eb, sentinel=vb)
    jc, jo = _jax_counts(jax_counter(vb, kb), s, d, v)
    pc, po = _port_counts(s, d, v, vb, kb)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pc, jc)
    assert jc.sum() > 0
    if dense:
        assert (jo > 0).all(), "fixture meant to overflow K did not"


def test_k14_clique_overflow_window_matches_jax(jax_counter):
    """The K14-clique window of test_pallas_window.py:130-138 at kb=8:
    equal degrees give vertex 0 an oriented out-degree of 13 > 8."""
    ks, kd = np.triu_indices(14, k=1)
    rng = np.random.default_rng(5)
    extra_s = rng.integers(0, 128, 200).astype(np.int32)
    extra_d = rng.integers(0, 128, 200).astype(np.int32)
    src = np.concatenate([ks.astype(np.int32), extra_s])
    dst = np.concatenate([kd.astype(np.int32), extra_d])
    _w, s, d, v = seg.window_stack(src, dst, 128, sentinel=128)
    jc, jo = _jax_counts(jax_counter(128, 8), s, d, v)
    pc, po = _port_counts(s, d, v, 128, 8)
    assert jo[0] > 0
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pc, jc)


def test_padding_loops_and_duplicates_match_jax(jax_counter):
    """Windows of padding only, self-loops only, one edge repeated both
    ways, and a dense small window with loops and repeats."""
    eb, vb = 64, 32
    s = np.full((4, eb), vb, np.int32)
    d = np.full((4, eb), vb, np.int32)
    v = np.zeros((4, eb), bool)
    s[1], d[1], v[1] = 5, 5, True
    s[2, ::2], d[2, ::2], s[2, 1::2], d[2, 1::2] = 3, 9, 9, 3
    v[2] = True
    rng = np.random.default_rng(9)
    s[3], d[3], v[3] = rng.integers(0, 12, eb), rng.integers(0, 12, eb), True
    jc, jo = _jax_counts(jax_counter(vb, 8), s, d, v)
    pc, po = _port_counts(s, d, v, vb, 8)
    np.testing.assert_array_equal(po, jo)
    np.testing.assert_array_equal(pc, jc)
    assert list(pc[:3]) == [0, 0, 0] and pc[3] > 0


@pytest.mark.parametrize("seed", range(3))
def test_orient_and_dedupe_match_jax(seed):
    """The two pipeline stages alone: the same orientation, the same
    sorted pairs and first-occurrence marks, and the same column of
    every valid edge."""
    rng = np.random.default_rng(seed)
    vb, n = 50, 400
    s = rng.integers(0, vb + 1, n).astype(np.int32)   # vb = padding
    d = rng.integers(0, vb + 1, n).astype(np.int32)
    s = np.where(d == vb, vb, s)
    d = np.where(s == vb, vb, d)
    deg = np.bincount(np.concatenate([s, d]), minlength=vb + 1)
    deg[vb] = 0
    deg = deg.astype(np.int32)
    ja, jb = jax_tri.orient_by_degree(jnp.asarray(s), jnp.asarray(d),
                                      jnp.asarray(deg), vb)
    pa, pb = wc.orient_by_degree(torch.from_numpy(s), torch.from_numpy(d),
                                 torch.from_numpy(deg))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    jout = jax_tri.dedupe_and_positions(ja, jb, vb, vb)
    pout = wc.dedupe_and_positions(pa, pb, vb, vb)
    ja2, jb2, jev, jpos = (np.asarray(x) for x in jout)
    pa2, pb2, pev, ppos = (x.numpy() for x in pout)
    np.testing.assert_array_equal(pa2, ja2)
    np.testing.assert_array_equal(pb2, jb2)
    np.testing.assert_array_equal(pev, jev)
    np.testing.assert_array_equal(ppos[pev], jpos[jev])


def test_counter_object_runs_on_its_device():
    counter = wc.WindowCounter(64, 8, torch.device("cpu"))
    src, dst = make_stream(2 * 64, 64, seed=4)
    _w, s, d, v = seg.window_stack(src, dst, 64, sentinel=64)
    t = [torch.from_numpy(x) for x in (s, d, v)]
    c, o = counter(*t)
    pc, po = wc.count_windows_plain(*t, 64, 8)
    assert torch.equal(c, pc) and torch.equal(o, po)
    assert c.shape == (2,)
    empty = wc.count_windows_plain(t[0][:0], t[1][:0], t[2][:0], 64, 8)
    assert [x.shape for x in empty] == [(0,), (0,)]
