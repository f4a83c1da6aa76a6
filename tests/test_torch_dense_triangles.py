"""The port's dense window triangle count (gelly_streaming_tpu_torch/ops/
dense_triangles.py) and the `triangle_count` dispatcher (ops/
triangles.py) on device="cpu", held against the JAX package: the
interpret-mode `pallas_triangles._six_t_partials` (partial for partial),
`_adjacency_six_t`, `triangle_count_dense` (XLA),
`triangle_count_dense_pallas`, `triangle_count`, and the brute force of
tests/library/test_triangles.py.

Partials are integers below 2^19 in float32 and counts integers:
equality, no tolerance.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_triangles as jax_pt
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch import triangle_count, triangle_count_dense
from gelly_streaming_tpu_torch.ops import dense_triangles as dt
from gelly_streaming_tpu_torch.ops import host_triangles
from gelly_streaming_tpu_torch.ops import triangles as port_tri


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _brute_force(src, dst, n):
    adj = [set() for _ in range(n)]
    for u, v in zip(src, dst):
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    count = 0
    for a, b, c in itertools.combinations(range(n), 3):
        if b in adj[a] and c in adj[a] and c in adj[b]:
            count += 1
    return count


def _edges(seed, n, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


@pytest.mark.parametrize("vp,seed", [(256, 0), (384, 1)])
def test_partials_match_interpret_kernel(vp, seed):
    """six_t_partials_plain against the interpret `_six_t_partials` on
    one adjacency (clustered edges, so tiles off the diagonal count
    too), partial for partial."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vp, 6 * vp)
    dst = (src + rng.integers(-40, 41, 6 * vp)) % vp
    a = dt.adjacency(torch.from_numpy(src), torch.from_numpy(dst), vp)
    assert a.shape == (vp, vp) and torch.equal(a, a.T)
    got = dt.six_t_partials(a)
    want = np.asarray(jax_pt._six_t_partials(jnp.asarray(a.numpy()),
                                             interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).sum() > vp


@pytest.mark.parametrize("v,case", [(200, "random"), (128, "padding"),
                                    (1000, "random")])
def test_adjacency_matches_jax(v, case):
    """adjacency + partials against `_adjacency_six_t` (the JAX build,
    interpret kernel): a side that is not a tile multiple, duplicates,
    self-loops, ids at and past v (dropped)."""
    src, dst = _edges(v, v + 20, 4 * v)
    if case == "padding":
        src[::3] = v
        dst[1::5] = src[1::5]
    got = dt.six_t_partials(dt.adjacency(torch.from_numpy(src),
                                         torch.from_numpy(dst), v))
    want = np.asarray(jax_pt._adjacency_six_t(
        jnp.asarray(src.astype(np.int32)), jnp.asarray(dst.astype(np.int32)),
        v, True))
    np.testing.assert_array_equal(got.numpy(), want)


def _fixtures():
    yield "random", _edges(0, 30, 120), 30
    yield "random2", _edges(3, 60, 500), 60
    u, w = np.triu_indices(12, k=1)
    yield "clique", (u + 3, w + 3), 20
    yield "empty", (np.zeros(0, np.int64), np.zeros(0, np.int64)), 16
    yield "loops", (np.arange(10), np.arange(10)), 10
    s, d = np.array([0, 1, 2, 1, 2, 0]), np.array([1, 2, 0, 0, 1, 2])
    yield "duplicates", (np.tile(s, 5), np.tile(d, 5)), 3


@pytest.mark.parametrize("name", [f[0] for f in _fixtures()])
def test_counts_match_jax(name):
    (src, dst), n = next((e, n) for f, e, n in _fixtures() if f == name)
    want = _brute_force(src, dst, n)
    got = triangle_count_dense(src, dst, n, device="cpu")
    assert got == want
    assert triangle_count(src, dst, n, device="cpu") == want
    if len(src):
        assert jax_tri.triangle_count_dense(src, dst, n) == want
        assert jax_pt.triangle_count_dense_pallas(src, dst, n) == want
        assert jax_tri.triangle_count(src, dst, n) == want
    if name == "clique":
        assert want == 220


def test_dispatch_switch_at_4096(monkeypatch):
    """triangle_count takes the dense route up to 2·DENSE_LIMIT = 4096
    vertices and the sparse one past it; both equal the JAX count and
    the numpy oracle, with triangles among the highest ids."""
    assert port_tri.DENSE_LIMIT == jax_tri.DENSE_LIMIT == 2048
    src, dst = _edges(5, 80, 400)
    src[:6], dst[:6] = (4095, 4095, 4095, 4094, 4093, 4093), \
        (4094, 4093, 17, 4093, 17, 70)
    routes = []
    dense, sparse = port_tri.triangle_count_dense, \
        port_tri.triangle_count_sparse
    monkeypatch.setattr(port_tri, "triangle_count_dense",
                        lambda *a: routes.append("dense") or dense(*a))
    monkeypatch.setattr(port_tri, "triangle_count_sparse",
                        lambda *a: routes.append("sparse") or sparse(*a))
    want = host_triangles.window_count(src, dst)
    assert want == jax_tri.triangle_count(src, dst, 4097)
    assert port_tri.triangle_count(src, dst, 4096, device="cpu") == want
    assert port_tri.triangle_count(src, dst, 4097, device="cpu") == want
    assert routes == ["dense", "sparse"]


def test_wrapper_checks(monkeypatch):
    with pytest.raises(ValueError, match="CUDA tensor"):
        dt.six_t_partials(torch.zeros(128, 128, device="meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        triangle_count(np.array([0]), np.array([1]), 8)
    with pytest.raises(RuntimeError):
        triangle_count_dense(np.array([0]), np.array([1]), 8)


@pytest.mark.parametrize("v,seed", [(100, 0), (300, 1), (1000, 2)])
def test_adjacency_int8_is_float32_cast(v, seed):
    """adjacency(..., dtype=torch.int8), the matrix the kernel reads, is
    the float32 one cast: duplicates, self-loops and ids at and past v
    included."""
    src, dst = _edges(seed, v + 10, 5 * v)
    src[::7] = dst[::7]
    args = (torch.from_numpy(src), torch.from_numpy(dst), v)
    a8 = dt.adjacency(*args, dtype=torch.int8)
    a32 = dt.adjacency(*args)
    assert a8.dtype == torch.int8 and a32.dtype == torch.float32
    assert torch.equal(a8, a32.to(torch.int8))
    assert torch.equal(a8.to(torch.float32), a32)
    assert int(a8.sum()) > v


@pytest.mark.parametrize("vp,seed", [(128, 3), (256, 4), (384, 5)])
def test_partials_int8_equal_float32_and_interpret(vp, seed):
    """six_t_partials_plain on the int8 adjacency equals it on the
    float32 one and the interpret `_six_t_partials`, partial for
    partial; six_t_partials on a CPU int8 matrix is the plain version."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vp, 6 * vp)
    dst = (src + rng.integers(-40, 41, 6 * vp)) % vp
    args = (torch.from_numpy(src), torch.from_numpy(dst), vp)
    a8 = dt.adjacency(*args, dtype=torch.int8)
    a32 = dt.adjacency(*args)
    got8 = dt.six_t_partials_plain(a8)
    assert got8.dtype == torch.float32 and got8.shape == (vp // 128, vp)
    assert torch.equal(got8, dt.six_t_partials_plain(a32))
    assert torch.equal(dt.six_t_partials(a8), got8)
    want = np.asarray(jax_pt._six_t_partials(jnp.asarray(a32.numpy()),
                                             interpret=True))
    np.testing.assert_array_equal(got8.numpy(), want)
    assert (want > 0).sum() > vp // 2


def test_kernel_wrapper_takes_int8_only():
    """The kernel's wrapper refuses what is not a CUDA tensor, int8 as
    well as float32, and the plain version refuses other types."""
    for dtype in (torch.int8, torch.float32):
        with pytest.raises(ValueError, match="CUDA tensor"):
            dt.six_t_partials(torch.zeros(128, 128, dtype=dtype,
                                          device="meta"))
    with pytest.raises(ValueError, match="int8 or float32"):
        dt.six_t_partials_plain(torch.zeros(128, 128, dtype=torch.float64))


@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_wrapper_refuses_asymmetric_matrix(dtype):
    """six_t_partials requires a symmetric 0/1 matrix (the kernel reads
    A's rows as the right operand's columns) and refuses any other;
    six_t_partials_plain, like the TPU kernel, takes it and equals the
    interpret `_six_t_partials`."""
    rng = np.random.default_rng(7)
    a = torch.from_numpy((rng.random((256, 256)) < 0.1).astype(np.int8))
    a = a.to(dtype)
    assert not torch.equal(a, a.T)
    with pytest.raises(ValueError, match="symmetric"):
        dt.six_t_partials(a)
    want = np.asarray(jax_pt._six_t_partials(
        jnp.asarray(a.to(torch.float32).numpy()), interpret=True))
    np.testing.assert_array_equal(dt.six_t_partials_plain(a).numpy(), want)
    sym = ((a + a.T) > 0).to(dtype)
    np.testing.assert_array_equal(dt.six_t_partials(sym).numpy(),
                                  dt.six_t_partials_plain(sym).numpy())
