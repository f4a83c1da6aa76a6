"""The port's main path, TriangleWindowKernel (gelly_streaming_tpu_torch/
ops/triangles.py) on device="cpu", held against the JAX package's
TriangleWindowKernel (GS_AUTOTUNE=0, K pinned on both sides), the
brute force of tests/library/test_triangles.py, and the port's numpy
oracle. Counts are integers: equality, no tolerance.
"""

import itertools

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch import TriangleWindowKernel
from gelly_streaming_tpu_torch.ops import host_triangles
from gelly_streaming_tpu_torch.ops import triangles as port_tri
from gelly_streaming_tpu_torch.utils.streams import make_stream

# reference: ExamplesTestData.java:22-29, as tests/library/test_triangles.py
GOLDEN = [(1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
          (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
          (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
          (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")


def _pair(eb, vb, kb=0):
    port = TriangleWindowKernel(eb, vb, k_bucket=kb, device="cpu")
    # the JAX kernel's default K reads committed tuning evidence: pin it
    # to the port's
    return port, jax_tri.TriangleWindowKernel(eb, vb, k_bucket=port.kb)


def _brute_force(src, dst, n):
    adj = [set() for _ in range(n)]
    for u, v in zip(src, dst):
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    return sum(1 for a, b, c in itertools.combinations(range(n), 3)
               if b in adj[a] and c in adj[a] and c in adj[b])


def _star_clique():
    src, dst = [0] * 99, list(range(1, 100))
    for u in range(1, 41):
        for v in range(u + 1, 41):
            src.append(u)
            dst.append(v)
    return np.array(src[:256]), np.array(dst[:256])


def test_golden_windows():
    """The 19-edge golden graph in 400 ms windows: (2,399) (3,799)
    (2,1199)."""
    e = np.array(GOLDEN)
    wins = [(e[e[:, 2] // 400 == w, 0], e[e[:, 2] // 400 == w, 1])
            for w in range(3)]
    port, jax_k = _pair(16, 16)
    assert port.count_windows(wins) == [2, 3, 2]
    assert jax_k.count_windows(wins) == [2, 3, 2]
    assert [port.count(s, d) for s, d in wins] == [2, 3, 2]


def test_overflow_fallback_count():
    """test_triangles.py:201-216: a hub past k_bucket=8 climbs the K
    ladder and still counts exactly."""
    port, jax_k = _pair(256, 128, kb=8)
    src, dst = _star_clique()
    want = _brute_force(src, dst, 128)
    assert port.count(src, dst) == jax_k.count(src, dst) == want
    assert port._escalation_ladder() == jax_k._escalation_ladder()
    assert (port.kb, port.kb_max) == (jax_k.kb, jax_k.kb_max)


def test_overflow_past_the_ladder_uses_sparse_count():
    """A window that overflows every rung ends in triangle_count_sparse:
    a 40-clique (a top out-degree of 39) with kb=8 and kb_max cut to 16,
    so both rungs of the ladder overflow."""
    port = TriangleWindowKernel(1024, 64, k_bucket=8, device="cpu")
    port.kb_max = 16            # ladder [8, 16]: both rungs overflow
    u, v = np.triu_indices(40, k=1)
    assert port._escalation_ladder() == [8, 16]
    assert port.count(u, v) == 40 * 39 * 38 // 6


def test_count_stream_overflow_window_recounted():
    """test_triangles.py:233-251: window 0 random (fits K), window 1 a
    40-clique (overflows kb=8), redone exactly."""
    port, jax_k = _pair(256, 128, kb=8)
    rng = np.random.default_rng(3)
    s0, d0 = rng.integers(0, 100, 256), rng.integers(0, 100, 256)
    u, v = np.triu_indices(40, k=1)
    s1, d1 = u[:256] + 1, v[:256] + 1
    src, dst = np.concatenate([s0, s1]), np.concatenate([d0, d1])
    want = [_brute_force(s0, d0, 128), _brute_force(s1, d1, 128)]
    assert port.count_stream(src, dst) == want
    assert jax_k._count_stream_device(src, dst) == want


def test_count_stream_ragged_tail_and_empty():
    """test_triangles.py:219-230: three full windows and a ragged one;
    the empty stream; oversize windows are refused."""
    port, jax_k = _pair(512, 256)
    rng = np.random.default_rng(11)
    e = 512 * 3 + 137
    src, dst = rng.integers(0, 200, e), rng.integers(0, 200, e)
    want = [port.count(src[s:s + 512], dst[s:s + 512])
            for s in range(0, e, 512)]
    assert want == [jax_k.count(src[s:s + 512], dst[s:s + 512])
                    for s in range(0, e, 512)]
    assert port.count_stream(src, dst) == want
    assert jax_k._count_stream_device(src, dst) == want
    empty = np.array([], np.int64)
    assert port.count_stream(empty, empty) == []
    assert port.count_windows([]) == []
    assert port.count(empty, empty) == 0
    with pytest.raises(ValueError):
        port.count(np.zeros(600, np.int64), np.ones(600, np.int64))
    with pytest.raises(ValueError):
        port.count_windows([(np.zeros(600, np.int64),
                             np.ones(600, np.int64))])


def test_count_windows_ragged_chunk():
    """70 windows of varying length: one full 64-window chunk and a
    ragged one padded to 8."""
    port, jax_k = _pair(32, 64)
    rng = np.random.default_rng(2)
    wins = []
    for w in range(70):
        n = int(rng.integers(0, 33))
        wins.append((rng.integers(0, 12, n), rng.integers(0, 12, n)))
    want = host_triangles.count_windows(wins)
    assert port.count_windows(wins) == want
    assert jax_k.count_windows(wins) == want


def test_make_stream_at_eb_8192():
    """The bench's stream (seed 7) at its 131K-scale window shape:
    eb=8192, vb=65536, K pinned to 128 on both sides."""
    src, dst = make_stream(32768, 65536, seed=7)
    port, jax_k = _pair(8192, 65536, kb=128)
    got = port.count_stream(src, dst)
    assert got == jax_k._count_stream_device(src, dst)
    assert got == host_triangles.count_stream(src, dst, 8192)
    assert len(got) == 4 and min(got) > 0


@pytest.mark.parametrize("seed", range(4))
def test_triangle_count_sparse_matches_jax(seed):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 30, 120), rng.integers(0, 30, 120)
    want = _brute_force(src, dst, 30)
    assert port_tri.triangle_count_sparse(src, dst, 30,
                                          device="cpu") == want
    assert jax_tri.triangle_count_sparse(src, dst, 30) == want


@pytest.mark.parametrize("eb", [8, 100, 4096, 32768, 1 << 20])
def test_buckets_and_ladder_match_jax(eb):
    """kb, kb_max and the K ladder agree with the JAX kernel at the same
    pinned K; the default K is the analytic min(128, 2·⌊√eb⌋)."""
    port, jax_k = _pair(eb, 1024)
    assert (port.eb, port.vb, port.kb, port.kb_max) == (
        jax_k.eb, jax_k.vb, jax_k.kb, jax_k.kb_max)
    assert port._escalation_ladder() == jax_k._escalation_ladder()
    assert port.kb == jax_tri.seg_ops.bucket_size(
        min(128, 2 * int(np.sqrt(port.eb))))


def test_no_device_means_the_card(monkeypatch):
    """device=None never falls back to the CPU: without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TriangleWindowKernel(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_tri.triangle_count_sparse([0, 1], [1, 2], 4)
