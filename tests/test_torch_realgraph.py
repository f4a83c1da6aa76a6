"""The port's copy of the synthetic cit-HepPh stream
(gelly_streaming_tpu_torch/utils/realgraph.py) against the JAX
package's: element for element at small sizes and at the default size
(with its sha256 pinned), and the statistics helpers equal on it."""

import hashlib

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.utils import realgraph as jax_realgraph

from gelly_streaming_tpu_torch.utils import realgraph

# sha256 over the default stream's src, dst and ts bytes, in that order
DEFAULT_DIGEST = ("67d208ca8f4d8d4818c5eb33d4bb1aa9"
                  "5cd5cf73f6e2fdf7741ef7193368cf22")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_stream(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,e,seed", [(50, 300, 3), (200, 2000, 3),
                                      (1000, 12_000, 3), (400, 5000, 17),
                                      (3000, 40_000, 5)])
def test_small_streams_equal_jax(n, e, seed):
    got = realgraph.citation_stream(num_papers=n, num_edges=e, seed=seed)
    _assert_same_stream(got, jax_realgraph.citation_stream(
        num_papers=n, num_edges=e, seed=seed))
    src, dst, ts = got
    assert len(src) == e and (src > dst).all()
    np.testing.assert_array_equal(ts, np.arange(e))


def test_small_stream_stats_equal_jax():
    src, dst, _ = realgraph.citation_stream(num_papers=800,
                                            num_edges=9000, seed=7)
    tri, avg_cc, deg = realgraph.undirected_stats(src, dst, 800)
    jtri, javg, jdeg = jax_realgraph.undirected_stats(src, dst, 800)
    assert (tri, avg_cc) == (jtri, javg)
    np.testing.assert_array_equal(deg, jdeg)
    assert realgraph.indegree_powerlaw_alpha(dst, 800, 5) == \
        jax_realgraph.indegree_powerlaw_alpha(dst, 800, 5)


def test_default_stream_equal_jax_and_digest():
    got = realgraph.citation_stream()
    assert len(got[0]) == realgraph.CIT_HEPPH_EDGES
    assert int(max(got[0].max(), got[1].max())) + 1 == \
        realgraph.CIT_HEPPH_NODES
    digest = hashlib.sha256()
    for a in got:
        digest.update(a.tobytes())
    assert digest.hexdigest() == DEFAULT_DIGEST
    _assert_same_stream(got, jax_realgraph.citation_stream())
