"""The port's union-find (gelly_streaming_tpu_torch/ops/unionfind.py) and
numpy summary oracle (ops/host_summary.py) held against the JAX
package's `ops/unionfind.py` and its numpy `host_snapshot._fixpoint`.

Labels are integers: equality, no tolerance. On the CPU `cc_fixpoint`
runs the plain rounds; the CUDA union-find is held against them by
chip_smoke.py on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import host_snapshot as jax_host
from gelly_streaming_tpu.ops import unionfind as jax_uf
from gelly_streaming_tpu_torch.ops import host_summary
from gelly_streaming_tpu_torch.ops import unionfind as uf

_jax_fixpoint = jax.jit(jax_uf.cc_fixpoint, static_argnames=("carried",))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _forest(rng, n, edges):
    """A carried labeling of n slots: the canonical labels of `edges`
    random edges, so every slot points at its set's minimum."""
    s, d = rng.integers(0, n, edges), rng.integers(0, n, edges)
    return jax_host._fixpoint(np.arange(n, dtype=np.int32), s, d)


@pytest.mark.parametrize("seed,n,edges,carried", [(0, 64, 40, True),
                                                  (1, 257, 300, True),
                                                  (2, 129, 60, False),
                                                  (3, 512, 900, False)])
def test_cc_fixpoint_matches_jax(seed, n, edges, carried):
    rng = np.random.default_rng(seed)
    lab0 = (_forest(rng, n, n // 3) if carried
            else np.arange(n, dtype=np.int32))
    s = rng.integers(0, n, edges).astype(np.int32)
    d = rng.integers(0, n, edges).astype(np.int32)
    want = np.asarray(_jax_fixpoint(jnp.asarray(lab0), jnp.asarray(s),
                                    jnp.asarray(d), carried=carried))
    got = uf.cc_fixpoint(_t(lab0), _t(s), _t(d), carried=carried)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        uf.cc_fixpoint_plain(_t(lab0), _t(s), _t(d), carried).numpy(), want)
    if carried:
        np.testing.assert_array_equal(host_summary.fixpoint(lab0, s, d),
                                      jax_host._fixpoint(lab0, s, d))
        np.testing.assert_array_equal(host_summary.fixpoint(lab0, s, d),
                                      want)


def test_cc_fixpoint_carried_split_case():
    """The case of cc_fixpoint's docstring: old root r=2 with child 7;
    the batch joins 7 to 5 and r to 0 in one round. Without the forest
    links the 5-side would stay apart; carried, all of {0, 2, 5, 7} end
    at 0."""
    lab0 = np.arange(10, dtype=np.int32)
    lab0[7] = 2
    s, d = np.array([7, 2], np.int32), np.array([5, 0], np.int32)
    want = np.asarray(_jax_fixpoint(jnp.asarray(lab0), jnp.asarray(s),
                                    jnp.asarray(d), carried=True))
    got = uf.cc_fixpoint(_t(lab0), _t(s), _t(d)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[[0, 2, 5, 7]].tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(host_summary.fixpoint(lab0, s, d), want)


@pytest.mark.parametrize("seed", range(3))
def test_cc_round_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lab = _forest(rng, 100, 30)
    s = rng.integers(0, 100, 80).astype(np.int32)
    d = rng.integers(0, 100, 80).astype(np.int32)
    want = np.asarray(jax_uf.cc_round(jnp.asarray(lab), jnp.asarray(s),
                                      jnp.asarray(d)))
    np.testing.assert_array_equal(uf.cc_round(_t(lab), _t(s), _t(d)).numpy(),
                                  want)


def test_labels_and_components_match_jax():
    rng = np.random.default_rng(4)
    nv = 90
    s, d = rng.integers(0, nv, 70), rng.integers(0, nv, 70)
    np.testing.assert_array_equal(
        uf.connected_components(s, d, nv, device="cpu"),
        jax_uf.connected_components(s, d, nv))
    eb = 128
    sp = np.full(eb, 128, np.int32)
    dp = np.full(eb, 128, np.int32)
    sp[:70], dp[:70] = s, d
    np.testing.assert_array_equal(
        uf.cc_labels(_t(sp), _t(dp), 128).numpy(),
        np.asarray(jax_uf.cc_labels(jnp.asarray(sp), jnp.asarray(dp), 128)))
    lab = _forest(rng, nv, 20)
    s2, d2 = rng.integers(0, nv, 30), rng.integers(0, nv, 30)
    for vb, eb in ((0, 0), (256, 64)):
        np.testing.assert_array_equal(
            uf.connected_components_with_labels(s2, d2, lab, nv, vb, eb,
                                                device="cpu"),
            jax_uf.connected_components_with_labels(s2, d2, lab, nv, vb,
                                                    eb))


@pytest.mark.parametrize("case", ["even_cycle", "odd_cycle", "random"])
def test_bipartite_labels_match_jax(case):
    if case == "even_cycle":     # 0-1-2-3-0 and a path 5-6
        s, d, nv = [0, 1, 2, 3, 5], [1, 2, 3, 0, 6], 8
    elif case == "odd_cycle":    # triangle 1-2-3 plus a tail 3-4
        s, d, nv = [1, 2, 3, 3], [2, 3, 1, 4], 6
    else:
        rng = np.random.default_rng(5)
        s, d, nv = rng.integers(0, 60, 40), rng.integers(0, 60, 40), 60
    s2, d2 = uf.double_cover_edges(s, d, nv)
    js2, jd2 = jax_uf.double_cover_edges(s, d, nv)
    np.testing.assert_array_equal(s2, js2)
    np.testing.assert_array_equal(d2, jd2)
    got = uf.bipartite_labels(s, d, nv, device="cpu")
    want = jax_uf.bipartite_labels(s, d, nv)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if case == "odd_cycle":
        assert got[2][[1, 2, 3, 4]].all() and not got[2][0]
    if case == "even_cycle":
        assert not got[2].any()
        assert got[1][[0, 2]].all() and not got[1][[1, 3]].any()
