"""The inputs that the grids of the snapshot and union-find kernels
make risky (gelly_streaming_tpu_torch/utils/tier_fixtures.py: runs of
slots split over the blocks of a grid, unions across them), held on the CPU
through the port's plain versions against the JAX package: the JAX
driver's snapshot scan (`core/driver._build_snapshot_scan`) and
`ops/unionfind.cc_fixpoint`. Every value is an integer or a bool:
equality, no tolerance. chip_smoke.py builds the same fixtures at the
card's sizes and holds the kernels against these plain versions there
(phases snapshot and models)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import driver as jax_driver
from gelly_streaming_tpu.ops import unionfind as jax_uf
from gelly_streaming_tpu_torch.ops import delta_egress, segment
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.ops import window_snapshot as ws
from gelly_streaming_tpu_torch.utils import tier_fixtures as tf

_jax_fixpoint = jax.jit(jax_uf.cc_fixpoint, static_argnames=("carried",))


@pytest.fixture(autouse=True)
def _one_thread():
    # many small torch ops: one thread each beside the other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _snapshot_both(vb, eb, windows, analytics, egress, deltas, cap,
                   mirrors):
    """(JAX scan's carry and outs, the port's carry and outs) of one
    chunk from the driver-layout mirrors."""
    deg, lab, cov = mirrors
    stack = segment.stack_window_list(windows, eb, vb)
    jcarry = (np.concatenate([deg, [0]]).astype(np.int32),
              np.concatenate([lab, [vb]]).astype(np.int32),
              np.concatenate([cov, [2 * vb]]).astype(np.int32))
    run = jax_driver._build_snapshot_scan(vb, tuple(analytics),
                                          deltas=deltas, egress=egress,
                                          cap=cap)
    jnew, jouts = run(tuple(jnp.asarray(c.copy()) for c in jcarry),
                      *(jnp.asarray(a) for a in stack))
    on = [a in analytics for a in ws.ANALYTICS]
    carry = ws.engine_carry(vb, *[x.copy() if o else None
                                  for x, o in zip(mirrors, on)])
    outs = ws.WindowSnapshot(vb, analytics, "cpu", deltas=deltas,
                             egress=egress, cap=cap)(
        carry, *(torch.from_numpy(np.ascontiguousarray(a)) for a in stack))
    return ([np.asarray(c) for c in jnew],
            {k: np.asarray(v) for k, v in jouts.items()}, carry,
            {k: v.numpy() for k, v in outs.items()})


def _assert_same(vb, analytics, egress, jnew, want, carry, got):
    if egress == "delta":
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        for k in ("deg", "labels"):
            if k in want:
                np.testing.assert_array_equal(got[k], want[k][:, :vb])
        if "cover" in want:
            c = want["cover"]
            np.testing.assert_array_equal(got["odd"],
                                          c[:, :vb] == c[:, vb:2 * vb])
        for k in ("deg_chg", "labels_chg", "cover_chg"):
            assert (k in got) == (k in want)
            if k in want:
                np.testing.assert_array_equal(got[k], want[k])
    on = [a in analytics for a in ws.ANALYTICS]
    if on[0]:
        np.testing.assert_array_equal(carry[0].numpy()[:vb], jnew[0][:vb])
    if on[1]:
        np.testing.assert_array_equal(carry[1].numpy()[:vb], jnew[1][:vb])
    if on[2]:
        np.testing.assert_array_equal(ws.driver_cover(carry[2].numpy(), vb),
                                      jnew[2][:2 * vb])


ALL = ws.ANALYTICS


@pytest.mark.parametrize("kind,vb,C,analytics,egress,deltas,cap", [
    # runs of 26 over 101 slots: the last block's run is ragged
    ("ragged", 101, 4, ALL, "full", False, 0),
    ("ragged", 250, 8, ALL, "delta", False, None),
    ("cross_ranks", 256, 8, ALL, "full", True, 0),
    ("cross_ranks", 130, 2, ("cc", "bipartite"), "delta", True, 64),
    ("chains", 512, 16, ALL, "full", False, 0),
    ("chains", 200, 4, ("bipartite",), "delta", False, None),
    ("zipf", 256, 4, ALL, "full", True, 0),
    ("zipf", 500, 8, ("degrees",), "delta", False, None),
    ("one_window", 300, 8, ALL, "full", False, 0),
    ("one_window", 300, 8, ALL, "delta", True, 64),
    ("past_cap", 256, 4, ALL, "delta", False, 8),
])
def test_snapshot_fixture_matches_jax(kind, vb, C, analytics, egress,
                                      deltas, cap):
    eb = 48
    if cap is None:
        cap = delta_egress.egress_cap(eb, vb)
    windows = tf.snapshot_windows(kind, vb, eb, C, seed=vb + C)
    mirrors = tf.driver_mirrors(vb, seed=C)
    jnew, want, carry, got = _snapshot_both(vb, eb, windows, analytics,
                                            egress, deltas, cap, mirrors)
    _assert_same(vb, analytics, egress, jnew, want, carry, got)
    if kind == "past_cap":
        assert max(int(want[k].max()) for k in want
                   if k.endswith("_cnt")) > cap


@pytest.mark.parametrize("vb,C", [(200, 4), (509, 16)])
def test_snapshot_from_uncompressed_carry(vb, C):
    """A carried forest whose sets are chains at the call's start: the
    rows (full, no masks: the JAX scan compares window 0 with the
    uncompressed carry, the port with the compressed one) and the final
    carry equal the JAX scan's."""
    eb = 40
    mirrors = tf.driver_mirrors(vb, seed=vb, compressed=False)
    assert (mirrors[1] != tf.canonical(np.arange(vb), [], [])).any()
    for kind in ("zipf", "chains"):
        windows = tf.snapshot_windows(kind, vb, eb, C, seed=C)
        jnew, want, carry, got = _snapshot_both(vb, eb, windows, ALL,
                                                "full", False, 0, mirrors)
        _assert_same(vb, ALL, "full", jnew, want, carry, got)


def test_fixture_shapes():
    """The fixtures are what they say: runs ragged, cross-run edges
    between two runs, a chain through every run, a carried forest of
    chains with the canonical sets."""
    assert tf.runs(101, 4) == [(0, 26), (26, 52), (52, 78), (78, 101)]
    assert tf.runs(5, 4) == [(0, 2), (2, 4), (4, 5), (5, 5)]
    owner = np.repeat(np.arange(4), 26)[:101]
    s, d = tf.cross_rank_edges(np.random.default_rng(0), 101, 4, 200)
    assert (owner[s] != owner[d]).all()
    cs, cd = tf.rank_chain(101, 4, 5)
    assert owner[cs].tolist() == [3, 2, 1] and owner[cd].tolist() == [2, 1, 0]
    canon = tf.canonical(np.arange(50), [3, 9, 40], [9, 40, 1])
    chained = tf.chained_forest(canon)
    assert (chained <= np.arange(50)).all()
    assert chained[40] == 9 and chained[9] == 3 and chained[3] == 1
    np.testing.assert_array_equal(
        tf.canonical(chained, [], []), canon)


@pytest.mark.parametrize("kind,n,C", [
    ("one_slot", 1, 1),
    ("no_edges", 300, 4),
    ("out_of_range", 257, 4),
    ("long_chains", 512, 8),
    ("long_chains", 101, 16),
    ("cross_ranks", 400, 8),
])
def test_union_find_fixture_matches_jax(kind, n, C):
    lab0, src, dst, carried = tf.union_find_case(kind, n, 3 * n // 2, C,
                                                 seed=n)
    n = len(lab0)
    s, d = tf.in_range_edges(src, dst, n)
    if kind == "out_of_range":
        assert 0 < len(s) < len(src)
    else:
        assert len(s) == len(src)
    want = np.asarray(_jax_fixpoint(jnp.asarray(lab0), jnp.asarray(s),
                                    jnp.asarray(d), carried=carried))
    got = uf.cc_fixpoint(torch.from_numpy(lab0), torch.from_numpy(s),
                         torch.from_numpy(d), carried=carried)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "long_chains":
        assert lab0[-1] == n - 2 and want.max() < n - 1
