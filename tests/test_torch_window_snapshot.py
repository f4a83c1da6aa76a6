"""The driver's snapshot program (gelly_streaming_tpu_torch/ops/
window_snapshot.py) on device="cpu": its plain version held against the
JAX driver's XLA scan (`core/driver._build_snapshot_scan`), the numpy
host tier and the C++ fold, with the carry converted between the
driver's layout ((-) at vb+v) and the engines' ((-) at v+vb+1) and back.
Every value is an integer or a bool: equality, no tolerance. The CUDA
kernel is held against this plain version on the card by chip_smoke.py
(phase snapshot)."""

import itertools

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import driver as jax_driver
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.core.driver import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch.ops import host_snapshot, segment
from gelly_streaming_tpu_torch.ops import window_snapshot as ws

SUBSETS = [s for n in (1, 2, 3)
           for s in itertools.combinations(ws.ANALYTICS, n)]


@pytest.fixture(autouse=True)
def _one_thread():
    # many small torch ops: one thread each beside the other workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chunk(seed, vb, eb, lens, hi=None):
    """A [W, eb] standard-wire chunk of windows with `lens` edges (ids
    below `hi`), as numpy, plus its flat form for the host folds."""
    rng = np.random.default_rng(seed)
    hi = hi or vb
    wins = [(rng.integers(0, hi, n).astype(np.int32),
             rng.integers(0, hi, n).astype(np.int32)) for n in lens]
    s, d, v = segment.stack_window_list(wins, eb, vb)
    flat_s = np.concatenate([a for a, _ in wins])
    flat_d = np.concatenate([b for _, b in wins])
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return (s, d, v), (flat_s, flat_d, offs)


def _mirrors(seed, vb, nv):
    """Driver-layout mirrors of a stream that has run a while: degrees,
    canonical labels and cover from the host fold of a first chunk."""
    (_s, _d, _v), flat = _chunk(seed, vb, 16, [16, 9], hi=nv)
    deg = np.zeros(vb, np.int32)
    lab = np.arange(vb, dtype=np.int32)
    cov = np.arange(2 * vb, dtype=np.int32)
    host_snapshot.snapshot_windows(*flat, vb, deg, lab, cov)
    return deg, lab, cov


def _torch(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("analytics", SUBSETS)
@pytest.mark.parametrize("deltas", [False, True])
def test_plain_matches_host_tiers(analytics, deltas):
    vb, eb = 64, 32
    stack, flat = _chunk(1, vb, eb, [32, 1, 0, 17, 32, 5], hi=48)
    deg, lab, cov = _mirrors(2, vb, 40)
    on = [a in analytics for a in ws.ANALYTICS]
    host = [x.copy() if o else None for x, o in zip((deg, lab, cov), on)]
    want = host_snapshot.snapshot_windows(*flat, vb, *host)
    nat = [x.copy() if o else None for x, o in zip((deg, lab, cov), on)]
    got_native = native.snapshot_windows(*flat, vb, *nat)
    carry = ws.engine_carry(vb, *[x if o else None
                                  for x, o in zip((deg, lab, cov), on)])
    outs = ws.WindowSnapshot(vb, analytics, "cpu", deltas=deltas)(
        carry, *_torch(stack))
    for key in want:
        np.testing.assert_array_equal(got_native[key], want[key])
    if "deg" in want:
        np.testing.assert_array_equal(outs["deg"].numpy(), want["deg"])
        np.testing.assert_array_equal(carry[0].numpy()[:vb], host[0])
        assert carry[0][vb] == 0
    if "labels" in want:
        np.testing.assert_array_equal(outs["labels"].numpy(),
                                      want["labels"])
        np.testing.assert_array_equal(carry[1].numpy()[:vb], host[1])
        assert carry[1][vb] == vb
    if "cover" in want:
        c = want["cover"]
        np.testing.assert_array_equal(outs["odd"].numpy(),
                                      c[:, :vb] == c[:, vb:])
        # the sentinels stay singletons; the round trip gives the mirror
        assert carry[2][vb] == vb and carry[2][2 * vb + 1] == 2 * vb + 1
        np.testing.assert_array_equal(ws.driver_cover(carry[2].numpy(), vb),
                                      host[2])
    assert sorted(k for k in outs if k.endswith("_chg")) == (
        sorted(k + "_chg" for k, o in zip(("deg", "labels", "cover"), on)
               if o) if deltas else [])


def _jax_scan(vb, analytics, deltas, egress, cap, carry, stack):
    import jax.numpy as jnp

    run = jax_driver._build_snapshot_scan(vb, tuple(analytics),
                                          deltas=deltas, egress=egress,
                                          cap=cap)
    new_carry, outs = run(tuple(jnp.asarray(c.copy()) for c in carry),
                          *(jnp.asarray(a) for a in stack))
    return ([np.asarray(c) for c in new_carry],
            {k: np.asarray(v) for k, v in outs.items()})


@pytest.mark.parametrize("analytics", [ws.ANALYTICS, ("cc",),
                                       ("bipartite",), ("degrees", "cc")])
@pytest.mark.parametrize("egress,deltas,cap", [("full", False, 0),
                                               ("full", True, 0),
                                               ("delta", False, 64),
                                               ("delta", True, 5)])
def test_plain_matches_jax_scan(analytics, egress, deltas, cap):
    vb, eb = 64, 32
    stack, _flat = _chunk(3, vb, eb, [32, 20, 1, 32, 0, 31], hi=60)
    deg, lab, cov = _mirrors(4, vb, 50)
    # the JAX scan's carry: deg [vb+1], labels [vb+1], cover [2vb+1]
    jcarry = (np.concatenate([deg, [0]]).astype(np.int32),
              np.arange(vb + 1, dtype=np.int32),
              np.arange(2 * vb + 1, dtype=np.int32))
    jcarry[1][:vb] = lab
    jcarry[2][:2 * vb] = cov
    new, want = _jax_scan(vb, analytics, deltas, egress, cap, jcarry, stack)
    on = [a in analytics for a in ws.ANALYTICS]
    carry = ws.engine_carry(vb, *[x if o else None
                                  for x, o in zip((deg, lab, cov), on)])
    got = ws.WindowSnapshot(vb, analytics, "cpu", deltas=deltas,
                            egress=egress, cap=cap)(carry, *_torch(stack))
    if egress == "delta":
        assert sorted(got) == sorted(want)
        for k in want:   # the pads too: pad index 0, its value
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    else:
        for k in ("deg", "labels"):
            if k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              want[k][:, :vb])
        if "cover" in want:
            c = want["cover"]
            np.testing.assert_array_equal(got["odd"].numpy(),
                                          c[:, :vb] == c[:, vb:2 * vb])
        for k in ("deg_chg", "labels_chg", "cover_chg"):
            assert (k in got) == (k in want)
            if k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    if on[0]:
        np.testing.assert_array_equal(carry[0].numpy()[:vb], new[0][:vb])
    if on[1]:
        np.testing.assert_array_equal(carry[1].numpy()[:vb], new[1][:vb])
    if on[2]:
        np.testing.assert_array_equal(ws.driver_cover(carry[2].numpy(), vb),
                                      new[2][:2 * vb])


@pytest.mark.parametrize("old_vb,vb", [(8, 16), (16, 64), (64, 64)])
def test_cover_layout_round_trip_after_growth(old_vb, vb):
    _d, _l, cov = _mirrors(5, old_vb, old_vb)
    grown = StreamingAnalyticsDriver._grow_cover(cov, vb)
    eng = ws.engine_carry(vb, cover=grown)[2].numpy()
    np.testing.assert_array_equal(ws.driver_cover(eng, vb), grown)
    # the same sets: (+) v at v, (-) v at v+vb+1, min labels kept
    assert (eng[:vb][grown[:vb] < vb] == grown[:vb][grown[:vb] < vb]).all()
    assert eng[vb] == vb and eng[2 * vb + 1] == 2 * vb + 1
    with pytest.raises(ValueError):
        ws.engine_carry(vb, cover=grown[:-1])


def test_padding_and_one_edge_windows_fold_nothing_extra():
    vb, eb = 16, 8
    stack, flat = _chunk(6, vb, eb, [1, 0, 1, 8])
    carry = ws.engine_carry(vb, np.zeros(vb, np.int32),
                            np.arange(vb, dtype=np.int32),
                            np.arange(2 * vb, dtype=np.int32))
    outs = ws.WindowSnapshot(vb, ws.ANALYTICS, "cpu", deltas=True)(
        carry, *_torch(stack))
    assert outs["deg"].sum(1).tolist() == [2, 2, 4, 20]
    assert not outs["deg_chg"][1].any() and not outs["labels_chg"][1].any()


def test_wrapper_checks():
    vb = 16
    snap = ws.WindowSnapshot(vb, ("cc",), "cpu")
    s = torch.zeros(2, 8, dtype=torch.int32)
    v = torch.ones(2, 8, dtype=torch.bool)
    good = ws.engine_carry(vb, labels=np.arange(vb, dtype=np.int32))
    snap(good, s, s, v)
    with pytest.raises(ValueError, match="off"):
        snap(ws.engine_carry(vb, deg=np.zeros(vb, np.int32),
                             labels=np.arange(vb, dtype=np.int32)), s, s, v)
    with pytest.raises(ValueError, match="labels"):
        snap((None, torch.zeros(vb, dtype=torch.int64), None), s, s, v)
    with pytest.raises(ValueError, match="valid"):
        snap(good, s, s, v.to(torch.int32))
    with pytest.raises(ValueError):
        ws.WindowSnapshot(vb, ("triangles",), "cpu")
    with pytest.raises(ValueError):
        ws.WindowSnapshot(vb, ("cc",), "cpu", egress="delta", cap=0)
    with pytest.raises(ValueError):
        ws.WindowSnapshot(vb, ("cc",), "cpu", egress="wide")
