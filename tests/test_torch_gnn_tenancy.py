"""The port's GNN cohort (gelly_streaming_tpu_torch/core/tenancy.py
`GnnTenantCohort`, ops/gnn_window.py `build_gnn_cohort_scan`) on
device="cpu", held against the JAX package's `GnnTenantCohort` and
`build_gnn_cohort_scan` (the XLA round, GS_GNN_PALLAS unset) and against
N port `GnnSummaryEngine`s.

Features and weights lie on the integer lattice, so every summary is an
integer and every slab bit-exact: equality, no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import gnn_window as jax_gw
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu_torch import (GnnHostEngine, GnnSummaryEngine,
                                       GnnTenantCohort, TenantError,
                                       TenantRejected)
from gelly_streaming_tpu_torch.ops import gnn_window as gw

EB, VB, F = 64, 128, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _xla_round():
    with pytest.MonkeyPatch.context() as mp:
        for k in ("GS_GNN_PALLAS", "GS_GNN_F", "GS_GNN_ACT",
                  "GS_TENANT_MAX"):
            mp.delenv(k, raising=False)
        mp.setenv("GS_AUTOTUNE", "0")
        pallas_window._reset_pallas_window()
        yield
    pallas_window._reset_pallas_window()


def _weights(seed=3):
    """Sparse small weights (|W| ≤ 3 units), so the slab neither
    saturates nor dies out."""
    rng = np.random.RandomState(seed)
    keep = rng.random_sample((F, F)) < 2.0 / F
    return (rng.randint(-3, 4, (F, F)) * keep / 32,
            rng.randint(-8, 9, F) / 32)


def streams_for(n, windows=4):
    """n streams of `windows` windows; tenant 1 ends in a partial window,
    tenant 2 is two windows shorter."""
    rng = np.random.default_rng(40)
    out = {}
    for i in range(n):
        m = windows * EB - (EB // 3 if i == 1 else 0) - (2 * EB if i == 2
                                                          else 0)
        out["t%d" % i] = (rng.integers(0, VB, m).astype(np.int32),
                          rng.integers(0, VB, m).astype(np.int32))
    return out


def serve(co, streams, cut=EB + 5):
    """Admit (slab from default_features(seed=i)), feed each tenant up to
    `cut`, pump, feed the rest, pump, snapshot each tenant's state, close.
    Returns ({tenant: summaries}, {tenant: state_dict})."""
    co.set_weights(*_weights())
    for i, tid in enumerate(sorted(streams)):
        co.admit(tid, feature_units=gw.default_features(VB, F, seed=i))
    out = {tid: [] for tid in streams}
    for lo, hi in ((0, cut), (cut, None)):
        for tid, (s, d) in streams.items():
            co.feed(tid, s[lo:hi], d[lo:hi])
        for tid, res in co.pump().items():
            out[tid].extend(res)
    states = {tid: co.tenant_state_dict(tid) for tid in streams}
    for tid in streams:
        out[tid].extend(co.close(tid))
    return out, states


def engine_run(tid_index, s, d):
    """A port GnnSummaryEngine over (s, d) from tenant tid_index's slab:
    (the engine, its summaries)."""
    eng = GnnSummaryEngine(EB, VB, feature_dim=F, device="cpu")
    eng.set_weights(*_weights())
    eng.load_feature_units(gw.default_features(VB, F, seed=tid_index))
    return eng, eng.process(s, d)


def assert_state_equal(a, b):
    assert {k: v for k, v in a.items() if k not in ("carry", "gnn")} == {
        k: v for k, v in b.items() if k not in ("carry", "gnn")}
    x, y = (np.asarray(st["carry"][0]) for st in (a, b))
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, y)
    assert (a["gnn"]["feat_dim"], a["gnn"]["act"]) == (
        b["gnn"]["feat_dim"], b["gnn"]["act"])
    for k in ("weights", "bias"):
        np.testing.assert_array_equal(a["gnn"][k], b["gnn"][k])


def test_gnn_cohort_scan_matches_jax_xla(monkeypatch):
    """Ragged rows (4, 1, 0, 3 live windows: a pad row; an empty window
    inside row 3) from loaded slabs whose sentinel rows are nonzero:
    outputs and slabs equal to the JAX vmapped scan, nothing launched for
    padded windows."""
    nb, wb = 4, 4
    rng = np.random.default_rng(9)
    s = rng.integers(0, VB, (nb, wb, EB)).astype(np.int32)
    d = rng.integers(0, VB, (nb, wb, EB)).astype(np.int32)
    v = np.zeros((nb, wb, EB), bool)
    for n, w in enumerate((4, 1, 0, 3)):
        v[n, :w] = True
    v[3, 1] = False
    v[0, 3, EB // 2:] = False
    slabs = np.stack([gw.default_features(VB, F, seed=n) for n in range(nb)])
    slabs[:, VB] = 3.0
    W, b = gw.snap_weights(*_weights(), F)
    calls = []
    real_call = gw.GnnRound.__call__
    monkeypatch.setattr(gw.GnnRound, "__call__", lambda self, h, W, b, src,
                        *a: calls.append(src.shape[0])
                        or real_call(self, h, W, b, src, *a))
    run = gw.build_gnn_cohort_scan(EB, VB, F, "relu", device="cpu")
    live = [4, 1, 0, 3]            # windows up to each row's last live one
    hs, outs = run(torch.from_numpy(slabs.copy()), torch.from_numpy(W),
                   torch.from_numpy(b),
                   *(torch.from_numpy(x) for x in (s, d, v)), live)
    assert calls == [4, 1, 3]      # windows launched per row
    jhs, jouts = jax_gw.build_gnn_cohort_scan(EB, VB, F, "relu")(
        jnp.asarray(slabs), jnp.asarray(W), jnp.asarray(b), jnp.asarray(s),
        jnp.asarray(d), jnp.asarray(v))
    np.testing.assert_array_equal(hs.numpy(), np.asarray(jhs))
    for got, want in zip(outs, jouts):
        assert tuple(got.shape) == (nb, wb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="given carries"):
        run(torch.from_numpy(slabs[:2]), torch.from_numpy(W),
            torch.from_numpy(b), *(torch.from_numpy(x) for x in (s, d, v)),
            live)
    with pytest.raises(ValueError, match="live must"):
        run(torch.from_numpy(slabs.copy()), torch.from_numpy(W),
            torch.from_numpy(b), *(torch.from_numpy(x) for x in (s, d, v)),
            [4, 1, 0, 5])
    with pytest.raises(ValueError, match="activation"):
        gw.build_gnn_cohort_scan(EB, VB, F, "tanh", device="cpu")


@pytest.mark.parametrize("n_tenants", [1, 3, 8])
def test_gnn_cohort_matches_jax_and_engines(n_tenants):
    """Ragged cohorts over two pumps and close(): summaries and
    tenant_state_dict equal to the JAX cohort's; summaries and slabs
    equal to one GnnSummaryEngine per tenant."""
    streams = streams_for(n_tenants)
    co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")
    out, states = serve(co, streams)
    jout, jstates = serve(jax_tenancy.GnnTenantCohort(EB, VB, feature_dim=F),
                          streams)
    assert out == jout
    for i, tid in enumerate(sorted(streams)):
        assert_state_equal(states[tid], jstates[tid])
        src, dst = streams[tid]
        assert out[tid] == engine_run(i, src, dst)[1]
        full = len(src) // EB * EB        # the state before close()
        np.testing.assert_array_equal(states[tid]["carry"][0][:VB],
                                      engine_run(i, src[:full],
                                                 dst[:full])[0].state())
    assert co.tenants() == []


def test_gnn_cohort_state_both_ways():
    """A port tenant's state loads into the JAX and port GNN engines and
    the port's numpy twin, and into a JAX cohort tenant; a JAX cohort
    tenant's state loads into a port tenant; each continues the stream
    equal to the uninterrupted run."""
    (s, d), = streams_for(1, windows=5).values()
    cut = 2 * EB
    _eng, whole = engine_run(0, s, d)
    co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")
    co.set_weights(*_weights())
    co.admit("a", feature_units=gw.default_features(VB, F, seed=0))
    co.feed("a", s[:cut], d[:cut])
    assert co.pump()["a"] == whole[:2]
    state = co.tenant_state_dict("a")
    assert state["windows_done"] == 2 and state["wal_offset"] == cut
    for eng in (jax_gw.GnnSummaryEngine(EB, VB, feature_dim=F),
                GnnSummaryEngine(EB, VB, feature_dim=F, device="cpu"),
                GnnHostEngine(EB, VB, feature_dim=F)):
        eng.load_state_dict(state)
        assert eng.process(s[cut:], d[cut:]) == whole[2:]
    for first, second in (
            (co, jax_tenancy.GnnTenantCohort(EB, VB, feature_dim=F)),
            (jax_tenancy.GnnTenantCohort(EB, VB, feature_dim=F),
             GnnTenantCohort(EB, VB, feature_dim=F, device="cpu"))):
        if first is not co:
            first.set_weights(*_weights())
            first.admit("a", feature_units=gw.default_features(VB, F,
                                                               seed=0))
            first.feed("a", s[:cut], d[:cut])
            first.pump()
        second.set_weights(*_weights())
        second.admit("b")
        second.load_tenant_state_dict("b", first.tenant_state_dict("a"))
        assert second.windows_done("b") == 2
        second.feed("b", s[cut:], d[cut:])
        assert second.pump()["b"] + second.close("b") == whole[2:]
    with pytest.raises(ValueError, match="does not match"):
        GnnTenantCohort(EB, VB, feature_dim=2 * F,
                        device="cpu").load_tenant_state_dict("a", state)
    bad = dict(state, carry=(np.zeros((VB, F), np.float32),))
    with pytest.raises(ValueError, match="carry must be"):
        co.load_tenant_state_dict("a", bad)


def test_gnn_cohort_weights_snap_as_jax():
    """set_weights snaps onto the lattice exactly as the JAX cohort does
    (clipped to the F-derived cap); the default layer is the identity."""
    co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")
    jco = jax_tenancy.GnnTenantCohort(EB, VB, feature_dim=F)
    for got, want in zip(co.weights(), jco.weights()):
        np.testing.assert_array_equal(got, want)
    W = np.random.default_rng(2).normal(0, 40, (F, F))
    for c in (co, jco):
        c.set_weights(W)
    for got, want in zip(co.weights(), jco.weights()):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert np.abs(co.weights()[0]).max() == gw.weight_cap(F)
    assert not co.weights()[1].any()
    with pytest.raises(ValueError, match="W \\[F, F\\]"):
        co.set_weights(np.eye(F + 1))


def test_gnn_cohort_demote():
    """demote() hands a tenant to its own GnnSummaryEngine: full queued
    windows fold during the hand-off, the sub-window tail comes back
    unfolded, and the continued stream equals the engine run; the other
    tenant is undisturbed."""
    streams = streams_for(2)
    co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu")
    co.set_weights(*_weights())
    for i, tid in enumerate(sorted(streams)):
        co.admit(tid, feature_units=gw.default_features(VB, F, seed=i))
    got = {tid: [] for tid in streams}
    for tid, (s, d) in streams.items():
        co.feed(tid, s[:2 * EB], d[:2 * EB])
    for tid, res in co.pump().items():
        got[tid] += res
    s, d = streams["t0"]
    cut = 3 * EB + EB // 2
    co.feed("t0", s[2 * EB:cut], d[2 * EB:cut])
    eng, folded, (ts, td) = co.demote("t0")
    assert isinstance(eng, GnnSummaryEngine) and eng.device.type == "cpu"
    assert len(folded) == 1 and len(ts) == EB // 2
    got["t0"] += folded + eng.process(np.concatenate([ts, s[cut:]]),
                                      np.concatenate([td, d[cut:]]))
    want_eng, want = engine_run(0, s, d)
    assert got["t0"] == want
    np.testing.assert_array_equal(eng.state(), want_eng.state())
    assert co.tenants() == ["t1"]
    s, d = streams["t1"]
    co.feed("t1", s[2 * EB:], d[2 * EB:])
    got["t1"] += co.pump()["t1"] + co.close("t1")
    assert got["t1"] == engine_run(1, s, d)[1]


def test_gnn_cohort_admission_and_errors():
    co = GnnTenantCohort(EB, VB, feature_dim=F, device="cpu", max_tenants=2)
    co.admit("a", features=np.full((3, F), 0.5))
    np.testing.assert_array_equal(co.state("a")[:3], np.full((3, F), 16.0))
    assert not co.state("a")[3:].any()
    with pytest.raises(ValueError, match="unit slab"):
        co.admit("b", feature_units=np.zeros((VB, F)))
    co.admit("b")
    with pytest.raises(TenantRejected):
        co.admit("a")
    with pytest.raises(TenantRejected) as ei:
        co.admit("c")
    assert ei.value.tenant == "c"
    for call in (lambda: co.feed("ghost", [0], [1]),
                 lambda: co.queued_edges("ghost"),
                 lambda: co.tenant_state_dict("ghost"),
                 lambda: co.close("ghost")):
        with pytest.raises(TenantError):
            call()
    with pytest.raises(ValueError, match="lie in"):
        co.feed("a", [VB], [0])
    with pytest.raises(ValueError, match="length mismatch"):
        co.feed("a", [0, 1], [0])
    assert co.feed("a", np.arange(EB + 3) % VB, np.arange(EB + 3) % VB) \
        == EB + 3
    assert len(co.pump()["a"]) == 1 and co.queued_edges("a") == 3
    assert co.windows_done("a") == 1 and co.tenants() == ["a", "b"]
    assert len(co.close("a")) == 1 and co.tenants() == ["b"]
    with pytest.raises(ValueError, match="activation"):
        GnnTenantCohort(EB, VB, activation="tanh", device="cpu")
    with pytest.raises(ValueError, match="feature_dim"):
        GnnTenantCohort(EB, VB, feature_dim=0, device="cpu")
