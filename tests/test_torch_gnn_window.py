"""The port's windowed GNN engine (gelly_streaming_tpu_torch/ops/
gnn_window.py, ops/gnn_round.py) on device="cpu", held against the JAX
package's `GnnSummaryEngine` in both forms (the XLA round, and the
`_gnn_call` kernel in interpret mode under GS_GNN_PALLAS=on, as
tests/operations/test_gnn_window.py runs it), its numpy twin
`GnnHostEngine`, and the port's own `GnnHostEngine`.

Features and weights lie on the integer lattice, so every summary is an
integer and the slab bit-exact: equality, no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import gnn_window as jax_gw
from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu_torch import GnnHostEngine, GnnSummaryEngine
from gelly_streaming_tpu_torch.ops import gnn_round
from gelly_streaming_tpu_torch.ops import gnn_window as gw


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_gnn(request, monkeypatch):
    """The JAX package's GNN scan in one of its two forms."""
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    if request.param == "xla":
        monkeypatch.delenv("GS_GNN_PALLAS", raising=False)
    else:
        monkeypatch.setenv("GS_GNN_PALLAS", "on")
    pw._reset_pallas_window()
    yield request.param == "pallas_interpret"
    pw._reset_pallas_window()


def _stream(n, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


def _weights(F, seed=3):
    """Sparse small weights (about two nonzero inputs per output, |W| ≤
    3 units), so the slab neither saturates nor dies out."""
    rng = np.random.RandomState(seed)
    keep = rng.random_sample((F, F)) < 2.0 / F
    return (rng.randint(-3, 4, (F, F)) * keep / 32,
            rng.randint(-8, 9, F) / 32)


def _setup(eng, F, vb, seed=5):
    eng.set_weights(*_weights(F))
    eng.load_feature_units(gw.default_features(vb, F, seed=seed))
    return eng


def _port(eb, vb, F, act):
    return _setup(GnnSummaryEngine(eb, vb, feature_dim=F, activation=act,
                                   device="cpu"), F, vb)


def _jax(cls, eb, vb, F, act):
    return _setup(cls(eb, vb, feature_dim=F, activation=act), F, vb)


def _assert_state_equal(a, b):
    assert {k: v for k, v in a.items() if k not in ("carry", "gnn")} == {
        k: v for k, v in b.items() if k not in ("carry", "gnn")}
    assert len(a["carry"]) == len(b["carry"]) == 1
    x, y = (np.asarray(s["carry"][0]) for s in (a, b))
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, y)
    ga, gb = a["gnn"], b["gnn"]
    assert (ga["feat_dim"], ga["act"]) == (gb["feat_dim"], gb["act"])
    np.testing.assert_array_equal(ga["weights"], gb["weights"])
    np.testing.assert_array_equal(ga["bias"], gb["bias"])


def test_lattice_helpers_match_jax():
    for eb in (8, 2 ** 15, 2 ** 16, 2 ** 17):
        assert gw.agg_shift(eb) == jax_gw.agg_shift(eb)
    for F in (1, 8, 64, 65, 72, 128, 256):
        assert gw.weight_shift(F) == jax_gw.weight_shift(F)
        assert gw.weight_cap(F) == jax_gw.weight_cap(F)
        W, b = _weights(F, seed=F)
        for got, want in zip(gw.snap_weights(5 * W, b, F),
                             jax_gw.snap_weights(5 * W, b, F)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(gw.default_features(32, F, seed=F),
                                      jax_gw.default_features(32, F, seed=F))
    feats = np.random.default_rng(1).normal(4, 8, (20, 6))
    np.testing.assert_array_equal(gw.snap_features(feats, 32, 6),
                                  jax_gw.snap_features(feats, 32, 6))
    for got, want in zip(gw.default_weights(5), jax_gw.default_weights(5)):
        np.testing.assert_array_equal(got, want)
    assert (gw.Q_BITS, gw.UNIT_CAP, gw.AGG_EXACT_LOG2,
            gw.MATMUL_EXACT_F) == (jax_gw.Q_BITS, jax_gw.UNIT_CAP,
                                   jax_gw.AGG_EXACT_LOG2,
                                   jax_gw.MATMUL_EXACT_F)


@pytest.mark.parametrize("eb,vb,F,act", [
    (64, 128, 8, "relu"),
    (64, 128, 8, "abs"),
    (128, 64, 72, "identity"),     # weight_shift 1
    (65536, 64, 8, "relu"),        # agg_shift 1
    (32768, 4096, 256, "relu"),    # the benchmark's width: weight cap 128
])
def test_round_plain_matches_jax_round(eb, vb, F, act):
    """One window through `gnn_round_plain` and the JAX XLA round, from a
    slab whose sentinel row is nonzero, with padded slots."""
    h = gw.default_features(vb, F, seed=eb + F)
    h[vb] = 7.0
    W, b = gw.snap_weights(*_weights(F), F)
    s, d = _stream(eb, vb, seed=F)
    v = np.random.default_rng(2).random(eb) < 0.8
    h2, outs = gnn_round.gnn_round_plain(
        *(torch.from_numpy(x) for x in (h, W, b, s, d, v)), eb, act)
    jh, jouts = jax.jit(jax_gw._build_gnn_round(eb, vb, F, act))(
        *(jnp.asarray(x) for x in (h, W, b, s, d, v)))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(jh))
    assert [int(x) for x in outs] == [int(x) for x in jouts]
    assert all(x.dtype == torch.int32 for x in outs)
    assert h2[vb].abs().sum() == 0 and 0 < int(outs[0]) <= 511


@pytest.mark.parametrize("eb,vb,F,act", [
    (64, 128, 8, "relu"),
    (128, 64, 72, "abs"),
    (64, 128, 8, "identity"),
    (65536, 64, 8, "relu"),
])
def test_engine_matches_jax_ragged(jax_gnn, eb, vb, F, act):
    """A stream with a ragged last window (a chunk padded with empty
    windows): summaries, state() and state_dict equal to both JAX
    engines' and to both host twins'."""
    n = 3 * eb - eb // 3
    src, dst = _stream(n, vb, seed=eb + F)
    port = _port(eb, vb, F, act)
    out = port.process(src, dst)
    jeng = _jax(jax_gw.GnnSummaryEngine, eb, vb, F, act)
    assert jeng._pallas == jax_gnn
    assert out == jeng.process(src, dst)
    host = _jax(jax_gw.GnnHostEngine, eb, vb, F, act)
    assert out == host.process(src, dst)
    twin = _setup(GnnHostEngine(eb, vb, feature_dim=F, activation=act),
                  F, vb)
    assert out == twin.process(src, dst)
    assert out[-1]["msg_edges"] == n - 2 * eb
    for other in (jeng, host, twin):
        np.testing.assert_array_equal(port.state(), np.asarray(
            other.state()))
        _assert_state_equal(port.state_dict(), other.state_dict())
    # the fixture neither saturates nor dies out
    st = port.state()
    assert ((st > 0) & (st < 511)).mean() > 0.2
    assert len({s["feat_checksum"] for s in out}) == len(out)


def test_calls_in_edge_bucket_multiples():
    """process() in eb multiples then a ragged last call equals one call;
    a further call is refused; reset() starts over from zero features."""
    src, dst = _stream(7 * 64 - 5, 128, seed=4)
    port = _port(64, 128, 16, "relu")
    parts = [port.process(src[a:b], dst[a:b])
             for a, b in ((0, 128), (128, 320), (320, len(src)))]
    whole = _port(64, 128, 16, "relu").process(src, dst)
    assert sum(parts, []) == whole
    assert port.windows_done == 7 and port.resume_offset() == 7 * 64
    twin = _setup(GnnHostEngine(64, 128, feature_dim=16), 16, 128)
    assert twin.process(src, dst) == whole
    with pytest.raises(ValueError, match="closed a partial window"):
        port.process(src[:64], dst[:64])
    assert port.process(src[:0], dst[:0]) == []
    port.reset()
    assert not port.state().any()
    fresh = jax_gw.GnnHostEngine(64, 128, feature_dim=16, activation="relu")
    fresh.set_weights(*_weights(16))
    assert port.process(src, dst) == fresh.process(src, dst)


def test_empty_window_holds_slab(jax_gnn):
    """A chunk whose first window has no valid slot, from a slab whose
    sentinel row is nonzero: the window holds the slab (its checksum
    counts row vb), the next window zeroes row vb; equal to the JAX
    scan body, XLA or interpret `_gnn_call`."""
    eb, vb, F = 64, 128, 8
    h = gw.default_features(vb, F, seed=1)
    h[vb] = 9.0
    W, b = gw.snap_weights(*_weights(F), F)
    s, d = _stream(3 * eb, vb, seed=9)
    s, d = s.reshape(3, eb), d.reshape(3, eb)
    v = np.ones((3, eb), bool)
    v[0] = False
    v[2, eb // 2:] = False
    ht = torch.from_numpy(h.copy())
    sums = torch.empty(4, 3, dtype=torch.int32)
    gnn_round.GnnRound(vb, F, "cpu")(
        ht, *(torch.from_numpy(x) for x in (W, b, s, d, v)), "relu", sums)
    body = jax_gw._build_gnn_scan(eb, vb, F, "relu")
    assert bool(getattr(body, "gnn_pallas", False)) == jax_gnn
    jh, jsums = jax.jit(lambda h0, *xs: jax.lax.scan(
        lambda c, x: body(c, jnp.asarray(W), jnp.asarray(b), x), h0, xs))(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(d), jnp.asarray(v))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(sums.numpy(),
                                  np.stack([np.asarray(x) for x in jsums]))
    held = gw._wrap_i32(h.astype(np.int64).sum())
    assert sums[2, 0] == held and sums[3, 0] == 0
    assert sums[3].tolist() == [0, eb, eb // 2]
    assert ht[vb].abs().sum() == 0


def test_state_dict_both_ways():
    """A JAX engine's state_dict() loads into the port, which finishes
    the stream equal to an uninterrupted JAX run; the port's loads into
    the JAX engine, the JAX host twin and, by from_state, both twins."""
    eb, vb, F, act = 64, 128, 16, "abs"
    src, dst = _stream(6 * eb - 11, vb, seed=7)
    cut = 3 * eb
    whole_eng = _jax(jax_gw.GnnSummaryEngine, eb, vb, F, act)
    whole = whole_eng.process(src, dst)

    jax_first = _jax(jax_gw.GnnSummaryEngine, eb, vb, F, act)
    head = jax_first.process(src[:cut], dst[:cut])
    port = GnnSummaryEngine(eb, vb, feature_dim=F, activation=act,
                            device="cpu")
    port.load_state_dict(jax_first.state_dict())
    assert port.resume_offset() == cut
    np.testing.assert_array_equal(port.weights()[0],
                                  jax_first.weights()[0])
    assert head + port.process(src[cut:], dst[cut:]) == whole
    _assert_state_equal(port.state_dict(), whole_eng.state_dict())

    port_first = _port(eb, vb, F, act)
    head = port_first.process(src[:cut], dst[:cut])
    state = port_first.state_dict()
    others = [jax_gw.GnnSummaryEngine(eb, vb, feature_dim=F,
                                      activation=act),
              jax_gw.GnnHostEngine(eb, vb, feature_dim=F, activation=act)]
    for other in others:
        other.load_state_dict(state)
    others += [jax_gw.GnnHostEngine.from_state(state),
               GnnHostEngine.from_state(state),
               GnnHostEngine.from_state(jax_first.state_dict())]
    for other in others:
        assert head + other.process(src[cut:], dst[cut:]) == whole
        _assert_state_equal(other.state_dict(), whole_eng.state_dict())


def test_features_snapped_as_jax():
    """load_features snaps real values as the JAX engine does; a stream
    from them stays equal."""
    eb, vb, F = 32, 64, 4
    feats = np.random.default_rng(3).normal(3, 6, (50, F))
    port = GnnSummaryEngine(eb, vb, feature_dim=F, device="cpu")
    jeng = jax_gw.GnnHostEngine(eb, vb, feature_dim=F, activation="relu")
    for e in (port, jeng):
        e.load_features(feats)
        e.set_weights(np.eye(F) * 0.5)
    np.testing.assert_array_equal(port.state(), jeng.state())
    src, dst = _stream(4 * eb, vb, seed=2)
    assert port.process(src, dst) == jeng.process(src, dst)


def test_engine_refusals(monkeypatch):
    with pytest.raises(ValueError, match="out of range"):
        GnnSummaryEngine(64, 64, feature_dim=0, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        GnnHostEngine(64, 64, feature_dim=257)
    with pytest.raises(ValueError, match="activation"):
        GnnSummaryEngine(64, 64, activation="tanh", device="cpu")
    port = _port(64, 64, 8, "relu")
    with pytest.raises(ValueError, match="unit slab"):
        port.load_feature_units(np.zeros((64, 8), np.float32))
    with pytest.raises(ValueError, match="W \\[F, F\\]"):
        port.set_weights(np.zeros((8, 4)))
    with pytest.raises(ValueError, match="outside"):
        port.process(np.array([0, 64]), np.array([1, 2]))
    state = port.state_dict()
    with pytest.raises(ValueError, match="bucket mismatch"):
        _port(128, 64, 8, "relu").load_state_dict(state)
    with pytest.raises(ValueError, match="feature-width"):
        _port(64, 64, 16, "relu").load_state_dict(state)
    with pytest.raises(ValueError, match="activation mismatch"):
        _port(64, 64, 8, "abs").load_state_dict(state)
    bad = dict(state, carry=(state["carry"][0][:, :4],))
    with pytest.raises(ValueError, match="carry must be"):
        port.load_state_dict(bad)
    with pytest.raises(ValueError, match="carry must be"):
        port.load_state_dict(dict(state, carry=(state["carry"][0],) * 2))
    port.warm_fallback()
    h = torch.zeros(65, 8)
    s = torch.zeros(1, 8, dtype=torch.int32)
    sums = torch.empty(4, 1, dtype=torch.int32)
    rnd = gnn_round.GnnRound(64, 8, "cpu")
    with pytest.raises(ValueError, match="activation"):
        rnd(h, torch.zeros(8, 8), torch.zeros(8), s, s, s.bool(), "tanh",
            sums)
    with pytest.raises(ValueError, match="given a"):
        rnd(h[:64], torch.zeros(8, 8), torch.zeros(8), s, s, s.bool(),
            "relu", sums)
    with pytest.raises(ValueError, match="given tensors on meta"):
        rnd(h, torch.zeros(8, 8), torch.zeros(8), s.to("meta"), s,
            s.bool(), "relu", sums)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gnn_round.gnn_rounds(h.to("meta"), torch.zeros(8, 8), torch.zeros(8),
                             s.to("meta"), s, s.bool(), "relu", sums,
                             h.to("meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        GnnSummaryEngine(64, 64)
