"""The port's fused summary body (gelly_streaming_tpu_torch/ops/
window_summary.py) on the CPU, held against the JAX package's scan body
`scan_analytics._build_scan` in both of its forms: the XLA body (the
Pallas gate unset) and the `_window_call` kernel in interpret mode
(GS_PALLAS_WINDOW=on, as tests/operations/test_pallas_window.py runs
it). One [W, eb] chunk from a carry that is not fresh: the five outputs
per window and all three carries after the chunk.

Every output is an integer or a bool: equality, no tolerance. On the
CPU the port's wrapper runs the plain version, which keeps the JAX
sort's row order, so `triangles` matches even where a window overflows
K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch.ops import host_summary
from gelly_streaming_tpu_torch.ops import scan_analytics as sa
from gelly_streaming_tpu_torch.ops import segment as seg
from gelly_streaming_tpu_torch.ops import window_summary as ws
from gelly_streaming_tpu_torch.utils.streams import make_stream


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_scan_fn(request, monkeypatch):
    """build(eb, vb, kb) -> jitted (carry, s, d, v) -> (carry, outs) of
    the JAX package's summary scan body."""
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    if request.param == "xla":
        monkeypatch.delenv("GS_PALLAS_WINDOW", raising=False)
    else:
        monkeypatch.setenv("GS_PALLAS_WINDOW", "on")
    pw._reset_pallas_window()

    def build(eb, vb, kb):
        body = jax_scan._build_scan(eb, vb, kb)
        assert bool(getattr(body, "pallas_window", False)) == (
            request.param == "pallas_interpret")
        return jax.jit(lambda c, s, d, v: jax.lax.scan(body, c, (s, d, v)))

    yield build
    pw._reset_pallas_window()


def _stack(windows, eb, vb):
    """[(src, dst), ...] windows of ≤ eb edges -> [W, eb] stacks."""
    return seg.stack_window_list(
        [(np.asarray(s, np.int32), np.asarray(d, np.int32))
         for s, d in windows], eb, vb)


def _clique(m, base=0):
    u, v = np.triu_indices(m, k=1)
    return u + base, v + base


def _clustered(rng, num_w, eb, vb, size, cross):
    """Sparse stacks [num_w, eb]: edges inside clusters of `size`
    vertices, plus `cross` random edges per window that merge clusters
    slowly, so the component count stays high and moves."""
    base = size * rng.integers(0, vb // size, (num_w, eb))
    s = base + rng.integers(0, size, (num_w, eb))
    d = base + rng.integers(0, size, (num_w, eb))
    s[:, :cross] = rng.integers(0, vb, (num_w, cross))
    return (s.astype(np.int32), d.astype(np.int32),
            np.ones((num_w, eb), bool))


def _fixture(name, eb, vb):
    """(prefix stack folded first, the chunk under test)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "zipf":
        src, dst = make_stream(16 * eb, vb, seed=3)
        _w, s, d, v = seg.window_stack(src, dst, eb, sentinel=vb)
        return (s[:8], d[:8], v[:8]), (s[8:], d[8:], v[8:])
    if name == "sparse":
        s, d, v = (x.reshape(2, 4, eb)
                   for x in _clustered(rng, 8, eb, vb, 4, 2))
        return (s[0], d[0], v[0]), (s[1], d[1], v[1])
    if name == "bipartite":      # even -> odd until the last window
        wins = [(2 * rng.integers(0, vb // 2, eb),
                 2 * rng.integers(0, vb // 2, eb) + 1) for _ in range(6)]
        ts, td = np.array([0, 2, 4]), np.array([2, 4, 0])
        wins[-1] = (np.concatenate([wins[-1][0][:eb - 3], ts]),
                    np.concatenate([wins[-1][1][:eb - 3], td]))
        st = _stack(wins, eb, vb)
        return tuple(x[:2] for x in st), tuple(x[2:] for x in st)
    # ragged: a self-loops-only window, a window of padding and a
    # partial window, padded to 8 windows as the engine pads a chunk
    loops = np.arange(0, vb, 3)[:eb // 4]
    src, dst = make_stream(5 * eb, vb, seed=9)
    wins = [(src[:eb], dst[:eb]), (loops, loops), ([], []),
            (src[eb:eb + eb // 3], dst[eb:eb + eb // 3])]
    sc, dc, vc, n = seg.pad_window_chunk(*_stack(wins, eb, vb), 0, 4, 64,
                                         eb, vb)
    assert n == 4 and sc.shape[0] == 8
    _w, ps, pd, pv = seg.window_stack(src[eb:], dst[eb:], eb, sentinel=vb)
    return (ps, pd, pv), (sc, dc, vc)


def _port(carry, chunk, vb, kb):
    carry = tuple(torch.from_numpy(np.array(a, np.int32)) for a in carry)
    summary = ws.WindowSummary(vb, kb, torch.device("cpu"))
    outs = summary(carry, *(torch.from_numpy(np.ascontiguousarray(x))
                            for x in chunk))
    assert [o.dtype for o in outs] == [torch.int32, torch.int32,
                                       torch.bool, torch.int32, torch.int32]
    return [c.numpy() for c in carry], [o.numpy() for o in outs]


@pytest.mark.parametrize("name,eb,vb,kb", [("zipf", 256, 256, 16),
                                           ("sparse", 128, 256, 8),
                                           ("bipartite", 64, 64, 8),
                                           ("ragged", 64, 128, 8)])
def test_chunk_matches_jax_body(jax_scan_fn, name, eb, vb, kb):
    prefix, chunk = _fixture(name, eb, vb)
    carry0 = host_summary.fold_windows(host_summary.fresh_carry(vb),
                                       *prefix)[0]
    carry, outs = _port(carry0, chunk, vb, kb)
    jcarry, jouts = jax_scan_fn(eb, vb, kb)(
        tuple(jnp.asarray(a) for a in carry0),
        *(jnp.asarray(x) for x in chunk))
    for got, want in zip(carry, jcarry):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(got, np.asarray(want))
    # and the numpy oracle, triangles exact
    hcarry, mdeg, ncomp, odd, tri = host_summary.fold_windows(carry0, *chunk)
    for got, want in zip(carry, hcarry):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(outs[0], mdeg)
    np.testing.assert_array_equal(outs[1], ncomp)
    np.testing.assert_array_equal(outs[2], odd)
    clean = outs[4] == 0
    np.testing.assert_array_equal(outs[3][clean], tri[clean])
    if name == "bipartite":
        assert not outs[2][:-1].any() and outs[2][-1]
    if name == "ragged":
        # padding joined the cover's two sentinels; the self-loop window
        # made every looped vertex an odd cycle
        assert carry[2][2 * vb + 1] == vb
        assert outs[2][1] and outs[3][1] == 0
    if name == "sparse":
        assert outs[1].min() > 10 and len(set(outs[1].tolist())) > 1


def test_k14_overflow_matches_jax(jax_scan_fn):
    """The K14 clique window of tests/operations/test_pallas_window.py
    at kb=8: overflow raised, and the plain count equal to the JAX
    body's even so."""
    ks, kd = _clique(14)
    rng = np.random.default_rng(5)
    src = np.concatenate([ks, rng.integers(0, 128, 20)])
    dst = np.concatenate([kd, rng.integers(0, 128, 20)])
    _w, s, d, v = seg.window_stack(src, dst, 128, sentinel=128)
    carry0 = host_summary.fresh_carry(128)
    carry, outs = _port(carry0, (s, d, v), 128, 8)
    jcarry, jouts = jax_scan_fn(128, 128, 8)(
        tuple(jnp.asarray(a) for a in carry0),
        jnp.asarray(s), jnp.asarray(d), jnp.asarray(v))
    assert outs[4][0] > 0
    for got, want in zip(list(carry) + outs, list(jcarry) + list(jouts)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_summary_wrapper_checks():
    vb, kb = 64, 8
    summary = ws.WindowSummary(vb, kb, torch.device("cpu"))
    carry = ws.fresh_carry(vb, "cpu")
    s = torch.full((2, 16), vb, dtype=torch.int32)
    v = torch.zeros((2, 16), dtype=torch.bool)
    outs = summary(carry, s, s.clone(), v)     # all padding: no-ops
    assert [o.tolist() for o in outs] == [[0, 0], [0, 0], [False, False],
                                          [0, 0], [0, 0]]
    assert carry[2][2 * vb + 1] == vb and carry[0].sum() == 0
    with pytest.raises(ValueError, match="given tensors on cpu"):
        ws.WindowSummary(vb, kb, torch.device("meta"))(carry, s, s, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ws.summarize(carry, s, s, v, vb,
                     torch.empty(3, 2, dtype=torch.int32))


# ----------------------------------------------------------------------
# the CUDA summary body's incremental bookkeeping (csrc/summary_body.cuh)
# ----------------------------------------------------------------------
def _find(p, x):
    """find_root<true> of union_find.cuh: the root of x, halving."""
    parent = p[x]
    while parent < x:
        grand = p[parent]
        if grand >= parent:
            return parent
        p[x] = grand
        x = grand
        parent = p[x]
    return x


def _unite(p, a, b):
    """unite of union_find.cuh, one thread: hooks the larger root under
    the smaller; returns whether it hooked."""
    a, b = _find(p, a), _find(p, b)
    if a == b:
        return False
    a, b = min(a, b), max(a, b)
    p[b] = a
    return True


def incremental_model(carry, src, dst, valid, vb):
    """The summary body's bookkeeping, one slot at a time in numpy: a
    pass over the carry for its own max degree, touched roots and odd;
    then per window the degree adds (max of old + 1, newly touched
    counted), the unions (hooks in labels counted), padding's sentinel
    join, num_components += touched − hooks, and odd (monotone) from the
    window's valid slots s with find(s) == find(s+vb+1); every slot of
    labels and cover compressed to its root at the end. Returns (carry,
    max_degree, num_components, odd), the outputs as [W] arrays."""
    deg, labels, cover = (np.array(a, np.int64) for a in carry)
    n = vb + 1
    touched = deg[:vb] > 0
    mdeg = int(deg[:vb].max())
    ncomp = int(np.sum(touched & (labels[:vb] == np.arange(vb))))
    odd = any(_find(cover, v) == _find(cover, v + n)
              for v in np.flatnonzero(touched))
    outs = []
    for w in range(src.shape[0]):
        fresh = hooks = 0
        ends = []
        for s, d, ok in zip(src[w].tolist(), dst[w].tolist(),
                            valid[w].tolist()):
            if ok and 0 <= s < vb and 0 <= d < vb:
                for x in (s, d):
                    fresh += deg[x] == 0
                    deg[x] += 1
                    mdeg = max(mdeg, int(deg[x]))
                hooks += _unite(labels, s, d)
                _unite(cover, s, d + n)
                _unite(cover, s + n, d)
                ends.append(s)
            else:
                _unite(cover, vb, 2 * vb + 1)
        ncomp += fresh - hooks
        odd = odd or any(_find(cover, s) == _find(cover, s + n)
                         for s in ends)
        outs.append((mdeg, ncomp, odd))
    labels = np.array([_find(labels, v) for v in range(n)])
    cover = np.array([_find(cover, v) for v in range(2 * n)])
    mdeg, ncomp, odd = (np.array(x) for x in zip(*outs))
    return ((deg.astype(np.int32), labels.astype(np.int32),
             cover.astype(np.int32)), mdeg, ncomp, odd)


def _model_fixture(name, eb, vb):
    """(prefix stack, the chunk under test) for the model's fixtures:
    the four of `_fixture` where they exist, plus a late odd cycle
    between vertices touched long before, self-loops only, and hubs."""
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    if name in ("sparse", "bipartite", "ragged"):
        return _fixture(name, eb, vb)
    if name == "late_odd":          # bipartite; window 2 closes 10-31-20
        s = 2 * rng.integers(0, vb // 2, (6, eb))
        d = 2 * rng.integers(0, vb // 2, (6, eb)) + 1
        s[0, :2], d[0, :2] = (10, 20), (31, 31)
        s[4, -1], d[4, -1] = 10, 20
        st = (s.astype(np.int32), d.astype(np.int32),
              np.ones((6, eb), bool))
        return tuple(x[:2] for x in st), tuple(x[2:] for x in st)
    if name == "loops":             # self-loops only
        x = rng.integers(0, vb, (4, eb)).astype(np.int32)
        pre = _clustered(rng, 2, eb, vb, 4, 2)
        return pre, (x, x.copy(), np.ones((4, eb), bool))
    # star: one of two hubs in all but 8 slots of each window
    s = rng.integers(0, vb, (4, eb)).astype(np.int32)
    d = rng.integers(0, vb, (4, eb)).astype(np.int32)
    s[:, :eb - 8] = np.array([[5], [77], [5], [77]])
    return _clustered(rng, 2, eb, vb, 4, 2), (s, d, np.ones((4, eb), bool))


def _carry_from(source, prefix, eb, vb, kb):
    """The carry the chunk starts from: the prefix folded by the numpy
    oracle, or a JAX StreamSummaryEngine's state_dict() carry after
    three Zipf windows."""
    if source == "fold":
        return host_summary.fold_windows(host_summary.fresh_carry(vb),
                                         *prefix)[0]
    eng = jax_scan.StreamSummaryEngine(eb, vb, k_bucket=kb,
                                       ingress="standard")
    src, dst = make_stream(3 * eb, vb, seed=23)
    eng.process(src, dst)
    return tuple(np.array(a) for a in eng.state_dict()["carry"])


@pytest.mark.parametrize("source", ["fold", "jax_engine"])
@pytest.mark.parametrize("name,eb,vb,kb", [("sparse", 128, 256, 8),
                                           ("bipartite", 64, 64, 8),
                                           ("late_odd", 64, 128, 8),
                                           ("loops", 64, 128, 8),
                                           ("ragged", 64, 128, 8),
                                           ("star", 128, 256, 8)])
def test_incremental_model_matches_plain_and_jax(jax_scan_fn, name, eb, vb,
                                                 kb, source):
    """The CUDA body's incremental summaries, modelled slot by slot, equal
    the plain version's and the JAX body's per window, and its carry
    after the call theirs bit for bit, from a carry that is not fresh
    (which the hosts' check accepts)."""
    prefix, chunk = _model_fixture(name, eb, vb)
    carry0 = _carry_from(source, prefix, eb, vb, kb)
    sa.check_summary_carry(carry0, vb)
    mcarry, mdeg, ncomp, odd = incremental_model(carry0, *chunk, vb)
    carry, outs = _port(carry0, chunk, vb, kb)
    jcarry, jouts = jax_scan_fn(eb, vb, kb)(
        tuple(jnp.asarray(np.array(a)) for a in carry0),
        *(jnp.asarray(x) for x in chunk))
    for got, plain, jax_leaf in zip(mcarry, carry, jcarry):
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_array_equal(got, np.asarray(jax_leaf))
    for got, i in ((mdeg, 0), (ncomp, 1), (odd, 2)):
        np.testing.assert_array_equal(got, outs[i])
        np.testing.assert_array_equal(got, np.asarray(jouts[i]))
    if source == "fold" and name in ("bipartite", "late_odd"):
        last = len(odd) - 1 if name == "bipartite" else 2
        assert not odd[:last].any() and odd[last:].all()
    if name == "loops":
        assert odd.all()
    if name == "star":
        assert mdeg[-1] >= 2 * (eb - 8)


def _broken_carries(carry, vb):
    """{what: carry} from a valid carry with untouched vertices: labels
    pointing an untouched vertex at another, a touched vertex at an
    untouched one, and a cover whose set is not closed under the
    mirror v <-> v+vb+1."""
    deg, labels, cover = (np.array(a) for a in carry)
    cold = np.flatnonzero(deg[:vb] == 0)
    hot = np.flatnonzero(deg[:vb] > 0)
    lo, hi = int(cold[0]), int(cold[1])
    up = int(hot[hot > lo][0])
    out = {}
    bad = labels.copy()
    bad[hi] = lo
    out["untouched moved"] = (deg, bad, cover)
    bad = labels.copy()
    bad[up] = lo
    out["points at untouched"] = (deg, bad, cover)
    bad = cover.copy()
    bad[hi] = lo                      # joins hi+ with lo+, not hi- with lo-
    out["cover not mirrored"] = (deg, labels, bad)
    return out


def test_carry_invariants_refused_on_load():
    """check_summary_carry refuses a carry that breaks the body's
    invariants (a vertex of degree 0 must be a singleton root in labels;
    the cover's sets closed under the mirror), directly and through
    StreamSummaryEngine.load_state_dict, and loads a JAX-made one."""
    eb, vb = 64, 256
    src, dst = make_stream(3 * eb, vb, seed=31)
    jeng = jax_scan.StreamSummaryEngine(eb, vb, k_bucket=8,
                                        ingress="standard")
    jeng.process(src, dst)
    state = jeng.state_dict()
    port = StreamSummaryEngine(eb, vb, k_bucket=8, device="cpu")
    port.load_state_dict(state)
    for what, carry in _broken_carries(state["carry"], vb).items():
        match = "mirror" if what == "cover not mirrored" else "degree 0"
        with pytest.raises(ValueError, match=match):
            sa.check_summary_carry(carry, vb)
        with pytest.raises(ValueError, match=match):
            port.load_state_dict(dict(state, carry=carry))
    # the refused loads left the engine as the JAX state made it
    for a, b in zip(port.state_dict()["carry"], state["carry"]):
        np.testing.assert_array_equal(a, np.asarray(b))
