"""The port's multi-tenant cohort (gelly_streaming_tpu_torch/core/
tenancy.py `TenantCohort`, ops/cohort_summary.py `CohortSummary`) on
device="cpu", held against the JAX package's
`TenantCohort` and `build_cohort_scan` (the XLA form: its Pallas cohort
kernel does not build on the installed JAX) and against N sequential
port `StreamSummaryEngine`s.

The JAX cohort's knobs are cleared as tests/test_tenancy.py clears them
(GS_AUTOTUNE=0: every ready tenant in one slab) and K is passed to both
packages. Every summary and carry slot is an integer or a bool:
equality, no tolerance, `tenant_state_dict` carries bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu.ops import resident_engine
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu_torch import (GnnTenantCohort, StreamSummaryEngine,
                                       TenantBackpressure, TenantCohort,
                                       TenantError, TenantRejected)
from gelly_streaming_tpu_torch.ops import cohort_summary as cs
from gelly_streaming_tpu_torch.ops import host_triangles
from gelly_streaming_tpu_torch.ops.scan_analytics import check_summary_carry
from gelly_streaming_tpu_torch.ops.window_counter import count_windows_plain
from gelly_streaming_tpu_torch.utils.streams import make_stream

EB, VB, KB = 128, 256, 16
_KNOBS = ("GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS", "GS_TENANT_ADMISSION",
          "GS_TENANT_TPD", "GS_AUTOTUNE", "GS_COHORT_RESIDENT",
          "GS_COHORT_PALLAS", "GS_OOO_BOUND", "GS_SANITIZE")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _clean_knobs():
    with pytest.MonkeyPatch.context() as mp:
        for k in _KNOBS:
            mp.delenv(k, raising=False)
        mp.setenv("GS_AUTOTUNE", "0")
        resident_engine._reset_resident_cohort()
        pallas_window._reset_pallas_window()
        yield
    resident_engine._reset_resident_cohort()
    pallas_window._reset_pallas_window()


def streams_for(n, windows=4, vb=VB, seed=60):
    """n tenant streams; every odd one ends in a partial window."""
    out = {}
    for i in range(n):
        edges = windows * EB - (EB // 3 if i % 2 else 0)
        s, d = make_stream(edges, vb, seed=seed + i)
        out["t%d" % i] = (s.astype(np.int32), d.astype(np.int32))
    return out


def run_cohort(co, streams, piece=2 * EB, admit_vb=None, demote_after=None):
    """Admit, then feed every tenant `piece` edges per round and pump,
    until the streams are in; `demote_after` = (round, tenant); close
    every tenant. Returns {tenant: summaries}."""
    for tid in streams:
        co.admit(tid, vertex_bucket=(admit_vb or {}).get(tid))
    out = {tid: [] for tid in streams}
    cursor = dict.fromkeys(streams, 0)
    rounds = 0
    while any(cursor[t] < len(s) for t, (s, _d) in streams.items()):
        for tid, (s, d) in streams.items():
            c = cursor[tid]
            if c < len(s):
                co.feed(tid, s[c:c + piece], d[c:c + piece])
                cursor[tid] = min(len(s), c + piece)
        for tid, res in co.pump().items():
            out[tid].extend(res)
        rounds += 1
        if demote_after and rounds == demote_after[0]:
            co.demote(demote_after[1], reason="test")
    for tid in streams:
        out[tid].extend(co.close(tid))
    return out


def port_cohort(**kw):
    return TenantCohort(EB, VB, k_bucket=KB, device="cpu", **kw)


def jax_cohort():
    return jax_tenancy.TenantCohort(EB, VB, k_bucket=KB)


def sequential(streams, vbs=None):
    """{tenant: (summaries, state_dict)} of one port engine per stream."""
    out = {}
    for tid, (s, d) in streams.items():
        eng = StreamSummaryEngine(EB, (vbs or {}).get(tid, VB), k_bucket=KB,
                                  device="cpu")
        out[tid] = (eng.process(s, d), eng.state_dict())
    return out


def assert_state_equal(a, b, cover=True):
    assert {k: v for k, v in a.items() if k != "carry"} == {
        k: v for k, v in b.items() if k != "carry"}
    for i, (x, y) in enumerate(zip(a["carry"], b["carry"])):
        if i == 2 and not cover:
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def assert_matches_engines(co, out, streams, vbs=None):
    """Summaries, cursors, degrees and labels of every tenant equal its
    sequential engine's (the cover may differ at slot 2vb+1)."""
    for tid, (want, state) in sequential(streams, vbs).items():
        assert out[tid] == want, tid
        assert_state_equal(co.tenant_state_dict(tid), state, cover=False)


_JAX_RUNS = {}


def jax_run(key, streams, **kw):
    """The JAX cohort's run over `streams` (memoised per key: each JAX
    cohort compiles its own programs)."""
    if key not in _JAX_RUNS:
        co = jax_cohort()
        out = run_cohort(co, streams, **kw)
        _JAX_RUNS[key] = (out, {t: co.tenant_state_dict(t) for t in streams})
    return _JAX_RUNS[key]


# ----------------------------------------------------------------------
# the cohort body: CohortSummary / summarize_cohort_plain
# ----------------------------------------------------------------------
def _slab(nb, wb, wins, seed, clique=None):
    """An [nb, wb, EB] slab: row n holds wins[n] Zipf windows (the last
    one of row 0 partial), the rest padding; `clique` puts the K14
    clique into row 1's first window."""
    s = np.full((nb, wb, EB), VB, np.int32)
    d = np.full((nb, wb, EB), VB, np.int32)
    v = np.zeros((nb, wb, EB), bool)
    for n, w in enumerate(wins):
        a, b = make_stream(w * EB, VB, seed=seed + n)
        s[n, :w], d[n, :w], v[n, :w] = (a.reshape(w, EB), b.reshape(w, EB),
                                        True)
    if wins[0]:
        tail = slice(EB // 3, None)
        s[0, wins[0] - 1, tail] = d[0, wins[0] - 1, tail] = VB
        v[0, wins[0] - 1, tail] = False
    if clique:
        u, w = np.triu_indices(14, k=1)
        s[1, 0, :len(u)], d[1, 0, :len(w)] = u, w
    return s, d, v


@pytest.mark.parametrize("kb,clique", [(KB, False), (8, True)])
def test_cohort_scan_matches_jax_xla(kb, clique):
    """A prefix slab, then a slab with ragged rows (8, 1, 3, 0, 2
    windows: a pad row, a partial window) from the carries it left:
    outputs and stacked carries bit-equal to the JAX vmapped scan; with
    the K14 clique at kb=8 the overflow agrees too."""
    nb, wb = 8, 8
    prefix = _slab(nb, wb, [8, 8, 8, 0, 8, 8, 8, 8], seed=10)
    slab = _slab(nb, wb, [8, 1, 3, 0, 2, 5, 4, 7], seed=30, clique=clique)
    summ = cs.CohortSummary(VB, kb, torch.device("cpu"))
    jrun = jax_scan.build_cohort_scan(EB, VB, kb)
    carries = cs.fresh_cohort_carry(nb, VB, "cpu")
    jcarries = tuple(jnp.array(c.numpy(), copy=True) for c in carries)
    for s, d, v in (prefix, slab):
        outs = summ(carries, *(torch.from_numpy(x) for x in (s, d, v)))
        jcarries, jouts = jrun(jcarries, jnp.asarray(s), jnp.asarray(d),
                               jnp.asarray(v))
        for got, want in zip(outs, jouts):
            assert tuple(got.shape) == (nb, wb)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(carries, jcarries):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(carries[2][3, 2 * VB + 1]) == VB    # the pad row's join
    if clique:
        assert int(outs[4][1, 0]) > 0


def test_cohort_body_rows_equal_the_window_body():
    """Each row of `summarize_cohort_plain` is the summary body over that
    row alone."""
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    s, d, v = (torch.from_numpy(x) for x in _slab(8, 8, [8, 2, 0, 5, 1, 8,
                                                          3, 6], seed=50))
    carries = cs.fresh_cohort_carry(8, VB, "cpu")
    outs = cs.summarize_cohort_plain(carries, s, d, v, VB, KB)
    for n in range(8):
        carry = ws.fresh_carry(VB, "cpu")
        want = ws.summarize_windows_plain(carry, s[n], d[n], v[n], VB, KB)
        for got, w in zip(outs, want):
            assert torch.equal(got[n], w)
        for got, w in zip(carries, carry):
            assert torch.equal(got[n], w)


def test_cohort_scan_refusals():
    """CohortSummary checks the slab and the carries on the CPU path as
    on the card: other row counts, a strided slab, other dtypes and
    another device raise, consuming nothing."""
    summ = cs.CohortSummary(VB, KB, torch.device("cpu"))
    carries = cs.fresh_cohort_carry(8, VB, "cpu")
    s, d, v = (torch.from_numpy(x) for x in _slab(8, 8, [1] * 8, seed=1))
    with pytest.raises(ValueError, match=r"deg must be .*\(4, 257\)"):
        summ(carries, s[:4], d[:4], v[:4])
    with pytest.raises(ValueError, match="src must be a contiguous"):
        summ(carries, s[..., ::2], d[..., ::2], v[..., ::2])
    with pytest.raises(ValueError, match="valid must be"):
        summ(carries, s, d, v.to(torch.int32))
    with pytest.raises(ValueError, match="cover must be"):
        summ(carries[:2] + (carries[2][:, :-2].contiguous(),), s, d, v)
    assert torch.equal(carries[0], torch.zeros(8, VB + 1, dtype=torch.int32))
    summ = cs.CohortSummary(VB, KB, torch.device("meta"))
    with pytest.raises(ValueError, match="given tensors on cpu"):
        summ(carries, s, d, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cs.summarize_cohort(carries, s, d, v, VB,
                            torch.empty(8, 3, 8, dtype=torch.int32))


def test_cohort_scan_refuses_calls_past_32_bit_indices():
    """A slab whose rows hold 2^31 carry slots or more in all is refused
    before any launch: the summary body indexes a call in 32 bits
    (shapes only, on the meta device)."""
    nb, w, eb, vb = 3, 2, 64, 1 << 28
    summ = cs.CohortSummary(vb, KB, torch.device("meta"))
    carries = tuple(torch.empty(nb, k * (vb + 1), dtype=torch.int32,
                                device="meta") for k in (1, 1, 2))
    s, d = (torch.empty(nb, w, eb, dtype=torch.int32, device="meta")
            for _ in range(2))
    v = torch.empty(nb, w, eb, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported shape"):
        summ(carries, s, d, v)


def test_counter_one_call_over_dispatch():
    """The triangle stage of a dispatch is one counter call over the
    whole [nb·W, eb] slab (the kernel's scratch is per block, so nothing
    is cut into pieces): its (count, overflow) equal `count_windows_plain`
    over the flat slab and the JAX cohort scan's triangles and overflow
    row by row, the K14 clique window at kb=8 included; the counter
    refuses an output it cannot write."""
    nb, wb = 3, 4
    s, d, v = _slab(nb, wb, [4, 3, 2], seed=91, clique=True)
    summ = cs.CohortSummary(VB, 8, torch.device("cpu"))
    got = summ.count(*(torch.from_numpy(x) for x in (s, d, v)))
    want = count_windows_plain(*(torch.from_numpy(x.reshape(nb * wb, EB))
                                 for x in (s, d, v)), VB, 8)
    jrun = jax_scan.build_cohort_scan(EB, VB, 8)
    carries = tuple(jnp.asarray(c.numpy())
                    for c in cs.fresh_cohort_carry(nb, VB, "cpu"))
    _jc, jouts = jrun(carries, jnp.asarray(s), jnp.asarray(d),
                      jnp.asarray(v))
    for g, w, j in zip(got, want, (jouts[3], jouts[4])):
        assert g.shape == (nb * wb,) and torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy().reshape(nb, wb),
                                      np.asarray(j))
    assert int(got[1][wb]) > 0                     # the clique overflowed
    with pytest.raises(ValueError, match="out must be"):
        summ.counter(*(torch.from_numpy(x[0]) for x in (s, d, v)),
                     out=(torch.empty(wb, dtype=torch.int64),
                          torch.empty(wb, dtype=torch.int32)))


def _root(p, x):
    while p[x] != x:
        x = p[x]
    return x


def assert_summary_invariants(carry, vb):
    """The invariants the CUDA summary body reads its summaries on,
    checked slot by slot: a vertex of degree 0 is a singleton root in
    labels, and the mirror v <-> v+vb+1 maps each set of the cover onto
    one set."""
    deg, labels, cover = (np.asarray(a) for a in carry)
    for u in range(vb + 1):
        if labels[u] != u:
            assert deg[u] > 0 and deg[labels[u]] > 0, u
    n = vb + 1
    mirror_of = {}
    for x in range(2 * n):
        r, rm = _root(cover, x), _root(cover, (x + n) % (2 * n))
        assert mirror_of.setdefault(r, rm) == rm, x


def test_cohort_carries_keep_the_summary_invariants():
    """Every carry the cohorts and engines make satisfies the invariants
    (`check_summary_carry` accepts it, and the slot-by-slot check holds):
    tenants in the port's and the JAX cohort, a demoted tenant on its
    engine, the sequential port engines, and the rows of a slab with a
    pad row and ragged rows."""
    streams = streams_for(3)
    co = port_cohort()
    run_cohort(co, streams, demote_after=(1, "t1"))
    assert co.tenant_tier("t1") == "single"
    _jout, jstates = jax_run("demote", streams, demote_after=(1, "t1"))
    carries = [co.tenant_state_dict(t)["carry"] for t in streams]
    carries += [jstates[t]["carry"] for t in streams]
    carries += [state["carry"] for _out, state in
                sequential(streams).values()]
    slab = (torch.from_numpy(x) for x in _slab(4, 4, [4, 1, 0, 2], seed=92))
    rows = cs.fresh_cohort_carry(4, VB, "cpu")
    cs.CohortSummary(VB, KB, torch.device("cpu"))(rows, *slab)
    assert int(rows[2][2, 2 * VB + 1]) == VB       # the pad row's join
    carries += [tuple(c[n].numpy() for c in rows) for n in range(4)]
    for carry in carries:
        check_summary_carry(carry, VB)
        assert_summary_invariants(carry, VB)


def test_tenant_load_refuses_carries_breaking_the_invariants():
    """load_tenant_state_dict loads a JAX cohort's tenant state, and
    refuses (ValueError, the tenant unchanged) one whose labels point an
    untouched vertex elsewhere or a vertex at an untouched one, or whose
    cover is not closed under the mirror."""
    s, d = streams_for(1)["t0"]
    jco = jax_cohort()
    jco.admit("a")
    jco.feed("a", s[:2 * EB], d[:2 * EB])
    jco.pump()
    state = jco.tenant_state_dict("a")
    co = port_cohort()
    co.admit("a")
    co.load_tenant_state_dict("a", state)
    deg, labels, cover = (np.array(a) for a in state["carry"])
    cold = np.flatnonzero(deg[:VB] == 0)
    hot = np.flatnonzero(deg[:VB] > 0)
    lo, hi = int(cold[0]), int(cold[1])
    up = int(hot[hot > lo][0])
    broken = []
    for slot, to in ((hi, lo), (up, lo)):
        bad = labels.copy()
        bad[slot] = to
        broken.append(((deg, bad, cover), "degree 0"))
    bad = cover.copy()
    bad[hi] = lo
    broken.append(((deg, labels, bad), "mirror"))
    for carry, match in broken:
        with pytest.raises(ValueError, match=match):
            co.load_tenant_state_dict("a", dict(state, carry=carry))
        assert_state_equal(co.tenant_state_dict("a"), state)


# ----------------------------------------------------------------------
# TenantCohort against the JAX cohort and the sequential engines
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n_tenants", [1, 3, 8])
def test_cohort_matches_jax_and_engines(n_tenants):
    """Ragged cohorts (partial tails cut by close(), pad rows on
    non-power-of-two populations): summaries and tenant_state_dict equal
    to the JAX cohort's, summaries, degrees and labels to N sequential
    engines."""
    streams = streams_for(n_tenants)
    co = port_cohort()
    out = run_cohort(co, streams)
    jout, jstates = jax_run(("plain", n_tenants), streams)
    assert out == jout
    for tid in streams:
        assert_state_equal(co.tenant_state_dict(tid), jstates[tid])
        assert co.windows_done(tid) == len(out[tid])
        assert co.resume_offset(tid) == len(out[tid]) * EB
    assert_matches_engines(co, out, streams)


def test_mixed_vertex_buckets():
    """Tenants at their own vertex buckets dispatch one slab per group,
    equal to the JAX cohort and to engines at those buckets."""
    streams = dict(streams_for(2), big=tuple(
        x.astype(np.int32) for x in make_stream(3 * EB + 5, 2 * VB, seed=91)))
    vbs = {"big": 2 * VB}
    co = port_cohort()
    out = run_cohort(co, streams, admit_vb=vbs)
    jout, jstates = jax_run("mixed", streams, admit_vb=vbs)
    assert out == jout
    for tid in streams:
        assert_state_equal(co.tenant_state_dict(tid), jstates[tid])
    assert co.tenants["big"].vb == 2 * VB
    assert_matches_engines(co, out, streams, vbs)
    assert sorted(co._summaries) == [VB, 2 * VB]


def test_tenants_per_dispatch_two(monkeypatch):
    """tenants_per_dispatch=2 over 5 tenants: three dispatches a round,
    equal to the JAX cohort under GS_TENANT_TPD=2 (state bit for bit:
    nb is the bucket of each batch) and to the engines."""
    streams = streams_for(5)
    co = port_cohort(tenants_per_dispatch=2)
    sizes = []
    prep = co._prep_slab
    co._prep_slab = lambda b, w: sizes.append(len(b)) or prep(b, w)
    out = run_cohort(co, streams)
    assert sizes[:3] == [2, 2, 1]
    monkeypatch.setenv("GS_TENANT_TPD", "2")
    jco = jax_cohort()
    assert out == run_cohort(jco, streams)
    for tid in streams:
        assert_state_equal(co.tenant_state_dict(tid),
                           jco.tenant_state_dict(tid))
    assert_matches_engines(co, out, streams)


def test_demotion_mid_stream():
    """One tenant demoted after the first round runs on its own port
    StreamSummaryEngine; every tenant still equals the JAX cohort (with
    the same demotion) and the sequential engines."""
    streams = streams_for(3)
    co = port_cohort()
    out = run_cohort(co, streams, demote_after=(1, "t1"))
    assert co.tenant_tier("t1") == "single"
    assert co.tenant_tier("t0") == "cohort"
    assert isinstance(co.tenants["t1"].engine, StreamSummaryEngine)
    jout, jstates = jax_run("demote", streams, demote_after=(1, "t1"))
    assert out == jout
    for tid in streams:
        assert_state_equal(co.tenant_state_dict(tid), jstates[tid])
    assert_matches_engines(co, out, streams)
    co.demote("t1")                                  # idempotent
    assert co.tenant_tier("t1") == "single"


def test_queue_depths_and_window_ceiling():
    """Unequal queue depths in one pump pad the window axis per tenant;
    a queue deeper than windows_per_dispatch (8) folds in rounds of 8;
    pump(max_rounds=1) stops after one round."""
    streams = streams_for(2, windows=12)
    co = port_cohort(queue_windows=16)
    for tid in streams:
        co.admit(tid)
    (s0, d0), (s1, d1) = streams["t0"], streams["t1"]
    co.feed("t0", s0, d0)                   # 12 windows deep
    co.feed("t1", s1[:EB], d1[:EB])          # 1 window deep
    first = co.pump(max_rounds=1)
    assert len(first["t0"]) == 8 and len(first["t1"]) == 1
    rest = co.pump()
    assert len(rest["t0"]) == 4 and "t1" not in rest
    co.feed("t1", s1[EB:], d1[EB:])
    out = {"t0": first["t0"] + rest["t0"] + co.close("t0"),
           "t1": first["t1"] + co.pump()["t1"] + co.close("t1")}
    assert_matches_engines(co, out, streams)


@pytest.mark.parametrize("wpd,wc", [(5, 8), (16, 16)])
def test_windows_per_dispatch_matches_jax(wpd, wc, monkeypatch):
    """The window ceiling is the bucket of windows_per_dispatch (at
    least 8, as the JAX cohort's). Over queues 20, 3 and 11 windows
    deep each slab's wb, and so the cover's sentinel slot, follows the
    ceiling; summaries and tenant_state_dict equal the JAX cohort's at
    the same ceiling, summaries, degrees and labels the engines'."""
    streams = {tid: streams_for(3, windows=w)[tid]
               for tid, w in (("t0", 20), ("t1", 3), ("t2", 11))}
    co = port_cohort(windows_per_dispatch=wpd, queue_windows=24)
    assert co.wc == wc
    sizes = []
    prep = co._prep_slab
    co._prep_slab = lambda b, w: sizes.append(max(w)) or prep(b, w)
    out = run_cohort(co, streams, piece=20 * EB)
    assert max(sizes) == wc
    monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "24")
    jco = jax_tenancy.TenantCohort(EB, VB, k_bucket=KB,
                                   windows_per_dispatch=wpd)
    assert out == run_cohort(jco, streams, piece=20 * EB)
    for tid in streams:
        assert_state_equal(co.tenant_state_dict(tid),
                           jco.tenant_state_dict(tid))
    assert_matches_engines(co, out, streams)


def test_close_drains_only_the_closing_tenant():
    streams = streams_for(2)
    co = port_cohort()
    for tid, (s, d) in streams.items():
        co.admit(tid)
        co.feed(tid, s, d)
    got0 = co.close("t0")
    assert co.queued_edges("t1") == len(streams["t1"][0])
    got1 = co.pump()["t1"] + co.close("t1")
    assert co.close("t1") == []
    assert_matches_engines(co, {"t0": got0, "t1": got1}, streams)


def test_k_overflow_recounted_exactly():
    """The K14 clique at kb=8 overflows the cohort's counter and is
    recounted by the 4·K kernel: exact, and equal to the JAX cohort."""
    u, v = np.triu_indices(14, k=1)
    s, d = make_stream(3 * EB, VB, seed=5)
    s, d = s.astype(np.int32), d.astype(np.int32)
    s[EB:EB + len(u)], d[EB:EB + len(v)] = u, v
    streams = {"k": (s, d)}
    co = TenantCohort(EB, VB, k_bucket=8, device="cpu")
    out = run_cohort(co, streams)
    want = [host_triangles.window_count(s[a:a + EB], d[a:a + EB])
            for a in range(0, len(s), EB)]
    assert [w["triangles"] for w in out["k"]] == want and want[1] >= 364
    assert list(co._tri_redo) == [VB]
    jco = jax_tenancy.TenantCohort(EB, VB, k_bucket=8)
    assert out == run_cohort(jco, streams)


# ----------------------------------------------------------------------
# state carried across packages
# ----------------------------------------------------------------------
def test_jax_cohort_checkpoint_resumed_in_port():
    """A JAX cohort's state_dict() after two rounds loads into a fresh
    port cohort (admitting its tenants), which finishes the streams equal
    to an uninterrupted JAX cohort; and the other way round."""
    streams = streams_for(3)
    whole, wstates = jax_run(("plain", 3), streams)
    cut = 2 * EB
    for first, second in ((jax_cohort(), port_cohort()),
                          (port_cohort(), jax_cohort())):
        head = {tid: [] for tid in streams}
        for tid, (s, d) in streams.items():
            first.admit(tid)
            first.feed(tid, s[:cut], d[:cut])
        for tid, res in first.pump().items():
            head[tid].extend(res)
        second.load_state_dict(first.state_dict())
        assert sorted(second.tenants) == sorted(streams)
        for tid, (s, d) in streams.items():
            off = second.resume_offset(tid)
            assert off == cut
            second.feed(tid, s[off:], d[off:])
        for tid, res in second.pump().items():
            head[tid].extend(res)
        for tid in streams:
            head[tid].extend(second.close(tid))
            assert_state_equal(second.tenant_state_dict(tid), wstates[tid])
        assert head == whole


def test_tenant_state_loads_into_engines_both_ways():
    """A port tenant's state loads into the JAX and the port
    StreamSummaryEngine, which finish the stream equal to the cohort; an
    engine's state loads into a port tenant, which finishes it equal."""
    s, d = streams_for(1, windows=5)["t0"]
    cut = 2 * EB
    co = port_cohort()
    co.admit("a")
    co.feed("a", s[:cut], d[:cut])
    head = co.pump()["a"]
    state = co.tenant_state_dict("a")
    co.feed("a", s[cut:], d[cut:])
    tail = co.pump()["a"] + co.close("a")
    for eng in (jax_scan.StreamSummaryEngine(EB, VB, k_bucket=KB,
                                             ingress="standard"),
                StreamSummaryEngine(EB, VB, k_bucket=KB, device="cpu")):
        eng.load_state_dict(state)
        assert eng.process(s[cut:], d[cut:]) == tail
        assert_state_equal(eng.state_dict(), co.tenant_state_dict("a"))
    for eng in (jax_scan.StreamSummaryEngine(EB, VB, k_bucket=KB,
                                             ingress="standard"),
                StreamSummaryEngine(EB, VB, k_bucket=KB, device="cpu")):
        assert eng.process(s[:cut], d[:cut]) == head
        other = port_cohort()
        other.admit("b")
        other.load_tenant_state_dict("b", eng.state_dict())
        other.feed("b", s[cut:], d[cut:])
        assert other.pump()["b"] + other.close("b") == tail


def test_closed_partial_refusal_and_load_checks():
    """A tenant restored after its short final window was cut refuses
    more stream; loads at other buckets, with a cursor past the carry or
    a carry that is not a forest are refused."""
    s, d = streams_for(2)["t1"]
    co = port_cohort()
    co.admit("a")
    co.feed("a", s, d)
    co.close("a")
    state = co.tenant_state_dict("a")
    assert state["closed_partial"]
    for other in (port_cohort(), jax_cohort()):
        other.admit("a")
        other.load_tenant_state_dict("a", state)
        with pytest.raises(ValueError, match="partial window"):
            other.feed("a", s[:1], d[:1])
    fresh = port_cohort()
    fresh.admit("a")
    fresh.admit("big", vertex_bucket=2 * VB)
    with pytest.raises(ValueError, match="bucket mismatch"):
        fresh.load_tenant_state_dict("big", state)
    with pytest.raises(ValueError, match="wal_offset"):
        fresh.load_tenant_state_dict("a", dict(state, wal_offset=10 ** 6))
    bad = (state["carry"][0], np.roll(state["carry"][1], 1),
           state["carry"][2])
    with pytest.raises(ValueError, match="equal or smaller"):
        fresh.load_tenant_state_dict("a", dict(state, carry=bad))
    with pytest.raises(ValueError, match="bucket mismatch"):
        TenantCohort(2 * EB, VB, device="cpu").load_state_dict(
            co.state_dict())
    assert fresh.windows_done("a") == 0 and fresh.queued_edges("a") == 0


# ----------------------------------------------------------------------
# admission, backpressure, the id check and the event-time guard
# ----------------------------------------------------------------------
def test_admission_cap_and_typed_ids():
    co = port_cohort(max_tenants=2)
    co.admit("a")
    co.admit("b")
    with pytest.raises(TenantRejected) as ei:
        co.admit("c")
    assert ei.value.tenant == "c" and "max_tenants=2" in str(ei.value)
    with pytest.raises(TenantRejected):
        co.admit("a")
    with pytest.raises(TenantRejected):
        co.feed("ghost", [0], [1])
    with pytest.raises(TenantRejected):
        co.tenant_tier("ghost")
    assert co.close("a") == []
    with pytest.raises(TenantRejected):
        co.feed("a", [0], [1])
    co.admit("c")                 # a closed tenant frees its place
    assert isinstance(ei.value, TenantError)
    with pytest.raises(ValueError, match="admission"):
        TenantCohort(EB, VB, device="cpu", admission="queue")


def test_backpressure_reject_is_atomic():
    co = port_cohort(queue_windows=2)
    co.admit("a")
    s, d = make_stream(2 * EB, VB, seed=1)
    assert co.feed("a", s, d) == 2 * EB
    with pytest.raises(TenantBackpressure) as ei:
        co.feed("a", s[:1], d[:1])
    assert (ei.value.queued, ei.value.capacity) == (2 * EB, 2 * EB)
    assert ei.value.tenant == "a"
    assert co.queued_edges("a") == 2 * EB
    co.pump()
    assert co.feed("a", s[:1], d[:1]) == 1


def test_backpressure_drop_sheds_and_counts():
    co = port_cohort(queue_windows=1, admission="drop")
    co.admit("a")
    s, d = make_stream(2 * EB, VB, seed=2)
    assert co.feed("a", s, d) == EB
    assert co.tenants["a"].dropped_edges == EB
    want = StreamSummaryEngine(EB, VB, k_bucket=KB, device="cpu").process(
        s[:EB], d[:EB])
    assert co.pump()["a"] == want


def test_feed_checks_ids_and_lengths():
    co = port_cohort()
    co.admit("a")
    with pytest.raises(ValueError, match="dense in"):
        co.feed("a", [VB], [0])
    with pytest.raises(ValueError, match="dense in"):
        co.feed("a", [0], [-1])
    with pytest.raises(ValueError, match="length mismatch"):
        co.feed("a", [0, 1], [1])
    assert co.queued_edges("a") == 0


def test_event_time_guard_is_per_tenant():
    """Disjoint interleaved clocks are fine and fold exactly; a
    regression within a batch or against the tenant's newest stamp
    refuses the whole batch for that tenant only."""
    streams = streams_for(2, windows=2)
    (s0, d0), (s1, d1) = streams["t0"], streams["t1"]
    co = port_cohort()
    co.admit("t0")
    co.admit("t1")
    bad = np.arange(EB, dtype=np.int64)
    bad[EB // 2] = 0
    with pytest.raises(ValueError, match="WITHIN the batch"):
        co.feed("t0", s0[:EB], d0[:EB], ts=bad)
    with pytest.raises(ValueError, match="ts column length"):
        co.feed("t0", s0[:EB], d0[:EB], ts=bad[:3])
    assert co.queued_edges("t0") == 0
    co.feed("t0", s0[:EB], d0[:EB], ts=np.arange(10 ** 6, 10 ** 6 + EB))
    co.feed("t1", s1[:EB], d1[:EB], ts=np.arange(EB))
    with pytest.raises(ValueError, match="t0.*already reached"):
        co.feed("t0", s0[EB:], d0[EB:], ts=np.arange(EB))
    assert co.queued_edges("t0") == EB
    co.feed("t0", s0[EB:], d0[EB:],
            ts=np.arange(10 ** 6 + EB, 10 ** 6 + 2 * EB))
    co.feed("t1", s1[EB:], d1[EB:], ts=np.arange(EB, EB + len(s1) - EB))
    out = co.pump()
    for tid in streams:
        out[tid] = out.get(tid, []) + co.close(tid)
    assert_matches_engines(co, out, streams)


def test_cohorts_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        TenantCohort(EB, VB)
    with pytest.raises(RuntimeError):
        GnnTenantCohort(EB, VB)
    assert TenantCohort(EB, VB, device="cpu").device.type == "cpu"
