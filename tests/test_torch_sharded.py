"""The port's sharded engines (gelly_streaming_tpu_torch/parallel/)
against the JAX package's parallel/ on the 8-device virtual CPU mesh of
tests/conftest.py, at the same n (JAX make_mesh(n)): n=1 in this process
(a one-rank gloo group), n=3 and n=4 in two gloo groups of that many
ranks spawned for the whole file by tests/torch_mesh_worker.py, started
together at the first test, each a batch of scenarios that returns numpy
results. Checks: the raw (count, bucket_overflow, k_overflow) of each
window of make_sharded_window_triangle_fn in both table modes; the
kernel's ladder and count_stream / count_windows; degrees, CC labels,
bipartite and the triangle table of ShardedWindowEngine; sliding_reduce
in both tiers (float sums to 1e-5·Σ|v| a cell); ShardedSummaryEngine's
summaries and states, resumed across the packages and mesh sizes; every
rank's results equal; the wire check; the hybrid mesh; make_mesh(n) on
a larger world."""

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.parallel import host_twin as jax_twin
from gelly_streaming_tpu.parallel import mesh as jax_mesh
from gelly_streaming_tpu.parallel import multihost as jax_multihost
from gelly_streaming_tpu.parallel import sharded as jax_sharded
from gelly_streaming_tpu_torch.parallel import host_twin, mesh, sharded
from tests import torch_mesh_worker as W

SIZES = (1, 3, 4)
GROUP_SCENARIOS = {3: ["raw", "count", "engine", "summary", "wire",
                       "subset"],
                   4: ["raw", "count", "engine", "summary", "wire",
                       "hybrid", "subset"]}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Groups:
    """The n>1 groups, started at once; each joined at its first read.
    n=1 runs the same scenarios in this process."""

    def __init__(self, tmp_factory):
        self._groups = {n: W.Group(n, tmp_factory.mktemp("gloo%d" % n),
                                   names)
                        for n, names in GROUP_SCENARIOS.items()}
        self._ranks = {}
        self._one = {}

    def ranks(self, n: int) -> list:
        if n not in self._ranks:
            self._ranks[n] = self._groups[n].join()
        return self._ranks[n]

    def get(self, n: int, name: str):
        if n == 1:
            if name not in self._one:
                self._one[name] = W.SCENARIOS[name](one_rank_mesh())
            return self._one[name]
        return self.ranks(n)[0][name]

    def close(self):
        for n in self._groups:
            if n not in self._ranks:
                try:
                    self.ranks(n)
                except AssertionError:
                    pass


_MADE_GROUP = []


def one_rank_mesh():
    """The one-rank gloo mesh of this process (made once)."""
    if not dist.is_initialized():
        _MADE_GROUP.append(True)
    return mesh.make_mesh(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    g = _Groups(tmp_path_factory)
    yield g
    g.close()
    if _MADE_GROUP and dist.is_initialized():
        dist.destroy_process_group()
        _MADE_GROUP.clear()


_JAX = {}


def jax_once(key, make):
    if key not in _JAX:
        _JAX[key] = make()
    return _JAX[key]


# ----------------------------------------------------------------------
# the window counter's raw triples, both table modes
# ----------------------------------------------------------------------

def _jax_raw(n: int) -> dict:
    jm = jax_mesh.make_mesh(n)
    out = {}
    for table in W.TABLES:
        for kb, cap in W.raw_configs(n):
            fn = jax_sharded.make_sharded_window_triangle_fn(
                jm, W.EB, W.VB, kb, cap, table=table)
            out[(table, kb, cap)] = np.array(
                [[int(x) for x in fn(s, d, v)]
                 for s, d, v in W.window_fixtures()])
    return out


@pytest.mark.parametrize("n", SIZES)
def test_window_raw_triples_match_jax(groups, n):
    got = groups.get(n, "raw")
    want = jax_once(("raw", n), lambda: _jax_raw(n))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))
    # the fixtures reach both overflows
    small = want[("replicated",) + W.raw_configs(n)[0]]
    assert small[:, 1].any() and small[:, 2].any()


@pytest.mark.parametrize("n", SIZES)
def test_table_modes_give_one_count_where_clean(groups, n):
    got = groups.get(n, "raw")
    for kb, cap in W.raw_configs(n):
        rep, own = got[("replicated", kb, cap)], got[("owner", kb, cap)]
        np.testing.assert_array_equal(rep, own)
        clean = (rep[:, 1] == 0) & (rep[:, 2] == 0)
        for (s, d, v), c, ok in zip(W.window_fixtures(), rep[:, 0], clean):
            if ok:
                assert c == jax_tri.triangle_count_sparse(s[v], d[v], W.VB)


# ----------------------------------------------------------------------
# the kernel: the ladder, count_stream, count_windows
# ----------------------------------------------------------------------

def _exact(src, dst, eb):
    return [jax_tri.triangle_count_sparse(src[i:i + eb], dst[i:i + eb],
                                          W.VB)
            for i in range(0, len(src), eb)]


@pytest.mark.parametrize("n", SIZES)
def test_count_ladder_and_streams_are_exact(groups, n):
    got = groups.get(n, "count")
    src, dst = W.stream_fixture()
    for table in W.TABLES:
        eb = got[(table, "buckets")][0]
        assert got[(table, "stream")] == _exact(src, dst, eb)
        want = [jax_tri.triangle_count_sparse(s[v], d[v], W.VB)
                for s, d, v in W.window_fixtures()]
        assert got[(table, "count")] == want
        assert got[(table, "windows")] == want


@pytest.mark.parametrize("n,table", [(1, "owner"), (3, "replicated"),
                                     (4, "owner")])
def test_count_matches_jax_kernel(groups, n, table):
    got = groups.get(n, "count")

    def run():
        k = jax_sharded.ShardedTriangleWindowKernel(
            jax_mesh.make_mesh(n), 512, W.VB, k_bucket=8, table=table)
        src, dst = W.stream_fixture()
        return {"buckets": (k.eb, k.vb, k.kb, k.kb_max, k.cap),
                "stream": k.count_stream(src, dst),
                "count": [k.count(s[v], d[v])
                          for s, d, v in W.window_fixtures()]}

    want = jax_once(("count", n, table), run)
    for key in ("buckets", "stream", "count"):
        assert tuple(got[(table, key)]) == tuple(want[key]), key


# ----------------------------------------------------------------------
# the window engine
# ----------------------------------------------------------------------

def _jax_engine(n: int) -> dict:
    eng = jax_sharded.ShardedWindowEngine(jax_mesh.make_mesh(n),
                                          num_vertices_bucket=W.ENG_VB)
    a, b, c = W.engine_batches()
    out = {"deg1": eng.degrees(*a), "deg2": eng.degrees(*b),
           "cc1": eng.cc_labels(*a, carry=False),
           "cc2": eng.cc_labels(*b), "cc3": eng.cc_labels(*c),
           "bip1": eng.bipartite(*b, carry=False),
           "bip2": eng.bipartite(*c)}
    nbr, ta, tb = W.oriented_table(*a, 50)
    out["tri"] = eng.triangles(nbr, ta, tb, np.ones(len(ta), bool))
    out["state"] = eng.state_dict()
    return out


def _jax_panes() -> dict:
    """The JAX sliding reduces, at n=4 (their values do not depend on
    n, the float sums' rounding apart)."""
    out = {}
    pe = jax_sharded.ShardedWindowEngine(jax_mesh.make_mesh(4),
                                         num_vertices_bucket=W.PANE["vb"])
    pb, wp = W.PANE["pb"], W.PANE["wp"]
    for dtype in (np.int32, np.float32):
        src, pane, val = W.pane_fixture(dtype)
        for name in ("sum", "min", "max"):
            out[("pane", name, np.dtype(dtype).name)] = pe.sliding_reduce(
                src, pane, val, pb, wp, name=name)
    src, pane, val = W.pane_fixture(np.int32)
    out[("pane", "gcd")] = pe.sliding_reduce(src, pane, np.abs(val) + 1,
                                             pb, wp, fn=jnp.gcd)
    out[("pane", "fn_min")] = pe.sliding_reduce(src, pane, val, pb, wp,
                                                fn=jnp.minimum)
    return out


@pytest.mark.parametrize("n", SIZES)
def test_window_engine_matches_jax(groups, n):
    got = groups.get(n, "engine")
    want = jax_once(("engine", n), lambda: _jax_engine(n))
    for key in ("deg1", "deg2", "cc1", "cc2", "cc3"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("bip1", "bip2"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w, err_msg=key)
    assert got["tri"] == want["tri"]
    assert got["tri"] == jax_tri.triangle_count_sparse(
        *W.engine_batches()[0], 50)
    gs, ws = got["state"], want["state"]
    assert gs["mesh_shape"] == ws["mesh_shape"] == [n]
    # the degree slab's sentinel slot vb+1 holds the mesh padding, as
    # in the JAX engine at the same n
    for key in ("degree_state", "labels", "bip_labels"):
        np.testing.assert_array_equal(gs[key], np.asarray(ws[key]),
                                      err_msg=key)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tier", ["monoid", "assoc"])
def test_sliding_reduce_matches_jax(groups, n, tier):
    got = groups.get(n, "engine")
    want = jax_once("panes", _jax_panes)
    keys = ([k for k in want if k[:1] == ("pane",) and len(k) == 3]
            if tier == "monoid" else [("pane", "gcd"), ("pane", "fn_min")])
    for key in keys:
        (gv, gc), (wv, wc) = got[key], want[key]
        np.testing.assert_array_equal(gc, wc, err_msg=str(key))
        occupied = wc > 0
        if key[1:] == ("sum", "float32"):
            # the float sums: 1e-5·Σ|v| of each cell
            src, pane, val = W.pane_fixture(np.float32)
            wpn = W.PANE["wp"]
            for w, v in zip(*np.nonzero(occupied)):
                m = (src == v) & (pane >= w - wpn + 1) & (pane <= w)
                tol = 1e-5 * np.abs(val[m].astype(np.float64)).sum()
                assert abs(float(gv[w, v]) - float(wv[w, v])) <= tol, \
                    (w, v)
        elif tier == "monoid":
            np.testing.assert_array_equal(gv, wv, err_msg=str(key))
        else:
            np.testing.assert_array_equal(gv[occupied], wv[occupied],
                                          err_msg=str(key))
    if tier == "assoc":
        # the fn tier's min equals the monoid tier's on occupied cells
        (fv, fc), (mv, mc) = got[("pane", "fn_min")], \
            got[("pane", "min", "int32")]
        np.testing.assert_array_equal(fc, mc)
        np.testing.assert_array_equal(fv[fc > 0], mv[mc > 0])
        # gcd as a left fold in edge order, pane by pane
        gv, gc = got[("pane", "gcd")]
        src, pane, val = W.pane_fixture(np.int32)
        pos = np.abs(val) + 1
        wpn = W.PANE["wp"]
        for w, v in list(zip(*np.nonzero(gc > 0)))[:40]:
            acc = None
            for p in range(max(w - wpn + 1, 0), w + 1):
                for x in pos[(src == v) & (pane == p)].tolist():
                    acc = x if acc is None else math.gcd(acc, x)
            assert gv[w, v] == acc


# ----------------------------------------------------------------------
# the summary engine; states across the packages and the mesh sizes
# ----------------------------------------------------------------------

def _jax_summary(n: int) -> dict:
    src, dst = W.summary_fixture()
    jm = jax_mesh.make_mesh(n)
    eng = jax_sharded.ShardedSummaryEngine(jm, W.SUM_EB, W.SUM_VB,
                                           k_bucket=8)
    cut = 4 * eng.eb
    first = eng.process(src[:cut], dst[:cut])
    mid = eng.state_dict()
    rest = eng.process(src[cut:], dst[cut:])
    return {"summaries": first + rest, "mid": mid,
            "final": eng.state_dict(), "state": eng.state(), "eb": eng.eb}


def _same_state(got: dict, want: dict) -> None:
    for key in ("edge_bucket", "vertex_bucket", "windows_done",
                "closed_partial", "wal_offset"):
        assert got[key] == want[key], key
    for a, b in zip(got["carry"], want["carry"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n", SIZES)
def test_summary_engine_matches_jax(groups, n):
    got = groups.get(n, "summary")
    want = jax_once(("summary", n), lambda: _jax_summary(n))
    assert got["eb"] == want["eb"]
    assert got["summaries"] == want["summaries"]
    assert got["resumed"] == want["summaries"][4:]
    _same_state(got["mid"], want["mid"])
    _same_state(got["final"], want["final"])
    assert got["final"]["mesh_shape"] == [n]
    for a, b in zip(got["state"], want["state"]):
        np.testing.assert_array_equal(a, b)


def test_states_cross_packages_and_mesh_sizes(groups):
    """JAX ↔ port, and n=4 → n=1 → the twin, each resumed from the mid
    state to the uninterrupted run's summaries and final state."""
    src, dst = W.summary_fixture()
    want = jax_once(("summary", 4), lambda: _jax_summary(4))
    port4 = groups.get(4, "summary")
    cut = 4 * port4["eb"]
    # JAX n=4 → port n=1
    one = sharded.ShardedSummaryEngine(one_rank_mesh(), W.SUM_EB, W.SUM_VB,
                                       k_bucket=8)
    one.load_state_dict(want["mid"])
    assert one.process(src[cut:], dst[cut:]) == want["summaries"][4:]
    _same_state(one.state_dict(), want["final"])
    # port n=4 → JAX n=4
    jeng = jax_sharded.ShardedSummaryEngine(jax_mesh.make_mesh(4), W.SUM_EB,
                                            W.SUM_VB, k_bucket=8)
    jeng.load_state_dict(port4["mid"])
    assert jeng.process(src[cut:], dst[cut:]) == want["summaries"][4:]
    # port n=4 → port n=1 → its state → the twin
    one = sharded.ShardedSummaryEngine(one_rank_mesh(), W.SUM_EB, W.SUM_VB,
                                       k_bucket=8)
    one.load_state_dict(port4["mid"])
    twin = host_twin.HostSummaryEngine.from_sharded(one)
    assert twin.process(src[cut:], dst[cut:]) == want["summaries"][4:]
    _same_state(twin.state_dict(), port4["final"])
    # and the twin's state back onto the mesh
    back = sharded.ShardedSummaryEngine(one_rank_mesh(), W.SUM_EB,
                                        W.SUM_VB, k_bucket=8)
    back.load_state_dict(twin.state_dict())
    _same_state(back.state_dict(), port4["final"])


def test_window_engine_state_n4_to_n1_to_twin(groups):
    got = groups.get(4, "engine")["state"]
    eng = sharded.ShardedWindowEngine(one_rank_mesh(), W.ENG_VB)
    eng.load_state_dict(got)
    twin = host_twin.HostWindowEngine.from_sharded(eng)
    jtwin = jax_twin.HostWindowEngine(W.ENG_VB)
    jtwin.load_state_dict(got)
    batch = (np.array([5, 40, 41]), np.array([6, 41, 5]))
    np.testing.assert_array_equal(eng.cc_labels(*batch),
                                  twin.cc_labels(*batch))
    np.testing.assert_array_equal(twin.cc_labels(*batch),
                                  jtwin.cc_labels(*batch))
    for g, w in zip(eng.bipartite(*batch), jtwin.bipartite(*batch)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(eng.degrees(*batch)[:W.ENG_VB],
                                  jtwin.degrees(*batch))


# ----------------------------------------------------------------------
# replication, the wire, the layouts
# ----------------------------------------------------------------------

def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("n", [3, 4])
def test_every_rank_returns_the_same_answer(groups, n):
    ranks = groups.ranks(n)
    for name in ("raw", "count", "engine", "summary", "wire"):
        for r in range(1, n):
            assert _equal(ranks[r][name], ranks[0][name]), (name, r)


@pytest.mark.parametrize("n", SIZES)
def test_corrupt_shard_wire_refused_under_the_check(groups, n):
    got = groups.get(n, "wire")
    assert got["clean"] == groups.get(n, "count")[("replicated", "stream")]
    assert got["refused"] is not None
    assert ("corrupt shard wire: shard %d of %d" % (n - 1, n)
            in got["refused"])


def test_wire_check_is_off_by_default(monkeypatch):
    monkeypatch.delenv("GS_MESH_WIRE_CHECK", raising=False)
    bad = np.array([[1, 2, 999]], np.int32)
    assert sharded.guard_wire((bad,), 1, 10)[0] is bad
    monkeypatch.setenv("GS_MESH_WIRE_CHECK", "1")
    with pytest.raises(RuntimeError, match="shard 0 of 1"):
        sharded.guard_wire((bad,), 1, 10)


def test_hybrid_mesh_shapes_and_errors(groups):
    got = groups.get(4, "hybrid")
    import jax

    jm = jax_multihost.make_hybrid_mesh(ici_shards=2, dcn_shards=2,
                                        devices=jax.devices()[:4])
    assert got["shape"] == dict(jm.shape)
    assert got["flat"] == dict(jax_multihost.flatten_for_edges(jm).shape)
    assert got["layout"] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError) as err:
        jax_multihost.make_hybrid_mesh(ici_shards=3, dcn_shards=2,
                                       devices=jax.devices()[:4])
    assert got["error"] == str(err.value)
    assert got["counts"] == groups.get(4, "count")[("replicated", "stream")]


@pytest.mark.parametrize("n", [3, 4])
def test_make_mesh_takes_the_first_ranks(groups, n):
    ranks = [r["subset"] for r in groups.ranks(n)]
    assert [r["member"] for r in ranks] == [True] * (n - 1) + [False]
    assert "not in the mesh" in ranks[-1]["refused"]
    sub = groups.get(n - 1, "count") if n - 1 in (1, 3) else None
    for r in ranks[:-1]:
        assert r["shape"] == {"shard": n - 1}
        if sub is not None:
            assert r["counts"] == sub[("replicated", "stream")]


def test_make_mesh_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(device="cuda")


def test_mesh_of_a_gloo_group_and_its_helpers():
    m = one_rank_mesh()
    assert (m.shape, m.size, m.rank, m.backend) == ({"shard": 1}, 1, 0,
                                                     "gloo")
    assert mesh.shard_count(m) == 1
    assert [mesh.mesh_padded_len(k, m) for k in (0, 5)] == [1, 5]
    with pytest.raises(ValueError, match="a mesh of 2 ranks"):
        mesh.make_mesh(2, device="cpu")
    s, d = mesh.pad_edges_for_mesh(np.arange(3), np.arange(3), m, 9)
    assert list(s) == [0, 1, 2]


def test_window_collective_bytes_match_jax():
    for args in ((8, 262144, 64, 2048), (4, 65536, 128, 512),
                 (1, 1024, 8, 16)):
        for table in W.TABLES:
            assert (sharded.window_collective_bytes(*args, table=table)
                    == jax_sharded.window_collective_bytes(*args,
                                                           table=table))


def test_package_imports_neither_jax_nor_the_jax_package():
    import ast
    import os

    root = os.path.dirname(os.path.abspath(sharded.__file__))
    for name in sorted(os.listdir(root)):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(root, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else
                        [node.module or ""]
                        if isinstance(node, ast.ImportFrom) else [])
                for mod in mods:
                    assert not mod.startswith(("jax", "gelly_streaming_tpu.")), \
                        (name, mod)
                    assert mod != "gelly_streaming_tpu", (name, mod)
