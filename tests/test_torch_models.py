"""The port's summary-aggregation models (gelly_streaming_tpu_torch/models/
connected_components, bipartiteness, iterative_cc; utils/disjoint_set,
candidates) on device="cpu", held against the JAX package's host and
`Tpu*` forms on the goldens of tests/library/test_algorithms.py and
test_workloads.py: the printed states line for line, the incremental
windows, the carried-label regressions, the merger under disorder and
under thread concurrency, the host-vs-device fuzz, and the iterative
CC's state_dict loaded both ways. The analytics are integers and the
printed forms strings: equality, no tolerance."""

import copy
import itertools
import queue
import random
import re
import threading

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as jgs
from gelly_streaming_tpu.core.types import text_line as jax_text_line
from gelly_streaming_tpu.models import (
    BipartitenessCheck as JaxBipartitenessCheck,
    ConnectedComponents as JaxConnectedComponents,
    TpuBipartitenessCheck, TpuConnectedComponents)
from gelly_streaming_tpu.models.iterative_cc import (
    TpuIterativeConnectedComponents,
    iterative_connected_components as jax_iterative_cc)
from gelly_streaming_tpu.ops import unionfind as jax_unionfind
from gelly_streaming_tpu.utils.candidates import (
    Candidates as JaxCandidates, edge_to_candidate as jax_edge_to_candidate)
from gelly_streaming_tpu.utils.disjoint_set import (
    DisjointSet as JaxDisjointSet)

import gelly_streaming_tpu_torch as pgs
from gelly_streaming_tpu_torch.core.types import text_line
from gelly_streaming_tpu_torch.models import (
    BipartitenessCheck, ConnectedComponents, TorchBipartitenessCheck,
    TorchConnectedComponents, TorchIterativeConnectedComponents)
from gelly_streaming_tpu_torch.models.iterative_cc import (
    iterative_connected_components)
from gelly_streaming_tpu_torch.ops import unionfind
from gelly_streaming_tpu_torch.utils.candidates import (
    Candidates, SignedVertex, edge_to_candidate)
from gelly_streaming_tpu_torch.utils.disjoint_set import DisjointSet

CC_EDGES = [(1, 2), (1, 3), (2, 3), (1, 5), (6, 7), (8, 9)]
BIPARTITE_EDGES = [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)]
NON_BIPARTITE_EDGES = [(1, 2), (2, 3), (3, 1), (4, 5), (5, 7), (4, 1)]

# (port class, JAX class) of each form
CC_FORMS = {"host": (ConnectedComponents, JaxConnectedComponents),
            "device": (TorchConnectedComponents, TpuConnectedComponents)}
BIP_FORMS = {"host": (BipartitenessCheck, JaxBipartitenessCheck),
             "device": (TorchBipartitenessCheck, TpuBipartitenessCheck)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _aggregate(pkg, algorithm, pairs, timestamps=False):
    """The states `graph.aggregate(algorithm)` emits over `pairs` in one
    package: ingestion time on a clock pinned at 0, or event time from
    the edge value."""
    if pkg is pgs:
        env = pkg.StreamEnvironment(clock=pkg.ManualClock(0), device="cpu")
    else:
        env = pkg.StreamEnvironment(clock=pkg.ManualClock(0))
    kw = {}
    if timestamps:
        kw["timestamp_extractor"] = pkg.AscendingTimestampExtractor(
            lambda e: e.value)
    edges = [pkg.Edge(p[0], p[1], p[2] if len(p) > 2 else pkg.NULL)
             for p in pairs]
    graph = pkg.SimpleEdgeStream(env.from_collection(edges), env, **kw)
    sink = graph.aggregate(algorithm).collect()
    env.execute()
    return env.results_of(sink)


def _lines_pair(forms, form, window_ms, pairs, timestamps=False):
    port_cls, jax_cls = forms[form]
    got = [text_line(s) for s in _aggregate(pgs, port_cls(window_ms), pairs,
                                            timestamps)]
    want = [jax_text_line(s) for s in _aggregate(jgs, jax_cls(window_ms),
                                                 pairs, timestamps)]
    return got, want


def _groups(line):
    return sorted(sorted(int(x) for x in g.split(","))
                  for g in re.findall(r"\[([^\]]*)\]", line))


@pytest.mark.parametrize("form", ["host", "device"])
def test_connected_components_golden(form):
    got, want = _lines_pair(CC_FORMS, form, 5, CC_EDGES)
    assert got == want
    assert _groups(got[-1]) == [[1, 2, 3, 5], [6, 7], [8, 9]]


@pytest.mark.parametrize("form", ["host", "device"])
def test_bipartiteness_positive_golden(form):
    got, want = _lines_pair(BIP_FORMS, form, 500, BIPARTITE_EDGES)
    assert got == want == [
        "(true,{1={1=(1,true), 2=(2,false), 3=(3,false), 4=(4,false), "
        "5=(5,true), 7=(7,true), 9=(9,true)}})"]


@pytest.mark.parametrize("form", ["host", "device"])
def test_bipartiteness_negative_golden(form):
    got, want = _lines_pair(BIP_FORMS, form, 500, NON_BIPARTITE_EDGES)
    assert got == want == ["(false,{})"]


@pytest.mark.parametrize("form", ["host", "device"])
def test_cc_incremental_windows(form):
    """Two event-time merge windows: the merger emits an improving
    global state per window partial."""
    pairs = [(1, 2, 10), (3, 4, 20), (2, 3, 150)]
    got, want = _lines_pair(CC_FORMS, form, 100, pairs, timestamps=True)
    assert got == want
    assert [_groups(line) for line in got] == [[[1, 2], [3, 4]],
                                               [[1, 2, 3, 4]]]


def test_device_forms_take_the_environment_device():
    """The `Torch*` folds run on the environment's device: the default
    (the card) raises without CUDA instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = pgs.StreamEnvironment(clock=pgs.ManualClock(0))
    graph = pgs.SimpleEdgeStream(env.from_collection(
        [pgs.Edge(1, 2, pgs.NULL)]), env)
    graph.aggregate(TorchConnectedComponents(5)).collect()
    with pytest.raises(RuntimeError, match="CUDA"):
        env.execute()
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchIterativeConnectedComponents()


@pytest.mark.parametrize("labels,src,dst,check", [
    # two flat forests {0,5}->0 and {1,6}->1 merged through non-roots
    ([0, 1, 2, 3, 4, 0, 1, 7], [5], [6], [0, 1, 5, 6]),
    # an old root merging into two trees in one round
    ([0, 1, 2, 3, 3, 1], [4, 3], [1, 0], [0, 1, 3, 4, 5]),
])
def test_carried_labels_regressions(labels, src, dst, check):
    labels = np.array(labels, np.int32)
    got = unionfind.connected_components_with_labels(
        np.array(src), np.array(dst), labels.copy(), len(labels),
        device="cpu")
    want = jax_unionfind.connected_components_with_labels(
        np.array(src), np.array(dst), labels.copy(), len(labels))
    np.testing.assert_array_equal(got, want)
    assert list(got[check]) == [0] * len(check)


def _fold(agg, edge_list):
    state = copy.deepcopy(agg.initial_value)
    for s, t in edge_list:
        state = agg.update_fun(state, s, t, None)
    return state


def _comps(ds):
    groups = {}
    for v in ds.get_matches():
        groups.setdefault(ds.find(v), set()).add(v)
    return frozenset(frozenset(g) for g in groups.values())


def _assert_improving(emitted):
    for earlier, later in itertools.combinations(emitted, 2):
        for group in _comps(earlier):
            for a, b in itertools.combinations(sorted(group), 2):
                if a in later.get_matches() and b in later.get_matches():
                    assert later.find(a) == later.find(b)


def test_merger_correct_under_partial_disorder():
    """3 partitions × 3 windows of partials delivered in many orders:
    the port's merger emits what the JAX merger emits, state for state,
    and ends at the full components."""
    windows = {
        (0, 0): [(1, 2), (3, 4)], (1, 0): [(5, 6)], (2, 0): [(2, 3)],
        (0, 1): [(7, 8)], (1, 1): [(4, 5)], (2, 1): [(9, 10)],
        (0, 2): [(6, 7)], (1, 2): [(11, 12)], (2, 2): [(10, 11)],
    }
    want_final = frozenset({frozenset(range(1, 9)),
                            frozenset(range(9, 13))})
    orders = [sorted(windows), sorted(windows, reverse=True),
              sorted(windows, key=lambda pw: (-pw[1], pw[0]))]
    rng = random.Random(13)
    for _ in range(4):
        perm = list(windows)
        rng.shuffle(perm)
        orders.append(perm)
    port, ref = ConnectedComponents(1000), JaxConnectedComponents(1000)
    for order in orders:
        merger, jmerger = port.make_merger(), ref.make_merger()
        emitted, jemitted = [], []
        for key in order:
            merger(_fold(port, windows[key]), emitted.append)
            jmerger(_fold(ref, windows[key]), jemitted.append)
        assert [repr(s) for s in emitted] == [repr(s) for s in jemitted]
        assert _comps(emitted[-1]) == want_final, order
        _assert_improving(emitted)


def test_merger_correct_under_true_thread_concurrency():
    """Four producer threads fold their partitions' windows and push the
    partials through a queue; the one consumer merges in arrival order.
    Every interleaving ends at one component and keeps the emissions
    improving."""
    agg = ConnectedComponents(1000)
    partitions = {
        0: [[(1, 2), (3, 4)], [(7, 8)], [(6, 7)]],
        1: [[(5, 6)], [(4, 5)], [(11, 12)]],
        2: [[(2, 3)], [(9, 10)], [(10, 11)]],
        3: [[(12, 13)], [(8, 9)], [(13, 14)]],
    }
    num_partials = sum(len(w) for w in partitions.values())
    for _ in range(8):
        q = queue.Queue()

        def producer(wins):
            for w in wins:
                q.put(_fold(agg, copy.deepcopy(w)))

        threads = [threading.Thread(target=producer, args=(w,))
                   for w in partitions.values()]
        for t in threads:
            t.start()
        merger = agg.make_merger()
        emitted = []
        for _ in range(num_partials):
            merger(q.get(timeout=30), emitted.append)
        for t in threads:
            t.join(timeout=30)
        assert len(emitted) == num_partials
        assert _comps(emitted[-1]) == frozenset({frozenset(range(1, 15))})
        _assert_improving(emitted)


def _bfs_bipartite(pairs):
    adj = {}
    for a, b in pairs:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    color = {}
    for start in adj:
        if start in color:
            continue
        color[start] = 0
        stack = [start]
        while stack:
            u = stack.pop()
            for w in adj[u]:
                if w not in color:
                    color[w] = color[u] ^ 1
                    stack.append(w)
                elif color[w] == color[u]:
                    return False
    return True


@pytest.mark.parametrize("seed", range(8))
def test_cc_and_bipartiteness_fuzz_host_vs_device(seed):
    """Random graphs through aggregate(): each port form prints what its
    JAX twin prints, the device forms reach the host forms' final
    components and verdict, and the verdict matches a BFS 2-coloring."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(6, 40))
    e = int(rng.integers(v, 4 * v))
    pairs = [(int(a) + 1, int(b) + 1) for a, b in
             zip(rng.integers(0, v, e), rng.integers(0, v, e)) if a != b]
    pairs = pairs or [(1, 2)]
    finals = {}
    for form in ("host", "device"):
        got, want = _lines_pair(CC_FORMS, form, 5, pairs)
        assert got == want, form
        finals[form] = _groups(got[-1])
    assert finals["host"] == finals["device"]
    verdicts = {}
    for form in ("host", "device"):
        got, want = _lines_pair(BIP_FORMS, form, 500, pairs)
        assert got == want, form
        verdicts[form] = got[-1].startswith("(true")
    assert verdicts["host"] == verdicts["device"] == _bfs_bipartite(pairs)


def test_bipartiteness_device_divergences_kept():
    """The JAX device form's two documented divergences from the host
    form hold in the port's: a self-loop is an odd cycle, and a
    component is printed fully canonicalized."""
    loop = [(1, 2), (3, 3)]
    got, want = _lines_pair(BIP_FORMS, "device", 500, loop)
    assert got == want == ["(false,{})"]
    host, _ = _lines_pair(BIP_FORMS, "host", 500, loop)
    assert host[-1].startswith("(true")
    bridged = [(5, 6), (7, 8), (6, 7), (1, 5)]
    got, want = _lines_pair(BIP_FORMS, "device", 500, bridged)
    assert got == want == [
        "(true,{1={1=(1,true), 5=(5,false), 6=(6,true), 7=(7,false), "
        "8=(8,true)}})"]


def test_iterative_cc_feedback():
    """The feedback-loop form: the port's update stream equals the JAX
    package's, and the last label per vertex is its component min."""
    pairs = [(1, 2), (3, 4), (2, 3), (6, 7)]
    out = []
    for pkg, fn in ((pgs, iterative_connected_components),
                    (jgs, jax_iterative_cc)):
        env = pkg.StreamEnvironment()
        sink = fn(env.from_collection(pairs)).collect()
        env.execute()
        out.append(env.results_of(sink))
    assert out[0] == out[1]
    assert dict(out[0]) == {1: 1, 2: 1, 3: 1, 4: 1, 6: 6, 7: 6}


def test_iterative_cc_carried_state():
    model = TorchIterativeConnectedComponents(device="cpu")
    ref = TpuIterativeConnectedComponents()
    batches = [([1, 3], [2, 4]), ([2], [3])]
    got = [model.process_batch(np.array(s), np.array(d))
           for s, d in batches]
    want = [ref.process_batch(np.array(s), np.array(d)) for s, d in batches]
    assert got == want
    assert dict(got[0]) == {1: 1, 2: 1, 3: 3, 4: 3}
    assert dict(got[1]) == {3: 1, 4: 1}


@pytest.mark.parametrize("seed", range(3))
def test_iterative_cc_state_dict_both_ways(seed):
    """A stream in batches, cut after the second: the state of each
    form loads into the other, and the resumed runs equal the
    uninterrupted ones batch for batch."""
    rng = np.random.default_rng(seed)
    batches = [(rng.integers(0, 300, n) * 7, rng.integers(0, 300, n) * 7)
               for n in (40, 90, 5, 160, 33)]
    full = TpuIterativeConnectedComponents()
    want = [full.process_batch(s, d) for s, d in batches]
    port = TorchIterativeConnectedComponents(device="cpu")
    assert [port.process_batch(s, d) for s, d in batches] == want
    np.testing.assert_array_equal(port.state_dict()["labels"],
                                  full.state_dict()["labels"])

    head_p = TorchIterativeConnectedComponents(device="cpu")
    head_j = TpuIterativeConnectedComponents()
    for s, d in batches[:2]:
        head_p.process_batch(s, d)
        head_j.process_batch(s, d)
    sp, sj = head_p.state_dict(), head_j.state_dict()
    assert set(sp) == set(sj) == {"labels", "ids"}
    for k in sp:
        np.testing.assert_array_equal(sp[k], sj[k])
    into_jax = TpuIterativeConnectedComponents()
    into_jax.load_state_dict(copy.deepcopy(sp))
    into_port = TorchIterativeConnectedComponents(device="cpu")
    into_port.load_state_dict(copy.deepcopy(sj))
    for (s, d), w in zip(batches[2:], want[2:]):
        assert into_jax.process_batch(s, d) == w
        assert into_port.process_batch(s, d) == w


def _even_odd(cls):
    ds = cls()
    for i in range(8):
        ds.union(i, i + 2)
    return ds


def test_disjoint_set_reference_unit_goldens():
    """DisjointSetTest.java's goldens on the port's copy, each state and
    printed form equal to the JAX copy's."""
    ds, jds = _even_odd(DisjointSet), _even_odd(JaxDisjointSet)
    assert len(ds.get_matches()) == 10
    assert ds.get_matches() == jds.get_matches()
    r1, r2 = ds.find(0), ds.find(1)
    assert r1 != r2
    assert all(ds.find(i) == (r1 if i % 2 == 0 else r2) for i in range(10))
    other, jother = DisjointSet(), JaxDisjointSet()
    for i in range(8):
        other.union(i, i + 100)
        jother.union(i, i + 100)
    other.merge(ds)
    jother.merge(jds)
    assert len(other.get_matches()) == 18
    assert len({other.find(e) for e in other.get_matches()}) == 2
    assert repr(other) == repr(jother)
    assert other.state_dict() == jother.state_dict()
    small = DisjointSet()
    small.union(1, 2)
    small.union(8, 9)
    assert repr(small) == "{1=[1, 2], 8=[8, 9]}"
    loaded = DisjointSet()
    loaded.load_state_dict(jother.state_dict())
    assert repr(loaded) == repr(jother)


@pytest.mark.parametrize("seed", range(4))
def test_candidates_merge_equals_jax(seed):
    """Random edge sequences folded through Candidates.merge, one
    candidate an edge as the host bipartiteness fold does: every
    intermediate printed state and state_dict equals the JAX copy's."""
    rng = np.random.default_rng(seed)
    pairs = [(int(a), int(b)) for a, b in
             zip(rng.integers(0, 12, 14), rng.integers(0, 12, 14)) if a != b]
    cand, jcand = Candidates(True), JaxCandidates(True)
    for a, b in pairs:
        cand = cand.merge(edge_to_candidate(a, b))
        jcand = jcand.merge(jax_edge_to_candidate(a, b))
        assert repr(cand) == repr(jcand)
        assert cand.state_dict() == jcand.state_dict()
    back = Candidates()
    back.load_state_dict(jcand.state_dict())
    assert repr(back) == repr(jcand)
    assert repr(SignedVertex(3, False)) == "(3,false)"
    assert SignedVertex(3, True).reverse() == SignedVertex(3, False)


def test_summary_copies_are_independent():
    """The merger's emissions are deep copies: the port's fast copies of
    DisjointSet and Candidates print as the originals and share nothing
    a later merge changes."""
    ds = _even_odd(DisjointSet)
    snap = copy.deepcopy(ds)
    assert repr(snap) == repr(ds) and snap.state_dict() == ds.state_dict()
    ds.union(0, 1)
    ds.union(50, 51)
    assert repr(snap) == repr(_even_odd(DisjointSet)) != repr(ds)
    cand = Candidates(True)
    for a, b in ((1, 2), (2, 3), (5, 6)):
        cand = cand.merge(edge_to_candidate(a, b))
    snap, before = copy.deepcopy(cand), repr(cand)
    assert repr(snap) == before
    cand = cand.merge(edge_to_candidate(3, 5))
    cand.merge(edge_to_candidate(1, 3))
    assert repr(snap) == before != repr(cand)
