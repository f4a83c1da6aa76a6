"""The PyTorch port's graph-stream API (StreamEnvironment, SimpleEdgeStream,
slice and the neighborhood fold/reduce/apply, the models) held against
the reference's goldens and the JAX package on the CPU.

Goldens: the reference's TestSlice.java:81-229 ({fold, reduce, apply} ×
{OUT, IN, ALL}, as tests/operations/test_slice.py holds them), each run
through the port's host UDFs and its Torch* UDFs; every Torch* pipeline
also runs through the JAX package's Jax* counterpart and must print the
same lines.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu as J
from gelly_streaming_tpu.core.types import csv_line as j_csv_line
from gelly_streaming_tpu.core.types import text_line as j_text_line
from gelly_streaming_tpu.models import triangles as j_tri
from gelly_streaming_tpu.models import workloads as j_work
from gelly_streaming_tpu.io import sources as j_sources
import gelly_streaming_tpu_torch as P
from gelly_streaming_tpu_torch.core.types import csv_line as p_csv_line
from gelly_streaming_tpu_torch.core.types import text_line as p_text_line
from gelly_streaming_tpu_torch.io import sources as p_sources
from gelly_streaming_tpu_torch.models import triangles as p_tri
from gelly_streaming_tpu_torch.models import workloads as p_work

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FOLD_EXPECTED = {
    "OUT": ["1,25", "2,23", "3,69", "4,45", "5,51"],
    "IN": ["1,51", "2,12", "3,36", "4,34", "5,80"],
    "ALL": ["1,76", "2,35", "3,105", "4,79", "5,131"],
}
APPLY_EXPECTED = {
    "OUT": ["1,small", "2,small", "3,big", "4,small", "5,big"],
    "IN": ["1,big", "2,small", "3,small", "4,small", "5,big"],
    "ALL": ["1,big", "2,small", "3,big", "4,big", "5,big"],
}
DIRS = ["OUT", "IN", "ALL"]
EDGES = [(1, 2, 12), (1, 3, 13), (2, 3, 23), (3, 4, 34), (3, 5, 35),
         (4, 5, 45), (5, 1, 51)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _penv():
    return P.StreamEnvironment(clock=P.ManualClock(0), device="cpu")


def _jenv():
    return J.StreamEnvironment(clock=J.ManualClock(0))


def _graph(pkg, env, edges=EDGES, event_time=False):
    stream = env.from_collection([pkg.Edge(*e) for e in edges])
    if event_time:
        return pkg.SimpleEdgeStream(
            stream, env, timestamp_extractor=pkg.AscendingTimestampExtractor(
                lambda e: e.value))
    return pkg.SimpleEdgeStream(stream, env)


def _run(env, stream, fmt):
    sink = stream.collect()
    env.execute()
    return sorted(fmt(v) for v in env.results_of(sink))


def _both(build_p, build_j, **kw):
    """Lines of the same pipeline through the port (CPU) and the JAX
    package."""
    penv, jenv = _penv(), _jenv()
    got = _run(penv, build_p(_graph(P, penv, **kw)), p_csv_line)
    want = _run(jenv, build_j(_graph(J, jenv, **kw)), j_csv_line)
    return got, want


# ---- the nine TestSlice goldens ---------------------------------------

@pytest.mark.parametrize("direction", DIRS)
def test_fold_neighbors_host(direction):
    fold = P.EdgesFold(lambda acc, vid, nid, val: (vid, acc[1] + val))
    penv = _penv()
    out = _graph(P, penv).slice(
        P.Time.seconds(1), P.EdgeDirection[direction]).fold_neighbors(
        (0, 0), fold)
    assert _run(penv, out, p_csv_line) == sorted(FOLD_EXPECTED[direction])


@pytest.mark.parametrize("direction", DIRS)
def test_fold_neighbors_torch(direction):
    got, want = _both(
        lambda g: g.slice(P.Time.seconds(1), P.EdgeDirection[direction])
        .fold_neighbors(P.TorchEdgesFold(
            init=(torch.tensor(0, dtype=torch.int32),
                  torch.tensor(0, dtype=torch.int32)),
            fn=lambda acc, vid, nid, val: (vid, acc[1] + val))),
        lambda g: g.slice(J.Time.seconds(1), J.EdgeDirection[direction])
        .fold_neighbors(J.JaxEdgesFold(
            init=(jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            fn=lambda acc, vid, nid, val: (vid, acc[1] + val))))
    assert got == want == sorted(FOLD_EXPECTED[direction])


@pytest.mark.parametrize("direction", DIRS)
def test_reduce_on_edges_host(direction):
    penv = _penv()
    out = _graph(P, penv).slice(
        P.Time.seconds(1), P.EdgeDirection[direction]).reduce_on_edges(
        P.EdgesReduce(lambda a, b: a + b))
    assert _run(penv, out, p_csv_line) == sorted(FOLD_EXPECTED[direction])


@pytest.mark.parametrize("direction", DIRS)
@pytest.mark.parametrize("spec", ["named", "generic", "associative"])
def test_reduce_on_edges_torch(direction, spec):
    def udf(pkg, cls):
        return (cls(name="sum") if spec == "named"
                else cls(fn=lambda a, b: a + b,
                         associative=(spec == "associative")))

    got, want = _both(
        lambda g: g.slice(P.Time.seconds(1), P.EdgeDirection[direction])
        .reduce_on_edges(udf(P, P.TorchEdgesReduce)),
        lambda g: g.slice(J.Time.seconds(1), J.EdgeDirection[direction])
        .reduce_on_edges(udf(J, J.JaxEdgesReduce)))
    assert got == want == sorted(FOLD_EXPECTED[direction])


@pytest.mark.parametrize("direction", DIRS)
def test_apply_on_neighbors_host(direction):
    def classify(vid, neighbors, collect):
        total = sum(v for _n, v in neighbors)
        collect((vid, "big" if total > 50 else "small"))

    penv = _penv()
    out = _graph(P, penv).slice(
        P.Time.seconds(1), P.EdgeDirection[direction]).apply_on_neighbors(
        P.EdgesApply(classify))
    assert _run(penv, out, p_csv_line) == sorted(APPLY_EXPECTED[direction])


@pytest.mark.parametrize("direction", DIRS)
def test_apply_on_neighbors_torch(direction):
    def emit(vid, row):
        return (vid, "big" if row[0] > 50 else "small")

    got, want = _both(
        lambda g: g.slice(P.Time.seconds(1), P.EdgeDirection[direction])
        .apply_on_neighbors(P.TorchEdgesApply(
            fn=lambda vid, nbrs, vals, mask:
            torch.where(mask, vals, 0).sum(-1), emit=emit)),
        lambda g: g.slice(J.Time.seconds(1), J.EdgeDirection[direction])
        .apply_on_neighbors(J.JaxEdgesApply(
            fn=lambda vid, nbrs, vals, mask:
            jnp.sum(jnp.where(mask, vals, 0)), emit=emit)))
    assert got == want == sorted(APPLY_EXPECTED[direction])


def test_multiple_windows_event_time():
    """test_slice.py:130: windows split neighborhoods by event time."""
    edges = [(1, 2, 10), (1, 3, 20), (1, 4, 120)]
    for udf in (P.EdgesReduce(lambda a, b: a + b),
                P.TorchEdgesReduce(name="sum")):
        penv = _penv()
        out = _graph(P, penv, edges, event_time=True).slice(
            P.Time.milliseconds_of(100)).reduce_on_edges(udf)
        assert _run(penv, out, p_csv_line) == ["1,120", "1,30"]


# ---- sliding windows: the pane path and the duplicating path ----------

def _timed_edges(n=300, seed=3):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, 2000, n))
    src = rng.integers(0, 25, n)
    dst = rng.integers(0, 25, n)
    return [(int(s), int(d), int(t)) for s, d, t in zip(src, dst, ts)]


@pytest.mark.parametrize("spec", ["sum", "min", "max", "associative",
                                  "generic"])
@pytest.mark.parametrize("direction", DIRS)
def test_sliding_slice(spec, direction):
    """slice(size, slide=): named and associative reduces take the pane
    path (one call for all windows), a generic fn the duplicating
    path; each equals the JAX package's."""
    def udf(cls, mx):
        if spec in ("sum", "min", "max"):
            return cls(name=spec)
        return cls(fn=mx, associative=spec == "associative")

    edges = _timed_edges()
    got, want = _both(
        lambda g: g.slice(P.Time.milliseconds_of(400),
                          P.EdgeDirection[direction],
                          slide=P.Time.milliseconds_of(100))
        .reduce_on_edges(udf(P.TorchEdgesReduce, torch.maximum)),
        lambda g: g.slice(J.Time.milliseconds_of(400),
                          J.EdgeDirection[direction],
                          slide=J.Time.milliseconds_of(100))
        .reduce_on_edges(udf(J.JaxEdgesReduce, jnp.maximum)),
        edges=edges, event_time=True)
    assert got == want and len(got) > 20


def test_sliding_fold_and_pane_kernel_used():
    """A sliding fold duplicates each edge into its windows; a named
    reduce advertises a pane kernel, a generic one does not."""
    edges = _timed_edges(120, seed=5)
    got, want = _both(
        lambda g: g.slice(P.Time.milliseconds_of(300), P.EdgeDirection.OUT,
                          slide=P.Time.milliseconds_of(100))
        .fold_neighbors(P.TorchEdgesFold(
            init=(torch.tensor(0, dtype=torch.int32),
                  torch.tensor(0, dtype=torch.int32)),
            fn=lambda acc, vid, nid, val: (vid, acc[1] * 3 + nid))),
        lambda g: g.slice(J.Time.milliseconds_of(300), J.EdgeDirection.OUT,
                          slide=J.Time.milliseconds_of(100))
        .fold_neighbors(J.JaxEdgesFold(
            init=(jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
            fn=lambda acc, vid, nid, val: (vid, acc[1] * 3 + nid))),
        edges=edges, event_time=True)
    assert got == want and len(got) > 10
    from gelly_streaming_tpu_torch.ops import neighborhood
    env = _penv()
    named = neighborhood.make_reduce_kernel(P.TorchEdgesReduce(name="sum"),
                                            env)
    generic = neighborhood.make_reduce_kernel(
        P.TorchEdgesReduce(fn=torch.add), env)
    assert hasattr(named, "pane_kernel")
    assert not hasattr(generic, "pane_kernel")


def test_float_values_and_fold_emit():
    edges = [(1, 2, 0.5), (1, 3, 0.25), (2, 3, 1.125), (3, 1, 2.0)]
    got, want = _both(
        lambda g: g.slice(P.Time.seconds(1), P.EdgeDirection.ALL)
        .reduce_on_edges(P.TorchEdgesReduce(name="max")),
        lambda g: g.slice(J.Time.seconds(1), J.EdgeDirection.ALL)
        .reduce_on_edges(J.JaxEdgesReduce(name="max")), edges=edges)
    assert got == want
    emit = lambda vid, row: (vid, row[0], row[1])  # noqa: E731
    got, want = _both(
        lambda g: g.slice(P.Time.seconds(1))
        .fold_neighbors(P.TorchEdgesFold(
            init=(torch.tensor(0.0), torch.tensor(0, dtype=torch.int32)),
            fn=lambda acc, vid, nid, val: (acc[0] + val, acc[1] + 1),
            emit=emit)),
        lambda g: g.slice(J.Time.seconds(1))
        .fold_neighbors(J.JaxEdgesFold(
            init=(jnp.zeros((), jnp.float32), jnp.zeros((), jnp.int32)),
            fn=lambda acc, vid, nid, val: (acc[0] + val, acc[1] + 1),
            emit=emit)), edges=edges)
    assert got == want


# ---- SimpleEdgeStream transforms and degree streams --------------------

TRANSFORMS = {
    "map_edges": lambda g: g.map_edges(lambda e: e.value * 2).get_edges(),
    "filter_edges": lambda g: g.filter_edges(
        lambda e: e.value % 2 == 1).get_edges(),
    "filter_vertices": lambda g: g.filter_vertices(
        lambda v: v.id != 3).get_edges(),
    "distinct": lambda g: g.union(g).distinct().get_edges(),
    "reverse": lambda g: g.reverse().get_edges(),
    "undirected": lambda g: g.undirected().get_edges(),
    "vertices": lambda g: g.get_vertices(),
    "degrees": lambda g: g.get_degrees(),
    "in_degrees": lambda g: g.get_in_degrees(),
    "out_degrees": lambda g: g.get_out_degrees(),
    "number_of_vertices": lambda g: g.number_of_vertices(),
    "number_of_edges": lambda g: g.number_of_edges(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_simple_edge_stream_transforms(name):
    got, want = _both(TRANSFORMS[name], TRANSFORMS[name])
    assert got == want and got


def test_graph_aggregation_runs_its_merger():
    def build(pkg, agg_mod):
        def run(g):
            agg = agg_mod.WindowGraphAggregation(
                lambda s, a, b, v: s + v, lambda p, c: p + c, 0, 1000)
            return g.aggregate(agg)
        return run

    from gelly_streaming_tpu.core import aggregation as ja
    from gelly_streaming_tpu_torch.core import aggregation as pa
    got, want = _both(build(P, pa), build(J, ja))
    assert got == want == ["213"]


# ---- models --------------------------------------------------------------

def _generated(pkg, env):
    """examples/window_triangles.py:27-37: the reference's built-in
    graph (WindowTriangles.java:188-197)."""
    def gen(key, collect):
        for i in range(1, 3):
            collect(pkg.Edge(key, key + i, key * 100 + (i - 1) * 50))

    edges = env.generate_sequence(1, 10).flat_map(gen)
    return pkg.SimpleEdgeStream(
        edges, env, timestamp_extractor=pkg.AscendingTimestampExtractor(
            lambda e: e.value)).map_edges(lambda e: pkg.NULL)


@pytest.mark.parametrize("fused", [True, False])
def test_window_triangles_generated_graph(fused):
    penv, jenv = _penv(), _jenv()
    if fused:
        pout = p_tri.WindowTriangleCount(P.Time.milliseconds_of(300)).run(
            _generated(P, penv))
        jout = j_tri.WindowTriangleCount(J.Time.milliseconds_of(300)).run(
            _generated(J, jenv))
    else:
        pout = p_work.window_triangles_pipeline(_generated(P, penv),
                                                P.Time.milliseconds_of(300))
        jout = j_work.window_triangles_pipeline(_generated(J, jenv),
                                                J.Time.milliseconds_of(300))
    got = _run(penv, pout, p_text_line)
    assert got == _run(jenv, jout, j_text_line)
    assert got


@pytest.fixture
def movielens_file(tmp_path):
    """tests/fixtures/movielens_2k_sorted.txt as 'src dst ts' lines
    (user, movie, its timestamp in seconds)."""
    rows = np.loadtxt(os.path.join(REPO, "tests", "fixtures",
                                   "movielens_2k_sorted.txt"), dtype=np.int64)
    path = tmp_path / "movielens.txt"
    np.savetxt(path, rows[:, [0, 1, 3]], fmt="%d")
    return str(path)


@pytest.mark.parametrize("fused", [True, False])
def test_window_triangles_movielens(movielens_file, fused):
    """Both forms over the movielens fixture (user and movie ids share
    one id space, so the windows hold triangles), equal to the JAX
    package, and the fused form equal to the API-parity pipeline."""
    window = 200
    out = {}
    for pkg, tri, work, fmt, env in (
            (P, p_tri, p_work, p_text_line, _penv()),
            (J, j_tri, j_work, j_text_line,
             _jenv())):
        graph = work.timestamped_graph(env, movielens_file)
        res = (tri.WindowTriangleCount(pkg.Time.milliseconds_of(window))
               .run(graph) if fused else work.window_triangles_pipeline(
                   graph, pkg.Time.milliseconds_of(window)))
        out[pkg] = _run(env, res, fmt)
    assert out[P] == out[J] and out[P]


def test_window_triangle_count_sparse_route():
    """A window past 4096 interned vertices takes triangle_count's sparse
    route; its count equals the JAX package's and the numpy oracle."""
    from gelly_streaming_tpu_torch.ops import host_triangles
    rng = np.random.default_rng(11)
    n = 9000
    src = rng.integers(0, 6000, n)
    dst = rng.integers(0, 6000, n)
    # a few dense clusters so the window holds triangles
    src[:300] = rng.integers(0, 30, 300)
    dst[:300] = rng.integers(0, 30, 300)
    edges = [(int(s), int(d), 5) for s, d in zip(src, dst)]
    penv, jenv = _penv(), _jenv()
    got = _run(penv, p_tri.WindowTriangleCount(P.Time.seconds(1)).run(
        _graph(P, penv, edges, event_time=True)), p_text_line)
    want = _run(jenv, j_tri.WindowTriangleCount(J.Time.seconds(1)).run(
        _graph(J, jenv, edges, event_time=True)),
        j_text_line)
    assert got == want
    assert got == ["(%d,999)" % host_triangles.window_count(src, dst)]
    assert len(np.unique(np.concatenate([src, dst]))) > 4096


def test_read_edge_file(tmp_path):
    path = tmp_path / "e.txt"
    path.write_text("1 2 10\n2 3 20\n3 1 130\n4 1 140\n")
    for event_time in (False, True):
        penv, jenv = _penv(), _jenv()
        pg = p_sources.read_edge_file(penv, str(path), event_time=event_time)
        jg = j_sources.read_edge_file(jenv, str(path), event_time=event_time)
        got = _run(penv, pg.slice(P.Time.milliseconds_of(100))
                   .reduce_on_edges(P.TorchEdgesReduce(name="max")),
                   p_csv_line) if not event_time else _run(
            penv, pg.get_degrees(), p_csv_line)
        want = _run(jenv, jg.slice(J.Time.milliseconds_of(100))
                    .reduce_on_edges(J.JaxEdgesReduce(name="max")),
                    j_csv_line) if not event_time else _run(
            jenv, jg.get_degrees(), j_csv_line)
        assert got == want and got


# ---- contracts -----------------------------------------------------------

def test_environment_contracts(monkeypatch):
    env = _penv()
    # tracing is ported (tests/test_torch_tracing.py)
    assert env.trace_report() == []
    assert env.enable_tracing() is env and env.trace_report() == []
    # a host-UDF job needs no card; a device UDF resolves None to the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = P.StreamEnvironment(clock=P.ManualClock(0))
    out = _graph(P, env).slice(P.Time.seconds(1)).reduce_on_edges(
        P.EdgesReduce(lambda a, b: a + b))
    assert _run(env, out, p_csv_line) == sorted(FOLD_EXPECTED["OUT"])
    env = P.StreamEnvironment(clock=P.ManualClock(0))
    out = _graph(P, env).slice(P.Time.seconds(1)).reduce_on_edges(
        P.TorchEdgesReduce(name="sum"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _run(env, out, p_csv_line)
    with pytest.raises(ValueError, match="Illegal edge direction"):
        _graph(P, _penv()).slice(P.Time.seconds(1), "sideways")
    env = _penv()
    _run(env, _graph(P, env).get_edges(), p_csv_line)
    with pytest.raises(RuntimeError, match="already executed"):
        env.execute()


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """In a fresh interpreter: the slice's modules load neither `jax`
    nor `gelly_streaming_tpu`."""
    code = (
        "import importlib, sys\n"
        "for m in ('core.types', 'core.gtime', 'core.plan',\n"
        "          'core.functions', 'core.datastream', 'core.runtime',\n"
        "          'core.env', 'core.graphstream', 'core.aggregation',\n"
        "          'ops.segment', 'ops.cell_reduce', 'ops.windowed_reduce',\n"
        "          'ops.neighborhood', 'models.triangles',\n"
        "          'models.workloads', 'io.sources', 'native'):\n"
        "    importlib.import_module('gelly_streaming_tpu_torch.' + m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'gelly_streaming_tpu'\n"
        "             or n.startswith('gelly_streaming_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_iteration_and_keyed_windows():
    """The runtime's fixpoint iteration (iterate / close_with) and keyed
    and all-window folds, reduces and sums, against the JAX package."""
    def build(pkg):
        def run(env):
            head = env.generate_sequence(1, 6).iterate(max_iterations=50)
            step = head.map(lambda x: x // 2).filter(lambda x: x > 0)
            head.close_with(step)
            pairs = env.from_collection([(i % 3, i) for i in range(12)])
            keyed = pairs.key_by(0).time_window(pkg.Time.seconds(1))
            return [step, keyed.fold(0, lambda a, v: a * 2 + v[1]),
                    keyed.reduce(lambda a, b: (a[0], a[1] + b[1])),
                    keyed.sum(1),
                    pairs.time_window_all(pkg.Time.seconds(1)).sum(1)]
        return run

    got = []
    for pkg, env, fmt in ((P, _penv(), p_csv_line),
                          (J, _jenv(), j_csv_line)):
        sinks = [s.collect() for s in build(pkg)(env)]
        env.execute()
        got.append([sorted(fmt(v) for v in env.results_of(s))
                    for s in sinks])
    assert got[0] == got[1] and all(got[0])
