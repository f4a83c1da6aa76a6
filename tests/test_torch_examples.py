"""The six example programs that run the summary-aggregation models
(examples/connected_components.py, bipartiteness_check.py,
iterative_connected_components.py, centralized_weighted_matching.py,
broadcast_triangle_count.py, incidence_sampling_triangle_count.py),
each built in-process with the port's API (device="cpu" for the device
forms) and with the JAX package's, on the example's built-in default
data and on tests/test_examples.py's edge file (the matching example on
the MovieLens fixture too): the output lines are equal, as the example
writes them. Ingestion time runs on a clock pinned at 0 so a whole input
is one window."""

import os

import numpy as np
import pytest
import torch

import gelly_streaming_tpu as jgs
import gelly_streaming_tpu.models as jax_models
from gelly_streaming_tpu.core import types as jax_types
from gelly_streaming_tpu.models import iterative_cc as jax_iterative
from gelly_streaming_tpu.models import matching as jax_matching
from gelly_streaming_tpu.models import sampling_triangles as jax_sampling

import gelly_streaming_tpu_torch as pgs
import gelly_streaming_tpu_torch.models as port_models
from gelly_streaming_tpu_torch.core import types as port_types
from gelly_streaming_tpu_torch.models import iterative_cc as port_iterative
from gelly_streaming_tpu_torch.models import matching as port_matching
from gelly_streaming_tpu_torch.models import sampling_triangles as \
    port_sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = "1 2 100\n1 3 150\n3 2 200\n2 4 250\n3 4 300\n4 5 400\n"
MOVIELENS = os.path.join(REPO, "tests", "fixtures", "movielens_2k_sorted.txt")

# each package's namespace, the port's device forms under the JAX names
PORT = dict(pkg=pgs, types=port_types, iterative=port_iterative,
            matching=port_matching, sampling=port_sampling,
            ConnectedComponents=port_models.ConnectedComponents,
            TpuConnectedComponents=port_models.TorchConnectedComponents,
            BipartitenessCheck=port_models.BipartitenessCheck,
            TpuBipartitenessCheck=port_models.TorchBipartitenessCheck,
            TpuIterative=lambda: port_iterative.
            TorchIterativeConnectedComponents(device="cpu"))
JAX = dict(pkg=jgs, types=jax_types, iterative=jax_iterative,
           matching=jax_matching, sampling=jax_sampling,
           ConnectedComponents=jax_models.ConnectedComponents,
           TpuConnectedComponents=jax_models.TpuConnectedComponents,
           BipartitenessCheck=jax_models.BipartitenessCheck,
           TpuBipartitenessCheck=jax_models.TpuBipartitenessCheck,
           TpuIterative=jax_iterative.TpuIterativeConnectedComponents)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("examples") / "edges.txt"
    p.write_text(EDGES)
    return str(p)


def _env(ns):
    pkg = ns["pkg"]
    if pkg is pgs:
        return pkg.StreamEnvironment(clock=pkg.ManualClock(0), device="cpu")
    return pkg.StreamEnvironment(clock=pkg.ManualClock(0))


def _pair_edges(ns, env, path, pairs):
    """The example's edge source: `path` lines 'src dst ...' or the
    built-in `pairs`, with NullValue values."""
    pkg = ns["pkg"]
    if path is None:
        return env.from_collection([pkg.Edge(s, t, pkg.NULL)
                                    for s, t in pairs])
    return env.read_text_file(path).map(
        lambda l: pkg.Edge(int(l.split()[0]), int(l.split()[1]), pkg.NULL))


def _collect(ns, env, stream, render):
    sink = stream.collect()
    env.execute()
    return [render(v) for v in env.results_of(sink)]


def aggregate_example(ns, cls_name, default_pairs, default_ms, path, ms):
    """connected_components.py / bipartiteness_check.py: aggregate() and
    write_as_text."""
    env = _env(ns)
    edges = _pair_edges(ns, env, path, default_pairs)
    graph = ns["pkg"].SimpleEdgeStream(edges, env)
    out = graph.aggregate(ns[cls_name](default_ms if path is None else ms))
    return _collect(ns, env, out, ns["types"].text_line)


def iterative_example(ns, device_form, path):
    """iterative_connected_components.py, both forms."""
    if path is None:
        pairs = [(1, 2), (1, 3), (2, 3), (1, 5), (6, 7), (8, 9)]
    else:
        with open(path) as f:
            pairs = [tuple(int(x) for x in l.split()[:2]) for l in f
                     if l.strip()]
    if device_form:
        updates = ns["TpuIterative"]().process_batch(
            np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs]))
    else:
        env = _env(ns)
        result = ns["iterative"].iterative_connected_components(
            env.from_collection(pairs))
        updates = _collect(ns, env, result, lambda v: v)
    return [f"({v},{c})" for v, c in updates]


def matching_example(ns, path):
    """centralized_weighted_matching.py: MovieLens lines, items shifted
    by 1,000,000 and ratings ×10."""
    pkg = ns["pkg"]
    env = _env(ns)
    if path is None:
        edges = env.from_collection([
            pkg.Edge(s, t, w) for s, t, w in
            [(1, 2, 30), (2, 3, 40), (1, 3, 10), (3, 4, 200), (4, 5, 5)]])
    else:
        def parse(line):
            user, item, rating = line.split("\t")[:3]
            return pkg.Edge(int(user), int(item) + 1_000_000,
                            int(rating) * 10)
        edges = env.read_text_file(path).map(parse)
    out = ns["matching"].centralized_weighted_matching(edges)
    return _collect(ns, env, out, ns["types"].text_line)


def sampling_example(ns, fn_name, path, vertices, samples, parallelism):
    """broadcast_triangle_count.py / incidence_sampling_triangle_count.py:
    the estimates as write_as_csv lines."""
    env = _env(ns)
    edges = _pair_edges(ns, env, path,
                        [(1, 2), (2, 3), (1, 3), (3, 4), (3, 5), (4, 5)])
    out = getattr(ns["sampling"], fn_name)(edges, samples, vertices,
                                           parallelism)
    return _collect(ns, env, out, ns["types"].csv_line)


def _same(fn, *args):
    got, want = fn(PORT, *args), fn(JAX, *args)
    assert got == want
    return got


@pytest.mark.parametrize("device_form", [False, True])
@pytest.mark.parametrize("data", ["default", "file"])
def test_connected_components_example(edge_file, device_form, data):
    cls = "TpuConnectedComponents" if device_form else "ConnectedComponents"
    path = edge_file if data == "file" else None
    lines = _same(aggregate_example, cls,
                  [(1, 2), (1, 3), (2, 3), (1, 5), (6, 7), (8, 9)], 1000,
                  path, 100)
    assert lines[-1] == ("{1=[1, 2, 3, 4, 5]}" if path else
                         "{1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}")


@pytest.mark.parametrize("device_form", [False, True])
@pytest.mark.parametrize("data", ["default", "file"])
def test_bipartiteness_example(edge_file, device_form, data):
    cls = "TpuBipartitenessCheck" if device_form else "BipartitenessCheck"
    path = edge_file if data == "file" else None
    lines = _same(aggregate_example, cls,
                  [(1, 2), (1, 3), (1, 4), (4, 5), (4, 7), (4, 9)], 500,
                  path, 100)
    assert lines[-1].startswith("(false" if path else "(true")


@pytest.mark.parametrize("device_form", [False, True])
@pytest.mark.parametrize("data", ["default", "file"])
def test_iterative_cc_example(edge_file, device_form, data):
    lines = _same(iterative_example, device_form,
                  edge_file if data == "file" else None)
    assert lines


@pytest.mark.parametrize("data", ["default", "movielens"])
def test_matching_example(data):
    lines = _same(matching_example, MOVIELENS if data == "movielens"
                  else None)
    assert any(line.startswith("ADD") for line in lines)


@pytest.mark.parametrize("fn_name", ["broadcast_triangle_count",
                                     "incidence_sampling_triangle_count"])
@pytest.mark.parametrize("data,vertices,samples,parallelism", [
    ("default", 5, 1000, 1), ("file", 5, 100, 2)])
def test_sampling_examples(edge_file, fn_name, data, vertices, samples,
                           parallelism):
    lines = _same(sampling_example, fn_name,
                  edge_file if data == "file" else None, vertices, samples,
                  parallelism)
    # the default run's scaled estimate, Σbeta · 6 edges · 3 / 1000,
    # rounds to 0, which the summer never emits
    assert bool(lines) == (data == "file")
