"""Sampling-based triangle count estimators.

A copy of the JAX package's `models/sampling_triangles.py`. The state is
numpy arrays over the S instances, updated once per edge on the host: a
device launch per edge would cost more than it computes. The seeded
numpy Generators are kept (a torch.Generator draws other numbers), so
the estimates equal the JAX package's bit for bit.

Counterparts of the reference's two estimators, re-designed so the
per-sample-instance state updates are vectorized across all S instances
(state-of-arrays instead of the reference's List<SampleTriangleState>
object loop — the replicated-sampling strategy P3, SURVEY.md §2.4):

- Broadcast estimator (example/BroadcastTriangleCount.java:62-174):
  every instance sees every edge; instance i resamples its wedge
  candidate with probability 1/edge_count, draws a uniform third
  vertex, sets beta=1 when both closing edges have been seen; the
  summer scales Σbeta by maxEdges·(V-2)/samples.

- Incidence sampler (example/IncidenceSamplingTriangleCount.java:61-242):
  a parallelism-1 router flips the same coins (seeded 0xDEADBEEF,
  :78) and forwards only sampled/incident edges to per-instance
  processors — same estimate, less traffic.

Randomness is deterministic per instance (seeded numpy Generators), so
estimates are reproducible — unlike the reference's Math.random() third
-vertex draw.
"""

from __future__ import annotations


import numpy as np

from ..core.datastream import DataStream
from ..core.types import Edge
from ..utils.events import SampledEdge, TriangleEstimate


class VectorTriangleSampler:
    """S wedge-sampling instances updated as arrays per edge.

    Emits a TriangleEstimate whenever the local beta sum changes
    (reference: TriangleSampler.flatMap, BroadcastTriangleCount.java:80-134).
    """

    def __init__(self, samples: int, vertex_count: int, seed: int = 0xDEADBEEF,
                 subtask: int = 0):
        self.s = samples
        self.v = vertex_count
        self.seed = seed
        self.subtask = subtask
        self.rng = np.random.default_rng(seed + subtask)
        self.edge_count = 0
        self.src = np.full(samples, -1, np.int64)
        self.trg = np.full(samples, -1, np.int64)
        self.third = np.full(samples, -1, np.int64)
        self.src_found = np.zeros(samples, bool)
        self.trg_found = np.zeros(samples, bool)
        self.beta = np.zeros(samples, np.int64)
        self.previous = 0

    def open(self, ctx) -> None:
        # factories build instances before the subtask is known — reseed
        # here so parallel instances are independent estimators
        self.subtask = ctx.get_index_of_this_subtask()
        self.rng = np.random.default_rng(self.seed + self.subtask)

    def _resample(self, mask: np.ndarray, edge: Edge) -> None:
        n = int(mask.sum())
        if n == 0:
            return
        self.src[mask] = edge.source
        self.trg[mask] = edge.target
        third = self.rng.integers(0, self.v, n)
        # redraw any collision with the edge's endpoints
        for _ in range(64):
            bad = (third == edge.source) | (third == edge.target)
            if not bad.any():
                break
            third[bad] = self.rng.integers(0, self.v, int(bad.sum()))
        self.third[mask] = third
        self.src_found[mask] = False
        self.trg_found[mask] = False
        self.beta[mask] = 0

    def _update(self, edge: Edge) -> None:
        open_ = self.beta == 0
        s, t = edge.source, edge.target
        self.src_found |= open_ & (
            ((self.src == s) & (self.third == t))
            | ((self.src == t) & (self.third == s))
        )
        self.trg_found |= open_ & (
            ((self.trg == s) & (self.third == t))
            | ((self.trg == t) & (self.third == s))
        )
        self.beta = np.where(open_ & self.src_found & self.trg_found,
                             1, self.beta)

    def __call__(self, edge: Edge, collect) -> None:
        self.edge_count += 1
        resample = self.rng.random(self.s) < (1.0 / self.edge_count)
        self._resample(resample, edge)
        self._update(edge)
        beta_sum = int(self.beta.sum())
        if beta_sum != self.previous:
            self.previous = beta_sum
            collect(TriangleEstimate(self.subtask, self.edge_count, beta_sum))


class TriangleSummer:
    """Combine per-subtask estimates into the global running estimate
    (reference: TriangleSummer, BroadcastTriangleCount.java:138-174):
    estimate = Σbeta · maxEdges · (V-2) / samples, emitted on change."""

    def __init__(self, samples: int, vertex_count: int):
        self.samples = samples
        self.v = vertex_count
        self.results = {}
        self.max_edges = 0
        self.previous = 0

    def __call__(self, estimate: TriangleEstimate, collect) -> None:
        self.results[estimate.source_subtask] = estimate
        self.max_edges = max(self.max_edges, estimate.edge_count)
        beta_sum = sum(e.beta for e in self.results.values())
        result = int((1.0 / self.samples) * beta_sum * self.max_edges
                     * (self.v - 2))
        if result != self.previous:
            self.previous = result
            collect((self.max_edges, result))


def broadcast_triangle_count(edges: DataStream, samples: int,
                             vertex_count: int,
                             parallelism: int = 1) -> DataStream:
    """Broadcast estimator pipeline
    (reference: BroadcastTriangleCount.java:41-45): replicate the edge
    stream to `parallelism` sampler instances, funnel estimates through
    one summer."""
    local = max(1, samples // parallelism)
    sampled = edges.broadcast().parallel_flat_map(
        lambda: VectorTriangleSampler(local, vertex_count), parallelism
    )
    # normalize by the number of instances actually running (rounding /
    # the >=1-per-subtask floor can make local*parallelism != samples)
    return sampled.flat_map(
        TriangleSummer(local * parallelism, vertex_count)
    ).set_parallelism(1)


# ----------------------------------------------------------------------
# incidence sampling
# ----------------------------------------------------------------------

class EdgeSampleRouter:
    """Parallelism-1 router: flips every instance's coin, forwards
    resampled edges and edges incident to an instance's current sample
    as SampledEdge records keyed by subtask
    (reference: EdgeSampleMapper, IncidenceSamplingTriangleCount.java:61-122)."""

    def __init__(self, instance_size: int, parallelism: int,
                 seed: int = 0xDEADBEEF):
        self.n = instance_size * parallelism
        self.p = parallelism
        self.rng = np.random.default_rng(seed)
        self.sample_src = np.full(self.n, -1, np.int64)
        self.sample_trg = np.full(self.n, -1, np.int64)
        self.has_sample = np.zeros(self.n, bool)
        self.edge_count = 0

    def __call__(self, edge: Edge, collect) -> None:
        self.edge_count += 1
        flips = self.rng.random(self.n) < (1.0 / self.edge_count)
        s, t = edge.source, edge.target
        incident = self.has_sample & (
            (self.sample_src == s) | (self.sample_src == t)
            | (self.sample_trg == s) | (self.sample_trg == t)
        )
        for i in np.nonzero(flips)[0]:
            collect(SampledEdge(int(i) % self.p, int(i) // self.p, edge,
                                self.edge_count, True))
        for i in np.nonzero(~flips & incident)[0]:
            collect(SampledEdge(int(i) % self.p, int(i) // self.p, edge,
                                self.edge_count, False))
        self.sample_src[flips] = s
        self.sample_trg[flips] = t
        self.has_sample |= flips


class RoutedTriangleSampler:
    """Per-(subtask, instance) wedge state driven by routed SampledEdge
    records (reference: TriangleSampleMapper,
    IncidenceSamplingTriangleCount.java:125-203).

    The runtime executes a keyed flat-map as a single stateful instance,
    so this holds a [parallelism, instances] state matrix — each
    (subtask, instance) slot is an independent sampler, and estimates
    carry the record's subtask, matching the reference's p parallel
    mapper instances.
    """

    def __init__(self, instances: int, vertex_count: int,
                 parallelism: int = 1, seed: int = 17):
        self.v = vertex_count
        self.rng = np.random.default_rng(seed)
        shape = (parallelism, instances)
        self.src = np.full(shape, -1, np.int64)
        self.trg = np.full(shape, -1, np.int64)
        self.third = np.full(shape, -1, np.int64)
        self.src_found = np.zeros(shape, bool)
        self.trg_found = np.zeros(shape, bool)
        self.beta = np.zeros(shape, np.int64)
        self.edge_count = 0
        self.previous = np.zeros(parallelism, np.int64)

    def __call__(self, rec: SampledEdge, collect) -> None:
        edge = rec.edge
        self.edge_count = rec.edge_count
        k, i = rec.subtask, rec.instance
        if rec.resample:
            self.src[k, i] = edge.source
            self.trg[k, i] = edge.target
            third = int(self.rng.integers(0, self.v))
            for _ in range(64):  # bounded redraw (degenerate v <= 2)
                if third not in (edge.source, edge.target):
                    break
                third = int(self.rng.integers(0, self.v))
            self.third[k, i] = third
            self.src_found[k, i] = False
            self.trg_found[k, i] = False
            self.beta[k, i] = 0

        found = False
        if self.beta[k, i] == 0:
            s, t = edge.source, edge.target
            if ((self.src[k, i] == s and self.third[k, i] == t)
                    or (self.src[k, i] == t and self.third[k, i] == s)):
                self.src_found[k, i] = True
            if ((self.trg[k, i] == s and self.third[k, i] == t)
                    or (self.trg[k, i] == t and self.third[k, i] == s)):
                self.trg_found[k, i] = True
            found = bool(self.src_found[k, i] and self.trg_found[k, i])
            self.beta[k, i] = 1 if found else 0

        if found:
            beta_sum = int(self.beta[k].sum())
            if beta_sum != self.previous[k]:
                self.previous[k] = beta_sum
                collect(TriangleEstimate(k, self.edge_count, beta_sum))


def incidence_sampling_triangle_count(edges: DataStream, samples: int,
                                      vertex_count: int,
                                      parallelism: int = 1) -> DataStream:
    """Incidence-sampling pipeline
    (reference: IncidenceSamplingTriangleCount.java:38-45)."""
    local = max(1, samples // parallelism)
    routed = edges.flat_map(
        EdgeSampleRouter(local, parallelism)
    ).set_parallelism(1)
    estimates = routed.key_by(0).flat_map(
        RoutedTriangleSampler(local, vertex_count, parallelism)
    )
    return estimates.flat_map(
        TriangleSummer(local * parallelism, vertex_count)
    ).set_parallelism(1)
