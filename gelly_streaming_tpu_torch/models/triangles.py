"""Window triangle count, the north-star workload, on the record API.

Port of the JAX package's `models/triangles.py`. For the reference's
WindowTriangles (example/WindowTriangles.java:61-66): instead of
materializing O(d²) candidate-pair records and shuffling them twice
(slice → candidates → keyBy(pair) → window count → global sum), each
tumbling window's COO batch is interned and counted exactly by the
port's `triangle_count` on the environment's device: the dense
contraction (csrc/dense_triangles.cu) up to 4096 interned vertices, the
sparse route (a host CSR build, csrc/intersect.cu's row intersection)
past it. Output records are (count, window_max_timestamp) tuples, the
reference's `timeWindowAll(...).sum(0)` emission (:66).

`generate_candidate_edges` / `count_triangles` reproduce the
intermediate-record semantics of the reference's two window UDFs
(:83-116, :119-140) for the API-parity pipeline
(models/workloads.window_triangles_pipeline).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core.datastream import DataStream
from ..core.gtime import Time
from ..core.plan import OpNode
from ..ops import segment as seg_ops
from ..ops import triangles as tri_ops


class WindowTriangleCount:
    """Exact sliced triangle count, one device count a window."""

    def __init__(self, window_time: Time):
        self.window_time = window_time

    def run(self, graph) -> DataStream:
        """graph: a SimpleEdgeStream. Returns a stream of
        (triangle_count, window_max_ts)."""
        edges = graph.get_edges()
        env = graph.env

        def kernel(window_edges, wmax) -> List[Tuple[tuple, int]]:
            src = np.asarray([e.source for e in window_edges])
            dst = np.asarray([e.target for e in window_edges])
            uniq, (s, d) = seg_ops.intern(src, dst)
            n = tri_ops.triangle_count(s, d, len(uniq), env.device)
            return [((n, wmax), wmax)]

        node = OpNode("window_batch", [edges.node],
                      size_ms=self.window_time.milliseconds, kernel=kernel)
        return DataStream(env, node)


# ----------------------------------------------------------------------
# API-parity UDFs (the reference's two-stage candidate pipeline)
# ----------------------------------------------------------------------

def generate_candidate_edges(vertex_id, neighbors, collect):
    """Per-vertex window apply: emit each (vertex, neighbor) as a real-edge
    record (flag False) and every distinct neighbor pair with both ids
    greater than the vertex as a candidate record (flag True)
    (reference: GenerateCandidateEdges, WindowTriangles.java:83-116,
    including the j=i self-pair quirk)."""
    seen = []
    seen_set = set()
    for nbr, _val in neighbors:
        collect((vertex_id, nbr, False))
        if nbr not in seen_set:
            seen_set.add(nbr)
            seen.append(nbr)
    for i in range(len(seen) - 1):
        for j in range(i, len(seen)):
            if seen[i] > vertex_id and seen[j] > vertex_id:
                collect((seen[i], seen[j], True))


def count_triangles(_key, window, values, collect):
    """Per-(pair, window) count: number of candidate records if at least
    one real-edge record shares the group
    (reference: CountTriangles, WindowTriangles.java:119-140)."""
    candidates = sum(1 for v in values if v[2])
    edges = sum(1 for v in values if not v[2])
    if edges > 0:
        collect((candidates, window.max_timestamp()))
