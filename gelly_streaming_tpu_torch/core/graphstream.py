"""Core graph-stream API: GraphStream / SimpleEdgeStream / GraphWindowStream.

Port of the JAX package's `core/graphstream.py`, the reference's L2
layer (GraphStream.java:38-141, SimpleEdgeStream.java:59-539,
GraphWindowStream.java:47-182). A graph stream never materializes the
graph, only summaries held in operator state (reference README "A Graph
Streaming Model"); windows become columnar COO batches run by the
neighborhood kernels of ops/neighborhood.py on the environment's device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from ..ops import neighborhood
from .datastream import DataStream
from .gtime import AscendingTimestampExtractor, Time, TimeCharacteristic
from .plan import OpNode
from .types import NULL, Edge, EdgeDirection, Vertex


class GraphStream:
    """Abstract contract of any graph stream (reference: GraphStream.java:43-140)."""

    def get_context(self):
        raise NotImplementedError

    def get_vertices(self) -> DataStream:
        raise NotImplementedError

    def get_edges(self) -> DataStream:
        raise NotImplementedError

    def map_edges(self, fn) -> "GraphStream":
        raise NotImplementedError

    def filter_vertices(self, fn) -> "GraphStream":
        raise NotImplementedError

    def filter_edges(self, fn) -> "GraphStream":
        raise NotImplementedError

    def distinct(self) -> "GraphStream":
        raise NotImplementedError

    def get_degrees(self) -> DataStream:
        raise NotImplementedError

    def get_in_degrees(self) -> DataStream:
        raise NotImplementedError

    def get_out_degrees(self) -> DataStream:
        raise NotImplementedError

    def number_of_edges(self) -> DataStream:
        raise NotImplementedError

    def number_of_vertices(self) -> DataStream:
        raise NotImplementedError

    def undirected(self) -> "GraphStream":
        raise NotImplementedError

    def reverse(self) -> "GraphStream":
        raise NotImplementedError

    def aggregate(self, graph_aggregation) -> DataStream:
        raise NotImplementedError


class SimpleEdgeStream(GraphStream):
    """The one concrete graph stream: wraps a DataStream of Edge records
    (reference: SimpleEdgeStream.java:59-94; ingestion-time ctor at :73-77,
    event-time ctor with ascending-timestamp extractor at :90-94)."""

    def __init__(self, edges: DataStream, env=None,
                 timestamp_extractor: Optional[AscendingTimestampExtractor] = None):
        self.env = env if env is not None else edges.env
        if timestamp_extractor is not None:
            self.env.set_stream_time_characteristic(TimeCharacteristic.EVENT_TIME)
            node = OpNode("assign_timestamps", [edges.node],
                          extractor=timestamp_extractor)
            edges = DataStream(self.env, node)
        self.edges = edges

    def get_context(self):
        return self.env

    def get_edges(self) -> DataStream:
        return self.edges

    def get_vertices(self) -> DataStream:
        """Distinct vertex stream: emit both endpoints, keep first occurrence
        (reference: EmitSrcAndTarget + FilterDistinctVertices,
        SimpleEdgeStream.java:120-125,185-206)."""

        def emit_src_and_target(edge, collect):
            collect(Vertex(edge.source, NULL))
            collect(Vertex(edge.target, NULL))

        seen = set()

        def filter_distinct(vertex):
            if vertex.id in seen:
                return False
            seen.add(vertex.id)
            return True

        return (self.edges.flat_map(emit_src_and_target)
                .key_by(0).filter(filter_distinct))

    # ------------------------------------------------------------------
    # transformations
    # ------------------------------------------------------------------
    def map_edges(self, fn: Callable[[Edge], Any]) -> "SimpleEdgeStream":
        """Map each edge's value (reference: SimpleEdgeStream.java:221-251)."""
        return SimpleEdgeStream(
            self.edges.map(lambda e: Edge(e.source, e.target, fn(e))), self.env
        )

    def filter_edges(self, fn: Callable[[Edge], bool]) -> "SimpleEdgeStream":
        return SimpleEdgeStream(self.edges.filter(fn), self.env)

    def filter_vertices(self, fn: Callable[[Vertex], bool]) -> "SimpleEdgeStream":
        """Keep an edge iff the filter accepts both endpoints
        (reference: ApplyVertexFilterToEdges, SimpleEdgeStream.java:268-285)."""
        return SimpleEdgeStream(
            self.edges.filter(
                lambda e: fn(Vertex(e.source, NULL)) and fn(Vertex(e.target, NULL))
            ),
            self.env,
        )

    def distinct(self) -> "SimpleEdgeStream":
        """Per-source neighbor dedup, first occurrence wins
        (reference: DistinctEdgeMapper, SimpleEdgeStream.java:305-327)."""
        seen: dict = {}

        def dedup(edge, collect):
            nbrs = seen.setdefault(edge.source, set())
            if edge.target not in nbrs:
                nbrs.add(edge.target)
                collect(edge)

        return SimpleEdgeStream(
            self.edges.key_by(0).flat_map(dedup), self.env
        )

    def reverse(self) -> "SimpleEdgeStream":
        return SimpleEdgeStream(self.edges.map(lambda e: e.reverse()), self.env)

    def undirected(self) -> "SimpleEdgeStream":
        """Emit each edge and its reverse (reference: SimpleEdgeStream.java:347-365)."""

        def both(edge, collect):
            collect(edge)
            collect(edge.reverse())

        return SimpleEdgeStream(self.edges.flat_map(both), self.env)

    def union(self, other: "SimpleEdgeStream") -> "SimpleEdgeStream":
        return SimpleEdgeStream(self.edges.union(other.edges), self.env)

    # ------------------------------------------------------------------
    # continuous properties
    # ------------------------------------------------------------------
    def _degree_stream(self, collect_in: bool, collect_out: bool) -> DataStream:
        """Continuous degree stream: one improving update per contributing
        edge (reference: DegreeTypeSeparator + DegreeMapFunction,
        SimpleEdgeStream.java:444-482)."""

        def separator(edge, collect):
            if collect_out:
                collect(Vertex(edge.source, 1))
            if collect_in:
                collect(Vertex(edge.target, 1))

        counts: dict = {}

        def running_count(vertex):
            counts[vertex.id] = counts.get(vertex.id, 0) + vertex.value
            return Vertex(vertex.id, counts[vertex.id])

        return self.aggregate(separator, running_count)

    def get_degrees(self) -> DataStream:
        return self._degree_stream(True, True)

    def get_in_degrees(self) -> DataStream:
        return self._degree_stream(True, False)

    def get_out_degrees(self) -> DataStream:
        return self._degree_stream(False, True)

    def number_of_vertices(self) -> DataStream:
        """Continuously improving distinct-vertex count
        (reference: SimpleEdgeStream.java:370-387)."""
        seen: set = set()

        def vertex_count(vertex, collect):
            seen.add(vertex.id)
            collect(len(seen))

        def separator(edge, collect):
            collect(Vertex(edge.source, 1))
            collect(Vertex(edge.target, 1))

        return self.global_aggregate(separator, vertex_count, True)

    def number_of_edges(self) -> DataStream:
        """Running total edge count, duplicates included
        (reference: TotalEdgeCountMapper, SimpleEdgeStream.java:392-408)."""
        state = {"n": 0}

        def count(_edge):
            state["n"] += 1
            return state["n"]

        return self.edges.map(count).set_parallelism(1)

    def global_aggregate(self, edge_mapper, vertex_mapper,
                         collect_updates: bool) -> DataStream:
        """Parallelism-1 global aggregate pipeline; optionally emit only on
        value change (reference: SimpleEdgeStream.java:509-539)."""
        result = (self.edges.flat_map(edge_mapper).set_parallelism(1)
                  .flat_map(vertex_mapper).set_parallelism(1))
        if collect_updates:
            prev = {"v": object()}

            def on_change(value, collect):
                if value != prev["v"]:
                    prev["v"] = value
                    collect(value)

            result = result.flat_map(on_change).set_parallelism(1)
        return result

    # ------------------------------------------------------------------
    # aggregation & discretization
    # ------------------------------------------------------------------
    def aggregate(self, graph_aggregation_or_edge_mapper,
                  vertex_mapper=None) -> DataStream:
        """Two overloads, matching the reference's:

        aggregate(graph_aggregation) — run a summary aggregation
        (reference: SimpleEdgeStream.java:104-106).

        aggregate(edge_mapper, vertex_mapper) — the generic continuous
        aggregate: flat-map each edge into keyed vertex records, then
        apply a stateful per-key map emitting one improving update per
        input (reference: SimpleEdgeStream.java:493-498; basis of the
        degree streams, :417-498).
        """
        if vertex_mapper is None:
            return graph_aggregation_or_edge_mapper.run(self.get_edges())
        return (self.edges.flat_map(graph_aggregation_or_edge_mapper)
                .key_by(0).map(vertex_mapper))

    def slice(self, size: Time,
              direction: EdgeDirection = EdgeDirection.OUT,
              slide: "Time" = None) -> "GraphWindowStream":
        """Discretize into tumbling windows keyed so a vertex's whole
        neighborhood lands in one partition
        (reference: SimpleEdgeStream.java:139-171: IN → reverse() then key
        by source; OUT → key by source; ALL → undirected() doubling then
        key by source).

        Pass `slide` for SLIDING windows — each edge then contributes to
        every window whose [start, start+size) span covers its
        timestamp. The substrate (Flink timeWindow(size, slide))
        supports this; the reference's examples only use tumbling."""
        if direction == EdgeDirection.IN:
            stream = self.reverse()
        elif direction == EdgeDirection.OUT:
            stream = self
        elif direction == EdgeDirection.ALL:
            stream = self.undirected()
        else:
            raise ValueError("Illegal edge direction")
        return GraphWindowStream(self.env, stream.get_edges(), size, slide)


class GraphWindowStream:
    """A stream of discrete graphs: tumbling windows over keyed edges
    (reference: GraphWindowStream.java:47-53).

    Neighborhood ops execute per window as device work over the
    window's COO batch — fold/reduce are incremental segment kernels,
    apply materializes padded neighborhoods (SURVEY.md §3.2).
    """

    def __init__(self, env, keyed_edges: DataStream, size: Time,
                 slide: Time = None):
        self.env = env
        self.edges = keyed_edges
        self.size = size
        self.slide = slide

    def _window_node(self, kernel) -> DataStream:
        node = OpNode("window_batch", [self.edges.node],
                      size_ms=self.size.milliseconds,
                      slide_ms=(self.slide.milliseconds
                                if self.slide is not None else None),
                      kernel=kernel)
        return DataStream(self.env, node)

    def fold_neighbors(self, initial_or_fold, fold_udf=None) -> DataStream:
        """Per-(vertex, window) incremental fold
        (reference: GraphWindowStream.java:62-87).

        Call as fold_neighbors(initial, EdgesFold) for the host path or
        fold_neighbors(TorchEdgesFold) for the device path.
        """
        spec = initial_or_fold if fold_udf is None else (initial_or_fold, fold_udf)
        return self._window_node(neighborhood.make_fold_kernel(spec,
                                                               self.env))

    def reduce_on_edges(self, reduce_udf) -> DataStream:
        """Per-(vertex, window) reduce of edge values, projected to
        (vertexId, value) (reference: GraphWindowStream.java:101-121)."""
        return self._window_node(neighborhood.make_reduce_kernel(reduce_udf,
                                                                 self.env))

    def apply_on_neighbors(self, apply_udf) -> DataStream:
        """Buffered whole-neighborhood apply, 0..n outputs per vertex
        (reference: GraphWindowStream.java:130-182)."""
        return self._window_node(neighborhood.make_apply_kernel(apply_udf,
                                                                self.env))
