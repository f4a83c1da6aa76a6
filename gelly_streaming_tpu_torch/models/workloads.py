"""Runnable workload pipelines — the reference's example programs
(SURVEY.md §2.3) as composable functions. Copy of the JAX package's
`models/workloads.py`.
"""

from __future__ import annotations

from ..core.datastream import DataStream
from ..core.functions import EdgesApply
from ..core.gtime import AscendingTimestampExtractor, Time
from ..core.graphstream import SimpleEdgeStream
from ..core.types import NULL, Edge, EdgeDirection
from .triangles import count_triangles, generate_candidate_edges


def parse_edge_line(line: str) -> Edge:
    """'src trg timestamp' whitespace-separated line → Edge with the
    timestamp as value (reference: WindowTriangles.java:176-185)."""
    fields = line.split()
    return Edge(int(fields[0]), int(fields[1]), int(fields[2]))


def timestamped_graph(env, path: str) -> SimpleEdgeStream:
    """Event-time graph stream from a 'src trg ts' file; edge values are
    replaced by NullValue after timestamp extraction
    (reference: WindowTriangles.java:172-186)."""
    edges = env.read_text_file(path).map(parse_edge_line)
    stream = SimpleEdgeStream(
        edges, env,
        timestamp_extractor=AscendingTimestampExtractor(lambda e: e.value),
    )
    return stream.map_edges(lambda e: NULL)


def window_triangles_pipeline(graph: SimpleEdgeStream,
                              window_time: Time) -> DataStream:
    """The reference WindowTriangles dataflow, stage for stage
    (WindowTriangles.java:61-66): slice(ALL) → candidate generation →
    keyBy(pair) window count → all-window sum."""
    return (
        graph.slice(window_time, EdgeDirection.ALL)
        .apply_on_neighbors(EdgesApply(generate_candidate_edges))
        .key_by(0, 1)
        .time_window(window_time)
        .apply(count_triangles)
        .time_window_all(window_time)
        .sum(0)
    )
