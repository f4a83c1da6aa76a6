"""DataStream API — the slice of Flink's streaming surface the reference uses.

Covers exactly the transformation set inventoried in SURVEY.md §1/L1:
map, flatMap, filter, keyBy, project, union, broadcast, setParallelism,
print, writeAsText/Csv, timeWindow, timeWindowAll(+sum), iterate/closeWith.
(reference usage: SimpleEdgeStream.java throughout; WindowTriangles.java:61-66;
IterativeConnectedComponents.java:56-58).

These are thin lazy wrappers over `plan.OpNode`; the runtime executes them.
Copy of the JAX package's `core/datastream.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .gtime import Time
from .plan import KeySpec, OpNode


class DataStream:
    def __init__(self, env, node: OpNode):
        self.env = env
        self.node = node

    # ------------------------------------------------------------------
    # stateless transformations
    # ------------------------------------------------------------------
    def map(self, fn: Callable[[Any], Any]) -> "DataStream":
        return DataStream(self.env, OpNode("map", [self.node], fn=fn))

    def flat_map(self, fn: Callable[[Any, Callable], None]) -> "DataStream":
        """fn(value, collect) — `collect(out)` emits one record downstream.

        Stateful flat-mappers (objects with per-key dicts, like the
        reference's Rich functions) are supported: fn may be a callable
        object holding state. State lives for the life of the plan — a
        plan is a one-shot job, like a Flink program; `execute()` refuses
        to run twice.
        """
        return DataStream(self.env, OpNode("flat_map", [self.node], fn=fn))

    def filter(self, fn: Callable[[Any], bool]) -> "DataStream":
        return DataStream(self.env, OpNode("filter", [self.node], fn=fn))

    def project(self, *fields: int) -> "DataStream":
        return DataStream(self.env, OpNode("project", [self.node], fields=fields))

    def union(self, *others: "DataStream") -> "DataStream":
        return DataStream(
            self.env, OpNode("union", [self.node] + [o.node for o in others])
        )

    def broadcast(self) -> "DataStream":
        """Replicate the stream to every parallel subtask
        (reference: BroadcastTriangleCount.java:42)."""
        return DataStream(self.env, OpNode("broadcast", [self.node]))

    def parallel_flat_map(self, fn_factory: Callable[[], Any],
                          parallelism: int) -> "DataStream":
        """`parallelism` independent stateful flat-map instances, each
        seeing this (typically broadcast) stream in full — the
        broadcast + parallel RichFlatMapFunction pattern
        (reference: BroadcastTriangleCount.java:42-45)."""
        return DataStream(
            self.env,
            OpNode("parallel_flat_map", [self.node],
                   parallelism=parallelism, fn_factory=fn_factory),
        )

    def set_parallelism(self, parallelism: int) -> "DataStream":
        self.node.parallelism = parallelism
        return self

    # ------------------------------------------------------------------
    # keying / windowing
    # ------------------------------------------------------------------
    def key_by(self, *fields, selector: Optional[Callable] = None) -> "KeyedStream":
        spec = KeySpec(selector=selector) if selector else KeySpec(fields=fields)
        return KeyedStream(self.env, self.node, spec)

    def time_window_all(self, size: Time,
                        slide: Optional[Time] = None) -> "AllWindowedStream":
        return AllWindowedStream(self.env, self.node, size, slide)

    # ------------------------------------------------------------------
    # iteration (reference: IterativeConnectedComponents.java:56-58)
    # ------------------------------------------------------------------
    def iterate(self, max_iterations: int = 1000) -> "IterativeStream":
        head = OpNode("iterate", [self.node], max_iterations=max_iterations)
        return IterativeStream(self.env, head)

    # ------------------------------------------------------------------
    # sinks
    # ------------------------------------------------------------------
    def print_(self) -> "DataStream":
        node = OpNode("sink", [self.node], mode="print")
        self.env._register_sink(node)
        return DataStream(self.env, node)

    # Alias matching examples written against the reference naming.
    print = print_

    def write_as_csv(self, path: str, overwrite: bool = True) -> "DataStream":
        node = OpNode("sink", [self.node], mode="csv", path=path, overwrite=overwrite)
        self.env._register_sink(node)
        return DataStream(self.env, node)

    def write_as_text(self, path: str, overwrite: bool = True) -> "DataStream":
        node = OpNode("sink", [self.node], mode="text", path=path, overwrite=overwrite)
        self.env._register_sink(node)
        return DataStream(self.env, node)

    def collect(self) -> "DataStream":
        """Buffer results in memory; retrieve after execute() via
        `env.results_of(stream)`. (Test convenience; the reference reads
        back CSV files instead.)"""
        node = OpNode("sink", [self.node], mode="collect")
        self.env._register_sink(node)
        return DataStream(self.env, node)


class KeyedStream:
    """Stream hash-partitioned by key — the process/network boundary in the
    reference (SURVEY.md §3 'PROCESS/NETWORK BOUNDARY')."""

    def __init__(self, env, parent: OpNode, key_spec: KeySpec):
        self.env = env
        self.parent = parent
        self.key_spec = key_spec
        self.node = OpNode("key_by", [parent], key_spec=key_spec)

    def time_window(self, size: Time,
                    slide: Optional[Time] = None) -> "WindowedStream":
        """Tumbling windows by default; pass `slide` for SLIDING windows
        (Flink's KeyedStream.timeWindow(size, slide) — part of the
        substrate surface, though the reference's examples only ever
        use the tumbling form, SimpleEdgeStream.java:159-167)."""
        return WindowedStream(self.env, self.node, self.key_spec, size,
                              slide)

    def map(self, fn) -> DataStream:
        """Keyed stateful map: fn(value) -> value; fn may be a callable object
        holding per-key state (reference: DegreeMapFunction,
        SimpleEdgeStream.java:465-482)."""
        return DataStream(self.env, OpNode("keyed_map", [self.node], fn=fn))

    def flat_map(self, fn) -> DataStream:
        return DataStream(self.env, OpNode("keyed_flat_map", [self.node], fn=fn))

    def filter(self, fn) -> DataStream:
        """Keyed stateful filter (reference: FilterDistinctVertices,
        SimpleEdgeStream.java:194-206)."""
        return DataStream(self.env, OpNode("keyed_filter", [self.node], fn=fn))


class WindowedStream:
    """Tumbling (slide=None) or sliding time windows over a keyed stream
    (reference: KeyedStream.timeWindow → WindowedStream)."""

    def __init__(self, env, parent: OpNode, key_spec: KeySpec, size: Time,
                 slide: Optional[Time] = None):
        self.env = env
        self.parent = parent
        self.key_spec = key_spec
        self.size = size
        self.slide = slide

    def _slide_ms(self) -> Optional[int]:
        return self.slide.milliseconds if self.slide is not None else None

    def fold(self, initial: Any, fn: Callable[[Any, Any], Any]) -> DataStream:
        """Incremental per-(key,window) fold, arrival order
        (reference: GraphWindowStream.java:63, WindowGraphAggregation.java:58)."""
        node = OpNode(
            "window", [self.parent], key_spec=self.key_spec,
            size_ms=self.size.milliseconds, slide_ms=self._slide_ms(),
            op="fold", initial=initial, fn=fn,
        )
        return DataStream(self.env, node)

    def reduce(self, fn: Callable[[Any, Any], Any]) -> DataStream:
        node = OpNode(
            "window", [self.parent], key_spec=self.key_spec,
            size_ms=self.size.milliseconds, slide_ms=self._slide_ms(),
            op="reduce", fn=fn,
        )
        return DataStream(self.env, node)

    def apply(self, fn) -> DataStream:
        """Buffered window apply: fn(key, window, values, collect)
        (reference: WindowedStream.apply, GraphWindowStream.java:131)."""
        node = OpNode(
            "window", [self.parent], key_spec=self.key_spec,
            size_ms=self.size.milliseconds, slide_ms=self._slide_ms(),
            op="apply", fn=fn,
        )
        return DataStream(self.env, node)

    def sum(self, field: int) -> DataStream:
        node = OpNode(
            "window", [self.parent], key_spec=self.key_spec,
            size_ms=self.size.milliseconds, slide_ms=self._slide_ms(),
            op="sum", field=field,
        )
        return DataStream(self.env, node)


class AllWindowedStream:
    """Non-keyed tumbling/sliding windows
    (reference: WindowTriangles.java:66)."""

    def __init__(self, env, parent: OpNode, size: Time,
                 slide: Optional[Time] = None):
        self.env = env
        self.parent = parent
        self.size = size
        self.slide = slide

    def _slide_ms(self) -> Optional[int]:
        return self.slide.milliseconds if self.slide is not None else None

    def sum(self, field: int) -> DataStream:
        node = OpNode(
            "window_all", [self.parent], size_ms=self.size.milliseconds,
            slide_ms=self._slide_ms(), op="sum", field=field,
        )
        return DataStream(self.env, node)

    def apply(self, fn) -> DataStream:
        node = OpNode(
            "window_all", [self.parent], size_ms=self.size.milliseconds,
            slide_ms=self._slide_ms(), op="apply", fn=fn,
        )
        return DataStream(self.env, node)


class IterativeStream(DataStream):
    """Feedback loop (reference: DataStream.iterate()/closeWith,
    IterativeConnectedComponents.java:56-58).

    Records entering the loop are processed by the body; records fed back
    via close_with() re-enter until quiescence (finite-stream fixpoint).
    """

    def __init__(self, env, head: OpNode):
        super().__init__(env, head)
        self._head = head

    def close_with(self, feedback: DataStream) -> DataStream:
        self._head.params["feedback"] = feedback.node
        return feedback
