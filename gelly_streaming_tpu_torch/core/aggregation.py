"""Summary-aggregation framework — the merge-tree engine.

Re-design of the reference's L3 layer (GraphAggregation.java:19-118,
WindowGraphAggregation.java:30-105): per-partition windowed folds of
edges into a summary state S, merged by a single non-blocking Merger
that emits an improved global state after every incoming partial.

Port of the JAX package's `core/aggregation.py`: the per-partition
window fold is the parallel part; with a device `fold_kernel` it runs as
one device call per window batch. The merge of partials across chips has
no code here, as in the JAX module (its :8-13): the SUM and MIN merges
are fused into the sharded window programs of parallel/sharded.py.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional

from .datastream import DataStream
from .gtime import Time
from .plan import OpNode


class GraphAggregation:
    """Abstract incremental aggregation
    (reference: GraphAggregation.java:28-56).

    update_fun(state, src, trg, value) -> state   — per-edge fold
    combine_fun(partial, current) -> state        — merge partials
    transform(state) -> output                    — optional post-map
    """

    def __init__(self, update_fun: Callable, combine_fun: Callable,
                 initial_value: Any, transient_state: bool,
                 transform: Optional[Callable] = None):
        self.update_fun = update_fun
        self.combine_fun = combine_fun
        self.initial_value = initial_value
        self.transient_state = transient_state
        self.transform = transform

    def run(self, edge_stream: DataStream) -> DataStream:
        raise NotImplementedError

    def make_merger(self) -> Callable:
        """Non-blocking incremental merger: combine each partial into the
        running global state and emit it; reset when transient
        (reference: Merger, GraphAggregation.java:90-117). Emissions are
        snapshots (deep copies) — the reference serializes at emission
        time, which our in-memory sinks must reproduce."""
        initial = self.initial_value
        combine = self.combine_fun
        transient = self.transient_state
        state = {"current": copy.deepcopy(initial)}

        def merger(partial, collect):
            state["current"] = combine(partial, state["current"])
            collect(copy.deepcopy(state["current"]))
            if transient:
                state["current"] = copy.deepcopy(initial)

        return merger


class WindowGraphAggregation(GraphAggregation):
    """Merge-tree summary aggregation
    (reference: WindowGraphAggregation.java:47-65): tag each edge with
    its partition index, fold per (partition, window), funnel all
    partials through one merger.

    With `fold_kernel` set, the per-window fold runs as a device kernel
    over the window's columnar edge batch: kernel(edges, wmax, device)
    -> S, `device` the environment's (the JAX package's kernel takes no
    device: its programs run on the default backend).
    """

    def __init__(self, update_fun: Callable, combine_fun: Callable,
                 initial_value: Any, time_millis: int,
                 transient_state: bool = False,
                 transform: Optional[Callable] = None,
                 fold_kernel: Optional[Callable] = None):
        super().__init__(update_fun, combine_fun, initial_value,
                         transient_state, transform)
        self.time_millis = time_millis
        self.fold_kernel = fold_kernel

    def run(self, edge_stream: DataStream) -> DataStream:
        env = edge_stream.env
        if self.fold_kernel is not None:
            # Device path: one kernel invocation per window batch.
            kernel = self.fold_kernel

            def window_kernel(edges, wmax):
                return [(kernel(edges, wmax, env.device), wmax)]

            node = OpNode("window_batch", [edge_stream.node],
                          size_ms=self.time_millis, kernel=window_kernel)
            partials = DataStream(env, node)
        else:
            update = self.update_fun
            tagged = DataStream(
                env, OpNode("partition_tag", [edge_stream.node],
                            parallelism=env.parallelism)
            )
            partials = tagged.key_by(0).time_window(
                Time.milliseconds_of(self.time_millis)
            ).fold(
                self.initial_value,
                lambda s, rec: update(s, rec[1].source, rec[1].target,
                                      rec[1].value),
            )

        merged = partials.flat_map(self.make_merger()).set_parallelism(1)
        if self.transform is not None:
            return merged.map(self.transform)
        return merged
