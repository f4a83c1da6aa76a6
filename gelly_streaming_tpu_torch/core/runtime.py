"""Host-side executor for the lazy operator DAG.

Port of the JAX package's `core/runtime.py`. Executes the plan built
by the DataStream layer: pushes timestamped records through operators,
groups tumbling windows, runs fixpoint iteration, and hands columnar
window batches to device kernels ("window_batch" nodes, the hot path;
with slide= and a kernel's pane path, one batch for all windows). Not
ported: the per-operator timing of `enable_tracing` and the metrics
marks (ROADMAP step 1.8).

Semantics notes (parity with the reference's runtime behavior):
- Finite sources → every window fires at end-of-stream, in ascending
  window-end order; records within a (key, window) keep arrival order.
  This matches the reference tests, which pin parallelism=1 "to ensure
  total ordering for windows" (ConnectedComponentsTest.java:62).
- Window results carry timestamp = window.maxTimestamp() = end - 1
  (Flink TimeWindow semantics; WindowTriangles.java:137).
- `iterate`/`close_with` runs the loop body to quiescence — the
  finite-stream fixpoint of the reference's feedback queue
  (IterativeConnectedComponents.java:56-58).
"""

from __future__ import annotations

import copy
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

from .plan import OpNode
from .types import csv_line, text_line

Record = Tuple[Any, int]  # (value, timestamp_ms)


class RuntimeContext:
    """Subtask info for rich functions
    (reference: RichMapFunction.getRuntimeContext().getIndexOfThisSubtask(),
    WindowGraphAggregation.java:74, BroadcastTriangleCount.java:131)."""

    def __init__(self, subtask_index: int, num_subtasks: int):
        self.subtask_index = subtask_index
        self.num_subtasks = num_subtasks

    def get_index_of_this_subtask(self) -> int:
        return self.subtask_index

    def get_number_of_subtasks(self) -> int:
        return self.num_subtasks


def _open(fn: Any, subtask: int = 0, num_subtasks: int = 1) -> Any:
    if hasattr(fn, "open"):
        fn.open(RuntimeContext(subtask, num_subtasks))
    return fn


class Executor:
    def __init__(self, env):
        self.env = env
        self.memo: Dict[int, List[Record]] = {}

    # ------------------------------------------------------------------
    def run(self) -> Dict[int, List[Record]]:
        # Run iteration loops first: their fixpoint evaluation memoizes
        # every body node's accumulated output, so no sink path can later
        # re-execute a stateful body operator with already-mutated state.
        for sink in self.env._sinks:
            for node in self._ancestors(sink):
                if node.kind == "iterate":
                    self.eval(node)
        results: Dict[int, List[Record]] = {}
        for sink in self.env._sinks:
            records = self.eval(sink.parents[0])
            results[sink.id] = records
            self._emit(sink, records)
        return results

    def _ancestors(self, node: OpNode) -> List[OpNode]:
        seen, order, stack = set(), [], [node]
        while stack:
            n = stack.pop()
            if n.id in seen:
                continue
            seen.add(n.id)
            order.append(n)
            stack.extend(n.parents)
            fb = n.params.get("feedback")
            if fb is not None:
                stack.append(fb)
        return order

    def _emit(self, sink: OpNode, records: List[Record]) -> None:
        mode = sink.params["mode"]
        if mode == "print":
            for value, _ts in records:
                print(text_line(value))
        elif mode in ("csv", "text"):
            import os

            fmt = csv_line if mode == "csv" else text_line
            path = sink.params["path"]
            if not sink.params.get("overwrite", True) and os.path.exists(path):
                raise FileExistsError(
                    f"sink target exists and overwrite=False: {path}"
                )
            with open(path, "w") as f:
                for value, _ts in records:
                    f.write(fmt(value) + "\n")
        # "collect" needs no side effect; records are in the results dict.

    # ------------------------------------------------------------------
    def eval(self, node: OpNode, overrides: Optional[Dict[int, List[Record]]] = None,
             cache: Optional[Dict[int, List[Record]]] = None) -> List[Record]:
        """Evaluate a node to its full record list (memoized).

        `overrides`/`cache` support iteration subgraph re-evaluation with
        the loop head's output replaced by the pending feedback records.
        """
        memo = cache if cache is not None else self.memo
        if overrides and node.id in overrides:
            return overrides[node.id]
        # Nodes upstream of a loop head are already fully evaluated in the
        # global memo — reuse them instead of re-running (possibly stateful)
        # operators once per loop pass.
        if cache is not None and node.id in self.memo:
            return self.memo[node.id]
        if node.id in memo:
            return memo[node.id]
        if node.kind == "iterate" and overrides is None:
            self._run_iteration(node)
            return self.memo[node.id]
        records = self._apply(node, overrides, cache)
        memo[node.id] = records
        return records

    # ------------------------------------------------------------------
    def _apply(self, node: OpNode, overrides, cache) -> List[Record]:
        kind = node.kind
        ev = lambda n: self.eval(n, overrides, cache)

        if kind == "source":
            return self._eval_source(node)

        if kind == "assign_timestamps":
            extractor = node.params["extractor"]
            return [
                (v, int(extractor.extract_ascending_timestamp(v)))
                for (v, _ts) in ev(node.parents[0])
            ]

        if kind == "map":
            fn = _open(node.params["fn"])
            return [(fn(v), ts) for (v, ts) in ev(node.parents[0])]

        if kind in ("flat_map", "keyed_flat_map"):
            fn = _open(node.params["fn"])
            out: List[Record] = []
            for v, ts in ev(node.parents[0]):
                fn(v, _collector(out, ts))
            return out

        if kind in ("filter", "keyed_filter"):
            fn = _open(node.params["fn"])
            return [(v, ts) for (v, ts) in ev(node.parents[0]) if fn(v)]

        if kind == "keyed_map":
            fn = _open(node.params["fn"])
            return [(fn(v), ts) for (v, ts) in ev(node.parents[0])]

        if kind == "project":
            fields = node.params["fields"]
            out = []
            for v, ts in ev(node.parents[0]):
                if len(fields) == 1:
                    out.append((v[fields[0]], ts))
                else:
                    out.append((tuple(v[f] for f in fields), ts))
            return out

        if kind == "union":
            merged: List[Record] = []
            for p in node.parents:
                merged.extend(ev(p))
            merged.sort(key=lambda r: r[1])  # stable: ties keep source order
            return merged

        if kind in ("broadcast", "key_by"):
            # Single-driver execution: partitioning is a no-op reordering-wise;
            # keying/broadcast semantics are honored by downstream operators.
            return ev(node.parents[0])

        if kind == "partition_tag":
            # Tag records with a round-robin subtask index 0..p-1 — emulates
            # the reference's rebalance → RichMapFunction subtask tagging
            # (WindowGraphAggregation.java:68-81).
            p = node.params.get("parallelism") or self.env.parallelism
            out = []
            for i, (v, ts) in enumerate(ev(node.parents[0])):
                out.append(((i % p, v), ts))
            return out

        if kind == "parallel_flat_map":
            # p independent stateful instances each seeing the full input —
            # the broadcast + parallel RichFlatMapFunction pattern
            # (BroadcastTriangleCount.java:42-45).
            p = node.params.get("parallelism") or self.env.parallelism
            proto = node.params["fn_factory"]
            out: List[Record] = []
            for i in range(p):
                fn = _open(proto(), i, p)
                for v, ts in ev(node.parents[0]):
                    fn(v, _collector(out, ts))
            out.sort(key=lambda r: r[1])
            return out

        if kind == "window":
            return self._eval_window(node, ev(node.parents[0]))

        if kind == "window_all":
            return self._eval_window_all(node, ev(node.parents[0]))

        if kind == "window_batch":
            return self._eval_window_batch(node, ev(node.parents[0]))

        if kind == "custom":
            return node.params["run"](ev(node.parents[0]) if node.parents else [])

        if kind == "iterate":
            # Inside a subgraph evaluation the head must have been overridden.
            raise RuntimeError("iterate head evaluated without override")

        raise ValueError(f"unknown op kind: {kind}")

    # ------------------------------------------------------------------
    def _eval_source(self, node: OpNode) -> List[Record]:
        items = node.params.get("items")
        if items is None:
            items = list(node.params["items_fn"]())
        clock = self.env.clock
        return [(item, clock.now_ms()) for item in items]

    # ------------------------------------------------------------------
    @staticmethod
    def _window_starts(ts: int, size: int, slide) -> List[int]:
        """Starts of every window containing ts. Tumbling (slide=None):
        the single aligned window. Sliding: all starts in (ts-size, ts]
        aligned to the slide (Flink's SlidingEventTimeWindows
        assignment), ascending."""
        if slide is None or slide == size:
            return [ts - ts % size]
        starts = []
        s = ts - ts % slide
        while s > ts - size:
            starts.append(s)
            s -= slide
        starts.reverse()
        return starts

    def _eval_window(self, node: OpNode, records: List[Record]) -> List[Record]:
        key_spec = node.params["key_spec"]
        size = node.params["size_ms"]
        slide = node.params.get("slide_ms")
        groups: Dict[Tuple[Any, int], List[Record]] = defaultdict(list)
        order: List[Tuple[Any, int]] = []
        for v, ts in records:
            for wstart in self._window_starts(ts, size, slide):
                k = (key_spec.key_of(v), wstart)
                if k not in groups:
                    order.append(k)
                groups[k].append((v, ts))
        # fire in ascending window end; ties by first arrival
        order.sort(key=lambda kw: kw[1])
        out: List[Record] = []
        for key, wstart in order:
            wmax = wstart + size - 1
            values = [v for v, _ in groups[(key, wstart)]]
            out.extend(
                (v, wmax) for v in self._run_window_fn(node, key, wmax, values)
            )
        return out

    def _eval_window_all(self, node: OpNode, records: List[Record]) -> List[Record]:
        size = node.params["size_ms"]
        slide = node.params.get("slide_ms")
        groups: Dict[int, List[Any]] = defaultdict(list)
        for v, ts in records:
            for wstart in self._window_starts(ts, size, slide):
                groups[wstart].append(v)
        out: List[Record] = []
        for wstart in sorted(groups):
            wmax = wstart + size - 1
            out.extend(
                (v, wmax)
                for v in self._run_window_fn(node, None, wmax, groups[wstart])
            )
        return out

    def _run_window_fn(self, node: OpNode, key, wmax: int, values: List[Any]) -> List[Any]:
        op = node.params["op"]
        if op == "fold":
            acc = copy.deepcopy(node.params["initial"])
            fn = node.params["fn"]
            for v in values:
                acc = fn(acc, v)
            return [acc]
        if op == "reduce":
            fn = node.params["fn"]
            acc = values[0]
            for v in values[1:]:
                acc = fn(acc, v)
            return [acc]
        if op == "apply":
            fn = node.params["fn"]
            out: List[Any] = []
            window = _Window(wmax)
            fn(key, window, values, out.append)
            return out
        if op == "sum":
            field = node.params["field"]
            total = sum(v[field] for v in values)
            first = list(values[0])
            first[field] = total
            return [tuple(first)]
        raise ValueError(f"unknown window op {op}")

    # ------------------------------------------------------------------
    def _eval_window_batch(self, node: OpNode, records: List[Record]) -> List[Record]:
        """Device hot path: group records into windows and hand each
        window to a columnar kernel: kernel(values, window_max_ts) -> [(v, ts)].

        Sliding windows (slide_ms set): when the kernel advertises a
        pane path (`kernel.pane_kernel`) and the slide divides the
        size, records are grouped ONCE by slide-sized pane and all
        windows are computed in one batched device dispatch from
        per-pane partials, no edge duplication. Otherwise each record
        is assigned to every covering window (factor size/slide
        duplication, always correct).
        """
        size = node.params["size_ms"]
        slide = node.params.get("slide_ms")
        kernel = node.params["kernel"]
        pane_kernel = getattr(kernel, "pane_kernel", None)
        if (slide is not None and slide != size and pane_kernel is not None
                and size % slide == 0):
            panes: Dict[int, List[Any]] = defaultdict(list)
            for v, ts in records:
                panes[ts - ts % slide].append(v)
            return pane_kernel(panes, size, slide)
        groups: Dict[int, List[Any]] = defaultdict(list)
        for v, ts in records:
            for wstart in self._window_starts(ts, size, slide):
                groups[wstart].append(v)
        out: List[Record] = []
        for wstart in sorted(groups):
            out.extend(kernel(groups[wstart], wstart + size - 1))
        return out

    # ------------------------------------------------------------------
    def _run_iteration(self, head: OpNode) -> None:
        feedback = head.params.get("feedback")
        if feedback is None:
            raise RuntimeError("iterate() without close_with()")
        max_iter = head.params.get("max_iterations", 1000)
        pending = self.eval(head.parents[0])
        head_all: List[Record] = []
        body_all: Dict[int, List[Record]] = defaultdict(list)
        # Stateful fns in the body persist across loop passes (user fn
        # objects hold their own state); every body node's per-pass output
        # accumulates so sinks on any branch of the loop body see the full
        # stream, not just the feedback edge.
        for _ in range(max_iter):
            if not pending:
                break
            head_all.extend(pending)
            cache: Dict[int, List[Record]] = {}
            fed = self.eval(feedback, overrides={head.id: pending}, cache=cache)
            for nid, recs in cache.items():
                body_all[nid].extend(recs)
            pending = fed
        else:
            if pending:
                raise RuntimeError(
                    f"iteration did not converge within {max_iter} passes "
                    f"({len(pending)} records still pending)"
                )
        self.memo[head.id] = head_all
        for nid, recs in body_all.items():
            self.memo[nid] = recs


class _Window:
    def __init__(self, max_timestamp: int):
        self._max = max_timestamp

    def max_timestamp(self) -> int:
        return self._max


def _collector(out: List[Record], ts: int) -> Callable[[Any], None]:
    return lambda value: out.append((value, ts))


def execute(env) -> Dict[int, List[Record]]:
    return Executor(env).run()
