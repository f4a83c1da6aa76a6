"""Lazy operator DAG for the host-side stream driver.

Copy of the JAX package's `core/plan.py`. The reference builds a Flink
operator graph and submits it with `env.execute()` (e.g.
WindowTriangles.java:57-74). The same lazy programming model here:
transformations append `OpNode`s to a DAG; execution (core/runtime.py)
pushes timestamped record batches through it. Hot operators
("window_batch" nodes) hand columnar window batches to the port's
device kernels instead of running per-record host code.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Optional, Sequence

_ids = itertools.count()


class OpNode:
    """One operator in the dataflow plan.

    kind: source | map | flat_map | filter | key_by | window | window_all |
          union | broadcast | project | iterate | iterate_body | sink |
          neighborhood | graph_aggregation | custom
    """

    def __init__(self, kind: str, parents: Sequence["OpNode"] = (), **params: Any):
        self.id = next(_ids)
        self.kind = kind
        self.parents = list(parents)
        self.params = params
        self.parallelism: Optional[int] = None

    def __repr__(self) -> str:
        return f"OpNode({self.kind}#{self.id})"


class KeySpec:
    """How a keyed exchange extracts keys — field positions or a selector fn.

    Mirrors Flink `keyBy(fields...)` / `keyBy(KeySelector)` as used at
    SimpleEdgeStream.java:159-167 and WindowTriangles.java:64.
    """

    def __init__(self, fields: Optional[Sequence[int]] = None,
                 selector: Optional[Callable[[Any], Any]] = None):
        if (fields is None) == (selector is None):
            raise ValueError("exactly one of fields/selector required")
        self.fields = tuple(fields) if fields is not None else None
        self.selector = selector

    def key_of(self, value: Any) -> Any:
        if self.selector is not None:
            return self.selector(value)
        if len(self.fields) == 1:
            return value[self.fields[0]]
        return tuple(value[f] for f in self.fields)
