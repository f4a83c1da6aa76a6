"""Neighborhood UDF interfaces.

Host forms mirror the reference's three UDF interfaces exactly
(EdgesFold.java:46, EdgesReduce.java:42, EdgesApply.java:47); they are
copies of the JAX package's (`core/functions.py` :14-52). The Torch*
forms stand in for its Jax* forms (:57-109): their fns take and return
torch tensors on the engine's device, one lane a segment (a vertex of
the window), so a fn written for scalars with `torch.where` runs
unchanged on a whole window's lanes at once (ops/neighborhood.py).
"""

from __future__ import annotations

from typing import Any, Callable, Optional


class EdgesFold:
    """Host fold UDF: fn(accum, vertex_id, neighbor_id, edge_value) -> accum
    (reference: EdgesFold.java:46)."""

    def __init__(self, fn: Callable[[Any, Any, Any, Any], Any] = None):
        self._fn = fn

    def fold_edges(self, accum, vertex_id, neighbor_id, edge_value):
        if self._fn is None:
            raise NotImplementedError
        return self._fn(accum, vertex_id, neighbor_id, edge_value)


class EdgesReduce:
    """Host reduce UDF: fn(a, b) -> value (reference: EdgesReduce.java:42)."""

    def __init__(self, fn: Callable[[Any, Any], Any] = None):
        self._fn = fn

    def reduce_edges(self, a, b):
        if self._fn is None:
            raise NotImplementedError
        return self._fn(a, b)


class EdgesApply:
    """Host apply UDF: fn(vertex_id, neighbors, collect) with `neighbors`
    an iterable of (neighbor_id, edge_value) (reference: EdgesApply.java:47)."""

    def __init__(self, fn: Callable[[Any, Any, Callable], None] = None):
        self._fn = fn

    def apply_on_edges(self, vertex_id, neighbors, collect):
        if self._fn is None:
            raise NotImplementedError
        return self._fn(vertex_id, neighbors, collect)


# ----------------------------------------------------------------------
# device forms
# ----------------------------------------------------------------------

class TorchEdgesFold:
    """Device fold: fn(acc_tree, vertex_id, neighbor_id, edge_value) ->
    acc_tree over 1-D tensors (one lane a vertex); `init` is the
    accumulator tree (tuples, lists or dicts of scalars or 0-d tensors).

    Runs as the stepped fold of ops/segment.py: each vertex folds its
    edges in arrival order (GraphWindowStream.java:77-80), the t-th edge
    of every vertex in one call. `emit` maps (vertex_id, acc row) to the
    emitted record; by default the accumulator tuple itself.
    """

    def __init__(self, init, fn, emit=None):
        self.init = init
        self.fn = fn
        self.emit = emit


class TorchEdgesReduce:
    """Device reduce of neighborhood edge values, in three tiers
    (fastest first):
    - `name` ('sum'|'min'|'max'): the named monoid on the cell-reduce
      kernel (ops/cell_reduce.py);
    - `fn` + `associative=True`: the log-step flagged scan (the
      combine tree reorders the applications, which associativity
      licenses);
    - `fn` alone: the stepped fold in exact arrival order
      (GraphWindowStream.java:107-121); correct for any elementwise fn.
    """

    def __init__(self, fn=None, name: Optional[str] = None,
                 associative: bool = False):
        if fn is None and name is None:
            raise ValueError("need fn or name")
        self.fn = fn
        self.name = name
        self.associative = associative


class TorchEdgesApply:
    """Device apply over a padded neighborhood view: fn(vertex_ids [n],
    neighbor_ids [n, max_deg], edge_values [n, max_deg], mask [n,
    max_deg]) -> a tree of [n] tensors, one row a vertex of the window
    (reduce over the last dim). For variable-arity outputs use the host
    EdgesApply.
    """

    def __init__(self, fn, emit=None):
        self.fn = fn
        self.emit = emit
