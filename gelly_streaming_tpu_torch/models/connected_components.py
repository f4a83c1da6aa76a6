"""Streaming connected components via summary aggregation.

Port of the JAX package's `models/connected_components.py`, the
counterpart of the reference's `ConnectedComponents`
(library/ConnectedComponents.java:43-139): a WindowGraphAggregation
whose per-window fold unions each edge into a DisjointSet
(UpdateCC, :87-90) and whose combiner merges the smaller summary into
the larger (CombineCC, :121-130).

Two execution modes:
- `ConnectedComponents` — host fold, exact reference semantics.
- `TorchConnectedComponents` — the window fold runs on the
  environment's device (the JAX package's `TpuConnectedComponents`):
  the window is interned and labelled by ops/unionfind (the union-find
  kernel `gs_cc_fixpoint` on the card, its plain fixpoint on the CPU);
  the per-window summary is the (vertex → component-min) labeling,
  unioned into the global DisjointSet by the merger. Same results, O(E)
  device work per window and only O(V_window) host merge work.
"""

from __future__ import annotations

import numpy as np

from ..core.aggregation import WindowGraphAggregation
from ..ops import segment as seg_ops
from ..ops import unionfind
from ..utils.disjoint_set import DisjointSet


def _update_cc(ds: DisjointSet, src, trg, _value) -> DisjointSet:
    ds.union(src, trg)
    return ds


def _combine_cc(s1: DisjointSet, s2: DisjointSet) -> DisjointSet:
    if s1.size() <= s2.size():
        s2.merge(s1)
        return s2
    s1.merge(s2)
    return s1


def window_arrays(edges):
    """The window's (src, dst) id columns as numpy arrays."""
    return (np.asarray([e.source for e in edges]),
            np.asarray([e.target for e in edges]))


class ConnectedComponents(WindowGraphAggregation):
    def __init__(self, merge_window_millis: int):
        super().__init__(
            update_fun=_update_cc,
            combine_fun=_combine_cc,
            initial_value=DisjointSet(),
            time_millis=merge_window_millis,
            transient_state=False,
        )


class TorchConnectedComponents(WindowGraphAggregation):
    def __init__(self, merge_window_millis: int):
        super().__init__(
            update_fun=_update_cc,  # unused: fold_kernel takes the window
            combine_fun=_combine_cc,
            initial_value=DisjointSet(),
            time_millis=merge_window_millis,
            transient_state=False,
            fold_kernel=self._window_labels,
        )

    @staticmethod
    def _window_labels(edges, _wmax, device) -> DisjointSet:
        """Device window fold: one union-find call over the window's COO
        batch; summary = DisjointSet of (vertex, component-min) pairs."""
        uniq, (s_dense, d_dense) = seg_ops.intern(*window_arrays(edges))
        labels = unionfind.connected_components(s_dense, d_dense, len(uniq),
                                                device)
        summary = DisjointSet()
        for v, root in zip(uniq.tolist(), uniq[labels].tolist()):
            # root first: union-by-rank ties keep the component minimum
            # as representative, so printed summaries match the host
            # variant's typical output
            summary.union(root, v)
        return summary
