"""Iterative connected components.

Port of the JAX package's `models/iterative_cc.py`: two designs for the
reference's feedback-loop CC (example/IterativeConnectedComponents.java:52-168):

- `iterative_connected_components` — the reference's shape: a stream
  iteration whose body (`AssignComponents`) keeps per-key component
  sets, relabels on merges, and re-emits relabeled (vertex, component)
  records into the feedback edge until quiescence.

- `TorchIterativeConnectedComponents` — the device replacement (the
  JAX package's `TpuIterativeConnectedComponents`): no feedback queue;
  each batch is folded into the carried labels by one union-find call
  (ops/unionfind.connected_components_with_labels: the kernel
  `gs_cc_fixpoint` on the card, the plain fixpoint on the CPU). Same
  fixpoint; its `state_dict` ({"labels", "ids"}) loads into the JAX
  form and the JAX form's into it.
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np

from ..core.datastream import DataStream
from ..ops import segment as seg_ops
from ..ops import unionfind
from ..core.platform import resolve_device
from ..utils.interning import make_interner


class AssignComponents:
    """Stateful component assigner (reference:
    IterativeConnectedComponents.java:67-168). Input records are
    (vertex, vertex) edges — including fed-back (vertex, component)
    relabels; emits (vertex, component) updates."""

    def __init__(self):
        self._components: Dict[int, Set[int]] = {}
        self._comp_of: Dict[int, int] = {}

    def __call__(self, edge, collect) -> None:
        source, target = edge[0], edge[1]
        source_comp = self._comp_of.get(source, -1)
        target_comp = self._comp_of.get(target, -1)

        if source_comp != -1 and target_comp != -1:
            if source_comp != target_comp:
                self._merge(source_comp, target_comp, collect)
        elif source_comp != -1:
            self._add_to_existing(source_comp, target, collect)
        elif target_comp != -1:
            self._add_to_existing(target_comp, source, collect)
        else:
            self._create(source, target, collect)

    def _set_comp(self, comp: int, vertices: Set[int]) -> None:
        self._components[comp] = vertices
        for v in vertices:
            self._comp_of[v] = comp

    def _create(self, source: int, target: int, collect) -> None:
        comp = min(source, target)
        self._set_comp(comp, {source, target})
        collect((source, comp))
        collect((target, comp))

    def _add_to_existing(self, comp: int, to_add: int, collect) -> None:
        vertices = self._components.pop(comp)
        if comp >= to_add:
            # the new vertex id becomes the component id: relabel everyone
            for v in vertices:
                collect((v, to_add))
            vertices.add(to_add)
            self._set_comp(to_add, vertices)
        else:
            vertices.add(to_add)
            self._set_comp(comp, vertices)
            collect((to_add, comp))

    def _merge(self, source_comp: int, target_comp: int, collect) -> None:
        src_set = self._components.pop(source_comp)
        trg_set = self._components.pop(target_comp)
        comp = min(source_comp, target_comp)
        relabeled = trg_set if comp == source_comp else src_set
        for v in relabeled:
            collect((v, comp))
        src_set |= trg_set
        self._set_comp(comp, src_set)


def iterative_connected_components(edges: DataStream,
                                   max_iterations: int = 1000) -> DataStream:
    """Feedback-loop CC (reference: IterativeConnectedComponents.java:56-58):
    relabel records re-enter the loop until no more updates."""
    iteration = edges.iterate(max_iterations=max_iterations)
    result = iteration.key_by(0).flat_map(AssignComponents())
    iteration.close_with(result)
    return result


class TorchIterativeConnectedComponents:
    """Carried union-find labels, one device call a batch.

    Vertex ids get stable dense slots (IncrementalInterner); the label
    vector is carried on the host and padded to a bucket that grows by
    doubling, so a batch costs O(E_batch + V_bucket) device work, not a
    rebuild of the whole history. `device=None` is the card (raising
    without one); `device="cpu"` runs the plain fixpoint.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._interner = None  # chosen (native vs python) on first batch
        self._labels = np.arange(0, dtype=np.int32)  # dense slot -> dense root

    def process_batch(self, src: np.ndarray, dst: np.ndarray):
        """Union a batch of edges into the carried labeling; returns the
        (vertex, component) pairs whose component changed, component =
        the smallest-slot vertex's id (first-seen vertex of the
        component, matching min-label semantics in arrival order)."""
        if self._interner is None:
            self._interner = make_interner(np.asarray(src))
        s = self._interner.intern_array(np.asarray(src))
        d = self._interner.intern_array(np.asarray(dst))
        v = len(self._interner)
        vb = seg_ops.bucket_size(v)
        old = self._labels
        labels = np.arange(vb, dtype=np.int32)
        labels[: len(old)] = old
        new = unionfind.connected_components_with_labels(
            s, d, labels, vb, device=self.device)
        changed_slots = np.nonzero(new[:v] != labels[:v])[0]
        # also report fresh vertices (slots beyond the previous state)
        fresh = np.arange(len(old), v)[new[len(old):v]
                                       == np.arange(len(old), v)]
        self._labels = new[:v]
        out = []
        for slot in np.concatenate([changed_slots, fresh]).tolist():
            out.append((self._interner.id_of(slot),
                        self._interner.id_of(int(new[slot]))))
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume (utils/checkpoint.py): the JAX form's keys
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        ids = (list(self._interner.ids_of(
                   np.arange(len(self._interner), dtype=np.int32)))
               if self._interner is not None else [])
        if all(isinstance(i, (int, np.integer)) for i in ids):
            ids = np.asarray(ids, np.int64)  # compact array form
        return {"labels": self._labels, "ids": ids}

    def load_state_dict(self, state: dict) -> None:
        ids = state["ids"]
        ids = np.asarray(ids) if len(ids) else np.asarray([], np.int64)
        self._interner = make_interner(ids)
        if len(ids):
            self._interner.intern_array(ids)
        self._labels = np.asarray(state["labels"], np.int32)
