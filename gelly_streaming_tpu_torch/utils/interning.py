"""Incremental vertex-id interning for streaming state: arbitrary
hashable vertex ids get stable dense int32 slots, assigned once on first
sight, so per-vertex state (degrees, CC labels) lives in fixed arrays
that grow by bucket doubling.

Port of the JAX package's `utils/interning.py` (:19-131). The parallel
form runs on the port's ingress pool (ops/ingress_pipeline.map_ordered)
and assigns exactly the slots of interning sequentially.
"""

from __future__ import annotations

from typing import Dict, Hashable, List

import numpy as np

from .. import native
from ..ops import ingress_pipeline


class IncrementalInterner:
    def __init__(self):
        self._to_dense: Dict[Hashable, int] = {}
        self._to_id: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._to_id)

    def intern_array(self, ids: np.ndarray) -> np.ndarray:
        """Map ids to dense slots, assigning new slots on first sight."""
        out = np.empty(len(ids), np.int32)
        to_dense = self._to_dense
        to_id = self._to_id
        for i, v in enumerate(np.asarray(ids).tolist()):
            slot = to_dense.get(v)
            if slot is None:
                slot = len(to_id)
                to_dense[v] = slot
                to_id.append(v)
            out[i] = slot
        return out

    def id_of(self, dense: int) -> Hashable:
        return self._to_id[dense]

    def ids_of(self, dense: np.ndarray) -> List[Hashable]:
        return [self._to_id[i] for i in np.asarray(dense).tolist()]


def parallel_intern_arrays(interner, arrays):
    """Intern several arrays in order, with the per-element work on the
    ingress pool and the slots of interning them one after another:

      1. parallel: each array's first-occurrence-ordered unique ids and
         the inverse map back to positions;
      2. sequential: intern only those unique lists, in array order, so
         new ids meet the interner in the order a sequential loop would
         present them;
      3. parallel: scatter the unique slots back through each inverse.

    Arrays that np.unique cannot order like the interner (objects,
    floats: NaN != NaN) and runs with the pipeline off
    (`ingress_pipeline.pipeline_enabled()`) take the sequential
    loop. Returns (dense arrays, sizes), sizes[i] = len(interner) after
    array i."""
    arrays = [np.asarray(a) for a in arrays]
    orderable = all(a.dtype.kind in "biuSU" for a in arrays)
    if (not orderable or not ingress_pipeline.pipeline_enabled()
            or len(arrays) < 2):
        out, sizes = [], []
        for a in arrays:
            out.append(interner.intern_array(a))
            sizes.append(len(interner))
        return out, sizes

    def uniques(a):
        if a.size == 0:
            return a, np.zeros(0, np.int64)
        uniq, first, inv = np.unique(a, return_index=True,
                                     return_inverse=True)
        order = np.argsort(first, kind="stable")
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order))
        return uniq[order], rank[inv.reshape(-1)]

    pairs = ingress_pipeline.map_ordered(uniques, arrays)
    dense, sizes = [], []
    for u, _inv in pairs:
        dense.append(interner.intern_array(u))
        sizes.append(len(interner))

    def scatter(i):
        d, (_u, inv) = dense[i], pairs[i]
        return (d[inv].astype(np.int32) if len(d)
                else np.zeros(0, np.int32))

    return ingress_pipeline.map_ordered(scatter, range(len(arrays))), sizes


def make_interner(ids_sample: np.ndarray = None):
    """The C++ interner for integer id streams where the native library
    is available, the Python one otherwise."""
    if (ids_sample is None
            or np.issubdtype(np.asarray(ids_sample).dtype, np.integer)) \
            and native.available():
        return native.NativeInterner()
    return IncrementalInterner()
