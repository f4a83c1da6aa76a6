"""Numpy twins of the sharded engines: the oracle that needs no device,
and the floor a mesh session demotes to.

Port of the JAX package's `parallel/host_twin.py` (`HostWindowEngine`
:65, `HostTriangleWindowKernel` :145, `HostSummaryEngine` :187), over
the port's numpy oracles: the carried min-label fixpoint of
ops/host_summary.py (`fixpoint`, the JAX `host_snapshot._fixpoint`), the
exact window count of ops/host_triangles.py and the per-window fold of
ops/host_summary.py (`fold_windows`). No torch device, no process group.

- `HostWindowEngine`         numpy `ShardedWindowEngine`
- `HostTriangleWindowKernel` numpy `ShardedTriangleWindowKernel`
- `HostSummaryEngine`        numpy `ShardedSummaryEngine` (and so of
                             the single-chip `StreamSummaryEngine`: the
                             carried layout is shared)

Every sharded merge ends in an all_reduce, so the carried slabs are
replicated on every rank and one rank's copy is the shard-count
independent layout: a state taken on a mesh of any size loads on a mesh
of any other size, into a single-chip engine, or into these twins, and a
twin's state loads back onto any mesh (the cross-mesh resume).

Bit-exactness is by construction: degrees are integer sums, triangle
counts are exact in every tier, and the carried min-label fixpoints end
at the canonical labeling whatever the schedule. The one deliberate
divergence (the JAX twin's too): the sharded degree fold counts its mesh
padding into the [vb+2] slab's sentinel slot vb+1 (a count that depends
on the mesh width), which the twins leave at zero; the slot feeds no
output and no `[:vb]` read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import host_summary, host_triangles
from ..ops import segment as seg_ops
from ..ops import unionfind
from ..ops.scan_analytics import SummaryEngineBase, check_summary_carry


class HostWindowEngine:
    """Numpy twin of `ShardedWindowEngine`: running degrees, carried
    min-label CC and double-cover bipartiteness, with its state layouts
    (`degree_state` / `labels` [vb+2], `bip_labels` [2vb+2]) and
    `state_dict` keys, so state hands off both ways across any mesh
    width."""

    def __init__(self, num_vertices_bucket: int = 1 << 16):
        self.vb = num_vertices_bucket
        self.reset()

    @classmethod
    def from_sharded(cls, engine) -> "HostWindowEngine":
        """Twin a live `ShardedWindowEngine`, adopting its state: the
        mid-stream demotion hand-off."""
        twin = cls(num_vertices_bucket=engine.vb)
        twin.load_state_dict(engine.state_dict())
        return twin

    def reset(self) -> None:
        self._degree_state = np.zeros(self.vb + 2, np.int32)
        self._labels = np.arange(self.vb + 2, dtype=np.int32)
        self._bip_labels: Optional[np.ndarray] = None

    @staticmethod
    def _edges(src, dst):
        return (np.asarray(src, np.int64).ravel(),
                np.asarray(dst, np.int64).ravel())

    def degrees(self, src, dst) -> np.ndarray:
        s, d = self._edges(src, dst)
        np.add.at(self._degree_state, s, 1)
        np.add.at(self._degree_state, d, 1)
        return self._degree_state[: self.vb].copy()

    def cc_labels(self, src, dst, carry: bool = True) -> np.ndarray:
        s, d = self._edges(src, dst)
        labels = (self._labels if carry
                  else np.arange(self.vb + 2, dtype=np.int32))
        self._labels = host_summary.fixpoint(labels, s, d)
        return self._labels[: self.vb].copy()

    def bipartite(self, src, dst, carry: bool = True):
        fresh = np.arange(2 * self.vb + 2, dtype=np.int32)
        labels = (self._bip_labels
                  if (carry and self._bip_labels is not None)
                  else fresh)
        s, d = self._edges(src, dst)
        s2, d2 = unionfind.double_cover_edges(s, d, self.vb)
        self._bip_labels = host_summary.fixpoint(labels, s2, d2)
        return unionfind.decode_double_cover(self._bip_labels, self.vb)

    def state_dict(self) -> dict:
        state = {
            "vb": self.vb,
            "mesh_shape": None,   # the twin is the no-mesh floor
            "degree_state": self._degree_state.copy(),
            "labels": self._labels.copy(),
        }
        if self._bip_labels is not None:
            state["bip_labels"] = self._bip_labels.copy()
        return state

    def load_state_dict(self, state: dict) -> None:
        if state["vb"] != self.vb:
            raise ValueError(
                f"vertex bucket mismatch: checkpoint has {state['vb']}, "
                f"twin built with {self.vb}")
        self._degree_state = np.asarray(state["degree_state"],
                                        np.int32).copy()
        self._labels = np.asarray(state["labels"], np.int32).copy()
        self._bip_labels = (np.asarray(state["bip_labels"],
                                       np.int32).copy()
                            if "bip_labels" in state else None)


class HostTriangleWindowKernel:
    """Numpy twin of `ShardedTriangleWindowKernel`: exact per-window
    counts by `host_triangles.window_count`, at the sharded kernel's
    resolved buckets so window boundaries cut identically. Stateless,
    like its twin."""

    def __init__(self, edge_bucket: int, vertex_bucket: int):
        # verbatim buckets: from_sharded passes the mesh kernel's
        # resolved (eb, vb), so count_stream cuts the same windows
        self.eb = int(edge_bucket)
        self.vb = int(vertex_bucket)

    @classmethod
    def from_sharded(cls, kernel) -> "HostTriangleWindowKernel":
        return cls(edge_bucket=kernel.eb, vertex_bucket=kernel.vb)

    def count(self, src: np.ndarray, dst: np.ndarray) -> int:
        if len(src) > self.eb:
            raise ValueError(f"window of {len(src)} edges exceeds edge "
                             f"bucket {self.eb}")
        return host_triangles.window_count(src, dst)

    def count_stream(self, src: np.ndarray, dst: np.ndarray) -> list:
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        eb = self.eb
        return [self.count(src[i:i + eb], dst[i:i + eb])
                for i in range(0, len(src), eb)]

    def count_windows(self, windows) -> list:
        return [self.count(np.asarray(s), np.asarray(d))
                for s, d in windows]


class HostSummaryEngine(SummaryEngineBase):
    """Numpy twin of the summary engines: the same `SummaryEngineBase`
    chunk loop, window cuts, checkpoint layout and summary dicts, every
    device stage a host fold: `_h2d` hands the host stacks on, and
    `_dispatch_async` folds each window row in numpy
    (`host_summary.fold_windows`: degrees, the min-label CC and double
    cover fixpoints, the exact count), so nothing overflows. The carry is
    numpy. Loads a `ShardedSummaryEngine` or single-chip checkpoint of
    equal buckets."""

    METRICS_TIER = "host"

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0):
        # k_bucket is accepted for the engines' constructor: the host
        # count has no K
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.stage_timers = None
        self.reset()

    @classmethod
    def from_state(cls, state: dict) -> "HostSummaryEngine":
        """A twin built from a summary engine's state (sharded or
        single-chip: the layout is shared), adopting it."""
        twin = cls(edge_bucket=int(state["edge_bucket"]),
                   vertex_bucket=int(state["vertex_bucket"]))
        twin.load_state_dict(state)
        return twin

    @classmethod
    def from_sharded(cls, engine) -> "HostSummaryEngine":
        """Twin a live `ShardedSummaryEngine` mid-stream: its replicated
        carry and cursor (the demotion hand-off; combine with
        `engine.drained_partial` after an escaping error)."""
        return cls.from_state(engine.state_dict())

    def _init_carry(self):
        return host_summary.fresh_carry(self.vb)

    def _to_carry(self, a):
        return np.array(a, np.int32)

    def _check_carry(self, carry) -> None:
        check_summary_carry(carry, self.vb)

    def _h2d(self, args, ordinal: int):
        return args

    def _dispatch_async(self, staged, wire: str):
        s, d, valid = (np.asarray(a) for a in staged)
        self._carry, mdeg, ncomp, odd, tri = host_summary.fold_windows(
            self._carry, s, d, valid)
        return np.stack([mdeg, ncomp, odd.astype(np.int32),
                         tri.astype(np.int32)])

    def _materialize(self, raw) -> np.ndarray:
        return raw

    def _finalize_summaries(self, at: int, res: np.ndarray, src, dst,
                            out: list) -> None:
        for mdeg, ncomp, odd, tri in res.T:
            out.append({"max_degree": int(mdeg),
                        "num_components": int(ncomp),
                        "odd_cycle": bool(odd), "triangles": int(tri)})
        self.windows_done += res.shape[1]

    def state(self):
        """(degrees[vb], cc_labels[vb], odd[vb]) snapshots."""
        deg, labels, cover = (np.array(x) for x in self._carry)
        odd = cover[:self.vb] == cover[self.vb + 1:2 * self.vb + 1]
        return deg[:self.vb], labels[:self.vb], odd
