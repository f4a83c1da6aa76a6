"""Windowed GNN message passing: one exact GCN round per tumbling window
against a carried [vb+1, F] feature slab.

Port of the JAX package's `ops/gnn_window.py` (DESIGN.md §23 there):
the lattice helpers (:79-169), `GnnEngineBase` (:268-420),
`GnnSummaryEngine` (:422-472) and the numpy twin `GnnHostEngine`
(:528-608). Each chunk of up to MAX_WINDOWS windows costs one h2d of its
[W, eb] stack, one `gnn_round.GnnRound` call (the CUDA kernel on a
card, the plain PyTorch version on the CPU) and one d2h of its [4, W]
summaries, through SummaryEngineBase's ingress pipeline (prep and h2d on
a worker pool, rounds dispatched in chunk order, summaries read one
chunk behind). The engines run the standard wire only, as the JAX
`GnnEngineBase` does:

  max_feat         largest feature of rows [:vb], in lattice units
  active_vertices  rows of [:vb] with a feature > 0
  feat_checksum    wrapping int32 sum of the whole slab (row vb too)
  msg_edges        valid slots of the window (messages sent)

Exactness: features live on the 2^-5 grid as integer units in
[0, UNIT_CAP]; weights are snapped to the same grid with |W| ≤
weight_cap(F), so |p·W| < 2^24 and every intermediate is an integer in
float32; a window's aggregate stays below 2^24 by `agg_shift(eb)`.
Summation order is then free, and the port is bit-equal to the JAX
package and to `GnnHostEngine`. A window with no valid slot holds the
slab (padded windows depend on it). Messages flow src → dst, one per
valid slot: self-loops and duplicates each send one.

`state_dict()` has the JAX engine's keys and layout (carry = (h,) plus a
`gnn` section with feat_dim, act and the snapped weights), so a
checkpoint of either package loads into the other.

`build_gnn_cohort_scan` runs the same rounds for the rows of a tenant
slab (core/tenancy.GnnTenantCohort).

`GnnResidentEngine` (the JAX package's :475-526) runs the same rounds
at GS_RESIDENT_SPB windows a dispatch, each super-batch one replayed
CUDA graph of the GNN round over the slab (ops/resident_engine.py).

Host hooks: SummaryEngineBase's, with the JAX engines' tier and program
names in the health marks and provenance records ("gnn_scan",
"gnn_resident", "host"; "gnn_round"). The engines read GS_GNN_F and
GS_GNN_ACT where feature_dim or activation is None (the JAX package's
:286-288); the round's dispatch goes through `metrics.wrap_dispatch`
("gnn_scan", "gnn_resident"), and a device engine states its round's
cost to the observatory at construction (`gnn_round.register_cost_model`,
the JAX `register_gnn_cost_model`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.platform import resolve_device
from ..utils import knobs
from ..utils import metrics
from . import resident_engine
from . import segment as seg_ops
from .gnn_round import (ACTIVATIONS, AGG_EXACT_LOG2, UNIT_CAP, GnnRound,
                        agg_shift, gnn_round_plain, register_cost_model,
                        slab_summaries)
from . import ingress_pipeline
from .scan_analytics import SummaryEngineBase, _to_host
from .staging import ChunkStager, HostCopy

__all__ = ["AGG_EXACT_LOG2", "GnnEngineBase", "GnnHostEngine",
           "GnnResidentEngine", "GnnSummaryEngine", "MATMUL_EXACT_F", "Q_BITS", "UNIT_CAP",
           "agg_shift", "build_gnn_cohort_scan", "default_features",
           "default_weights",
           "gnn_round_plain", "snap_features", "snap_weights",
           "weight_cap", "weight_shift"]

Q_BITS = 5                    # storage grid 2^-Q_BITS (units of 1/32)
MATMUL_EXACT_F = 64           # F ≤ 64 dots exactly at full weight width

_ACTS_NP = {
    "relu": lambda z: np.maximum(z, 0.0),
    "abs": np.abs,
    "identity": lambda z: z,
}


def weight_shift(F: int) -> int:
    """Weight-grid coarsening for wide feature dims: F ≤ 64 keeps the
    full ±512-unit weight range; each doubling beyond halves the weight
    cap so |P·W| stays under 2^24."""
    return max(0, (int(F) - 1).bit_length() - 6)


def weight_cap(F: int) -> int:
    return max(1, (UNIT_CAP + 1) >> weight_shift(F))


def snap_weights(W, b, F: int):
    """Snap real-valued weights onto the lattice: round to the 2^-5
    grid, clip to the F-derived cap. Returns (W_units, b_units) as
    integer-valued float32 arrays."""
    cap = float(weight_cap(F))
    wu = np.clip(np.rint(np.asarray(W, np.float64) * (1 << Q_BITS)),
                 -cap, cap).astype(np.float32)
    bu = np.clip(np.rint(np.asarray(b, np.float64) * (1 << Q_BITS)),
                 -cap, cap).astype(np.float32)
    if wu.shape != (F, F) or bu.shape != (F,):
        raise ValueError(
            "GNN weights must be W [F, F] and b [F] at F=%d; got %s "
            "and %s" % (F, wu.shape, bu.shape))
    return wu, bu


def snap_features(feats, vb: int, F: int) -> np.ndarray:
    """Snap real-valued per-vertex features onto the storage lattice:
    2^-5 grid, clipped to [0, UNIT_CAP] units. Accepts [n, F] for
    n ≤ vb; missing rows stay zero."""
    f = np.asarray(feats, np.float64)
    if f.ndim != 2 or f.shape[1] != F or f.shape[0] > vb:
        raise ValueError(
            "features must be [n ≤ vb=%d, F=%d]; got %s"
            % (vb, F, f.shape))
    units = np.clip(np.rint(f * (1 << Q_BITS)), 0,
                    UNIT_CAP).astype(np.float32)
    slab = np.zeros((vb + 1, F), np.float32)
    slab[:units.shape[0]] = units
    return slab


def default_features(vb: int, F: int, seed: int = 0) -> np.ndarray:
    """Deterministic small-integer feature slab: units in [0, 8)."""
    rng = np.random.RandomState(seed)
    slab = np.zeros((vb + 1, F), np.float32)
    slab[:vb] = rng.randint(0, 8, size=(vb, F)).astype(np.float32)
    return slab


def default_weights(F: int):
    """Identity layer at value 1.0 (32 lattice units), zero bias."""
    return np.eye(F, dtype=np.float32), np.zeros(F, np.float32)


def build_gnn_cohort_scan(eb: int, vb: int, F: int, act: str,
                          device=None):
    """N tenants' GNN windows in one call, the counterpart of the JAX
    package's `build_gnn_cohort_scan` (gnn_window.py:240-265):
    run(carries[N, vb+1, F], W, b, src[N, Wn, eb], dst, valid, live) ->
    (carries, (max_feat, active_vertices, feat_checksum, msg_edges)),
    each output [N, Wn] int32 as the JAX form's. The float32 carries are
    updated in place and returned; the (shared) weights and the slab are
    tensors on `device`. `live` is a host sequence of N ints: row n's
    windows up to and including its last one with a valid slot (0 for a
    pad row), which the caller knows from the slab it built.

    Both padding axes are inert by the round's empty-window hold, so
    nothing is launched for them: row n's rounds run through one
    `GnnRound` (the GNN kernel on a card, `gnn_rounds_plain` on the CPU;
    one aggregate scratch shared in stream order) on its first live[n]
    windows; the held windows after them repeat the last one's summaries
    with no messages, and a pad row reports its held slab. Nothing is
    copied back to the host."""
    if act not in ACTIVATIONS:
        raise ValueError("unknown GNN activation %r (choices: %s)"
                         % (act, sorted(ACTIVATIONS)))
    rnd = GnnRound(vb, F, resolve_device(device))

    def run(carries, W, b, src, dst, valid, live):
        if src.dim() != 3 or src.shape[2] != eb \
                or tuple(carries.shape) != (src.shape[0], vb + 1, F):
            raise ValueError("GNN cohort scan at eb=%d vb+1=%d F=%d given "
                             "carries %s and a %s slab"
                             % (eb, vb + 1, F, tuple(carries.shape),
                                tuple(src.shape)))
        rows, windows = src.shape[:2]
        if len(live) != rows or not all(0 <= k <= windows for k in live):
            raise ValueError("live must give each of the %d rows a window "
                             "count in [0, %d], got %r"
                             % (rows, windows, list(live)))
        sums = torch.zeros(rows, 4, windows, dtype=torch.int32,
                           device=src.device)
        for n, k in enumerate(live):
            k = int(k)
            if k:
                part = torch.empty(4, k, dtype=torch.int32,
                                   device=src.device)
                rnd(carries[n], W, b, src[n, :k], dst[n, :k],
                    valid[n, :k], act, part)
                sums[n, :, :k] = part
                sums[n, :3, k:] = part[:3, k - 1:k]
            else:
                sums[n, :3] = torch.stack(slab_summaries(carries[n]))[:, None]
        return carries, tuple(sums[:, i] for i in range(4))

    return run


def _wrap_i32(total) -> np.ndarray:
    """Two's-complement int32 wrap of an exact int64 sum."""
    return np.asarray(total, np.int64).astype(np.int32)


class GnnEngineBase(SummaryEngineBase):
    """The GNN engines' shared part over SummaryEngineBase's chunk loop:
    the [vb+1, F] float32 feature-slab carry, snapped weights, the GNN
    summary dicts and the checkpoint layout (carry + `gnn` section).
    Subclasses set device (or none) and provide `_dispatch_async`, whose
    outputs are a chunk's [4, W] summaries."""

    METRICS_TIER = "gnn_scan"
    PROGRAM = "gnn_round"

    def _configure(self, edge_bucket: int, vertex_bucket: int,
                   feature_dim, activation) -> None:
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.F = int(feature_dim if feature_dim is not None
                     else knobs.get_int("GS_GNN_F"))
        self.act = str(activation if activation is not None
                       else knobs.get_str("GS_GNN_ACT"))
        if self.act not in ACTIVATIONS:
            raise ValueError(
                "unknown GNN activation %r (exact-parity choices: %s)"
                % (self.act, sorted(ACTIVATIONS)))
        if not 1 <= self.F <= 256:
            raise ValueError("feature_dim %d out of range [1, 256]"
                             % self.F)
        self._w_units, self._b_units = snap_weights(
            *default_weights(self.F), self.F)
        self.stage_timers = ingress_pipeline.StageTimers()

    # -- weights / features -------------------------------------------
    def set_weights(self, W, b=None) -> None:
        """Adopt a dense-update layer, snapped onto the lattice."""
        if b is None:
            b = np.zeros(self.F, np.float32)
        self._w_units, self._b_units = snap_weights(W, b, self.F)
        self._weights_changed()

    def _weights_changed(self) -> None:
        """Device engines refresh their device copies of the weights."""

    def weights(self):
        """(W_units, b_units): the snapped lattice representation."""
        return self._w_units.copy(), self._b_units.copy()

    def load_features(self, feats) -> None:
        """Seed the feature slab from real values (snapped), at a window
        boundary."""
        self._adopt_carry((self._to_carry(snap_features(feats, self.vb,
                                                        self.F)),))

    def load_feature_units(self, slab) -> None:
        """Adopt a [vb+1, F] slab of lattice units as it is."""
        slab = np.asarray(slab, np.float32)
        if slab.shape != (self.vb + 1, self.F):
            raise ValueError("unit slab must be [vb+1=%d, F=%d]; got %s"
                             % (self.vb + 1, self.F, slab.shape))
        self._adopt_carry((self._to_carry(slab),))

    # -- carry / checkpoint -------------------------------------------
    def _init_carry(self):
        return (self._to_carry(np.zeros((self.vb + 1, self.F),
                                        np.float32)),)

    def _check_carry(self, carry) -> None:
        if len(carry) != 1 or carry[0].shape != (self.vb + 1, self.F) \
                or not np.issubdtype(carry[0].dtype, np.floating):
            raise ValueError(
                "carry must be (h,) with h a float [vb+1=%d, F=%d] slab, "
                "got %s" % (self.vb + 1, self.F,
                            [(a.dtype, a.shape) for a in carry]))

    def state(self) -> np.ndarray:
        """[vb, F] feature snapshot in lattice units."""
        return _to_host(self._carry[0])[:self.vb]

    def state_dict(self) -> dict:
        state = super().state_dict()
        state["gnn"] = {
            "feat_dim": self.F,
            "act": self.act,
            "weights": self._w_units.copy(),
            "bias": self._b_units.copy(),
        }
        return state

    def load_state_dict(self, state: dict) -> None:
        g = state.get("gnn") or {}
        if int(g.get("feat_dim", self.F)) != self.F:
            raise ValueError(
                "feature-width mismatch: checkpoint carries F=%s, engine "
                "runs F=%d" % (g.get("feat_dim"), self.F))
        act = g.get("act")
        if act is not None and act != self.act:
            raise ValueError(
                "activation mismatch: checkpoint was folded with act=%r, "
                "engine runs act=%r" % (act, self.act))
        super().load_state_dict(state)
        if g.get("weights") is not None:
            self._w_units, self._b_units = (
                np.asarray(g["weights"], np.float32).copy(),
                np.asarray(g["bias"], np.float32).copy())
            self._weights_changed()

    # -- summary assembly ---------------------------------------------
    def _finalize_summaries(self, at: int, res: np.ndarray, src, dst,
                            out: list) -> None:
        for maxf, active, csum, nmsg in res.T:
            out.append({"max_feat": int(maxf),
                        "active_vertices": int(active),
                        "feat_checksum": int(csum),
                        "msg_edges": int(nmsg)})
        self.windows_done += res.shape[1]

    def warm_fallback(self) -> None:
        """No recount path to warm."""


class GnnSummaryEngine(GnnEngineBase):
    """Windowed GNN rounds over chunks of windows at fixed buckets
    (edge_bucket, vertex_bucket) and feature width, one `GnnRound` call
    per MAX_WINDOWS windows against the device-resident slab (the round
    owns the kernel's aggregate scratch).

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. `feature_dim` and
    `activation` None read GS_GNN_F and GS_GNN_ACT."""

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 feature_dim: int = None, activation: str = None,
                 device=None):
        self._configure(edge_bucket, vertex_bucket, feature_dim,
                        activation)
        self.device = resolve_device(device)
        self._ring = ChunkStager(self.device, slots=self._ring_slots())
        self._round = GnnRound(self.vb, self.F, self.device)
        self._run = metrics.wrap_dispatch("gnn_scan", self._round)
        register_cost_model(self.eb, self.vb, self.F, self.MAX_WINDOWS,
                            self.device)
        self._weights_changed()
        self.reset()

    def _to_carry(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32)).to(self.device)

    def _weights_changed(self) -> None:
        self._wdev = torch.from_numpy(self._w_units).to(self.device)
        self._bdev = torch.from_numpy(self._b_units).to(self.device)

    def _dispatch_async(self, staged, wire: str = "standard"):
        src, dst, v = self._ring.take(staged)
        sums = torch.empty(4, src.shape[0], dtype=torch.int32,
                           device=self.device)
        self._run(self._carry[0], self._wdev, self._bdev, src, dst, v,
                  self.act, sums)
        self._ring.done(staged)
        return HostCopy(sums)


class GnnResidentEngine(GnnSummaryEngine):
    """The resident tier of the GNN engine: GnnSummaryEngine at
    `superbatch` windows a dispatch (default GS_RESIDENT_SPB), each
    super-batch one replayed CUDA graph of the GNN round over the slab,
    the weights and one staging slot (ops/resident_engine
    .SuperBatchGraphs), GS_RESIDENT_SLOTS super-batches prepped and
    copied ahead. The slab is updated in place; `state_dict` copies it
    and leaves it live. Summaries, slab and checkpoints equal
    GnnSummaryEngine's bit for bit."""

    METRICS_TIER = "gnn_resident"
    _adopt_carry = resident_engine.adopt_carry_in_place

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 feature_dim: int = None, activation: str = None,
                 device=None, superbatch: int = None):
        super().__init__(edge_bucket, vertex_bucket, feature_dim,
                         activation, device)
        self.MAX_WINDOWS = seg_ops.bucket_size(
            superbatch if superbatch else
            resident_engine.resident_spb(self.eb))
        self._graphs = resident_engine.SuperBatchGraphs("gnn_resident")
        self._run_resident = metrics.wrap_dispatch("gnn_resident",
                                                   self._replay)
        self._warmed = set()
        # buffers the graphs bind, made now so they never move: the
        # round's aggregate scratch and every staging slot
        if self.device.type == "cuda":
            self._round.scratch = torch.empty_like(self._carry[0])
        self._ring.reserve(self._ring.nbytes(self._specs(self.MAX_WINDOWS)))

    @property
    def INGEST_SLOTS(self):
        return resident_engine.ring_slots()

    def _specs(self, w: int) -> list:
        return [((w, self.eb), np.int32), ((w, self.eb), np.int32),
                ((w, self.eb), np.bool_)]

    def _weights_changed(self) -> None:
        # into the tensors the graphs bind, where they exist
        if getattr(self, "_wdev", None) is None:
            super()._weights_changed()
            return
        self._wdev.copy_(torch.from_numpy(self._w_units))
        self._bdev.copy_(torch.from_numpy(self._b_units))

    def _fold(self, h, W, b, src, dst, valid) -> torch.Tensor:
        sums = torch.empty(4, src.shape[0], dtype=torch.int32,
                           device=src.device)
        self._round(h, W, b, src, dst, valid, self.act, sums)
        return sums

    def _warm(self, w: int) -> None:
        """One all-padding super-batch of w windows on a throwaway slab,
        waited for (a no-op on the CPU)."""
        if self.device.type != "cuda" or w in self._warmed:
            return
        dev = self.device
        pad = torch.full((w, self.eb), self.vb, dtype=torch.int32,
                         device=dev)
        self._fold(torch.zeros_like(self._carry[0]), self._wdev, self._bdev,
                   pad, pad, torch.zeros(w, self.eb, dtype=torch.bool,
                                         device=dev))
        torch.cuda.synchronize(dev)
        self._warmed.add(w)

    def _static(self, tensors) -> tuple:
        return (self._carry[0], self._wdev, self._bdev) + tuple(tensors)

    def _prepare_round(self, widths, wire: str) -> None:
        if self.device.type != "cuda":
            return
        for w in widths:
            for slot in range(self._ring.slot_count):
                tensors = self._ring.slot_tensors(slot, self._specs(w))
                self._graphs.capture((w, slot), self._static(tensors),
                                     self._fold,
                                     warm=lambda w=w: self._warm(w))

    def _dispatch_async(self, staged, wire: str = "standard"):
        tensors = self._ring.take(staged)
        sums = self._run_resident(*self._static(tensors),
                                  slot=self._ring.slot_index(staged))
        self._ring.done(staged)
        return HostCopy(sums)

    def _replay(self, *static, slot: int):
        """The super-batch's graph over the slab, the weights and the
        stack in staging slot `slot`, replayed (captured at its first
        use)."""
        w = static[-1].shape[0]
        return self._graphs.run((w, slot), static, self._fold,
                                warm=lambda: self._warm(w))


class GnnHostEngine(GnnEngineBase):
    """Numpy twin of the GNN engine: the same chunk loop, window cuts,
    checkpoint layout and summary dicts, each window's round replayed in
    numpy (`np.add.at` aggregation, float32 product: exact by the
    lattice argument), with no torch device. The card's oracle where the
    JAX package is not installed. Loads a GnnSummaryEngine checkpoint of
    equal buckets and feature width."""

    METRICS_TIER = "host"

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 feature_dim: int = None, activation: str = None):
        self._configure(edge_bucket, vertex_bucket, feature_dim,
                        activation)
        self.reset()

    @classmethod
    def from_state(cls, state: dict) -> "GnnHostEngine":
        """A twin built from a GNN engine checkpoint, and adopting it."""
        g = state.get("gnn") or {}
        twin = cls(int(state["edge_bucket"]), int(state["vertex_bucket"]),
                   feature_dim=int(g.get("feat_dim") or 16),
                   activation=g.get("act") or "relu")
        twin.load_state_dict(state)
        return twin

    def _to_carry(self, a) -> np.ndarray:
        return np.array(a, np.float32)

    def _h2d(self, args, ordinal: int):
        return args                    # no device: the host stacks as they are

    def _materialize(self, raw) -> np.ndarray:
        return raw

    def _dispatch_async(self, args, wire: str = "standard") -> np.ndarray:
        s, d, valid = args
        vb, F = self.vb, self.F
        sh = agg_shift(self.eb)
        sc = np.float32(2.0 ** -sh)
        cap = np.float32(UNIT_CAP)
        actf = _ACTS_NP[self.act]
        (h,) = self._carry
        h = h.copy()
        sums = np.zeros((4, s.shape[0]), np.int32)
        for i in range(s.shape[0]):
            v = valid[i]
            if v.any():
                si = np.where(v, s[i], vb).astype(np.int64)
                di = np.where(v, d[i], vb).astype(np.int64)
                msgs = h[si]
                if sh:
                    msgs = np.floor(msgs * sc)
                m = np.zeros((vb + 1, F), np.float32)
                np.add.at(m, di, msgs)
                p = np.minimum(h + np.minimum(m, cap), cap)
                z = p @ self._w_units + self._b_units
                h = np.clip(actf(z), 0.0, cap).astype(np.float32)
                h[vb] = 0.0
            # else: an empty window holds the slab
            sums[0, i] = np.int32(h[:vb].max())
            sums[1, i] = np.int32(np.sum(np.any(h[:vb] > 0, axis=1)))
            sums[2, i] = _wrap_i32(h.astype(np.int64).sum())
            sums[3, i] = np.int32(np.sum(v))
        self._carry = (h,)
        return sums
