"""The resident tier: the summary carry kept on the device across
super-batches of many windows, each super-batch one replayed CUDA graph,
its prep and h2d on the ingress pipeline's workers ahead of it.

Port of the JAX package's `ops/resident_engine.py` (`resident_spb` :65,
`ring_slots` :89, `resolve_resident` :131, `resolve_resident_cohort`
:174, `ResidentState` :211-268, `IngestRing` :274-340, `Mailbox` :343-413,
`ResidentSummaryEngine` :419-565). There one super-batch is one jitted
`lax.scan` dispatch whose carry argument is donated, so the slabs update
in place. On the card the port's kernels already update the carry in
place (ops/window_summary.py, ops/gnn_round.py, ops/window_snapshot.py),
so `donation_supported`/`donate_kw` have no counterpart; what stands in
for "one donated dispatch a super-batch" is `SuperBatchGraphs`: the
launches of a super-batch (the summary kernel and its counter, the GNN
round, or the driver's snapshot kernel) captured once into a CUDA graph
per (windows, wire, staging slot) and replayed.

- A graph reads its inputs from one slot of the engine's staging ring
  (ops/staging.ChunkStager, its buffers reserved at the largest
  super-batch so they never move): one graph per slot, no copy into a
  graph-owned input. The carry tensors are the graph's static buffers:
  a replay updates them in place, so `state_dict` between replays sees
  exactly the windows finalized so far. The outputs are the graph's own
  tensors (its private pool); each replay's are copied to pinned host
  memory right behind it, on the same stream.
- Every launch runs once eagerly, on a throwaway carry and an
  all-padding stack, before its first capture (`warm`), so the kernels'
  one-time `cudaFuncSetAttribute` calls and the counter's scratch happen
  outside capture. Capture runs on a side stream in thread-local mode,
  so the pipeline's workers may keep copying meanwhile.
- A graph records the launches its capture made (the wrappers count
  them, and the capture's counts are taken back out): each replay adds
  them to `kernels.LAUNCHES` and one to `kernels.REPLAYS[family]`.
- On the CPU there is no graph: the same chunk loop runs the plain
  versions eagerly.

`ResidentSummaryEngine` is the fused summary engine
(ops/scan_analytics.StreamSummaryEngine) at `GS_RESIDENT_SPB` windows a
dispatch, on the compact wire wherever the vertex bucket fits uint16,
with `GS_RESIDENT_SLOTS` super-batches prepped and copied ahead; its
summaries, carry and checkpoints are those of the scan engine, bit for
bit. `GnnResidentEngine` (ops/gnn_window.py) and the driver's
`snapshot_tier="resident"` (core/driver.py) use the same graphs.

Host hooks (the JAX engine's :305, :468, :500): the engines' hooks are
SummaryEngineBase's, run at each super-batch's finalize as in the scan
twin, and a journal replay into a resident engine gives the scan twin's
carries. Each super-batch dispatch is one launch of its graph family in
the cost observatory (utils/costmodel.py, its work what the capture
launched) and goes through `metrics.wrap_dispatch` ("resident_fused",
"resident_fused_compact", "gnn_resident": the shape watch); `IngestRing`
sets the `gs_inflight_chunks` gauge.

The cohort's resident tier (core/tenancy.py `TenantCohort`, selected by
`resolve_resident_cohort`) uses the same graphs in family
"cohort_resident": one per (vertex bucket, K, tenants, windows, staging
slot), the cohort kernel and its counter over the group's stacked carry.

Selection (measured adoption, utils/evidence.py): GS_RESIDENT and
GS_COHORT_RESIDENT pin `on`/`off`; unset or `auto` adopts the resident
tier only where the device's rows all show parity and a 5% win:
`resident_ab` rows of probe `driver_resident` over the best of the scan
and native tiers (`resolve_resident`), `tenancy_ab` rows of probe
`cohort_resident` over sequential engines (`resolve_resident_cohort`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..utils import costmodel
from ..utils import evidence
from ..utils import knobs
from ..utils import metrics
from . import autotune
from . import compact_ingress
from . import ingress_pipeline
from . import segment as seg_ops
from .scan_analytics import StreamSummaryEngine

__all__ = ["IngestRing", "Mailbox", "ResidentState",
           "ResidentSummaryEngine", "SuperBatchGraphs", "resident_spb",
           "resolve_resident", "resolve_resident_cohort", "ring_slots"]


# ----------------------------------------------------------------------
# knobs / selection
# ----------------------------------------------------------------------
def resident_spb(eb: int) -> int:
    """Windows per super-batch: the GS_RESIDENT_SPB bucket (a power of
    two, default 256). The JAX package caps it by a TPU compile size;
    the kernels here take any count of windows a call (the summary body,
    the counter's plan and scratch, the GNN round and the snapshot
    kernel's grid are all sized by eb and vb, not by W), so the knob
    stands as asked. `eb` is kept for the JAX signature."""
    del eb
    return seg_ops.bucket_size(knobs.get_int("GS_RESIDENT_SPB"))


def ring_slots() -> int:
    """Ingest-ring depth (GS_RESIDENT_SLOTS, default 2): super-batches
    prepped and copied ahead of the dispatch cursor."""
    return knobs.get_int("GS_RESIDENT_SLOTS")


def _reset_resident() -> None:
    """Test hook: forget the memoized resident-tier selections."""
    evidence.forget("resident")


def _reset_resident_cohort() -> None:
    """Test hook: forget the memoized resident-cohort selections."""
    evidence.forget("resident_cohort")


def resolve_resident(device=None) -> bool:
    """Should the driver run the resident snapshot tier where no
    `snapshot_tier=` is given? GS_RESIDENT pins it (`on`/`off`); unset
    or `auto` adopts it where every `resident_ab` row of probe
    `driver_resident` on the device shows parity and the resident rate
    at 1.05× the best of the scan and native rates (on a card, in the
    worst turns)."""
    pin = knobs.get_str("GS_RESIDENT")
    if pin in ("on", "off"):
        return pin == "on"

    def gate(perf, label):
        rows = [r for r in perf.get("resident_ab", [])
                if r.get("probe") == "driver_resident"]
        if evidence.on_card(label):
            return evidence.worst_clears_bar(rows, "resident",
                                             ("scan", "native"))
        return evidence.rows_clear_bar(
            rows, "resident_edges_per_s",
            lambda r: max(r.get("scan_edges_per_s") or 0,
                          r.get("native_edges_per_s") or 0))

    return evidence.choose("resident", device, gate, False)


def resolve_resident_cohort(device=None) -> bool:
    """Should a tenant cohort keep each group's carries stacked on the
    device between rounds (the resident cohort tier, core/tenancy.py)?
    GS_COHORT_RESIDENT pins it (`on`/`off`); unset or `auto` adopts it
    where every `tenancy_ab` row of probe `cohort_resident` on the device
    shows parity and the cohort's rate at 1.05× the sequential one (on a
    card, in the worst turns)."""
    pin = knobs.get_str("GS_COHORT_RESIDENT")
    if pin in ("on", "off"):
        return pin == "on"

    def gate(perf, label):
        rows = [r for r in perf.get("tenancy_ab", [])
                if r.get("probe") == "cohort_resident"]
        if evidence.on_card(label):
            return evidence.worst_clears_bar(rows, "tenant", "sequential")
        return evidence.rows_clear_bar(
            rows, "tenant_edges_per_s",
            lambda r: r.get("sequential_edges_per_s") or 0)

    return evidence.choose("resident_cohort", device, gate, False)


# ----------------------------------------------------------------------
# ResidentState
# ----------------------------------------------------------------------
class ResidentState(NamedTuple):
    """The summary carry as a named triple, in the layout every summary
    engine of either package carries: degrees [vb+1] (sentinel slot vb),
    min-label slab [vb+1], double cover [2(vb+1)] ((-) at v+vb+1), all
    int32. Host numpy arrays or torch tensors."""

    degrees: object
    labels: object
    cover: object

    @classmethod
    def fresh(cls, vb: int) -> "ResidentState":
        """The host state of a stream that has folded nothing (an
        engine's device carry: `resident_state()`)."""
        return cls(np.zeros(vb + 1, np.int32),
                   np.arange(vb + 1, dtype=np.int32),
                   np.arange(2 * (vb + 1), dtype=np.int32))

    def to_host(self) -> "ResidentState":
        """Copies of the slabs as host numpy arrays."""
        return ResidentState(*(
            np.array(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in self))

    @classmethod
    def grow(cls, old: "ResidentState", old_vb: int,
             new_vb: int) -> "ResidentState":
        """The slabs laid out over a wider vertex bucket (host numpy; the
        caller uploads them), as the JAX ResidentState.grow: degrees copy
        (the sentinel holds 0); labels keep their values, new slots are
        identity; cover labels at or past the (+) sentinel old_vb shift
        with it to new_vb, the (-) half moves to new_vb+1+v, and both
        sentinels stay identity."""
        if new_vb < old_vb:
            raise ValueError("vertex bucket cannot shrink: %d -> %d"
                             % (old_vb, new_vb))
        old = old.to_host()
        shift = new_vb - old_vb
        deg = np.zeros(new_vb + 1, np.int32)
        deg[:old_vb] = old.degrees[:old_vb]
        lab = np.arange(new_vb + 1, dtype=np.int32)
        lab[:old_vb] = old.labels[:old_vb]
        cov = np.arange(2 * (new_vb + 1), dtype=np.int32)
        shifted = np.where(old.cover >= old_vb, old.cover + shift,
                           old.cover).astype(np.int32)
        cov[:old_vb] = shifted[:old_vb]
        cov[new_vb + 1:new_vb + 1 + old_vb] = shifted[
            old_vb + 1:old_vb + 1 + old_vb]
        return cls(deg, lab, cov)


# ----------------------------------------------------------------------
# IngestRing
# ----------------------------------------------------------------------
class IngestRing:
    """A bounded ingest ring over the ingress pipeline's worker pool, the
    JAX package's API (its driver's resident branch feeds super-batches
    through one; the port's resident engines and driver run theirs
    through ingress_pipeline.run_pipeline with a look-ahead of
    GS_RESIDENT_SLOTS, and the serving pump, ROADMAP step 1.9, takes
    this one): `submit(fn, key, item)` schedules one super-batch's prep
    and h2d (fn runs wholly on a worker and returns the staged payload),
    `pop(key)` hands it back in submission order. Depth `slots` (default
    GS_RESIDENT_SLOTS). Under forced_sync (or with no workers) submit()
    declines and the caller builds inline: the same payloads."""

    def __init__(self, slots: Optional[int] = None):
        self.slots = max(1, slots if slots is not None else ring_slots())
        self._q = deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.slots

    def submit(self, fn, key, item) -> bool:
        """Schedule fn(item) on the pool under `key`; False when the ring
        is full or pipelining is off (the caller runs it inline)."""
        if self.full:
            return False
        fut = ingress_pipeline.submit_prep(fn, item)
        if fut is None:
            return False
        self._q.append((key, fut, item))
        self._gauge()
        return True

    def _gauge(self) -> None:
        metrics.gauge_set("gs_inflight_chunks", len(self._q))

    def pop(self, key):
        """(future, item) of the ring's head if it is `key`, else None
        (the ring is FIFO: the carry folds super-batches in order)."""
        if self._q and self._q[0][0] == key:
            _k, fut, item = self._q.popleft()
            self._gauge()
            return fut, item
        return None

    def drain(self) -> None:
        """Cancel what is still queued and wait for what runs (error
        paths), so no worker writes a slot after the caller moved on."""
        futs = []
        while self._q:
            _k, fut, _item = self._q.popleft()
            fut.cancel()
            futs.append(fut)
        for fut in futs:
            if not fut.cancelled():
                try:
                    fut.result()
                except Exception:
                    pass        # the caller's own failure is reported


# ----------------------------------------------------------------------
# Mailbox
# ----------------------------------------------------------------------
class Mailbox:
    """A small bounded thread-safe mailbox, the hand-off of the async
    serving pump (core/serve.py, ROADMAP step 1.9): `put` never blocks
    and returns False when full or closed (the caller sheds; `dropped`
    counts refusals), `get` blocks up to `timeout` and returns None on
    timeout or once closed and drained, `close` wakes every waiter."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, int(capacity))
        self._q = deque()
        self._cv = threading.Condition()
        self._closed = False
        self.dropped = 0

    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    def put(self, item) -> bool:
        with self._cv:
            if self._closed or len(self._q) >= self.capacity:
                self.dropped += 1
                return False
            self._q.append(item)
            self._cv.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        with self._cv:
            while not self._q:
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None
            return self._q.popleft()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


# ----------------------------------------------------------------------
# SuperBatchGraphs
# ----------------------------------------------------------------------
class _Graph:
    __slots__ = ("graph", "ptrs", "out", "launches", "work", "sig")


class SuperBatchGraphs:
    """The CUDA graphs of one resident engine's super-batches (module
    docstring), in graph family `family` (a key of kernels.REPLAYS).

    `run(key, tensors, fn, warm)` returns fn(*tensors)'s output: on a
    card by replaying the graph of `key`, captured at its first use (and
    again when any of `tensors`, every tensor the launches read or write,
    has moved), after `warm()`; on the CPU by calling fn. The output
    tensors are the graph's: the next replay of the same key overwrites
    them."""

    def __init__(self, family: str):
        if family not in kernels.REPLAYS:
            raise ValueError("unknown graph family %r" % family)
        self.family = family
        self.captures = 0
        self._graphs = {}
        self._stream = None

    def clear(self) -> None:
        self._graphs = {}

    def has(self, key, tensors) -> bool:
        g = self._graphs.get(key)
        return g is not None and g.ptrs == _ptrs(tensors)

    def run(self, key, tensors, fn, warm=None):
        if tensors[0].device.type != "cuda":
            return fn(*tensors)
        g = self._graphs.get(key)
        ptrs = _ptrs(tensors)
        if g is None or g.ptrs != ptrs:
            g = self._capture(key, tensors, fn, warm)
        with costmodel.replay(self.family, g.sig, g.work,
                              tensors[0].device):
            g.graph.replay()
        for name, n in g.launches.items():
            kernels.LAUNCHES[name] += n
        kernels.REPLAYS[self.family] += 1
        return g.out

    def capture(self, key, tensors, fn, warm=None) -> None:
        """Capture `key`'s graph now unless it is there (a round's
        graphs are made before the round is timed)."""
        if tensors[0].device.type == "cuda" and not self.has(key, tensors):
            self._capture(key, tensors, fn, warm)

    def _capture(self, key, tensors, fn, warm) -> _Graph:
        self._graphs.pop(key, None)
        if warm is not None:
            warm()
        dev = tensors[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        before = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(dev)
        with torch.cuda.stream(self._stream), costmodel.collect() as coll:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(*tensors)
            finally:
                graph.capture_end()
        # the capture launched nothing: its counts go to the replays
        launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
        kernels.LAUNCHES.update(before)
        g = _Graph()
        g.graph, g.ptrs, g.out = graph, _ptrs(tensors), out
        g.launches = {k: n for k, n in launches.items() if n}
        g.work, g.sig = tuple(coll.work), costmodel.tensor_sig(tensors)
        self._graphs[key] = g
        self.captures += 1
        return g


def _ptrs(tensors) -> tuple:
    return tuple(t.data_ptr() for t in tensors)


def adopt_carry_in_place(engine, carry: tuple) -> None:
    """A resident engine's `_adopt_carry`: a carry of the live carry's
    shapes and types is copied into the live tensors, which the graphs
    bind (reset, load_state_dict and load_features then capture
    nothing anew); any other becomes the carry."""
    old = getattr(engine, "_carry", None)
    if old is not None and len(old) == len(carry) and all(
            isinstance(o, torch.Tensor) and isinstance(c, torch.Tensor)
            and o.shape == c.shape and o.dtype == c.dtype
            and o.device == c.device for o, c in zip(old, carry)):
        for o, c in zip(old, carry):
            o.copy_(c)
    else:
        engine._carry = tuple(carry)


# ----------------------------------------------------------------------
# ResidentSummaryEngine
# ----------------------------------------------------------------------
class ResidentSummaryEngine(StreamSummaryEngine):
    """The resident tier of the fused summary engine: StreamSummaryEngine
    with (a) `superbatch` windows a dispatch (default GS_RESIDENT_SPB;
    the tuner's arms are rungs under it), (b) each super-batch one
    replayed CUDA graph over the carry (SuperBatchGraphs), (c) the
    compact wire whenever the vertex bucket fits uint16 (an explicit
    `ingress=` pins the wire; the tuner never changes it) and (d)
    GS_RESIDENT_SLOTS super-batches prepped and copied ahead. Summaries,
    carry and checkpoints equal the scan engine's bit for bit, so a
    checkpoint resumes on either (or on the JAX package's engines)."""

    METRICS_TIER = "resident"
    TUNER_FAMILY = "resident"
    AUTOTUNE = True
    TUNABLE_INGRESS = False
    _adopt_carry = adopt_carry_in_place

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, device=None, ingress: str = None,
                 superbatch: int = None):
        self._superbatch = superbatch
        if ingress is None:
            vb = seg_ops.bucket_size(vertex_bucket)
            ingress = ("compact" if compact_ingress.supports(vb)
                       else "standard")
        super().__init__(edge_bucket, vertex_bucket, k_bucket=k_bucket,
                         device=device, ingress=ingress)
        self.MAX_WINDOWS = seg_ops.bucket_size(
            superbatch if superbatch else resident_spb(self.eb))
        self._graphs = SuperBatchGraphs("resident_summary")
        self._runs = {
            wire: metrics.wrap_dispatch(
                name, lambda *carry_stack, slot, wire=wire:
                self._replay(carry_stack, wire, slot))
            for wire, name in (("standard", "resident_fused"),
                               ("compact", "resident_fused_compact"))}
        self._reserve()

    @property
    def INGEST_SLOTS(self):
        # a live read: tests and tools flip the knob mid-process
        return ring_slots()

    def _reserve(self) -> None:
        """Size the counter's scratch and every staging slot for the
        largest super-batch now, so no graph's buffer ever moves."""
        w, eb = self.MAX_WINDOWS, self.eb
        self._summary.counter.reserve(w, eb)
        self._ring.reserve(max(
            self._ring.nbytes(_wire_specs(w, eb, wire))
            for wire in ("standard", "compact")))

    def resident_state(self) -> ResidentState:
        """The live carry (device tensors; `.to_host()` copies)."""
        return ResidentState(*self._carry)

    def _launch(self, tensors, wire: str, slot: int):
        return self._runs[wire](*self._carry, *tensors, slot=slot)

    def _replay(self, carry_stack, wire: str, slot: int):
        """The super-batch's graph over the carry and the stack in
        staging slot `slot`, replayed (captured at its first use)."""
        key = (carry_stack[-1].shape[0], wire, slot)
        return self._graphs.run(
            key, carry_stack, self._graph_fn(wire),
            warm=lambda: self._warm_arm({"wb": key[0], "ingress": wire}))

    def _graph_fn(self, wire: str):
        def fold(deg, labels, cover, *stack):
            return self._fold((deg, labels, cover), stack, wire)
        return fold

    def _prepare_round(self, wbs, wire: str) -> None:
        """Capture, before a round is timed, the graphs of its chunk
        sizes `wbs` over every staging slot."""
        if self.device.type != "cuda":
            return
        for w in wbs:
            for slot in range(self._ring.slot_count):
                tensors = self._ring.slot_tensors(
                    slot, _wire_specs(w, self.eb, wire))
                self._graphs.capture(
                    (w, wire, slot), self._carry + tensors,
                    self._graph_fn(wire),
                    warm=lambda w=w: self._warm_arm({"wb": w,
                                                     "ingress": wire}))

    def grow_vertex_bucket(self, vertex_bucket: int) -> None:
        """Adopt a wider vertex bucket mid-stream: the carry re-laid out
        (ResidentState.grow), the kernels and graphs rebuilt at the new
        shapes, and a live tuner re-keyed, not discarded
        (DispatchTuner.rekey): the incumbent windows-per-super-batch
        survives as the prior. An explicit wire pin survives, unless
        compact turned lossy at the new bucket (it becomes standard). As
        in the JAX engine, the wire the engine resolved at construction
        counts as pinned: growth keeps it, or makes compact standard past
        uint16."""
        new_vb = seg_ops.bucket_size(vertex_bucket)
        if new_vb <= self.vb:
            return
        grown = ResidentState.grow(self.resident_state(), self.vb, new_vb)
        cursor, closed, fed = (self.windows_done, self._closed_partial,
                               self._fed_edges)
        tuner = getattr(self, "_tuner", None)
        timers = self.stage_timers
        pin = self.ingress if self._pinned_ingress else None
        if pin == "compact" and not compact_ingress.supports(new_vb):
            pin = "standard"
        self.__init__(self.eb, new_vb, k_bucket=self.kb,
                      device=self.device, ingress=pin,
                      superbatch=self._superbatch)
        self._adopt_carry(tuple(torch.from_numpy(a).to(self.device)
                                for a in grown))
        self.windows_done = cursor
        self._closed_partial = closed
        self._fed_edges = fed
        self.stage_timers = timers
        if tuner is not None:
            wbs = autotune.rungs(self.MAX_WINDOWS)
            inc = dict(tuner.incumbent)
            if inc.get("wb") not in wbs:
                inc["wb"] = self.MAX_WINDOWS
            inc["ingress"] = self.ingress
            tuner.rekey("%s:eb=%d:vb=%d" % (self.TUNER_FAMILY, self.eb,
                                            self.vb),
                        space={"wb": wbs, "ingress": [self.ingress]},
                        initial=inc)
            self._tuner = tuner


def _wire_specs(w: int, eb: int, wire: str) -> list:
    """(shape, numpy dtype) of a [w, eb] chunk's arrays on `wire`, in the
    order the engines stage them."""
    if wire == "compact":
        return [((w, eb), np.uint16), ((w, eb), np.uint16),
                ((w,), np.int32)]
    return [((w, eb), np.int32), ((w, eb), np.int32), ((w, eb), np.bool_)]
