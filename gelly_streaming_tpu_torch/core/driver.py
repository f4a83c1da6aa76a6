"""The columnar streaming analytics driver: the ingest-to-device path.

Port of the JAX package's `core/driver.py` (`WindowResult` :268-303,
`StreamingAnalyticsDriver` :306-2644), on one card or on a mesh:

    file -> native parse (native/ingest.cpp, io/sources.py)
         -> tumbling event-time windows (Flink's TimeWindow floor) or
            count-based windows of edge_bucket edges, or with `slide`
            sliding count-based windows: an emission every `slide`
            edges (a pane)
         -> incremental vertex interning (utils/interning.py)
         -> per window, against carried state:
              degrees    running degree of every vertex slot
              cc         carried min-label components
              bipartite  carried double-cover odd-cycle flags
              triangles  exact count of the window alone (sliding:
                         of the last edge_bucket/slide panes)

The carried analytics run on the snapshot tier the constructor pins, or
`resolve_snapshot_tier()` picks (GS_RESIDENT=on: "resident", else
"scan"): "scan" (the snapshot program of ops/window_snapshot.py, its
CUDA kernel on the card and its plain version on the CPU, chunks of up
to 64 windows through the ingress pipeline with the finalize one chunk
behind), "resident" (the same program at GS_RESIDENT_SPB windows a
super-batch, each one a replayed CUDA graph over a device carry kept
across calls, GS_RESIDENT_SLOTS super-batches prepped and copied ahead;
ops/resident_engine.py, the JAX driver's :847-884 and :1520-1600, where
the resident branch has an ingest ring of its own: here both tiers are
one chunk loop, `_scan_device`), "native" (the C++ fold,
native.snapshot_windows) or "host" (numpy, ops/host_snapshot.py). All
four give the same bits. With GS_AUTOTUNE on (the default) the scan
tier's windows per call and the resident tier's windows per super-batch
are tuned online (ops/autotune.py; the JAX driver's
`_ensure_scan_tuner`, `_warm_scan_arm`, `_ensure_resident_tuner`,
:868-930): the scan tier in rounds of GS_AUTOTUNE_ROUND chunks, as the
engines tune, the resident tier one super-batch a round, as the JAX
driver's; both re-key when a bucket
grows and ride the checkpoint as "autotune" and "autotune_resident". Triangles
go through `TriangleWindowKernel.count_windows` on the matching stream
tier ("device", "native", "host"), one flush per call. The host keeps
mirrors of the carried state in the JAX driver's layouts (degrees int64
[nv], labels int32 [nv], cover int32 [2·vb] with (-) at vb+v), which
move only at chunk boundaries, together with the cursors and the
auto-checkpoint; `state_dict` holds them under the JAX driver's keys, so
a checkpoint of either driver resumes in the other. Buckets grow by
doubling. A call with one window is a chunk of one (the JAX driver's
per-window path: the snapshot program and the counter at W=1).

Sliding windows (`slide`, the JAX driver's pane composition,
core/driver.py:357-379 there) stay on the chunked path: each pane is a
window of the snapshot tier, so the cumulative fields come at pane
granularity, and each emission's triangles are counted in the call's one
flush over its composed slab, the last edge_bucket/slide − 1 panes (the
pane ring) and its own. The ring moves with the mirrors at chunk
boundaries and rides the checkpoint (`slide`, `pane_ring_src`,
`pane_ring_dst`).

Hooks (the JAX driver's :659-779, :1079-1187, :1338-1391, :2445-2500;
each a no-op disarmed): `run_arrays` admits a batch through the
metrics stream mark, the latency stamp, the `admit` fault site, the
armed sanitizer (utils/sanitize.py, external ids: vb=None) and the
journal (`enable_wal`, utils/wal.py: appended after validation and
before any window is cut; `stream_file` never journals and is refused
on a journal-armed driver); each chunk's finalize fills
`WindowResult.latency`, emits one provenance record a window (its
`digest` the JAX driver's `result_digest`) and marks the metrics
registry; a flushed checkpoint advances the journal's retention cursor.
`tenant=` labels the marks, lanes, journal records and demotion events;
`tracing=True` times the JAX driver's steps into a StepTimer
(`trace_report`, the same step names, calls and records as the JAX
driver for the same job; where the JAX driver takes its per-window path
and the port runs the windows as one chunk, the per-window rows share
the chunk's seconds and are marked "apportioned").

The demotion ladder (resident -> scan -> native -> host; resident is
never a target, native is skipped where the library cannot load) never
leaves the card: a driver pinned to a tier on the card (resident, scan)
walks only resident -> scan, and one pinned to native walks native ->
host. A chunk is the unit of consistency, so a failure re-enters the
call from the mirrors of the last finalized chunk on the next rung, the
chunk in flight drained first. Three things demote: a StageTimeout or
StageFailed of the pipeline's guarded host stages (queued, prep; never
h2d, a copy to the card); and a host-side failure at the `dispatch` or
`finalize` fault site (fired inline on the caller's thread before the
launch) whose cause is a RuntimeError, OSError or MemoryError. A kernel
or CUDA error (`resilience.is_device_error`) never demotes: it raises to
the caller as it was raised. A failure with no rung below raises its
typed StageTimeout or StageFailed. GS_TIER_RETRY_WINDOWS windows of
probation re-promote; GS_TIER_DEMOTE=0 pins the tier and raises the
typed error. The triangle flush walks the same ladder
(TriangleWindowKernel on the native and host stream tiers), recounting
only the windows not finalized. `demotion_log()` lists the driver's
demotions and re-promotions.

The mesh branch (`mesh=`, a parallel/mesh.Mesh; the JAX driver's
:489-531, :1058-1254, :1737-1750, :2028-2074, :2501-2640). Its base tier
is "sharded": each chunk of up to 64 windows runs
parallel/sharded.make_sharded_snapshot_scan on the caller's thread, every
rank staging its slice of the edge axis (an eb the mesh does not divide
is padded with invalid slots where the JAX driver takes its per-window
path; the results are the same), the `dispatch` site, the wire check
(`guard_wire`) and `shard_dispatch` inside the guarded dispatch, so a
transient fault is retried with a fresh firing, `finalize` and
`shard_gather` before the copy back. The carry is staged from the
mirrors at each call's entry in the engines' layouts
(`engine_state_from_mirrors`), and the mirrors move at every chunk
boundary from the replicated end state, so they stay the one truth: a
demotion needs nothing from a failing mesh and a checkpoint never
touches it. Triangles flush on ShardedTriangleWindowKernel (row 1) while
the mesh lives. A mesh session always takes full egress, never the
resident tier or `slide=`, and its scan tuner is single-chip (a
demotion's). Its ladder is sharded -> scan, both on the card; the
sharded rung demotes on the failures above (a StageFailed of the
`dispatch`, `shard_dispatch`, `shard_wire` or `shard_gather` sites whose
cause is a RuntimeError, OSError or MemoryError; a prep failure of the
triangle stream), never on a device error or a failed collective
(parallel/mesh.CollectiveError), which raise as they were raised, so
every rank stays in lockstep: a fault plan fires alike on every rank, a
dead peer does not. GS_MESH_DEMOTE=0 pins the rung; re-promotion stages
the mirrors back into the mesh carry, and a failed probe is recorded and
restarts probation. The demotion records carry `mesh_shape` and the
cause's `shard_id`. Checkpoints carry "sharded", "mesh_shape" and the
"engine" key (the engines' state, built from the mirrors); a mesh driver
takes the checkpoint's vertex bucket exactly, and either package's
checkpoint of either mode resumes in either mode
(`mirrors_from_engine_state`). On a mesh of several ranks only rank 0
writes files (auto-checkpoints, the journal); every rank reads them.

The evidence routing of the snapshot tier and the egress waits for step
1.1: `egress` is a plain argument and `auto` resolves to the scan tier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import native
from ..core.platform import resolve_device
from ..io.sources import iter_edge_chunks
from ..ops import autotune
from ..ops import delta_egress
from ..ops import host_snapshot
from ..ops import ingress_pipeline
from ..ops import resident_engine
from ..ops import segment as seg_ops
from ..ops import triangles as tri_ops
from ..ops import window_snapshot as snap_ops
from ..ops.staging import ChunkStager, HostCopy
from ..utils import checkpoint
from ..utils import faults
from ..utils import knobs
from ..utils import latency
from ..utils import metrics
from ..utils import provenance
from ..utils import resilience
from ..utils import sanitize as sanitize_mod
from ..utils import telemetry
from ..utils import wal as wal_mod
from ..utils.interning import make_interner, parallel_intern_arrays
from ..utils.tracing import StepTimer

SNAPSHOT_TIERS = ("resident", "scan", "native", "host")
_TRIANGLE_TIER = {"resident": "device", "scan": "device",
                  "native": "native", "host": "host"}
_CARRIED = ("degrees", "cc", "bipartite")
# the tiers on the card: a driver pinned to one of them demotes only to
# the next of them (the ladder below them is SNAPSHOT_TIERS, top down)
_DEVICE_TIERS = ("resident", "scan")
# a mesh session's ladder: the sharded scan, then the scan tier
_MESH_TIERS = ("sharded", "scan")


def resolve_snapshot_tier() -> str:
    """The snapshot tier of a driver given no `snapshot_tier=`:
    "resident" under the GS_RESIDENT=on pin, else "scan" (the JAX
    driver's :224-250, whose committed-evidence routing the port reads
    none of until step 1.1 measures its own)."""
    return "resident" if resident_engine.resolve_resident() else "scan"


def _snapshot_view(a: np.ndarray, row_size: int = 0) -> np.ndarray:
    """A read-only snapshot of `a`: a view where it covers most of its
    row, an owned copy where it is small beside `row_size` (so a small
    window's field does not pin its chunk's whole [W, vb] stack)."""
    if row_size and 4 * a.size < row_size:
        a = a.copy()
    else:
        a = a[:]
    a.flags.writeable = False
    return a


def _frozen_delta(idx: np.ndarray, vals: np.ndarray) -> tuple:
    idx.flags.writeable = False
    vals.flags.writeable = False
    return (idx, vals)


@dataclasses.dataclass
class WindowResult:
    """One window's analytics. Vertex-indexed arrays are in dense slot
    order; `vertex_ids[slot]` is the external id. Every array is a
    read-only snapshot, never live carried state; `.copy()` for a
    mutable one."""

    window_start: int
    num_edges: int
    vertex_ids: np.ndarray                      # external id per slot
    degrees: Optional[np.ndarray] = None        # running, per slot
    cc_labels: Optional[np.ndarray] = None      # carried min-label slots
    bipartite_odd: Optional[np.ndarray] = None  # carried odd-cycle flag
    triangles: Optional[int] = None             # exact, this window only
    # emit_deltas=True: (slot ids, new values) of every slot whose value
    # differs from the previous window's snapshot (start states: zero
    # degrees, identity labels, no odd cycle)
    delta_degrees: Optional[tuple] = None       # (int32 ids, int64 vals)
    delta_cc: Optional[tuple] = None            # (int32 ids, int32 vals)
    delta_bipartite: Optional[tuple] = None     # (int32 ids, bool vals)
    # the latency plane's ingest-to-deliver record, {"e2e_s", "stages",
    # "replayed"}, joined to the admission stamp of its last edge; None
    # disarmed
    latency: Optional[dict] = None


class StreamingAnalyticsDriver:
    """Windowed analytics of an edge stream over external int64 vertex
    ids. `window_ms` sizes event-time windows (rows with timestamps);
    untimestamped rows are cut into count-based windows of
    `edge_bucket` edges. `device=None` is the card (raising without
    one); `device="cpu"` runs the plain versions. `snapshot_tier` pins
    the carried analytics' tier (SNAPSHOT_TIERS, default "scan");
    `egress` ("full" by default, or "delta") the scan tier's copy back,
    `egress_cap` the delta rows' width (ops/delta_egress.egress_cap).
    `slide`, a power of two dividing the edge bucket, makes the
    count-based windows slide: one WindowResult every `slide` edges
    (GS_SLIDE where it is None). With no `snapshot_tier`,
    `resolve_snapshot_tier()` picks it. `tenant` labels the driver's
    hook records; `tracing=True` keeps a StepTimer (`trace_report`).
    `mesh` (a parallel.mesh.Mesh this rank is a member of) runs the
    carried analytics and the triangles over it: the driver's device is
    the mesh's, its base tier "sharded" (module docstring)."""

    ANALYTICS = ("degrees", "cc", "bipartite", "triangles")
    _SCAN_CHUNK = 64                    # windows per snapshot call
    INFLIGHT = ingress_pipeline.DEFAULT_INFLIGHT

    def __init__(self, window_ms: int,
                 analytics: Sequence[str] = ANALYTICS,
                 vertex_bucket: int = 1 << 12,
                 edge_bucket: int = 1 << 12,
                 mesh=None, tracing: bool = False,
                 emit_deltas: bool = False,
                 snapshot_tier: str = None,
                 egress: str = None,
                 tenant: str = None,
                 slide: int = None,
                 egress_cap: int = None,
                 device=None):
        unknown = set(analytics) - set(self.ANALYTICS)
        if unknown:
            raise ValueError(f"unknown analytics: {sorted(unknown)}")
        if snapshot_tier is not None and snapshot_tier not in SNAPSHOT_TIERS:
            raise ValueError(f"unknown snapshot_tier: {snapshot_tier!r}")
        # the JAX driver's refusals, in its order, before any use of the
        # mesh
        if snapshot_tier == "resident" and mesh is not None:
            raise ValueError(
                "the resident tier is single-chip: a mesh session's base "
                "tier is the sharded scan (its demotion ladder re-enters on "
                "scan, never resident)")
        tier = (resolve_snapshot_tier() if snapshot_tier is None
                else snapshot_tier)
        if tier == "native" and not native.available():
            raise ValueError("native snapshot tier pinned but the native "
                             "library is unavailable: %s"
                             % native.build_error())
        egress = "full" if egress is None else egress
        if egress not in delta_egress.EGRESS:
            raise ValueError(f"unknown egress: {egress!r}")
        if slide is None:
            slide = knobs.get_int("GS_SLIDE")
        slide = int(slide) if slide else None
        if slide is not None and mesh is not None:
            raise ValueError(
                "sliding windows are single-chip: the sharded scan cuts "
                "whole-window slabs across the mesh (compose panes "
                "upstream or drop slide=)")
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if not mesh.member:
                raise ValueError("this rank is not in the mesh %s"
                                 % (mesh.shape,))
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError("device %s disagrees with the mesh's "
                                 "device %s" % (device, mesh.device))
            # the mesh's base tier and egress (the JAX driver's
            # _base_tier, _scan_egress)
            self.device = mesh.device
            tier, egress = "sharded", "full"
        # the stream this driver serves, in its hook records
        self.tenant = None if tenant is None else str(tenant)
        self.timer = StepTimer() if tracing else None
        self.window_ms = window_ms
        self.analytics = tuple(analytics)
        self.snapshot_tier = tier
        self.egress = egress
        self.egress_cap = egress_cap
        self.emit_deltas = bool(emit_deltas)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.eb = seg_ops.bucket_size(edge_bucket)
        if slide is not None and (seg_ops.bucket_size(slide) != slide
                                  or self.eb % slide != 0):
            raise ValueError(
                "slide must be a power of two dividing the window "
                "size (%d), got %d" % (self.eb, slide))
        # slide == eb is tumbling; None there, so such a driver resumes
        # its own checkpoints (the JAX driver keeps eb and refuses them)
        self.slide = slide if slide != self.eb else None
        self._wp = (self.eb // slide) if slide else 1  # panes a window
        self._tri_kernels = {}     # stream tier ("sharded") -> its kernel
        self._sharded_scans = {}   # vb -> make_sharded_snapshot_scan's fn
        self._tri_pending = None   # the call's triangle windows (transient)
        self._per_window = False   # the call takes the JAX per-window path
        self._snaps = {}           # (vb, egress, cap) -> WindowSnapshot
        self._ring = ChunkStager(self.device, slots=self.INFLIGHT + 1)
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)
        self._ckpt_path = None
        self._ckpt_policy = None   # utils.checkpoint.CheckpointPolicy
        self._pending_ckpt = []    # staged (windows_done, state): _stage_ckpt
        self._emitted = None       # not None inside stream_file
        # the journal (enable_wal), its retention at checkpoint flushes,
        # stream_file's depth (a file is its own journal) and the edges
        # fed, sanitizer rejects included (the dead letters' offsets)
        self._wal = None
        self._wal_dir = None
        self._wal_retention = wal_mod.RetentionCursor()
        self._fed_edges = 0
        # the demotion ladder: the demoted tier (None: the pinned one),
        # windows_done when it demoted, the driver's events
        self._demoted_tier = None
        self._demoted_at = 0
        self._demotions = []
        # the online tuners of the scan and resident tiers (built at
        # first use; None with GS_AUTOTUNE=0)
        self._scan_tuner = None
        self._resident_tuner = None
        self._warmed_snaps = set()  # (vb, egress, cap, windows) warmed
        # the resident tier's device carry, staging ring and CUDA graphs,
        # kept across calls at one (vertex bucket, window width)
        self._res_key = None
        self._res_carry = None
        self._res_stager = None
        self._res_graphs = resident_engine.SuperBatchGraphs(
            "driver_resident")
        self.reset()

    def reset(self) -> None:
        """Clear all carried stream state (interner, mirrors, cursors),
        keeping the buckets and the built kernels."""
        self.interner = make_interner(np.array([0]))
        self._ext_ids = np.zeros(0, np.int64)  # slot -> external id cache
        self._nv_done = 0          # slots of the last finalized window
        self._degrees = np.zeros(0, np.int64)
        self._cc = np.zeros(0, np.int32)
        self._bip = np.zeros(0, np.int32)
        self.windows_done = 0      # the resume cursor, in checkpoints
        self.edges_done = 0        # count-based window_start offset
        self._closed_partial = False
        self._pane_ring = []       # the last ≤ wp−1 interned (s, d) panes
        self._pending_ckpt = []
        if self._ckpt_policy is not None:
            self._ckpt_policy.mark(0)

    def _ensure_buckets(self, num_vertices: int, window_edges: int) -> None:
        grew = False
        while num_vertices > self.vb:
            self.vb *= 2
            grew = True
        while window_edges > self.eb:
            self.eb *= 2
            grew = True
        if not grew:
            return
        # growth changes the economics the tuners measured and their
        # cache identity: re-key them (the incumbent survives as the
        # prior; the new key's persisted best re-seeds it)
        if self._scan_tuner is not None:
            cap = self._SCAN_CHUNK
            self._scan_tuner.rekey(self._scan_tuner_key(),
                                   space={"wb": autotune.rungs(cap)},
                                   initial={"wb": cap})
        if self._resident_tuner is not None:
            cap = self._resident_chunk()
            self._resident_tuner.rekey(self._resident_tuner_key(),
                                       space={"wb": autotune.rungs(cap)},
                                       initial={"wb": cap})

    # ------------------------------------------------------------------
    def run_file(self, path: str) -> List[WindowResult]:
        src, dst, ts = native.parse_edge_file(path)
        return self.run_arrays(src, dst, ts)

    def stream_file(self, path: str, chunk_bytes: int = 1 << 26,
                    resume: bool = False):
        """Generator of the WindowResults of a file of any size, in
        bounded memory: the file is parsed in `chunk_bytes` pieces
        (prefetched on a producer thread, io/sources.iter_edge_chunks),
        and each piece's still-open last window is held back until the
        next piece closes it, so windows never split at piece
        boundaries.

        resume=True (after try_resume) skips the `edges_done` edges the
        restored checkpoint has folded. Auto-checkpoints taken meanwhile
        are written only once every window they cover has been yielded
        (_stage_ckpt), so a crash re-emits windows, never drops them.
        The file is its own journal: a journal-armed driver refuses."""
        if self._wal_dir is not None:
            # wal_offset is edges_done, and a file's edges are never
            # journaled: mixing the two sources would let recovery skip
            # journaled edges
            raise ValueError(
                "stream_file() on a journal-armed driver would skew the "
                "wal_offset/edges_done contract: use run_arrays "
                "(journaled live feed) or file streaming, not both on "
                "one driver")
        to_skip = self.edges_done if resume else 0
        pend = (np.zeros(0, np.int64),) * 3
        timestamped = None
        self._emitted = self.windows_done
        try:
            for src, dst, ts in iter_edge_chunks(path, chunk_bytes):
                if to_skip:
                    drop = min(to_skip, len(src))
                    src, dst, ts = src[drop:], dst[drop:], ts[drop:]
                    to_skip -= drop
                    if not len(src):
                        continue
                chunk_timestamped = bool(len(ts)) and int(ts.max()) >= 0
                if timestamped is None:
                    timestamped = chunk_timestamped
                elif timestamped != chunk_timestamped:
                    raise ValueError(
                        "mixed timestamped and untimestamped chunks")
                src = np.concatenate([pend[0], src])
                dst = np.concatenate([pend[1], dst])
                ts = np.concatenate([pend[2], ts])
                if timestamped:
                    if int(ts.min()) < 0:
                        raise ValueError(
                            "mixed timestamped and untimestamped rows")
                    starts = native.assign_windows(ts, self.window_ms)
                    open_from = int(np.searchsorted(starts, starts[-1]))
                else:
                    open_from = len(src) - (len(src) % self.eb)
                done = slice(0, open_from)
                if open_from:
                    yield from self._emit(self.run_arrays(
                        src[done], dst[done],
                        _starts=starts[done] if timestamped else None))
                pend = (src[open_from:], dst[open_from:], ts[open_from:])
            if len(pend[0]):
                yield from self._emit(self.run_arrays(
                    pend[0], pend[1], pend[2] if timestamped else None))
        finally:
            # staged checkpoints cover windows never delivered: drop them
            self._pending_ckpt = []
            self._emitted = None

    def run_arrays(self, src: np.ndarray, dst: np.ndarray,
                   ts: Optional[np.ndarray] = None,
                   _starts: Optional[np.ndarray] = None
                   ) -> List[WindowResult]:
        """Process a (possibly partial) stream. With no timestamps the
        windows are count-based, `edge_bucket` edges each, continuing
        from earlier calls. `_starts`: stream_file's window starts.

        Admission, in the JAX driver's order: the metrics stream mark,
        the latency stamp, the `admit` fault site, the armed sanitizer
        (its keep-mask filters the aligned ts / _starts columns), then,
        after the batch is validated and before any window is cut, the
        journal and the latency plane's admission mark."""
        lane = self.tenant or "driver"
        metrics.on_stream_start("driver", tenant=self.tenant)
        lat_t0 = latency.clock() if latency.enabled() else None
        got = faults.fire("admit", (lane, src, dst))
        if got is not None:
            _t, src, dst = got
        if sanitize_mod.enabled():
            try:
                # vb=None: external int64 ids, which the interner
                # densifies, so only the representability and policy
                # checks apply
                rep = sanitize_mod.sanitize(
                    src, dst, None, tenant=lane, origin="driver",
                    offset=self._fed_edges, dlq=sanitize_mod.resolve_dlq())
            except sanitize_mod.BatchRejected as e:
                self._fed_edges += e.size
                raise
            self._fed_edges += rep.accepted + rep.rejected
            src, dst = rep.src, rep.dst
            if rep.rejected:
                if ts is not None and len(np.atleast_1d(ts)):
                    ts = np.asarray(ts)[rep.keep]
                if _starts is not None:
                    _starts = np.asarray(_starts)[rep.keep]
        else:
            self._fed_edges += len(np.atleast_1d(np.asarray(src)))
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if _starts is not None or (
                ts is not None and len(ts) and int(np.max(ts)) >= 0):
            if self._wp > 1:
                raise ValueError(
                    "sliding windows (slide=) are count-based: "
                    "event-time streams window by window_ms (panes "
                    "over event time need an upstream assigner)")
            if _starts is not None:
                starts = _starts
            else:
                ts = np.asarray(ts, np.int64)
                if int(np.min(ts)) < 0:
                    raise ValueError(
                        "mixed timestamped and untimestamped rows: every "
                        "edge needs a timestamp for event-time windows "
                        "(rows without a third column parse as ts=-1)")
                starts = native.assign_windows(ts, self.window_ms)
            if np.any(np.diff(starts) < 0):
                raise ValueError(
                    "timestamps must be ascending (the reference's "
                    "AscendingTimestampExtractor contract, "
                    "SimpleEdgeStream.java:90-94)")
            bounds = np.flatnonzero(np.diff(starts)) + 1
            slices = np.split(np.arange(len(src)), bounds)
            windows = [(int(starts[idx[0]]), src[idx], dst[idx])
                       for idx in slices if len(idx)]
            self._admitted(src, dst, lat_t0,
                           np.asarray(ts, np.int64) if ts is not None
                           and len(np.atleast_1d(ts)) else None)
            return self._dispatch_windows(windows)
        if self._closed_partial:
            raise ValueError(
                "a previous count-based run closed a partial window "
                "(length not a multiple of edge_bucket); chunked "
                "count-based feeding must use edge_bucket multiples")
        self._admitted(src, dst, lat_t0)
        windows = []
        at = self.edges_done
        cut = self._cut_size()
        for i in range(0, len(src), cut):
            idx = slice(i, min(i + cut, len(src)))
            windows.append((at, src[idx], dst[idx]))
            at += idx.stop - idx.start
        return self._dispatch_windows(windows, count_based=True)

    def _admitted(self, src, dst, lat_t0, ts=None) -> None:
        """A validated batch, before its windows are cut: the journal
        append (the live feed's durability boundary; stream_file's
        edges never: the file is its own journal), then the latency
        plane's admission mark."""
        lane = self.tenant or "driver"
        if self._wal is not None and len(src) and self._emitted is None:
            self._wal.append(lane, src, dst, ts)
            faults.fire("wal_enqueue", lane)
        if lat_t0 is not None:
            latency.on_admit(lane, len(src), t0=lat_t0)

    def _cut_size(self) -> int:
        """Edges a count-based window: a pane (`slide`) under sliding
        windows, the whole edge bucket otherwise."""
        return self.slide if self._wp > 1 else self.eb

    def _dispatch_windows(self, windows, count_based: bool = False
                          ) -> List[WindowResult]:
        """Every call's windows through the chunked path, with one
        batched triangle flush; a short count-based last window closes
        the stream (`_closed_partial`, set at its chunk's boundary). A
        call of one window, or of sliding panes, is the JAX driver's
        per-window path: the same work here, traced under its step
        names (`_per_window`)."""
        if not windows:
            return []
        self._per_window = len(windows) == 1 or self._wp > 1
        with self._batched_triangles():
            return self._run_batched(
                windows, closes_partial=(
                    count_based and len(windows[-1][1]) < self._cut_size()))

    # ------------------------------------------------------------------
    # the chunked path: a chunk of up to _SCAN_CHUNK windows a call of
    # the snapshot tier; mirrors, cursors and checkpoints move together
    # at each chunk boundary, so an exception leaves the driver at the
    # last finished chunk, from which the demotion ladder re-enters
    # ------------------------------------------------------------------
    def _run_batched(self, windows,
                     closes_partial: bool = False) -> List[WindowResult]:
        # intern the whole call first (on the pool, the slots of a
        # sequential loop), so the buckets grow once; sizes[] gives each
        # window's vertex count for slicing its snapshots
        parts = [("intern", 2 * len(s)) for _w, s, _d in windows]
        with self._traced("intern", sum(n for _i, n in parts), parts):
            flat = []
            for _wstart, src, dst in windows:
                flat.append(src)
                flat.append(dst)
            dense, sizes = parallel_intern_arrays(self.interner, flat)
        interned = [(windows[i][0], dense[2 * i], dense[2 * i + 1],
                     sizes[2 * i + 1]) for i in range(len(windows))]
        self._ensure_buckets(len(self.interner),
                             max(len(s) for _w, s, _d, _n in interned))
        # the demotion ladder: a failure leaves the driver at its last
        # finalized chunk; a demotion re-enters there on the next rung
        results: List[WindowResult] = []
        while True:
            tier = self._effective_tier()
            try:
                self._scan_interned(interned[len(results):], results,
                                    closes_partial, tier)
                return results
            except resilience.StageError as e:
                if not self._maybe_demote(tier, e):
                    raise

    def _chunks(self, num_w: int) -> list:
        return list(range(0, num_w, self._SCAN_CHUNK))

    def _scan_interned(self, interned, results, closes_partial: bool,
                       tier: str) -> None:
        """The carried analytics of `interned` [(wstart, s, d, nv)] on
        `tier`, appending a WindowResult per window. The carry is built
        from the mirrors at entry, which makes the call re-enterable
        after a demotion."""
        num_w = len(interned)

        def finalize(at, take, outs, mirrors, st=None):
            chunk = interned[at:at + take]
            n0 = len(results)
            self._finalize_chunk(chunk, outs, mirrors, results)
            self._boundary(chunk, results[n0:], tier, st, closes_partial
                           and at + len(chunk) >= num_w)

        if not any(a in self.analytics for a in _CARRIED):
            for at in self._chunks(num_w):
                finalize(at, self._SCAN_CHUNK, {}, (None, None, None))
            return
        if tier == "sharded":
            self._scan_sharded(interned, finalize)
            return
        if tier in ("scan", "resident"):
            self._scan_device(interned, finalize, tier == "resident")
            return
        fold = (native.snapshot_windows if tier == "native"
                else host_snapshot.snapshot_windows)
        # copies of the mirrors, carried across this call's chunks
        carry = self._chunk_start_state()
        for at in self._chunks(num_w):
            chunk = interned[at:at + self._SCAN_CHUNK]
            prevs = (tuple(None if a is None else a.copy() for a in carry)
                     if self.emit_deltas else None)

            def fold_chunk(chunk=chunk, prevs=prevs):
                faults.fire("dispatch")
                return self._host_fold(fold, chunk, carry, prevs)

            with self._chunk_step("snapshot_scan", chunk):
                # guarded inline, never retried: the fold moves the
                # chunk-local copies in place; a failure demotes and the
                # call re-enters with fresh copies of the mirrors
                outs = resilience.call_guarded("dispatch", at, fold_chunk,
                                               retries=0, timeout=0)
            finalize(at, self._SCAN_CHUNK, outs,
                     tuple(None if a is None else a.copy() for a in carry))

    # ------------------------------------------------------------------
    # the mesh branch (the JAX driver's :1058-1077, :1195-1254, :1737-1750)
    # ------------------------------------------------------------------
    def _mesh_live(self) -> bool:
        """True while the sharded scan is the tier: a mesh driver that
        no demotion has moved onto the scan tier."""
        return self.mesh is not None and self._demoted_tier is None

    def _mesh_shape(self):
        """Ranks per mesh axis, as the demotion records and checkpoints
        give them; None on one card."""
        return (None if self.mesh is None
                else [int(x) for x in self.mesh.layout.shape])

    def _writes_files(self) -> bool:
        """Only the mesh's rank 0 writes the driver's files (the
        auto-checkpoints, the journal): every rank holds the same state,
        and n ranks must not write one path at once."""
        return self.mesh is None or self.mesh.rank == 0

    def _sync_engine_from_mirrors(self) -> tuple:
        """The re-promotion probe: the mirrors staged into a mesh carry
        (a failure here restarts probation; `_effective_tier`)."""
        return self._stage_mesh_carry()

    def _stage_mesh_carry(self) -> tuple:
        """The mesh carry (degrees [vb+2], labels [vb+2], cover [2vb+2],
        int32 on this rank's device) staged from the mirrors, at every
        sharded call's entry."""
        st = engine_state_from_mirrors(self.vb, self._degrees, self._cc,
                                       self._bip, self._mesh_shape())
        cov = st.get("bip_labels")
        if cov is None:
            cov = np.arange(2 * self.vb + 2, dtype=np.int32)
        return tuple(self.mesh.put(a) for a in (st["degree_state"],
                                                st["labels"], cov))

    def _scan_sharded(self, interned, finalize) -> None:
        """The sharded tier: chunks of _SCAN_CHUNK windows on the
        caller's thread through parallel/sharded.make_sharded_snapshot_scan
        over a carry staged from the mirrors. The `dispatch` site, the
        wire check and `shard_dispatch` run inside the guarded dispatch
        (retried under GS_STAGE_RETRIES with a fresh firing; never a
        deadline thread, which could issue collectives after it was
        abandoned); the `finalize` and `shard_gather` sites before the
        copy back. Each chunk's end state refreshes the mirrors at its
        boundary."""
        from ..parallel import sharded

        vb, n = self.vb, self.mesh.size
        fn = self._sharded_scans.get(vb)
        if fn is None:      # one bucket at a time: the last one's is dropped
            fn = sharded.make_sharded_snapshot_scan(
                self.mesh, vb, self.analytics, deltas=self.emit_deltas)
            self._sharded_scans = {vb: fn}
        carry = self._stage_mesh_carry()
        want = tuple(a in self.analytics for a in _CARRIED)
        for at in self._chunks(len(interned)):
            chunk = interned[at:at + self._SCAN_CHUNK]
            arrays = seg_ops.stack_window_rows(
                [(s, d) for _w, s, d, _n in chunk], len(chunk),
                self.eb, vb)

            def dispatch(arrays=arrays, carry_in=carry):
                faults.fire("dispatch")
                s_w, d_w = sharded.guard_wire(arrays[:2], n, vb + 1)
                sharded.fire_shard_dispatch(n)
                return fn(carry_in, s_w, d_w, arrays[2])

            with self._chunk_step("snapshot_scan", chunk, closes=False):
                carry, outs = resilience.call_guarded("dispatch", at,
                                                      dispatch, timeout=0)
                copies = {k: HostCopy(v) for k, v in outs.items()}
                ends = [HostCopy(t) if on else None
                        for t, on in zip(carry, want)]
            with self._chunk_step("snapshot_wait", chunk):
                self._fire_site("finalize", at, retries=0)
                self._fire_site("shard_gather", at, retries=0, payload=n)
                outs = {k: c.numpy().copy() for k, c in copies.items()}
                deg, lab, cov = (None if c is None else c.numpy()
                                 for c in ends)
            st = ({"dispatch": latency.clock()}
                  if latency.enabled() and not self._per_window else None)
            finalize(at, self._SCAN_CHUNK, outs, (
                None if deg is None else deg[:vb].copy(),
                None if lab is None else lab[:vb].copy(),
                None if cov is None else cov[:2 * vb].copy()), st)

    # ------------------------------------------------------------------
    # the demotion ladder (the JAX driver's _effective_tier,
    # _maybe_demote, demotion_log; :1079-1187, :1256)
    # ------------------------------------------------------------------
    def _effective_tier(self) -> str:
        """The tier the next chunk runs on: the demoted one, or after
        GS_TIER_RETRY_WINDOWS windows of probation there, the pinned
        tier again (a repeat failure demotes again and restarts
        probation). A mesh session's probe stages the mirrors into the
        mesh carry first: a host-side failure there (RuntimeError,
        OSError, MemoryError; not a device error) is recorded as a failed
        probe and restarts probation on the demoted tier."""
        if self._demoted_tier is None:
            return self.snapshot_tier
        n = resilience.tier_retry_windows()
        if not (n and self.windows_done - self._demoted_at >= n):
            return self._demoted_tier
        prev = self._demoted_tier
        if self.mesh is not None:
            try:
                self._sync_engine_from_mirrors()
            except (RuntimeError, OSError, MemoryError) as e:
                if resilience.is_device_error(e):
                    raise
                self._demotions.append(resilience.record_demotion(
                    "snapshot", prev, prev, self.windows_done,
                    "re-promotion probe failed (%s: %s); probation "
                    "restarted" % (type(e).__name__, e),
                    mesh_shape=self._mesh_shape(), tenant=self.tenant))
                self._demoted_at = self.windows_done
                return prev
        event = resilience.record_demotion(
            "snapshot", prev, self.snapshot_tier,
            self.windows_done, "re-promotion probe after %d probation "
            "windows" % (self.windows_done - self._demoted_at),
            mesh_shape=self._mesh_shape(), tenant=self.tenant)
        self._demotions.append(event)
        if self.timer:
            self.timer.event("tier_repromotion", event)
        self._demoted_tier = None
        return self.snapshot_tier

    def _maybe_demote(self, tier: str, err: BaseException) -> bool:
        """Demote from `tier` to the next rung of the ladder on `err`;
        False when `err` is not a failure a tier change can cure or no
        rung is left. A device error (`resilience.is_device_error`: a
        kernel's build or launch, a CUDA call) never demotes, whatever
        its cause chain says, nor does a failed or stalled h2d copy. A
        StageTimeout or StageFailed of the guarded host stages (queued,
        prep) demotes, and a StageFailed of the dispatch or finalize
        fault site demotes when its cause is a RuntimeError, OSError or
        MemoryError (a semantic error, ValueError or TypeError, is a bug
        to surface). The rungs below a tier on the card are on the card
        only: resident -> scan, and a mesh session's sharded -> scan (a
        failed collective is a device error: it never demotes).
        GS_TIER_DEMOTE=0 pins the tier, GS_MESH_DEMOTE=0 the sharded
        one."""
        if resilience.is_device_error(err) \
                or not resilience.tier_demotion_enabled() \
                or getattr(err, "stage", None) == "h2d":
            return False
        if tier == "sharded" and not resilience.mesh_demotion_enabled():
            return False
        if getattr(err, "stage", None) not in ("queued", "prep") and not (
                isinstance(err, resilience.StageFailed) and isinstance(
                    err.__cause__, (RuntimeError, OSError, MemoryError))):
            return False
        ladder = (_MESH_TIERS if self.mesh is not None
                  else _DEVICE_TIERS if self.snapshot_tier in _DEVICE_TIERS
                  else SNAPSHOT_TIERS)
        for nxt in ladder[ladder.index(tier) + 1:]:
            if nxt == "native" and not native.available():
                continue
            event = resilience.record_demotion(
                "snapshot", tier, nxt, self.windows_done, _reason(err),
                mesh_shape=self._mesh_shape(), shard_id=_shard_of(err),
                tenant=self.tenant)
            self._demotions.append(event)
            if self.timer:
                self.timer.event("tier_demotion", event)
            self._demoted_tier = nxt
            self._demoted_at = self.windows_done
            return True
        return False

    def demotion_log(self) -> List[dict]:
        """This driver's demotions and re-promotions (the process-wide
        log is `resilience.demotion_events()`)."""
        return list(self._demotions)

    def _fire_site(self, site: str, at: int, retries=None,
                   payload=None) -> None:
        """The host-side fault site `site` of the chunk at `at` (with
        `payload`), on the caller's thread before its launch or copy
        back: inline (timeout=0, never on a watchdog thread), an injected
        failure typed as StageFailed. A no-op without a fault plan."""
        if faults.active() is not None:
            resilience.call_guarded(
                site, at, lambda: faults.fire(site, payload),
                retries=retries, timeout=0)

    # ------------------------------------------------------------------
    # tracing (utils/tracing.StepTimer; the JAX driver's _step :2076)
    # ------------------------------------------------------------------
    def _step(self, name: str, num_records: int):
        """A traced step: through the StepTimer with tracing=True, else
        a telemetry span (a no-op disarmed)."""
        if self.timer:
            return self.timer.step(name, num_records)
        return telemetry.span("step." + name, records=num_records)

    @contextlib.contextmanager
    def _traced(self, name: str, records: int, parts, closes: bool = True):
        """A traced interval: on the JAX driver's batched path one step
        `name` of `records`; on its per-window path (`_per_window`) the
        steps `parts` [(step, records)], one a window, which the stage
        that `closes` the work records with the interval's seconds
        shared evenly: the port ran those steps as one, so a share is
        apportioned, not measured, and the report marks its row so."""
        if not self._per_window:
            with self._step(name, records):
                yield
            return
        t0 = time.perf_counter()
        yield
        if closes and self.timer and parts:
            dt = (time.perf_counter() - t0) / len(parts)
            for step, n in parts:
                self.timer.add(step, dt, n, apportioned=len(parts) > 1)

    def _chunk_step(self, name: str, chunk, closes: bool = True):
        """Trace a chunk's snapshot work: one `name` step a chunk, or on
        the per-window path one step a window and carried analytic."""
        names = [a for a in self.analytics if a in _CARRIED]
        return self._traced(
            name, sum(len(s) for _w, s, _d, _n in chunk),
            [(a, len(s)) for _w, s, _d, _n in chunk for a in names],
            closes)

    def _snapshot_program(self, egress: str) -> snap_ops.WindowSnapshot:
        """The snapshot program at the current vertex bucket on `egress`,
        built once a bucket and form (its device scratch stays)."""
        cap = (delta_egress.egress_cap(self.eb, self.vb, self.egress_cap)
               if egress == "delta" else 0)
        key = (self.vb, egress, cap)
        if key not in self._snaps:
            self._snaps = {k: v for k, v in self._snaps.items()
                           if k[0] == self.vb}
            self._snaps[key] = snap_ops.WindowSnapshot(
                self.vb, self.analytics, self.device,
                deltas=self.emit_deltas, egress=egress, cap=cap)
        return self._snaps[key]

    def _device_carry(self) -> tuple:
        """The snapshot program's carry on the device (the engines'
        layout), built from the mirrors."""
        return tuple(None if t is None else t.to(self.device)
                     for t in self._device_carry_host())

    def _device_carry_host(self) -> tuple:
        """The snapshot program's carry from the mirrors, as CPU
        tensors."""
        vb = self.vb
        if "bipartite" in self.analytics and len(self._bip) != 2 * vb:
            self._bip = self._grow_cover(self._bip, vb)
        return snap_ops.engine_carry(
            vb, self._degrees if "degrees" in self.analytics else None,
            self._cc if "cc" in self.analytics else None,
            self._bip if "bipartite" in self.analytics else None,
            "cpu")

    def _scan_device(self, interned, finalize, resident: bool) -> None:
        """The scan and resident tiers: one chunk loop through the
        ingress pipeline (ops/ingress_pipeline.run_pipeline) over an
        autotune.RoundPlan. Each chunk's [W, eb] stack is built and
        copied to a staging slot on a worker; the snapshot program runs
        in chunk order against the device carry; the copies back are
        enqueued behind it and the finalize reads them one chunk behind.

        - scan: chunks of _SCAN_CHUNK windows (W the chunk's windows),
          rounds of GS_AUTOTUNE_ROUND chunks under the scan tuner, the
          carry built from the mirrors each call, a look-ahead of
          INFLIGHT chunks;
        - resident: super-batches of GS_RESIDENT_SPB windows (W up to a
          power of two, the rest all padding), one super-batch a round
          under the resident tuner, as the JAX driver's, each launch
          replayed as the CUDA graph of (W, staging slot) over a device
          carry kept across calls, its graphs captured as the round is
          decided, a look-ahead of GS_RESIDENT_SLOTS super-batches.

        GS_AUTOTUNE=0 runs the static arm; forced_sync freezes the
        tuner.

        The `dispatch` fault site fires before each launch and the
        `finalize` site before each finalize reads its outs, both on
        the caller's thread (`_fire_site`); the launch itself is never
        guarded."""
        vb, width = self.vb, self._cut_size()
        snap = self._snapshot_program(self.egress)
        if resident:
            carry, stager = self._resident_state()
            cap, tuner = self._resident_chunk(), self._ensure_resident_tuner()
            round_len, inflight = 1, resident_engine.ring_slots()
        else:
            carry, stager = self._device_carry(), self._ring
            cap, tuner = self._SCAN_CHUNK, self._ensure_scan_tuner()
            round_len, inflight = None, self.INFLIGHT
        live = tuple(t for t in carry if t is not None)
        graphs = self._res_graphs

        def fold(*tensors):     # the launch a resident graph captures
            it = iter(tensors[:len(live)])
            return snap(tuple(None if t is None else next(it)
                              for t in carry), *tensors[len(live):])

        def rows(take: int) -> int:
            return seg_ops.bucket_size(take) if resident else take

        def on_round(arm, windows):
            wb = arm["wb"]
            if tuner is not None:
                self._warm_snapshot(snap, rows(min(wb, windows)))
            if resident and self.device.type == "cuda":
                widths = {rows(min(wb, windows))}
                if windows % wb:
                    widths.add(rows(windows % wb))
                for w in widths:
                    for slot in range(stager.slot_count):
                        graphs.capture(
                            (w, slot), live + stager.slot_tensors(
                                slot, _stack_specs(w, width)), fold,
                            warm=lambda w=w: self._warm_snapshot(snap, w))

        plan = autotune.RoundPlan(len(interned), {"wb": cap}, tuner,
                                  round_len=round_len, on_round=on_round)

        def prep(ch):
            chunk = interned[ch.at:ch.hi]
            return ch, seg_ops.stack_window_rows(
                [(s, d) for _w, s, d, _n in chunk], rows(len(chunk)),
                width, vb)

        def h2d(payload):
            ch, arrays = payload
            return ch, stager.put(arrays, ch.seq)

        def dispatch(dev_payload):
            ch, staged = dev_payload
            with self._chunk_step("snapshot_scan", interned[ch.at:ch.hi],
                                  closes=False):
                # the resident graph consumes its carry: its site is
                # never retried, as the JAX driver's resident dispatch
                self._fire_site("dispatch", ch.at,
                                retries=0 if resident else None)
                tensors = stager.take(staged)
                if resident:
                    w = tensors[0].shape[0]
                    outs = graphs.run(
                        (w, stager.slot_index(staged)), live + tensors,
                        fold, warm=lambda: self._warm_snapshot(snap, w))
                else:
                    outs = snap(carry, *tensors)
                stager.done(staged)
                return ch, self._enqueue_outs(ch.at, ch.hi - ch.at, outs,
                                              carry)

        def fin(raw):
            ch, out = raw
            with self._chunk_step("snapshot_wait", interned[ch.at:ch.hi]):
                self._fire_site("finalize", ch.at, retries=0)
                self._finish_chunk(out, interned, snap, finalize)
            plan.done(ch, sum(len(s) for _w, s, _d, _n
                              in interned[ch.at:ch.hi]))

        try:
            ingress_pipeline.run_pipeline(plan, prep, h2d, dispatch, fin,
                                          inflight=inflight)
        except BaseException:
            stager.release_all()
            raise
        plan.close()

    def _enqueue_outs(self, at: int, take: int, outs: dict, carry):
        """After a chunk's snapshot launch, on its stream: the copies back
        of its outs (the delta wire's rows wait for the finalize, which
        copies their used prefix) and of the carry (the mirrors)."""
        wire = {k: v for k, v in outs.items()
                if k.endswith(("_idx", "_val"))}
        copies = {k: HostCopy(v) for k, v in outs.items() if k not in wire}
        mirrors = tuple(None if t is None else HostCopy(
            t.clone() if t.device.type == "cpu" else t) for t in carry)
        done = None
        if wire and self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return at, take, copies, wire, done, mirrors

    def _finish_chunk(self, raw, interned, snap, finalize) -> None:
        """A chunk's finalize, one chunk behind its launch: its outs and
        mirrors read back, a delta chunk past its cap folded again on
        full rows."""
        at, take, copies, wire, done, mirrors = raw
        vb = self.vb
        # copied out of the pinned buffers, which then serve the next
        # chunks
        outs = {k: c.numpy().copy() for k, c in copies.items()}
        if wire and self._delta_overflowed(outs, snap.cap):
            # a window changed more slots than the cap: the chunk's full
            # rows again, from the chunk-start mirrors
            outs = self._refold_chunk_outs(interned[at:at + take])
        elif wire:
            outs.update(self._fetch_wire(outs, wire, done))
        deg, lab, cov = (None if m is None else m.numpy() for m in mirrors)
        # the dispatch boundary of the chunk's latency records closes
        # with its outs read (the per-window path has none)
        st = ({"dispatch": latency.clock()}
              if latency.enabled() and not self._per_window else None)
        finalize(at, take, outs, (
            None if deg is None else deg[:vb].copy(),
            None if lab is None else lab[:vb].copy(),
            None if cov is None else snap_ops.driver_cover(cov, vb)), st)

    # ------------------------------------------------------------------
    # the online tuners of the scan and resident tiers (ops/autotune.py)
    # ------------------------------------------------------------------
    def _scan_tuner_key(self) -> str:
        return ("snapshot_scan:eb=%d:vb=%d:%s"
                % (self.eb, self.vb, "+".join(self.analytics)))

    def _resident_tuner_key(self) -> str:
        return ("resident_scan:eb=%d:vb=%d:%s"
                % (self.eb, self.vb, "+".join(self.analytics)))

    def _resident_chunk(self) -> int:
        """Windows a resident super-batch (GS_RESIDENT_SPB, a power of
        two)."""
        return resident_engine.resident_spb(self.eb)

    def _ensure_scan_tuner(self):
        """The scan tier's windows-per-call tuner: rungs {16, 32, 64}
        under _SCAN_CHUNK. None with GS_AUTOTUNE=0 (the static chunks
        then run, with the same results)."""
        if not autotune.enabled():
            return None
        if self._scan_tuner is None:
            cap = self._SCAN_CHUNK
            self._scan_tuner = autotune.DispatchTuner(
                self._scan_tuner_key(), {"wb": autotune.rungs(cap)}, {"wb": cap},
                backend=self.device.type)
        return self._scan_tuner

    def _ensure_resident_tuner(self):
        """The resident tier's windows-per-super-batch tuner: rungs under
        the super-batch, keyed as its own family so scan-tier rates never
        seed it. None with GS_AUTOTUNE=0."""
        if not autotune.enabled():
            return None
        if self._resident_tuner is None:
            cap = self._resident_chunk()
            self._resident_tuner = autotune.DispatchTuner(
                self._resident_tuner_key(), {"wb": autotune.rungs(cap)},
                {"wb": cap}, backend=self.device.type)
        return self._resident_tuner

    def _warm_snapshot(self, snap, windows: int) -> None:
        """Launch the snapshot program once on an all-padding stack of
        `windows` windows against a throwaway carry, and wait (the
        kernel built, its scratch made, outside any timed round or graph
        capture; the carried state is not touched). A no-op on the
        CPU."""
        key = (self.vb, snap.egress, snap.cap, windows)
        if self.device.type != "cuda" or key in self._warmed_snaps:
            return
        vb, dev = self.vb, self.device
        carry = snap_ops.engine_carry(
            vb, np.zeros(0, np.int64) if "degrees" in self.analytics
            else None, np.zeros(0, np.int32) if "cc" in self.analytics
            else None, self._grow_cover(np.zeros(0, np.int32), vb)
            if "bipartite" in self.analytics else None, dev)
        pad = torch.full((windows, self._cut_size()), vb,
                         dtype=torch.int32, device=dev)
        snap(carry, pad, pad, torch.zeros(pad.shape, dtype=torch.bool,
                                          device=dev))
        torch.cuda.synchronize(dev)
        self._warmed_snaps.add(key)

    # ------------------------------------------------------------------
    # the resident tier (ops/resident_engine.py)
    # ------------------------------------------------------------------
    def _resident_state(self):
        """The resident tier's device carry (kept across calls: the
        graphs bind it), loaded from the mirrors, and its staging ring,
        reserved at a whole super-batch; both made anew, and the graphs
        dropped, when the vertex bucket or the window width changes."""
        vb, width, dev = self.vb, self._cut_size(), self.device
        key = (vb, width, self._resident_chunk())
        if self._res_key != key:
            self._res_key = key
            self._res_carry = None
            self._res_graphs.clear()
            self._res_stager = ChunkStager(
                dev, slots=resident_engine.ring_slots() + 1)
            self._res_stager.reserve(ChunkStager.nbytes(
                _stack_specs(key[2], width)))
        host = self._device_carry_host()
        if self._res_carry is None:
            self._res_carry = tuple(None if a is None else a.to(dev)
                                    for a in host)
        else:
            for t, a in zip(self._res_carry, host):
                if t is not None:
                    t.copy_(a)
        return self._res_carry, self._res_stager

    def _fetch_wire(self, outs: dict, wire: dict, done) -> dict:
        """The used prefix of each delta row ([W, max count]), copied
        back on the driver's copy stream behind the chunk's kernel
        alone (the next chunk's launch is already queued on the compute
        stream)."""
        got = {}
        for key in ("deg", "labels", "cover"):
            if key + "_cnt" not in outs:
                continue
            k = int(outs[key + "_cnt"].max())
            for part in ("_idx", "_val"):
                t = wire[key + part][:, :k]
                if done is None:
                    got[key + part] = t.numpy()
                    continue
                with torch.cuda.stream(self._copy):
                    self._copy.wait_event(done)
                    got[key + part] = t.cpu().numpy()
        return got

    @staticmethod
    def _delta_overflowed(outs: dict, cap: int) -> bool:
        """True when a window's changed count passed the wire's cap (its
        rows were cut: the chunk runs again on full rows)."""
        return any(int(np.max(outs[key + "_cnt"])) > cap
                   for key in ("deg", "labels", "cover")
                   if key + "_cnt" in outs)

    def _host_fold(self, fold, chunk, carry, prevs) -> dict:
        """One chunk on the native or host fold (mutating `carry`, the
        driver-layout copies), as the scan tier's full outs."""
        flat_s = np.concatenate([s for _w, s, _d, _n in chunk])
        flat_d = np.concatenate([d for _w, _s, d, _n in chunk])
        offs = np.zeros(len(chunk) + 1, np.int64)
        offs[1:] = np.cumsum([len(s) for _w, s, _d, _n in chunk])
        outs = fold(flat_s, flat_d, offs, self.vb, *carry)
        vb = self.vb
        if "cover" in outs:
            cov = outs.pop("cover")
            outs["odd"] = cov[:, :vb] == cov[:, vb:]
        if prevs is not None:
            # changed-slot masks against the previous window's snapshot
            # (row -1: the chunk's start state), as the scan's
            pd, pl, pc = prevs
            if "deg" in outs:
                outs["deg_chg"] = outs["deg"] != np.concatenate(
                    [pd[None], outs["deg"][:-1]])
            if "labels" in outs:
                outs["labels_chg"] = outs["labels"] != np.concatenate(
                    [pl[None], outs["labels"][:-1]])
            if "odd" in outs:
                podd = (pc[:vb] == pc[vb:])[None]
                outs["cover_chg"] = outs["odd"] != np.concatenate(
                    [podd, outs["odd"][:-1]])
        return outs

    def _chunk_start_state(self):
        """int32 copies of the mirrors in the host folds' layouts (deg
        [vb], labels [vb], cover [2·vb]), None where an analytic is
        off."""
        vb = self.vb
        deg32 = lab = cov = None
        if "degrees" in self.analytics:
            deg32 = np.zeros(vb, np.int32)
            deg32[:len(self._degrees)] = self._degrees
        if "cc" in self.analytics:
            lab = np.arange(vb, dtype=np.int32)
            lab[:len(self._cc)] = self._cc
        if "bipartite" in self.analytics:
            if len(self._bip) != 2 * vb:
                self._bip = self._grow_cover(self._bip, vb)
            cov = self._bip.astype(np.int32)
        return deg32, lab, cov

    def _refold_chunk_outs(self, chunk) -> dict:
        """The delta wire's overflow fallback: the chunk's full rows (and
        masks) from the program on full rows on the driver's device,
        over the chunk's slab staged again (its ring slot serves later
        chunks by now) and a carry from the chunk-start mirrors (the
        pipeline's carry has moved on to later chunks)."""
        arrays = seg_ops.stack_window_rows(
            [(s, d) for _w, s, d, _n in chunk], len(chunk), self._cut_size(),
            self.vb)
        src, dst, valid = (torch.from_numpy(a).to(self.device)
                           for a in arrays)
        outs = self._snapshot_program("full")(self._device_carry(), src,
                                              dst, valid)
        return {k: v.cpu().numpy() for k, v in outs.items()}

    def _finalize_chunk(self, chunk, outs: dict, mirrors, results) -> None:
        """A chunk's WindowResults from its outs (full rows, or the
        delta wire), then the mirrors from its end state `mirrors`
        (driver layouts: deg [vb], labels [vb], cover [2·vb]) and the
        pane ring."""
        vb = self.vb
        slabs, ring = self._triangle_slabs(chunk)
        if any(k.endswith("_cnt") for k in outs):
            self._emit_delta_chunk(chunk, outs, results, slabs)
            self._set_mirrors(chunk, mirrors, ring)
            return
        for i, (wstart, s, d, nv) in enumerate(chunk):
            res = WindowResult(window_start=wstart, num_edges=len(s),
                               vertex_ids=self._vertex_ids(nv))
            if "deg" in outs:
                snap = outs["deg"][i][:nv].astype(np.int64)
                self._check_degree_width(snap)
                res.degrees = _snapshot_view(snap)
                if "deg_chg" in outs:
                    idx = np.nonzero(outs["deg_chg"][i][:nv])[0].astype(
                        np.int32)
                    res.delta_degrees = _frozen_delta(idx, snap[idx])
            if "labels" in outs:
                res.cc_labels = _snapshot_view(outs["labels"][i][:nv], vb)
                if "labels_chg" in outs:
                    idx = np.nonzero(outs["labels_chg"][i][:nv])[0].astype(
                        np.int32)
                    res.delta_cc = _frozen_delta(idx, res.cc_labels[idx])
            if "odd" in outs:
                res.bipartite_odd = _snapshot_view(outs["odd"][i][:nv], vb)
                if "cover_chg" in outs:
                    idx = np.nonzero(outs["cover_chg"][i][:nv])[0].astype(
                        np.int32)
                    res.delta_bipartite = _frozen_delta(
                        idx, res.bipartite_odd[idx])
            self._pend_triangles(res, *slabs[i])
            results.append(res)
        self._set_mirrors(chunk, mirrors, ring)

    def _triangle_slabs(self, chunk):
        """Each window's triangle slab, and the pane ring after the
        chunk. Tumbling, a window's slab is the window. Sliding, it is
        the ring's panes before it and its own pane (≤ eb edges; the JAX
        driver's `_tri_window_edges`), and the ring keeps the last wp−1
        panes. Interned slots are stable, so ring panes stay valid as
        the vertex bucket grows."""
        if self._wp == 1:
            return [(s, d) for _w, s, d, _n in chunk], self._pane_ring
        ring = list(self._pane_ring)
        slabs = []
        for _w, s, d, _n in chunk:
            pane = (np.asarray(s, np.int32), np.asarray(d, np.int32))
            slabs.append(tuple(np.concatenate([p[k] for p in ring]
                                              + [pane[k]])
                               for k in (0, 1)))
            ring.append(pane)
            del ring[:-(self._wp - 1)]
        return slabs, ring

    def _set_mirrors(self, chunk, mirrors, ring) -> None:
        self._pane_ring = ring
        nv = chunk[-1][3] if chunk else 0
        self._nv_done = max(self._nv_done, nv)
        deg, lab, cov = mirrors
        if deg is not None:
            self._degrees = deg[:nv].astype(np.int64)
        if lab is not None:
            self._cc = lab[:nv].astype(np.int32)
        if cov is not None:
            self._bip = np.array(cov, np.int32)

    def _emit_delta_chunk(self, chunk, outs: dict,
                          results: List[WindowResult], slabs) -> None:
        """Decode a chunk's delta wire: each window's (idx, vals) pairs
        applied to working copies of the mirrors, which after window w
        are window w's snapshot (the full rows' bits, by definition)."""
        vb = self.vb
        want = {key: key + "_cnt" in outs for key in ("deg", "labels",
                                                      "cover")}
        if want["deg"]:
            deg_work = np.zeros(vb, np.int64)
            deg_work[:len(self._degrees)] = self._degrees
        if want["labels"]:
            lab_work = np.arange(vb, dtype=np.int32)
            lab_work[:len(self._cc)] = self._cc
        if want["cover"]:
            if len(self._bip) != 2 * vb:
                self._bip = self._grow_cover(self._bip, vb)
            odd_work = self._bip[:vb] == self._bip[vb:2 * vb]
        for i, (wstart, s, d, nv) in enumerate(chunk):
            res = WindowResult(window_start=wstart, num_edges=len(s),
                               vertex_ids=self._vertex_ids(nv))
            if want["deg"]:
                k = int(outs["deg_cnt"][i])
                idx = outs["deg_idx"][i][:k].copy()
                vals = outs["deg_val"][i][:k].astype(np.int64)
                self._check_degree_width(vals)
                delta_egress.apply_delta(deg_work, k, idx, vals)
                res.degrees = _snapshot_view(deg_work[:nv].copy())
                if self.emit_deltas:
                    res.delta_degrees = _frozen_delta(idx, vals)
            if want["labels"]:
                k = int(outs["labels_cnt"][i])
                idx = outs["labels_idx"][i][:k].copy()
                vals = outs["labels_val"][i][:k].copy()
                delta_egress.apply_delta(lab_work, k, idx, vals)
                res.cc_labels = _snapshot_view(lab_work[:nv].copy())
                if self.emit_deltas:
                    res.delta_cc = _frozen_delta(idx, vals)
            if want["cover"]:
                k = int(outs["cover_cnt"][i])
                idx = outs["cover_idx"][i][:k].copy()
                vals = outs["cover_val"][i][:k].astype(bool)
                delta_egress.apply_delta(odd_work, k, idx, vals)
                res.bipartite_odd = _snapshot_view(odd_work[:nv].copy())
                if self.emit_deltas:
                    res.delta_bipartite = _frozen_delta(idx, vals)
            self._pend_triangles(res, *slabs[i])
            results.append(res)

    def _boundary(self, chunk, res_chunk, tier: str, st,
                  closes_partial: bool) -> None:
        """After the mirrors, the chunk's hooks and then the cursors, the
        partial flag and the checkpoint, together (the JAX driver's
        `_boundary`, :1338-1391): a latency record on each of the
        chunk's WindowResults (`res_chunk`), a provenance record a
        window (wal_lo / wal_hi follow edges_done), the metrics mark."""
        lane = self.tenant or "driver"
        if latency.enabled():
            for i, res in enumerate(res_chunk):
                rec = latency.on_window(lane, edges=res.num_edges, st=st,
                                        ordinal=self.windows_done + i)
                if rec is not None:
                    res.latency = {"e2e_s": rec["e2e_s"],
                                   "stages": dict(rec["stages"]),
                                   "replayed": rec["replayed"]}
        if provenance.armed():
            lo = self.edges_done
            for i, res in enumerate(res_chunk):
                provenance.emit(
                    tenant=lane, window=self.windows_done + i, wal_lo=lo,
                    wal_hi=lo + res.num_edges, tier=tier, program="driver",
                    digest=provenance.result_digest(res))
                lo += res.num_edges
        edges = sum(len(s) for _w, s, _d, _n in chunk)
        self.windows_done += len(chunk)
        self.edges_done += edges
        metrics.mark_window(len(chunk), edges, engine="driver", tier=tier,
                            mesh_shape=self._mesh_shape(),
                            tenant=self.tenant)
        if closes_partial:
            self._closed_partial = True
        if self._ckpt_due():
            self._stage_ckpt()

    # ------------------------------------------------------------------
    # triangles: one count_windows flush per call
    # ------------------------------------------------------------------
    def _pend_triangles(self, res: WindowResult, s, d) -> None:
        if self._tri_pending is not None:
            self._tri_pending.append((res, np.asarray(s, np.int32),
                                      np.asarray(d, np.int32)))

    @contextlib.contextmanager
    def _batched_triangles(self):
        """Collect the enclosed windows' triangle work and count it in
        one count_windows call on clean exit (an exception leaves the
        windows' `triangles` None)."""
        if "triangles" not in self.analytics \
                or self._tri_pending is not None:
            yield
            return
        self._tri_pending = []
        try:
            yield
            pending = self._tri_pending
            if pending:
                with self._step("triangles",
                                sum(len(s) for _r, s, _d in pending)):
                    counts = self._flush_triangle_windows(
                        [(s, d) for _r, s, d in pending])
                for (res, _s, _d), c in zip(pending, counts):
                    res.triangles = c
        finally:
            self._tri_pending = None

    def _flush_triangle_windows(self, windows) -> list:
        """Count the flush's windows down the snapshot tier's ladder (the
        sharded kernel while the mesh lives): a demotable failure of one
        rung demotes, and the next rung counts only the windows the
        failed one had not finalized (its `drained_counts`)."""
        done: list = []
        while True:
            kern = self._tri_kern()
            tier = self._demoted_tier or self.snapshot_tier
            try:
                return done + kern.count_windows(windows[len(done):])
            except resilience.StageError as e:
                if not self._maybe_demote(tier, e):
                    raise
                done += list(kern.drained_counts or [])

    def _tri_kern(self):
        """The triangle kernel at the current buckets on the stream tier
        of the current snapshot tier (ShardedTriangleWindowKernel over
        the mesh while it lives, the device kernel on the scan and
        resident tiers, the native or host counter on theirs)."""
        if self._mesh_live():
            from ..parallel import mesh as mesh_mod
            from ..parallel import sharded

            k = self._tri_kernels.get("sharded")
            if k is None or (k.eb, k.vb) != (
                    mesh_mod.mesh_padded_len(self.eb, self.mesh), self.vb):
                k = self._tri_kernels["sharded"] = \
                    sharded.ShardedTriangleWindowKernel(
                        self.mesh, edge_bucket=self.eb,
                        vertex_bucket=self.vb)
            return k
        tier = _TRIANGLE_TIER[self._demoted_tier or self.snapshot_tier]
        k = self._tri_kernels.get(tier)
        if k is None or (k.eb, k.vb) != (self.eb, self.vb):
            k = self._tri_kernels[tier] = tri_ops.TriangleWindowKernel(
                edge_bucket=self.eb, vertex_bucket=self.vb,
                device=self.device, stream_tier=tier)
        return k

    # ------------------------------------------------------------------
    def _vertex_ids(self, nv: int) -> np.ndarray:
        """Slot -> external id table, extended by the slots added since
        the last window."""
        have = len(self._ext_ids)
        if nv > have:
            fresh = np.asarray(self.interner.ids_of(
                np.arange(have, nv, dtype=np.int32)), np.int64)
            self._ext_ids = np.concatenate([self._ext_ids, fresh])
        # a view: the cache grows only by reallocation, so an earlier
        # window's view keeps its own table
        return _snapshot_view(self._ext_ids[:nv])

    @staticmethod
    def _check_degree_width(snap: np.ndarray) -> None:
        """The device carries degrees in int32: a vertex past 2^31
        incident edges shows up negative at the next snapshot; fail
        there instead of checkpointing a wrapped count."""
        if len(snap) and int(snap.min()) < 0:
            raise OverflowError(
                "a vertex's running degree crossed 2^31 (int32 device "
                "state); shard the stream or reset windows before any "
                "single vertex accumulates that many incident edges")

    @staticmethod
    def _grow_cover(old: np.ndarray, vb: int) -> np.ndarray:
        """A cover labeling laid out over a wider vertex bucket: (-)
        slots move from old_vb+v to vb+v, labels into the (-) half move
        with them, new slots are identity."""
        old_vb = len(old) // 2
        cover = np.arange(2 * vb, dtype=np.int32)
        if old_vb:
            shifted = np.where(old >= old_vb, old + (vb - old_vb),
                               old).astype(np.int32)
            cover[:old_vb] = shifted[:old_vb]
            cover[vb:vb + old_vb] = shifted[old_vb:]
        return cover

    # ------------------------------------------------------------------
    # checkpoint / resume (utils/checkpoint.py)
    # ------------------------------------------------------------------
    def enable_auto_checkpoint(self, path: str, every_n_windows: int = 16,
                               every_seconds: float = 0.0,
                               policy=None) -> None:
        """Snapshot all carried state to `path` (atomic, the previous
        generation kept) every N windows and/or T seconds, checked at
        chunk boundaries (so a crash loses at most max(N, 64) windows,
        or an interval and a chunk). `policy` (a
        utils.checkpoint.CheckpointPolicy) may bring its own clock."""
        if policy is None:
            if every_n_windows < 1 and every_seconds <= 0:
                raise ValueError(
                    "need every_n_windows >= 1 and/or every_seconds > 0")
            policy = checkpoint.CheckpointPolicy(
                every_n_windows=max(0, every_n_windows),
                every_seconds=every_seconds)
        if not policy.enabled():
            raise ValueError("checkpoint policy has no trigger enabled")
        self._ckpt_path = path
        self._ckpt_policy = policy

    def _ckpt_due(self) -> bool:
        return (self._ckpt_path is not None
                and self._ckpt_policy.due(self.windows_done))

    def _stage_ckpt(self) -> None:
        """Save a due checkpoint, or inside stream_file stage it until
        every window it covers has been yielded (_emit): a crash then
        re-emits computed windows and never skips undelivered ones."""
        self._ckpt_policy.mark(self.windows_done)
        snap = (self.windows_done, self.state_dict())
        if self._emitted is None:
            self._save_ckpt(snap[1])
        else:
            self._pending_ckpt.append(snap)

    def _save_ckpt(self, state: dict) -> None:
        """Write a checkpoint, then let the journal's retention cursor
        drop what only older generations needed (it moves only at a
        flushed checkpoint's wal_offset)."""
        if self._writes_files():
            with self._step("checkpoint", 0):
                checkpoint.save(self._ckpt_path, state)
        self._wal_retention.flushed(self._wal, self.tenant or "driver",
                                    int(state["wal_offset"]))

    def _emit(self, results):
        """Yield a batch's results one by one, saving each staged
        checkpoint once its windows have all been yielded."""
        for res in results:
            yield res
            self._emitted += 1
            flushed = None
            while (self._pending_ckpt
                   and self._pending_ckpt[0][0] <= self._emitted):
                flushed = self._pending_ckpt.pop(0)
            if flushed is not None:
                self._save_ckpt(flushed[1])

    def try_resume(self, path: str) -> bool:
        """Restore from `path` (or its previous generation, when `path`
        is damaged) if a checkpoint exists; returns whether state was
        restored. With every generation damaged it warns and returns
        False; a semantic mismatch (window size, analytics) raises from
        load_state_dict."""
        try:
            got = checkpoint.load_latest(path)
        except checkpoint.CheckpointCorrupt as e:
            warnings.warn(f"{e}; no intact generation — starting fresh")
            return False
        if got is None:
            return False
        state, used = got
        if used != path:
            warnings.warn(
                f"checkpoint {path!r} is corrupt; resumed from the "
                f"rotated previous generation {used!r}")
        self.load_state_dict(state)
        telemetry.event("resume", durable=True, component="driver",
                        path=used, windows_done=self.windows_done)
        return True

    # ------------------------------------------------------------------
    # the journal (utils/wal.py; the JAX driver's :2445-2500)
    # ------------------------------------------------------------------
    def enable_wal(self, directory: str) -> bool:
        """Journal every live run_arrays() batch under `directory`
        (utils/wal.py, the format both packages read) after validation
        and before any window is cut. After a kill,
        `resume_and_replay(ckpt)` restores the newest checkpoint and
        feeds the journal past its `wal_offset` again, giving the lost
        windows bit-exactly. A journal-armed driver refuses
        stream_file(). False (a no-op) under GS_WAL=0. On a mesh of
        several ranks only rank 0 writes the journal; every rank replays
        it."""
        if not wal_mod.enabled():
            return False
        self._wal_dir = directory
        self._wal = (wal_mod.WriteAheadLog(directory)
                     if self._writes_files() else None)
        return True

    def seal_wal(self) -> None:
        """Durably close the journal (the clean-drain marker)."""
        if self._wal is not None:
            self._wal.seal()

    def resume_and_replay(self, ckpt_path: str) -> List[WindowResult]:
        """Kill recovery of a journal-armed driver: try_resume the
        newest checkpoint generation, then feed the journal's suffix
        past its `wal_offset` through run_arrays() (not journaled
        again). Returns the replayed WindowResults."""
        self.try_resume(ckpt_path)
        if self._wal_dir is None:
            return []
        tenant = self.tenant or "driver"
        parts = [(src, dst, ts) for tid, _start, src, dst, ts in
                 wal_mod.replay(self._wal_dir, {tenant: self.edges_done})
                 if tid == tenant]
        edges = sum(len(p[0]) for p in parts)
        telemetry.event("wal_replayed", durable=True, component="driver",
                        dir=self._wal_dir, edges=edges)
        metrics.counter_inc("gs_wal_replayed_edges_total", edges)
        if not edges:
            return []
        src = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        ts = (np.concatenate([p[2] for p in parts])
              if all(p[2] is not None for p in parts) else None)
        live, self._wal = self._wal, None
        try:
            return self.run_arrays(src, dst, ts)
        finally:
            self._wal = live

    def trace_report(self) -> List[dict]:
        """The StepTimer's report with tracing=True, else []."""
        return self.timer.report() if self.timer else []

    def state_dict(self) -> dict:
        """The JAX driver's checkpoint keys and layouts, as of the last
        finalized window: the vertex table ends at its slots, not at the
        slots a call interned ahead, so a driver resumed from a checkpoint
        inside a call gives the uninterrupted run's arrays. Sliding, the
        pane ring rides along, so a resumed stream composes the same
        triangle slabs. A mesh driver adds "sharded", "mesh_shape" and
        the "engine" key, the sharded engines' state built from the
        mirrors (it never touches the mesh)."""
        state = {
            "window_ms": self.window_ms,
            "analytics": list(self.analytics),
            "sharded": self.mesh is not None,
            "mesh_shape": self._mesh_shape(),
            "windows_done": self.windows_done,
            "edges_done": self.edges_done,
            "wal_offset": self.edges_done,
            "edge_bucket": self.eb,
            "vertex_bucket": self.vb,
            "closed_partial": self._closed_partial,
            "vertex_ids": np.array(self._vertex_ids(self._nv_done)),
            "degrees": self._degrees.copy(),
            "cc": self._cc.copy(),
            "bip": self._bip.copy(),
        }
        if self._wp > 1:
            state["slide"] = self.slide
            state["pane_ring_src"] = [s.copy() for s, _d in self._pane_ring]
            state["pane_ring_dst"] = [d.copy() for _s, d in self._pane_ring]
        if self.mesh is not None:
            state["engine"] = engine_state_from_mirrors(
                self.vb, self._degrees, self._cc, self._bip,
                self._mesh_shape())
        # the tuners' learned state, as the JAX driver keys it
        if self._scan_tuner is not None:
            state["autotune"] = self._scan_tuner.state_dict()
        if self._resident_tuner is not None:
            state["autotune_resident"] = self._resident_tuner.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Either package's checkpoint of either mode: a mesh
        checkpoint's "engine" state becomes the mirrors
        (`mirrors_from_engine_state`), which a mesh driver stages into
        its carry at its next call. A mesh driver takes the checkpoint's
        vertex bucket exactly, a single-chip one keeps a larger
        constructor bucket; tuner states load on one card only."""
        if state["window_ms"] != self.window_ms:
            raise ValueError("window size mismatch")
        if tuple(state["analytics"]) != self.analytics:
            raise ValueError(
                f"analytics mismatch: checkpoint has "
                f"{state['analytics']}, driver runs {list(self.analytics)}")
        ckpt_slide = state.get("slide")
        if (int(ckpt_slide) if ckpt_slide else None) != self.slide:
            # pane cuts are governed by slide as window cuts are by eb
            raise ValueError(
                "slide mismatch: checkpoint has %r, driver runs %r"
                % (ckpt_slide, self.slide))
        edges_done = int(state.get("edges_done", 0))
        woff = state.get("wal_offset")
        if woff is not None and int(woff) != edges_done:
            raise ValueError(
                "checkpoint wal_offset %d disagrees with its own "
                "edges_done cursor %d" % (int(woff), edges_done))
        self.interner = make_interner(np.array([0]))
        self._ext_ids = np.zeros(0, np.int64)
        self.windows_done = int(state.get("windows_done", 0))
        self.edges_done = edges_done
        self._closed_partial = bool(state.get("closed_partial", False))
        self._pane_ring = [
            (np.asarray(s, np.int32), np.asarray(d, np.int32))
            for s, d in zip(state.get("pane_ring_src", []),
                            state.get("pane_ring_dst", []))]
        if "edge_bucket" in state:
            # count-based windows are cut by eb: resume with the same cut
            self.eb = int(state["edge_bucket"])
        if "vertex_bucket" in state:
            # a mesh takes the checkpoint's bucket; on one card a larger
            # constructor bucket stays (the mirrors re-lay out)
            ckpt_vb = int(state["vertex_bucket"])
            self.vb = ckpt_vb if self.mesh is not None else max(self.vb,
                                                                ckpt_vb)
        self.interner.intern_array(np.asarray(state["vertex_ids"],
                                              np.int64))
        self._nv_done = len(self.interner)
        self._degrees = np.array(state["degrees"])
        self._cc = np.array(state["cc"])
        self._bip = np.array(state["bip"])
        if "engine" in state:
            # a mesh checkpoint: the engines' state is the truth
            deg, lab, bip = mirrors_from_engine_state(state["engine"],
                                                      self._nv_done)
            self._degrees, self._cc = deg, lab
            if bip is not None:
                self._bip = bip
        self._ensure_buckets(len(state["vertex_ids"]), 1)
        # either package's tuner state (inert with GS_AUTOTUNE=0); the
        # scan tier's tuners are single-chip
        for key, ensure in (("autotune", self._ensure_scan_tuner),
                            ("autotune_resident",
                             self._ensure_resident_tuner)):
            if state.get(key) is not None and self.mesh is None:
                tuner = ensure()
                if tuner is not None:
                    tuner.load_state_dict(state[key])


def engine_state_from_mirrors(vb: int, degrees, cc, bip,
                              mesh_shape=None) -> dict:
    """The sharded engines' state (parallel/sharded.ShardedWindowEngine's
    `state_dict` keys: "vb", "mesh_shape", "degree_state" and "labels"
    [vb+2], "bip_labels" [2vb+2] where the cover mirror is not empty)
    from the driver's mirrors (degrees [nv], labels [nv], the cover
    [2·vb'] at any vb' ≤ vb, which is laid out again at vb): the JAX
    driver's `_engine_state_from_mirrors` (:1227-1248). The sentinel
    slots take their identities, degree 0 and their own label, as the
    JAX batched path leaves them: they absorb padding and feed no
    output."""
    st = {"vb": vb, "mesh_shape": mesh_shape}
    deg = np.zeros(vb + 2, np.int32)
    deg[:len(degrees)] = degrees
    lab = np.arange(vb + 2, dtype=np.int32)
    lab[:len(cc)] = cc
    st["degree_state"], st["labels"] = deg, lab
    if len(bip):
        if len(bip) != 2 * vb:
            bip = StreamingAnalyticsDriver._grow_cover(bip, vb)
        cov = np.arange(2 * vb + 2, dtype=np.int32)
        cov[:2 * vb] = bip
        st["bip_labels"] = cov
    return st


def mirrors_from_engine_state(state: dict, nv: int) -> tuple:
    """(degrees int64 [nv], labels int32 [nv], cover int32 [2·vb] or None
    where the state has none) from the sharded engines' state, which is
    replicated, so any mesh width's: the JAX driver's
    `_absorb_engine_state` (:1195-1225)."""
    cov = state.get("bip_labels")
    return (np.asarray(state["degree_state"])[:nv].astype(np.int64),
            np.asarray(state["labels"])[:nv].astype(np.int32),
            None if cov is None
            else np.asarray(cov)[:len(cov) - 2].astype(np.int32))


def _reason(err: BaseException) -> str:
    """A demotion's reason: the error's first line, and its root cause's
    where the first line does not hold it (a worker's failure carries a
    traceback, which the record's 500 characters would cut)."""
    root, seen = err, set()
    while root.__cause__ is not None and id(root) not in seen:
        seen.add(id(root))
        root = root.__cause__
    head = "%s: %s" % (type(err).__name__, str(err).split("\n", 1)[0])
    tail = str(root).split("\n", 1)[0]
    if root is not err and tail not in head:
        head += " <- %s: %s" % (type(root).__name__, tail)
    return head


def _shard_of(err: BaseException):
    """The shard a failure names: the first `shard` along its cause
    chain (an InjectedFault of a mesh site), else None."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        if getattr(err, "shard", None) is not None:
            return err.shard
        err = err.__cause__
    return None


def _stack_specs(windows: int, width: int) -> list:
    """(shape, dtype) of a [windows, width] standard-wire stack."""
    return [((windows, width), np.int32), ((windows, width), np.int32),
            ((windows, width), np.bool_)]
