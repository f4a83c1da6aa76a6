"""Multi-tenant cohorts: N independent graph streams, one cohort dispatch
per window round.

Port of the JAX package's `core/tenancy.py`. `TenantCohort` admits up to
GS_TENANT_MAX streams, each with its own bounded ingest queue and its
own carry (deg, labels, cover) in the summary engines' layout, and
right-pads each ready tenant's next windows (at most the window ceiling:
`windows_per_dispatch`, default 8, or on the resident tier the
GS_RESIDENT_SPB bucket) into one cohort slab [nb, wb, eb] per (vertex
bucket, K) group and batch, which one call of the group's
`ops/cohort_summary.CohortSummary` folds: the cohort kernel of
csrc/cohort_summary.cu (one launch for the whole slab) and the window
counter on a card, the plain PyTorch version on the CPU. nb and wb are
the power-of-two buckets of the batch's tenants and windows, as in the
JAX cohort; pad rows carry a fresh state and are thrown away. Per tenant
the summaries, degrees and labels equal a `StreamSummaryEngine` fed the
same stream, and `tenant_state_dict()` equals the JAX cohort's bit for
bit (the cover's sentinel slot 2vb+1 records padded windows, so it may
differ from a sequential engine's). A window whose hubs outrun the K
bucket is recounted exactly by a `TriangleWindowKernel` at 4·K.

The serving pieces around the slab, as in the JAX cohort:

- **Admission and backpressure.** `admit()` is capped at GS_TENANT_MAX;
  each tenant's queue holds GS_TENANT_QUEUE_WINDOWS windows, and a
  feed past it raises `TenantBackpressure` (GS_TENANT_ADMISSION=reject)
  or sheds the overflow (drop). The constructor's `max_tenants`,
  `queue_windows` and `admission` override the knobs. A feed runs the
  `admit` fault site, the per-tenant event-time guard (behind the
  GS_OOO_BOUND reorder buffer when it is armed), the armed sanitizer
  (GS_SANITIZE, rejects to the dead-letter journal), the capacity gate,
  the journal (`enable_wal`) and the enqueue, in that order.
- **The bulkhead.** A `cohort_dispatch` fault or implausible outputs
  (a `PoisonOutput` from the host-side gate on the copied-back rows)
  bisect the batch to the poison tenants, which are quarantined: no
  cohort dispatch, solo probation windows on their own engine until
  GS_QUARANTINE_WINDOWS clean ones re-admit them. A failed slab prep
  (`tenant_prep`) demotes that tenant alone onto a `StreamSummaryEngine`
  on the cohort's device. Unlike the JAX bulkhead, nothing here runs
  the launch or the copy back under a stage guard or on a watchdog
  thread, and a device error (`resilience.is_device_error`, a kernel's
  `KernelError` among them) or a failed staging copy (h2d) raises to the
  caller with no bisect, quarantine or demotion: such a failure follows
  the machine, not a tenant's data. Likewise only a PoisonOutput or a
  failure of its host prep stage fails a probation probe; anything else
  raises with probation as it was. A tenant demoted by a failed prep is
  left out of the bisect and re-dispatch of its batch. No tenant's work
  leaves the card.
- **Durability.** Per-tenant checkpoints (`enable_auto_checkpoint`,
  staged at dispatch boundaries and written at pump()'s clean return;
  the carry of a tenant due for one rides its dispatch's one copy
  back), `checkpoint_all`, `try_resume` / `resume_all`, and the
  write-ahead journal (`enable_wal`, `seal_wal`, `recover`) in the
  on-disk formats both packages share.
- **Observation.** `cohort.dispatch` and `cohort.round` spans, latency
  stamps and per-window records (`defer_delivery` for a serving front
  end), per-tenant cost attribution, health marks, queue gauges and one
  provenance record a window; with GS_COSTMODEL the cost observatory's
  `cohort_summary` row.

`GnnTenantCohort` is the same serving shape for the windowed GNN: each
tenant owns a [vb+1, F] feature slab, the cohort shares one snapped
weight layer, and a pump folds every tenant's full windows through
`gnn_window.build_gnn_cohort_scan` (the GNN kernel of csrc/gnn_round.cu
per tenant row on a card), under the same spans, attribution, health
marks and provenance.

The dispatch loop, as in the JAX cohort:

- **The resident tier.** With GS_COHORT_RESIDENT=on
  (ops/resident_engine.resolve_resident_cohort) each (vb, K) group's
  carries stay on the device between rounds as one stacked [nb, ...]
  carry, restacked only when the rows of a dispatch are not the stack's
  (a tenant admitted, closed, drained, quarantined, demoted or restored,
  or a batch of other tenants): then every tenant of the old stack keeps
  a copy of its row first. A dispatch folds up to the GS_RESIDENT_SPB
  bucket of windows a tenant (`_window_ceiling`). On a card it is one
  replay of a CUDA graph (ops/resident_engine.SuperBatchGraphs, family
  "cohort_resident", keyed by (vb, K, nb, wb, staging slot)): a copy of
  the committed stack into the group's work stack, then the cohort
  kernel and its counter over the work stack and the staged slab. The
  work stack is committed only past the poison gate, so a refused
  dispatch leaves the committed stack and every carry as they were (the
  JAX cohort donates its stack to the program instead). On the CPU the
  same branch runs the plain versions eagerly.
- **The tenants-per-dispatch arm.** A `tenant_cohort` DispatchTuner
  (ops/autotune.py) per vertex bucket, keyed by eb, vb and the cohort
  bucket Nb and re-keyed when Nb changes, picks each round's tenants per
  dispatch (and, on the resident tier, windows per super-batch) and
  takes back the round's edges/s. GS_TENANT_TPD, or the constructor's
  `tenants_per_dispatch`, pins it; with GS_AUTOTUNE=0 every ready tenant
  of a group goes in one slab. The arm changes no summary.
- **The ingest ring.** A round of several batches preps batch k+1's slab
  on the ingress pool (ops/resident_engine.IngestRing) while batch k
  dispatches; a round of one batch preps inline. The staging copy stays
  in the dispatch, under its stage guard. A failure in the round drains
  the ring before it raises: the queues of the batches not dispatched
  are not consumed.

The serving front end over a cohort is `core/serve.py`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import autotune
from ..ops import ingress_pipeline
from ..ops import resident_engine
from ..ops import segment as seg_ops
from ..ops.cohort_summary import CohortSummary
from ..ops.ingress_pipeline import PrepError
from ..ops.gnn_round import ACTIVATIONS
from ..ops.gnn_window import (GnnSummaryEngine, build_gnn_cohort_scan,
                              default_weights, snap_features, snap_weights)
from ..ops.scan_analytics import (StreamSummaryEngine, _to_host,
                                  check_summary_carry)
from ..ops.staging import ChunkStager
from ..ops.triangles import TriangleWindowKernel, _tuned_kb
from ..ops.window_summary import fresh_carry
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
from .platform import resolve_device

__all__ = ["GnnTenantCohort", "PoisonOutput", "TenantBackpressure",
           "TenantCohort", "TenantError", "TenantQuarantined",
           "TenantRejected"]

ADMISSION_POLICIES = ("reject", "drop")


# ----------------------------------------------------------------------
# knobs (utils/knobs.py; read live on every call)
# ----------------------------------------------------------------------
def max_tenants() -> int:
    """Admission cap of the cohorts (GS_TENANT_MAX, default 64)."""
    return knobs.get_int("GS_TENANT_MAX")


def queue_windows() -> int:
    """Per-tenant queue depth in windows (GS_TENANT_QUEUE_WINDOWS,
    default 8): capacity in edges is depth × edge_bucket."""
    return knobs.get_int("GS_TENANT_QUEUE_WINDOWS")


def admission_policy() -> str:
    """Queue-overflow policy (GS_TENANT_ADMISSION): `reject` (default)
    raises TenantBackpressure accepting nothing; `drop` accepts what
    fits and sheds the rest."""
    return knobs.get_str("GS_TENANT_ADMISSION")


def pinned_tpd() -> int:
    """GS_TENANT_TPD: tenants per cohort dispatch; 0 = the tuner's arm,
    or every ready tenant of a group with GS_AUTOTUNE=0."""
    return knobs.get_int("GS_TENANT_TPD")


def quarantine_windows() -> int:
    """GS_QUARANTINE_WINDOWS: clean solo probation windows before a
    quarantined tenant re-enters the cohort (0 = permanent)."""
    return knobs.get_int("GS_QUARANTINE_WINDOWS")


def ooo_bound() -> int:
    """GS_OOO_BOUND: bounded out-of-orderness (event-time ns) of the
    per-tenant reorder buffer ahead of the monotonic guard; 0 = off."""
    return knobs.get_int("GS_OOO_BOUND")


# ----------------------------------------------------------------------
# typed errors
# ----------------------------------------------------------------------
class TenantError(RuntimeError):
    """Base of the typed tenancy failures; `tenant` names the stream.
    Construction stamps a `tenant_rejected` event (durable unless
    `_durable` is False) and counts `gs_tenant_rejections_total{kind}`,
    unless `_record` is False."""

    EVENT = "tenant_rejected"

    def __init__(self, message: str, tenant, _record: bool = True,
                 _durable: bool = True, **attrs):
        super().__init__(message)
        self.tenant = tenant
        if _record:
            telemetry.event(self.EVENT, durable=_durable,
                            tenant=str(tenant), kind=type(self).__name__,
                            **attrs)
            metrics.counter_inc("gs_tenant_rejections_total",
                                kind=type(self).__name__)


class TenantRejected(TenantError):
    """Admission refused: the cohort is at its cap, the id is unknown or
    closed, or a duplicate admit."""


class TenantBackpressure(TenantError):
    """A feed() overflowed the tenant's bounded queue under the `reject`
    policy. Carries `queued` and `capacity` (edges) so the caller can
    size its retry. Its event is durable once per overflow episode (the
    tenant's `bp_stamped`, reset when the queue drains): a retry loop
    against a full queue must not fsync on every attempt."""

    def __init__(self, message: str, tenant, queued: int, capacity: int,
                 _durable: bool = True):
        super().__init__(message, tenant, _durable=_durable,
                         queued=queued, capacity=capacity)
        self.queued = queued
        self.capacity = capacity


class TenantQuarantined(TenantRejected):
    """A feed() reached a permanently quarantined tenant
    (GS_QUARANTINE_WINDOWS=0). Carries `probation_left` (-1:
    permanent). Its event is buffered: the quarantine itself wrote the
    durable record."""

    def __init__(self, message: str, tenant, probation_left: int):
        super().__init__(message, tenant, _durable=False,
                         reason="quarantined",
                         probation_left=probation_left)
        self.probation_left = probation_left


class PoisonOutput(RuntimeError):
    """A cohort dispatch copied back implausible outputs (a negative
    count, components past the bucket) for the slab rows of `tenants`.
    Internal to the bulkhead, which quarantines exactly those tenants
    and dispatches the rest again; never raised to a caller."""

    def __init__(self, message: str, tenants):
        super().__init__(message)
        self.tenants = list(tenants)


def _resets_probation(err: BaseException) -> bool:
    """True for the probe failures that are the tenant's: a PoisonOutput,
    or a failure of the probe engine's host prep stage (typed by the
    stage guard, a PrepError of stage prep without it). A device error,
    a fatal fault, an h2d failure or an error of no known stage is not
    evidence against the tenant and raises to the caller."""
    if isinstance(err, PoisonOutput):
        return True
    if (isinstance(err, faults.InjectedFault) and err.fatal) \
            or resilience.is_device_error(err):
        return False
    return isinstance(err, (resilience.StageError, PrepError)) \
        and err.stage in ("queued", "prep")


def _int_outputs(outs) -> torch.Tensor:
    """A cohort summary's five [nb, wb] outputs as one int32 tensor."""
    return torch.stack([x.to(torch.int32) for x in outs])


class _Tenant:
    """One admitted stream: its bounded ingest queue, its carry in the
    engines' layout, its cursors, its bulkhead state and (demoted or on
    probation) its own single-tenant engine."""

    __slots__ = ("tid", "vb", "kb", "src", "dst", "carry", "res_row",
                 "windows_done", "closed_partial", "closing", "closed",
                 "tier", "engine", "ckpt_policy", "dropped_edges",
                 "bp_stamped", "fed_offset", "probation",
                 "quarantine_reason", "last_report", "last_ts", "ooo_src",
                 "ooo_dst", "ooo_ts")

    def __init__(self, tid: str, vb: int, kb: int):
        self.tid = tid
        self.vb = vb
        self.kb = kb
        self.src = np.zeros(0, np.int32)
        self.dst = np.zeros(0, np.int32)
        self.carry = None          # lazy: the fresh state until a dispatch
        self.res_row = None        # its row of the group's resident stack
                                   # (the carry lives there, not here)
        self.windows_done = 0
        self.closed_partial = False
        self.closing = False
        self.closed = False
        self.tier = "cohort"       # "cohort" | "single" | "quarantined"
        self.engine = None         # the demoted or probation engine
        self.ckpt_policy = None    # per-tenant CheckpointPolicy
        self.dropped_edges = 0
        self.bp_stamped = False    # durable once per overflow episode
        self.fed_offset = 0        # fed edges, rejects included (the DLQ's
                                   # source offsets)
        self.probation = 0         # clean solo windows since quarantine
        self.quarantine_reason = None
        self.last_report = None    # the last feed's SanitizeReport
        self.last_ts = None        # newest accepted event-time stamp
        # the GS_OOO_BOUND hold: edges sorted by ts, released once the
        # tenant's watermark passes them; never journaled while held
        self.ooo_src = np.zeros(0, np.int64)
        self.ooo_dst = np.zeros(0, np.int64)
        self.ooo_ts = np.zeros(0, np.int64)

    @property
    def queued(self) -> int:
        return len(self.src)


class TenantCohort:
    """N independent graph streams through one cohort dispatch per window
    round and bucket group. In serving order:

        cohort = TenantCohort(edge_bucket=4096, vertex_bucket=8192)
        cohort.admit("user-1"); cohort.admit("user-2", vertex_bucket=2048)
        cohort.feed("user-1", src, dst)     # bounded; may reject
        results = cohort.pump()             # {tenant: [summary, ...]}
        results = cohort.close("user-1")    # flush the partial window

    Summaries are the summary engines' dicts (max_degree /
    num_components / odd_cycle / triangles), equal per tenant to a
    StreamSummaryEngine fed the same stream.

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. `max_tenants`,
    `queue_windows` (queue depth in windows of edge_bucket edges) and
    `admission` ("reject": an overflowing feed raises TenantBackpressure
    and accepts nothing; "drop": it accepts what fits and counts the
    rest in the tenant's `dropped_edges`) override GS_TENANT_MAX,
    GS_TENANT_QUEUE_WINDOWS and GS_TENANT_ADMISSION, which None (the
    default) reads on every call. `tenants_per_dispatch` above 0 pins
    the tenants of a dispatch as GS_TENANT_TPD does; 0 reads the knob
    (0 there: the tuner's arm, or every ready tenant of a group with
    GS_AUTOTUNE=0). `windows_per_dispatch` is the JAX cohort's window
    ceiling on the scan form: a tenant folds at most its power-of-two
    bucket (at least 8) of windows per dispatch; the resident tier folds
    up to the GS_RESIDENT_SPB bucket. `k_bucket` is the tenants' default K (0: the
    fastest `k_sweep` row of the device's evidence,
    ops/triangles._tuned_kb, else the analytic default for the edge
    bucket); `admit(k_bucket=)` gives one its own."""

    MAX_WINDOWS_PER_DISPATCH = 8

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0,
                 windows_per_dispatch: Optional[int] = None, device=None,
                 max_tenants: Optional[int] = None,
                 queue_windows: Optional[int] = None,
                 admission: Optional[str] = None,
                 tenants_per_dispatch: int = 0):
        if admission is not None and admission not in ADMISSION_POLICIES:
            raise ValueError("admission must be one of %s, got %r"
                             % (ADMISSION_POLICIES, admission))
        if (max_tenants is not None and max_tenants < 1) \
                or (queue_windows is not None and queue_windows < 1) \
                or tenants_per_dispatch < 0:
            raise ValueError("max_tenants and queue_windows must be ≥ 1 and "
                             "tenants_per_dispatch ≥ 0")
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.default_vb = seg_ops.bucket_size(vertex_bucket)
        self.kb = seg_ops.bucket_size(k_bucket if k_bucket
                                      else _tuned_kb(self.eb, self.device))
        self.wc = seg_ops.bucket_size(
            windows_per_dispatch if windows_per_dispatch
            else self.MAX_WINDOWS_PER_DISPATCH)
        self._max_tenants = max_tenants
        self._queue_windows = queue_windows
        self._admission = admission
        self.tenants_per_dispatch = int(tenants_per_dispatch)
        self.tenants: Dict[str, _Tenant] = {}
        self._summaries = {}       # vb -> {kb: CohortSummary}
        self._fresh = {}           # vb -> fresh carry on the device
        self._tri_redo = {}        # vb -> {kb: the 4·K exact recount}
        self._tuners = {}          # vb -> DispatchTuner (the tpd arm)
        self._tuner_nb = {}        # vb -> the Nb it was keyed at
        # the resident tier: per (vb, kb) group the committed stack,
        # {"nb": rows, "rows": (tid | None, ...), "carry": 3 tensors},
        # restacked only when a dispatch's rows differ; its buffers and
        # the work stack a dispatch folds, per (vb, kb, nb)
        self._res = {}
        self._res_bufs = {}
        self._graphs = resident_engine.SuperBatchGraphs("cohort_resident")
        self.resident_dispatches = 0   # dispatches through the tier
        self.resident_restacks = 0     # of which restacked the group
        self._round_spb = 0        # this round's windows-per-superbatch arm
        self._ring = resident_engine.IngestRing()
        self._stage = ChunkStager(self.device)
        self._h2d_seq = 0          # the staging copies' ordinals
        self._round_no = 0
        self._ckpt_dir = None
        self._ckpt_every_n = 0
        self._ckpt_every_s = 0.0
        self._wal = None           # utils/wal.WriteAheadLog when armed
        self._wal_dir = None
        # journal retention (GS_WAL_RETAIN) at checkpoint_all()'s flush
        self._wal_retention = wal_mod.RetentionCursor()
        # a serving front end sets this so finalized windows defer their
        # latency record to its sink write (latency.delivered); direct
        # pump() callers record at finalize
        self.defer_delivery = False
        # feed() appends to a queue and the pump prefix-drops it under
        # this lock, so ingest threads may feed while one thread pumps
        self._qlock = threading.RLock()

    # -- the knobs, or the constructor's overrides ----------------------
    def _cap(self) -> int:
        return max_tenants() if self._max_tenants is None \
            else int(self._max_tenants)

    def _capacity(self) -> int:
        depth = queue_windows() if self._queue_windows is None \
            else int(self._queue_windows)
        return depth * self.eb

    def _policy(self) -> str:
        return admission_policy() if self._admission is None \
            else self._admission

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def admit(self, tenant_id, vertex_bucket: Optional[int] = None,
              k_bucket: Optional[int] = None) -> None:
        """Admit one stream under the admission cap. A tenant may declare
        its own vertex bucket and K (the cohort dispatches one slab per
        (vb, K) group); K defaults to the cohort's."""
        tid = str(tenant_id)
        if tid in self.tenants:
            raise TenantRejected("tenant %r is already admitted" % tid, tid,
                                 reason="duplicate")
        cap = self._cap()
        live = sum(1 for t in self.tenants.values() if not t.closed)
        if live >= cap:
            raise TenantRejected(
                "cohort is at its max_tenants=%d admission cap "
                "(GS_TENANT_MAX); tenant %r refused" % (cap, tid), tid,
                reason="max_tenants", cap=cap)
        vb = seg_ops.bucket_size(vertex_bucket if vertex_bucket
                                 else self.default_vb)
        kb = seg_ops.bucket_size(k_bucket) if k_bucket else self.kb
        t = _Tenant(tid, vb, kb)
        if self._ckpt_every_n or self._ckpt_every_s:
            t.ckpt_policy = checkpoint.CheckpointPolicy(
                every_n_windows=self._ckpt_every_n,
                every_seconds=self._ckpt_every_s)
        with self._qlock:
            self.tenants[tid] = t
        telemetry.event("tenant_admitted", tenant=tid, vb=vb)
        metrics.on_stream_start("cohort", tenant=tid)

    def _tids(self) -> list:
        """Sorted snapshot of the tenant ids, taken under the queue lock
        (admissions may land from other threads)."""
        with self._qlock:
            return sorted(self.tenants)

    def _tenant(self, tenant_id, for_feed: bool = False) -> _Tenant:
        tid = str(tenant_id)
        t = self.tenants.get(tid)
        if t is None:
            # only the feed path records: a typo'd id in introspection
            # must not stamp events or count rejections
            raise TenantRejected("unknown tenant %r (admit() first)" % tid,
                                 tid, _record=for_feed, reason="unknown")
        if for_feed and (t.closed or t.closing):
            raise TenantRejected(
                "tenant %r is closed — its final (partial) window was "
                "already cut" % tid, tid, reason="closed")
        if for_feed and t.tier == "quarantined" \
                and quarantine_windows() <= 0:
            # a permanent quarantine refuses typed: nothing would drain
            # the queue. With probation on, feeds stay accepted: they
            # are what the probation windows consume.
            raise TenantQuarantined(
                "tenant %r is quarantined (%s); GS_QUARANTINE_WINDOWS=0 "
                "— permanent for this process"
                % (tid, t.quarantine_reason), tid, probation_left=-1)
        return t

    # ------------------------------------------------------------------
    # feed / backpressure
    # ------------------------------------------------------------------
    def _check_event_time(self, t: _Tenant, src, ts):
        """Per-tenant event-time monotonicity: the optional ts column must
        align with the batch, be non-decreasing within it, and start at
        or after the tenant's newest accepted stamp. Tenants never
        compare clocks with each other. Returns the int64 column (None
        without one); raises ValueError naming the tenant, consuming
        nothing."""
        if ts is None:
            return None
        col = np.asarray(ts, np.int64)
        if col.shape != (len(src),):
            raise ValueError("tenant %r ts column length %d != batch length "
                             "%d" % (t.tid, col.size, len(src)))
        if col.size == 0:
            return col
        if col.size > 1 and bool(np.any(np.diff(col) < 0)):
            raise ValueError(
                "tenant %r event-time regression WITHIN the batch: ts must "
                "be non-decreasing per tenant" % t.tid)
        if t.last_ts is not None and int(col[0]) < t.last_ts:
            raise ValueError(
                "tenant %r event-time regression: batch starts at %d but "
                "the tenant's stream already reached %d"
                % (t.tid, int(col[0]), t.last_ts))
        return col

    def feed(self, tenant_id, src, dst, ts=None) -> int:
        """Append edges to one tenant's bounded queue; returns the number
        accepted. Past capacity (queue depth × edge_bucket edges) the
        admission policy decides: `reject` raises TenantBackpressure
        accepting nothing (an atomic refusal cannot split a window
        across a retry), `drop` accepts what fits and sheds the rest.
        Ids must lie in [0, the tenant's vertex bucket); with GS_SANITIZE
        armed the others go to the dead-letter journal instead.

        `ts` is an optional per-edge event-time column (int64), checked
        per tenant (`_check_event_time`). With GS_OOO_BOUND > 0 the
        batch first merges into the tenant's reorder hold, and only the
        prefix the watermark (newest stamp − bound) passed is admitted:
        held edges are not accepted yet (not journaled, not queued, not
        counted in the return value). With GS_LATENCY armed the accepted
        edges are stamped at this boundary (the stamp rides the
        journal's ts column)."""
        lat = latency.enabled()
        t_admit = latency.clock() if lat else 0.0
        t = self._tenant(tenant_id, for_feed=True)
        if t.closed_partial:
            # the engines' partial-window-must-be-final guard, across a
            # checkpoint taken after the short final window was cut
            raise ValueError(
                "tenant %r already closed a partial window (length not a "
                "multiple of edge_bucket); it cannot accept more of the "
                "stream" % t.tid)
        # the admission fault site, upstream of the sanitizer: a `call`
        # spec may poison the arrays
        got = faults.fire("admit", (t.tid, src, dst))
        if got is not None:
            _tid, src, dst = got
        bound = ooo_bound() if ts is not None else 0
        if bound > 0:
            with self._qlock:
                src, dst, ts = self._ooo_insert(t, src, dst, ts, bound)
            if len(src) == 0:
                return 0
            try:
                return self._feed_accepted(t, src, dst, ts, lat, t_admit)
            except TenantBackpressure:
                # atomic refusal: the released prefix goes back to the
                # front of the hold (its stamps precede every held one),
                # so the retry releases it again
                with self._qlock:
                    self._ooo_unrelease(t, src, dst, ts)
                raise
        return self._feed_accepted(t, src, dst, ts, lat, t_admit)

    def _feed_accepted(self, t: _Tenant, src, dst, ts, lat,
                       t_admit) -> int:
        """The admission path past the reorder buffer: event-time guard,
        sanitizer, capacity gate, journal, enqueue."""
        ts_col = self._check_event_time(t, src, ts)
        t.last_report = None
        report = None
        if sanitize_mod.enabled():
            # commit=False: the rejects are journaled and the offsets
            # advanced only once the batch clears the capacity gate, so
            # a backpressure refusal's retry journals them once
            try:
                report = sanitize_mod.sanitize(
                    src, dst, t.vb, tenant=t.tid, origin="feed",
                    offset=t.fed_offset, dlq=sanitize_mod.resolve_dlq(),
                    commit=False)
            except sanitize_mod.BatchRejected as e:
                # a whole-batch refusal is terminal: journaled already
                t.fed_offset += e.size
                raise
            src = report.src.astype(np.int32)
            dst = report.dst.astype(np.int32)
        else:
            src = np.asarray(src, np.int32)
            dst = np.asarray(dst, np.int32)
            if len(src) != len(dst):
                raise ValueError("src/dst length mismatch")
            if len(src) and (int(src.max()) >= t.vb
                             or int(dst.max()) >= t.vb
                             or int(src.min()) < 0 or int(dst.min()) < 0):
                raise ValueError(
                    "tenant %r ids must be dense in [0, %d) — out-of-range "
                    "ids would scatter into another slot's carried state"
                    % (t.tid, t.vb))
        # the capacity gate and the enqueue are one section under the
        # queue lock: a concurrent pump only ever shrinks the queue
        with self._qlock:
            capacity = self._capacity()
            room = capacity - t.queued
            take = len(src)
            if take > room:
                durable = not t.bp_stamped     # once per overflow episode
                t.bp_stamped = True
                if self._policy() == "reject":
                    raise TenantBackpressure(
                        "tenant %r queue is full (%d queued of %d edge "
                        "capacity; GS_TENANT_QUEUE_WINDOWS); pump() the "
                        "cohort or retry later" % (t.tid, t.queued,
                                                   capacity),
                        t.tid, queued=t.queued, capacity=capacity,
                        _durable=durable)
                take = max(0, room)
                shed = len(src) - take
                t.dropped_edges += shed
                telemetry.event("tenant_rejected", durable=durable,
                                tenant=t.tid, kind="drop", shed=shed)
                metrics.counter_inc("gs_tenant_dropped_edges_total", shed,
                                    tenant=t.tid)
            # the batch is consumed (wholly, or in part under `drop`):
            # journal the sanitizer's rejects, advance the offsets
            if report is not None:
                sanitize_mod.commit_report(report, tenant=t.tid,
                                           origin="feed",
                                           dlq=sanitize_mod.resolve_dlq())
                t.fed_offset += report.accepted + report.rejected
                t.last_report = report
            else:
                t.fed_offset += len(src)
            if ts_col is not None and len(ts_col):
                t.last_ts = int(ts_col[-1])
            if take:
                if self._wal is not None:
                    # journal before the queue: a kill anywhere past here
                    # (the wal_enqueue site among them) is recovered by
                    # replay; a refused feed journals nothing
                    self._wal.append(
                        t.tid, src[:take], dst[:take],
                        np.full(take, latency.admit_ns(t_admit), np.int64)
                        if lat else None)
                    faults.fire("wal_enqueue", t.tid)
                t.src = np.concatenate([t.src, src[:take]])
                t.dst = np.concatenate([t.dst, dst[:take]])
                if lat:
                    latency.on_admit(t.tid, take, t0=t_admit)
        metrics.gauge_set("gs_tenant_queue_edges", t.queued, tenant=t.tid)
        return take

    # ------------------------------------------------------------------
    # the GS_OOO_BOUND reorder buffer
    # ------------------------------------------------------------------
    def _ooo_insert(self, t: _Tenant, src, dst, ts, bound: int):
        """Merge one batch into the tenant's ts-sorted hold and take off
        the releasable prefix: every edge at or before the watermark
        (newest stamp seen − bound). Caller holds _qlock. Raises
        ValueError, the hold untouched, on a misaligned column or an
        edge older than the released frontier."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        col = np.asarray(ts, np.int64)
        if len(src) != len(dst) or col.shape != (len(src),):
            raise ValueError("tenant %r src/dst/ts length mismatch "
                             "(%d/%d/%d)" % (t.tid, len(src), len(dst),
                                             col.size))
        if col.size and t.last_ts is not None \
                and int(col.min()) < t.last_ts:
            raise ValueError(
                "tenant %r event-time regression past the GS_OOO_BOUND=%d "
                "horizon: batch reaches back to %d but the watermark "
                "already released through %d"
                % (t.tid, bound, int(col.min()), t.last_ts))
        m_src = np.concatenate([t.ooo_src, src.astype(np.int64)])
        m_dst = np.concatenate([t.ooo_dst, dst.astype(np.int64)])
        m_ts = np.concatenate([t.ooo_ts, col])
        order = np.argsort(m_ts, kind="stable")
        m_src, m_dst, m_ts = m_src[order], m_dst[order], m_ts[order]
        k = (int(np.searchsorted(m_ts, int(m_ts[-1]) - bound, side="right"))
             if m_ts.size else 0)
        t.ooo_src, t.ooo_dst, t.ooo_ts = m_src[k:], m_dst[k:], m_ts[k:]
        self._note_watermark(t)
        return m_src[:k], m_dst[:k], m_ts[:k]

    def _ooo_unrelease(self, t: _Tenant, src, dst, ts) -> None:
        """Return a refused released prefix to the front of the hold.
        Caller holds _qlock."""
        t.ooo_src = np.concatenate([np.asarray(src, np.int64), t.ooo_src])
        t.ooo_dst = np.concatenate([np.asarray(dst, np.int64), t.ooo_dst])
        t.ooo_ts = np.concatenate([np.asarray(ts, np.int64), t.ooo_ts])
        self._note_watermark(t)

    def _note_watermark(self, t: _Tenant) -> None:
        """Report the tenant's watermark lag to the latency plane:
        seconds between the newest stamp seen and the oldest edge still
        held. Caller holds _qlock."""
        if t.ooo_ts.size:
            high = max(int(t.ooo_ts[-1]),
                       t.last_ts if t.last_ts is not None else 0)
            lag = max(0.0, (high - int(t.ooo_ts[0])) / 1e9)
        else:
            lag = 0.0
        latency.note_watermark(t.tid, lag, held=int(t.ooo_ts.size))

    def _ooo_flush(self, t: _Tenant) -> List[dict]:
        """Release the tenant's whole hold, watermark or not (close()'s
        boundary: a final window must not strand edges). Feeds in
        capacity-sized slices, pumping this tenant between them when the
        queue is full; returns the summaries those pumps finalized."""
        out: List[dict] = []
        lat = latency.enabled()
        while t.ooo_ts.size:
            with self._qlock:
                room = max(0, self._capacity() - t.queued)
                k = min(room, int(t.ooo_ts.size))
                src, dst, col = t.ooo_src[:k], t.ooo_dst[:k], t.ooo_ts[:k]
                t.ooo_src = t.ooo_src[k:]
                t.ooo_dst = t.ooo_dst[k:]
                t.ooo_ts = t.ooo_ts[k:]
                self._note_watermark(t)
            if k:
                try:
                    self._feed_accepted(t, src, dst, col, lat,
                                        latency.clock() if lat else 0.0)
                except TenantBackpressure:
                    # a concurrent feeder filled the queue first
                    with self._qlock:
                        self._ooo_unrelease(t, src, dst, col)
            if t.ooo_ts.size:
                before = t.queued
                out.extend(self.pump(only=t.tid).get(t.tid, []))
                if k == 0 and t.queued >= before:
                    # nothing drains (a permanently quarantined tenant):
                    # the hold stays rather than spinning
                    break
        return out

    # ------------------------------------------------------------------
    # carries, summaries, slabs
    # ------------------------------------------------------------------
    def _fresh_carry(self, vb: int) -> tuple:
        """The zero-stream carry at vb on the device (a template: the
        dispatch copies it into the slab's stack, never updates it)."""
        got = self._fresh.get(vb)
        if got is None:
            got = self._fresh[vb] = fresh_carry(vb, self.device)
        return got

    def _carry_of(self, t: _Tenant) -> tuple:
        """The tenant's live carry wherever it is: its row of the
        group's resident stack (views, read at once and never kept),
        else its own carry, else the fresh state. Changes nothing."""
        if t.res_row is not None:
            entry = self._res[(t.vb, t.kb)]
            return tuple(a[t.res_row] for a in entry["carry"])
        return t.carry if t.carry is not None else self._fresh_carry(t.vb)

    def _evict_resident(self, key) -> None:
        """Give every tenant of the (vb, kb) resident stack a copy of its
        row and drop the stack. It must run before anything overwrites or
        replaces the stack: a tenant whose row still pointed into it
        would read another tenant's (or a pad row's) carry. The copies
        are clones: the stack's buffers are folded again by later
        dispatches."""
        entry = self._res.pop(key, None)
        if entry is None:
            return
        for tid in entry["rows"]:
            other = self.tenants.get(tid) if tid else None
            if other is not None and other.res_row is not None:
                other.carry = tuple(a[other.res_row].clone()
                                    for a in entry["carry"])
                other.res_row = None

    def _break_residency(self, t: _Tenant) -> None:
        """Membership is about to change (a probation absorb, a
        quarantine, a demotion, a restored checkpoint): evict the
        resident stack `t` shares, so the next resident dispatch
        restacks from the tenants' own carries."""
        if t.res_row is None:
            return
        self._evict_resident((t.vb, t.kb))
        t.res_row = None

    def _res_buffers(self, vb: int, kb: int, nb: int) -> tuple:
        """(stack, work): the resident tier's two stacked carries of nb
        rows at vb, allocated once a (vb, kb, nb) so the graphs that bind
        them keep their addresses."""
        key = (vb, kb, nb)
        got = self._res_bufs.get(key)
        if got is None:
            got = self._res_bufs[key] = tuple(
                tuple(torch.empty((nb,) + a.shape, dtype=a.dtype,
                                  device=self.device)
                      for a in self._fresh_carry(vb)) for _ in range(2))
        return got

    def _stack_rows(self, vb: int, nb: int, real, out=None) -> tuple:
        """The batch's carries stacked by slab row, pad rows fresh: new
        tensors, or written into `out`."""
        by_row = {row: t for t, row, _w, _n in real}
        fresh = self._fresh_carry(vb)
        return tuple(
            torch.stack([self._carry_of(by_row[r])[leaf] if r in by_row
                         else fresh[leaf] for r in range(nb)],
                        out=None if out is None else out[leaf])
            for leaf in range(3))

    def _adopt(self, t: _Tenant, carry) -> None:
        """Make host carry leaves `t`'s carry on the device."""
        t.carry = tuple(torch.as_tensor(np.array(a, np.int32))
                        .to(self.device) for a in carry)

    def _summary(self, vb: int, kb: int) -> CohortSummary:
        """The group's cohort summary: one per (vertex bucket, K),
        whatever the slab's nb and wb, keeping its counter's scratch
        across dispatches."""
        by_kb = self._summaries.setdefault(vb, {})
        summ = by_kb.get(kb)
        if summ is None:
            summ = by_kb[kb] = CohortSummary(vb, kb, self.device)
        return summ

    def _redo_kernel(self, vb: int, kb: int) -> TriangleWindowKernel:
        """The exact recount of one K-overflowing window at 4·K, the
        fallback every summary engine keeps."""
        by_kb = self._tri_redo.setdefault(vb, {})
        k = by_kb.get(kb)
        if k is None:
            k = by_kb[kb] = TriangleWindowKernel(
                self.eb, vb, k_bucket=4 * kb, device=self.device)
        return k

    # ------------------------------------------------------------------
    # the tenants-per-dispatch arm (ops/autotune.py)
    # ------------------------------------------------------------------
    def _pinned_tpd(self) -> int:
        """The constructor's `tenants_per_dispatch`, else GS_TENANT_TPD."""
        return self.tenants_per_dispatch or pinned_tpd()

    def _cohort_nb(self, vb: int) -> int:
        """The power-of-two bucket of the live cohort-tier tenants at
        this vertex bucket, capped at the admission cap's: the slab's row
        dimension and the arm family's N."""
        with self._qlock:
            live = list(self.tenants.values())
        n = sum(1 for t in live
                if t.tier == "cohort" and not t.closed and t.vb == vb)
        return min(seg_ops.bucket_size(max(1, n)),
                   seg_ops.bucket_size(self._cap()))

    def _tuner_space(self, nb: int) -> dict:
        """The `tenant_cohort` arms at cohort bucket nb: tenants-per-
        dispatch rungs under it and, on the resident tier,
        windows-per-super-batch rungs under the GS_RESIDENT_SPB bucket."""
        space = {"tpd": autotune.rungs(nb)}
        if resident_engine.resolve_resident_cohort(self.device):
            space["spb"] = autotune.rungs(
                resident_engine.resident_spb(self.eb))
        return space

    def _tuner(self, vb: int):
        """The group's `tenant_cohort` DispatchTuner, keyed
        `tenant_cohort:eb=…:vb=…:N=…` by the cohort bucket nb: a bucket
        change re-keys it (DispatchTuner.rekey: its EMAs reset, the
        incumbent kept where the new space has it), so a grown cohort
        never exploits rates measured on another slab shape. None with
        GS_AUTOTUNE=0 or a pin."""
        if self._pinned_tpd() > 0 or not autotune.enabled():
            return None
        nb = self._cohort_nb(vb)
        tuner = self._tuners.get(vb)
        if tuner is not None and self._tuner_nb.get(vb) == nb:
            return tuner
        space = self._tuner_space(nb)
        init = {k: v[-1] for k, v in space.items()}
        name = "tenant_cohort:eb=%d:vb=%d:N=%d" % (self.eb, vb, nb)
        if tuner is None:
            tuner = self._tuners[vb] = autotune.DispatchTuner(
                name, space, init, backend=self.device.type)
        else:
            tuner.rekey(name, space=space, initial=init)
        self._tuner_nb[vb] = nb
        return tuner

    def _resolve_tpd(self, vb: int, n_ready: int):
        """(tenants per dispatch, the tuner's arm or None) this round: the
        pin, else the tuner's arm (its best under forced_sync), else
        every ready tenant in one slab."""
        pin = self._pinned_tpd()
        if pin > 0:
            return pin, None
        tuner = self._tuner(vb)
        if tuner is None:
            return n_ready, None
        arm = (tuner.best() if ingress_pipeline.forced_sync_active()
               else tuner.next_round())
        return arm["tpd"], arm

    def _window_ceiling(self) -> int:
        """Windows of one tenant a dispatch folds: `wc` on the scan form;
        on the resident tier the GS_RESIDENT_SPB bucket, narrowed by the
        round's windows-per-super-batch arm. Window cuts are counted in
        edges, so the ceiling never changes a summary."""
        if not resident_engine.resolve_resident_cohort(self.device):
            return self.wc
        spb = resident_engine.resident_spb(self.eb)
        if self._round_spb:
            spb = min(spb, seg_ops.bucket_size(self._round_spb))
        return max(self.wc, spb)

    def _take_windows(self, t: _Tenant) -> int:
        """Full windows this tenant contributes to the next slab (plus
        the final partial one once closing), at most the window
        ceiling."""
        if t.tier != "cohort" or t.closed:
            return 0
        wc = self._window_ceiling()
        full = t.queued // self.eb
        if t.closing and t.queued % self.eb and full < wc:
            return min(full + 1, wc)
        return min(full, wc)

    def _prep_slab(self, batch: List[_Tenant], wins: List[int]):
        """Right-pad each tenant's next `wins` windows into the cohort
        slab [nb, wb, eb] (power-of-two buckets of the batch). Reads the
        queues only: they are consumed at finalize. A tenant whose prep
        fails (the `tenant_prep` fault site, a host error) lands in
        `failed` for demotion; a device error or a fatal fault raises."""
        st = latency.stamps()
        latency.stamp(st, "start")
        nb = seg_ops.bucket_size(len(batch))
        wb = seg_ops.bucket_size(max(wins))
        vb = batch[0].vb
        s = np.full((nb, wb, self.eb), vb, np.int32)
        d = np.full((nb, wb, self.eb), vb, np.int32)
        valid = np.zeros((nb, wb, self.eb), bool)
        real = []     # (tenant, row, windows, edges) packed
        failed = []   # (tenant, error text): demoted at dispatch
        for row, (t, w) in enumerate(zip(batch, wins)):
            try:
                faults.fire("tenant_prep", t.tid)
                # a consistent snapshot: concurrent feeds only append
                with self._qlock:
                    n = min(w * self.eb, t.queued)
                    t_src, t_dst = t.src, t.dst
                s[row].reshape(-1)[:n] = t_src[:n]
                d[row].reshape(-1)[:n] = t_dst[:n]
                valid[row].reshape(-1)[:n] = True
                real.append((t, row, w, n))
            except Exception as e:
                if (isinstance(e, faults.InjectedFault) and e.fatal) \
                        or resilience.is_device_error(e):
                    raise
                failed.append((t, "%s: %s" % (type(e).__name__, e)))
        latency.stamp(st, "prep")
        return nb, wb, s, d, valid, real, failed, st

    def _h2d(self, nb: int, wb: int, s, d, valid):
        """Stage the slab on the device ([nb·wb, eb] arrays into the
        stager's slot), on this thread, or under the h2d stage guard
        (deadline and retry, as the ingress pipeline's) where
        GS_STAGE_TIMEOUT_S or GS_STAGE_RETRIES arm it. Each attempt
        writes this copy's own slot (`ChunkStager.put` is idempotent per
        ordinal). A failure raises to the caller, typed by the guard:
        the bulkhead never bisects on it."""
        arrays = [a.reshape(nb * wb, self.eb) for a in (s, d, valid)]
        seq = self._h2d_seq
        self._h2d_seq += 1

        def put():
            faults.fire("h2d", ("cohort", seq))
            return self._stage.put(arrays, seq)

        try:
            if resilience.guard_active():
                return resilience.call_guarded("h2d", ("cohort", seq), put)
            return put()
        except BaseException:
            self._stage.release_all()
            raise

    def _ckpt_due(self, t: _Tenant, windows_done: int) -> bool:
        return (self._ckpt_dir is not None and t.ckpt_policy is not None
                and t.ckpt_policy.due(windows_done))

    def _dispatch_batch(self, vb: int, kb: int, slab, out: dict,
                        staged: list) -> int:
        """One cohort dispatch and its finalize: one staged copy of the
        slab, one fold of the group's cohort summary (`_fold_slab`), one
        copy back of its [5, nb, wb] outputs (with the carry rows of the
        tenants due for a checkpoint).

        On the scan form the batch's carries are stacked (pad rows
        fresh) into a copy the kernel folds, and each tenant then keeps a
        copy of its row. On the resident tier the group's committed stack
        serves as it is when the batch's rows are its rows; else it is
        evicted (its tenants keep copies of their rows) and the batch is
        restacked into it. The kernel folds a copy of it, the work stack,
        which becomes the committed stack; each tenant keeps only its
        row. Either way nothing changes before the poison gate passes: a
        refused dispatch leaves every carry, the committed stack, every
        queue and cursor as they were. Returns the edges covered."""
        nb, wb, s, d, valid, real, failed, st = slab
        for t, err in failed:
            self._demote(t, "slab prep failed: %s" % err)
        if not real:
            return 0
        res_on = resident_engine.resolve_resident_cohort(self.device)
        key = (vb, kb)
        rows = [None] * nb          # the tenant of each slab row
        for t, row, _w, _n in real:
            rows[row] = t.tid
        rows = tuple(rows)
        entry = self._res.get(key) if res_on else None
        if entry is None or entry["rows"] != rows \
                or any(t.res_row != row for t, row, _w, _n in real):
            # the rows changed (or the tier is off: a flipped pin leaves
            # rows in a stack): every tenant of the old stack takes a
            # copy of its row before the stack is overwritten
            self._evict_resident(key)
            entry = None
        if res_on:
            committed, stacked = self._res_buffers(vb, kb, nb)
            if entry is None:
                self._stack_rows(vb, nb, real, out=committed)
                self.resident_restacks += 1
        else:
            committed, stacked = None, self._stack_rows(vb, nb, real)
        edges = sum(n for _t, _r, _w, n in real)
        due = [row for t, row, w, _n in real
               if self._ckpt_due(t, t.windows_done + w)]
        with telemetry.span("cohort.dispatch", tenants=len(real),
                            windows=sum(w for _t, _r, w, _n in real),
                            edges=edges) as sp:
            # the bulkhead's fault site: on this thread, before the copy
            # and the launch, so a refusal leaves the device untouched
            faults.fire("cohort_dispatch",
                        tuple(t.tid for t, _r, _w, _n in real))
            stg = self._h2d(nb, wb, s, d, valid)
            try:
                slab_dev = tuple(x.view(nb, wb, self.eb)
                                 for x in self._stage.take(stg))
                latency.stamp(st, "h2d")
                res = self._fold_slab(vb, kb, committed, stacked, slab_dev,
                                      self._stage.slot_index(stg))
            finally:
                self._stage.done(stg)
            # one copy back: the outputs, then each due row's leaves
            host = (torch.cat([res.reshape(-1)] + [
                leaf[r] for r in due for leaf in stacked]) if due
                else res.reshape(-1)).cpu().numpy()
        latency.stamp(st, "dispatch")
        mdeg, ncomp, odd, tri, ovf = host[:res.numel()].reshape(5, nb, wb)
        tags = telemetry.pop_dispatch_tags()
        # the output gate, before any tenant state changes: implausible
        # analytics in a tenant's windows name its slab row, whose tenant
        # the bulkhead quarantines before it dispatches the rest again
        bad = ((mdeg < 0) | (ncomp < 0) | (ncomp > vb + 1)
               | ((tri < 0) & (ovf == 0)))
        poisoned = [t.tid for t, row, w, _n in real if bad[row, :w].any()]
        if poisoned:
            raise PoisonOutput(
                "cohort dispatch finalized implausible analytics for "
                "tenant(s) %s" % ", ".join(poisoned), poisoned)
        if res_on:
            # past the gate: the folded work stack becomes the committed
            # stack (a device copy into the buffers the graphs bind)
            for c, w in zip(committed, stacked):
                c.copy_(w)
            self._res[key] = {"nb": nb, "rows": rows, "carry": committed}
            self.resident_dispatches += 1
        saved = {}          # row -> the host leaves of its new carry
        at = res.numel()
        for r in due:
            cut = at + np.array([0, 1, 2, 4]) * (vb + 1)
            saved[r] = tuple(host[lo:hi] for lo, hi in zip(cut, cut[1:]))
            at = cut[-1]
        # the dispatch's wall seconds split over the real rows by edges
        metrics.attribute_dispatch(
            sp.elapsed, [(t.tid, n) for t, _r, _w, n in real],
            program="cohort_resident" if res_on else "cohort_summary",
            sig=tags.get("sig"))
        prov = provenance.armed()
        marks = metrics.enabled()
        for t, row, w, n in real:
            summaries = []
            for j in range(w):
                tri_w = int(tri[row, j])
                if ovf[row, j]:
                    lo, hi = j * self.eb, min((j + 1) * self.eb, n)
                    tri_w = self._redo_kernel(vb, kb).count(
                        t.src[lo:hi], t.dst[lo:hi])
                summaries.append({"max_degree": int(mdeg[row, j]),
                                  "num_components": int(ncomp[row, j]),
                                  "odd_cycle": bool(odd[row, j]),
                                  "triangles": tri_w})
            if res_on:
                # the carry stays in the committed stack: the tenant
                # keeps its row (checkpoints and demotions read it
                # through _carry_of)
                t.res_row, t.carry = row, None
            else:
                t.carry = tuple(a[row].clone() for a in stacked)
            with self._qlock:
                t.src = t.src[n:]
                t.dst = t.dst[n:]
                t.bp_stamped = False       # queue drained: a new episode
            if st is not None:
                for j in range(w):
                    latency.on_window(
                        t.tid, edges=min((j + 1) * self.eb, n) - j * self.eb,
                        st=st, ordinal=t.windows_done + j,
                        defer=self.defer_delivery)
            if prov:
                # the span recorded is the tenant's journal cursor
                # (windows_done × eb, the checkpoint contract)
                for j in range(w):
                    lo = (t.windows_done + j) * self.eb
                    provenance.emit(
                        tenant=t.tid, window=t.windows_done + j, wal_lo=lo,
                        wal_hi=lo + min((j + 1) * self.eb, n) - j * self.eb,
                        tier="cohort_resident" if res_on else "cohort",
                        program="cohort_scan",
                        sig=tags.get("sig"), summary=summaries[j])
            t.windows_done += w
            if n < w * self.eb:      # the final short window was just cut
                t.closed_partial = True
            if t.closing and t.queued == 0:
                t.closed = True
            out.setdefault(t.tid, []).extend(summaries)
            if marks:
                metrics.mark_window(w, n, engine="cohort", tier="cohort",
                                    tenant=t.tid)
                metrics.gauge_set("gs_tenant_queue_edges", t.queued,
                                  tenant=t.tid)
                if st is not None:
                    metrics.gauge_set("gs_tenant_queue_age_s",
                                      latency.queue_age(t.tid) or 0.0,
                                      tenant=t.tid)
            if row in saved:
                t.ckpt_policy.mark(t.windows_done)
                staged.append((t, self._state_of(t, saved[row])))
        return edges

    def _fold_slab(self, vb: int, kb: int, committed, stacked, slab_dev,
                   slot: int) -> torch.Tensor:
        """The group's cohort summary over the staged slab: its outputs
        as one [5, nb, wb] int32 tensor on the device, `stacked` folded
        in place. On the resident tier (`committed` given) the committed
        stack is first copied into `stacked`, the work stack; on a card
        the copy and the two launches are one replay of the CUDA graph of
        (vb, kb, nb, wb, staging slot), captured at its first use after
        one eager run (SuperBatchGraphs), so its output tensor is the
        graph's and the next replay rewrites it. The graph binds the two
        stacks, the slot's slab and the counter's scratch; any of them
        moved, it is captured again."""
        summ = self._summary(vb, kb)
        if committed is None:
            return _int_outputs(summ(stacked, *slab_dev))

        def fold(c0, c1, c2, w0, w1, w2, src, dst, valid, *_scratch):
            for w, c in ((w0, c0), (w1, c1), (w2, c2)):
                w.copy_(c)
            return _int_outputs(summ((w0, w1, w2), src, dst, valid))

        tensors = committed + stacked + slab_dev
        if self.device.type == "cuda":
            nb, wb, eb = slab_dev[0].shape
            summ.counter.reserve(nb * wb, eb)
            tensors += (summ.counter.scratch.buffer,)
        return self._graphs.run((vb, kb) + tuple(slab_dev[0].shape[:2])
                                + (slot,), tensors, fold,
                                warm=lambda: fold(*tensors))

    # ------------------------------------------------------------------
    # the bulkhead
    # ------------------------------------------------------------------
    def _dispatch_guarded(self, vb: int, kb: int, batch, wins, slab,
                          out: dict, staged: list) -> int:
        """The bulkhead around one dispatch batch. A non-fatal fault of
        the `cohort_dispatch` site bisects the batch to the tenants it
        follows, which are quarantined; a PoisonOutput quarantines the
        rows it names. The others dispatch the same round again from
        their untouched queues and carries. A failure that follows every
        tenant of the batch alone is not poison: its quarantines are
        revoked and the fault raises. Anything else (a device error, an
        h2d failure, a fatal fault) raises at once, nothing bisected."""
        errors = []     # (tenant id, error) per singleton quarantine
        edges = self._dispatch_bulkhead(vb, kb, batch, wins, slab, out,
                                        staged, errors)
        failed = {tid for tid, _e in errors}
        # the tenants a failed prep demoted were never dispatched
        tried = [t for t in batch if t.tier != "single"]
        if errors and failed == {t.tid for t in tried}:
            for t in tried:
                self._unquarantine(t, "systemic dispatch failure — every "
                                      "tenant failed alone")
            raise errors[-1][1]
        return edges

    def _dispatch_bulkhead(self, vb: int, kb: int, batch, wins, slab,
                           out: dict, staged: list, errors: list) -> int:
        try:
            return self._dispatch_batch(vb, kb, slab, out, staged)
        except (PoisonOutput, faults.InjectedFault) as e:
            if isinstance(e, faults.InjectedFault) and (
                    e.fatal or e.site != "cohort_dispatch"
                    or resilience.is_device_error(e)):
                raise
            # a tenant whose prep failed was demoted by the dispatch:
            # its own engine holds its state, so no retry may fold it
            live = [(t, w) for t, w in zip(batch, wins)
                    if t.tier == "cohort"]
            batch = [t for t, _w in live]
            wins = [w for _t, w in live]
            err = e
        if isinstance(err, PoisonOutput):
            # row-attributed evidence: no bisect, never revoked
            bad = set(err.tenants)
            for t in batch:
                if t.tid in bad:
                    self._quarantine(t, "implausible dispatch output")
            keep = [(t, w) for t, w in zip(batch, wins) if t.tid not in bad]
            if not keep:
                return 0
            b = [t for t, _w in keep]
            w = [x for _t, x in keep]
            return self._dispatch_bulkhead(vb, kb, b, w,
                                           self._prep_slab(b, w), out,
                                           staged, errors)
        if not batch:
            return 0
        halves = self._bisect_split(batch, wins, err, errors)
        if halves is None:
            return 0
        return sum(self._dispatch_bulkhead(vb, kb, b, w,
                                           self._prep_slab(b, w), out,
                                           staged, errors)
                   for b, w in halves if b)

    def _bisect_split(self, batch, wins, err, errors: list):
        """Halve a failing batch; a failing batch of one is the
        implicated tenant: quarantine it, record the evidence for the
        systemic-failure check, and stop (None)."""
        if len(batch) == 1:
            self._quarantine(batch[0], "poison dispatch: %s: %s"
                             % (type(err).__name__, err))
            errors.append((batch[0].tid, err))
            return None
        mid = len(batch) // 2
        telemetry.event("cohort_bisect", tenants=len(batch),
                        error=type(err).__name__)
        metrics.counter_inc("gs_cohort_bisects_total")
        return ((batch[:mid], wins[:mid]), (batch[mid:], wins[mid:]))

    def _quarantine(self, t: _Tenant, reason: str) -> None:
        """Suspend one poison stream: no cohort dispatches, its queued
        edges kept for probation (or refused feeds with a permanent
        quarantine); a durable `quarantine` event and a demotion
        record."""
        if t.tier == "quarantined":
            return
        self._break_residency(t)    # its carry leaves the device stack
        from_tier = t.tier
        t.tier = "quarantined"
        t.engine = None
        t.probation = 0
        t.quarantine_reason = str(reason)[:200]
        telemetry.event("quarantine", durable=True, tenant=t.tid,
                        reason=t.quarantine_reason,
                        windows_done=t.windows_done)
        metrics.counter_inc("gs_tenant_quarantines_total")
        metrics.gauge_set("gs_tenant_quarantined", 1, tenant=t.tid)
        resilience.record_demotion(
            "tenant:%s" % t.tid, from_tier, "quarantined", t.windows_done,
            t.quarantine_reason, tenant=t.tid)

    def _unquarantine(self, t: _Tenant, reason: str) -> None:
        """Revoke a quarantine imposed without discriminating evidence
        (the systemic-failure path)."""
        if t.tier != "quarantined":
            return
        t.tier = "cohort"
        t.engine = None
        t.probation = 0
        t.quarantine_reason = None
        telemetry.event("quarantine_revoked", durable=True, tenant=t.tid,
                        reason=reason)
        metrics.gauge_set("gs_tenant_quarantined", 0, tenant=t.tid)

    def quarantine(self, tenant_id, reason: str = "operator") -> None:
        """Suspend one tenant by hand (the state a poisoned dispatch
        leaves it in)."""
        self._quarantine(self._tenant(tenant_id), reason)

    def quarantined(self) -> List[str]:
        """The quarantined tenants' ids, sorted."""
        return [tid for tid in self._tids()
                if self.tenants[tid].tier == "quarantined"]

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def pump(self, max_rounds: Optional[int] = None,
             only: Optional[str] = None) -> Dict[str, list]:
        """Dispatch window rounds while any tenant has a full window
        queued (plus the final partial window of closing tenants). Each
        round first runs the demoted tenants' engines and the
        quarantined tenants' probation windows, then groups the ready
        tenants by (vertex bucket, K) and dispatches each group in
        batches of the round's tenants per dispatch (`_resolve_tpd`)
        through `_run_batches`; a tuned round's edges/s go back to the
        tuner, whose best is saved as the pump returns (not under
        forced_sync). Returns
        {tenant: [summary dict, ...]} for every window finalized by this
        call; due checkpoints are written when it returns (the delivery
        boundary). `only` restricts the pump to one tenant (close()'s
        drain)."""
        out: Dict[str, list] = {}
        staged: list = []
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            self._pump_singles(out, staged, only=only)
            probed = self._pump_probation(out, staged, only=only)
            by_group: Dict[tuple, list] = {}
            for tid in self._tids():
                if only is not None and tid != only:
                    continue
                t = self.tenants[tid]
                if self._take_windows(t) > 0:
                    by_group.setdefault((t.vb, t.kb), []).append(t)
            if not by_group:
                if probed:
                    # probation finalized windows (and maybe re-admitted
                    # a tenant): pump again; failing probes return 0, so
                    # this never spins
                    rounds += 1
                    continue
                break
            rounds += 1
            self._round_no += 1
            for (vb, kb), ready in sorted(by_group.items()):
                tpd, arm = self._resolve_tpd(vb, len(ready))
                # the resident tier's windows-per-super-batch arm narrows
                # this round's window ceiling
                self._round_spb = int((arm or {}).get("spb") or 0)
                descs = [(b, [self._take_windows(t) for t in b])
                         for b in (ready[i:i + tpd]
                                   for i in range(0, len(ready), tpd))]
                with telemetry.span(
                        "cohort.round", vb=vb, tenants=len(ready),
                        edges=sum(min(w * self.eb, t.queued)
                                  for b, ws in descs
                                  for t, w in zip(b, ws))) as sp:
                    edges = self._run_batches(vb, kb, descs, out, staged)
                if arm is not None and edges:
                    tuner = self._tuner(vb)
                    if tuner is not None:
                        tuner.record(arm, edges, sp.elapsed)
        if not ingress_pipeline.forced_sync_active():
            for tuner in self._tuners.values():
                tuner.save()
        for t, snap in staged:
            checkpoint.save(self._ckpt_path(t.tid), snap)
        return out

    def _run_batches(self, vb: int, kb: int, descs, out: dict,
                     staged: list) -> int:
        """Dispatch one round's batches, the ingest ring prepping batch
        k+1's slab on the ingress pool while batch k dispatches (the
        batches of a round hold different tenants, so a look-ahead prep
        reads no queue an earlier batch consumes). A round of one batch
        preps inline, as does a batch the ring declines (full, or
        forced_sync). A failure drains the ring (waiting for the preps
        still running) before it raises: the batches not dispatched keep
        their queues for the next pump. Returns the edges covered."""
        if len(descs) == 1:
            batch, wins = descs[0]
            return self._dispatch_guarded(vb, kb, batch, wins,
                                          self._prep_slab(batch, wins),
                                          out, staged)

        def prep(desc):
            return self._prep_slab(*desc)

        edges = 0
        ringed = set()      # the batches handed to the ring
        try:
            for i, (batch, wins) in enumerate(descs):
                # this batch unless the ring has it, and the look-ahead
                for j in (i, i + 1):
                    if j < len(descs) and j not in ringed \
                            and self._ring.submit(prep, j, descs[j]):
                        ringed.add(j)
                if i in ringed:
                    fut, _desc = self._ring.pop(i)
                    slab = fut.result()
                else:
                    slab = self._prep_slab(batch, wins)
                edges += self._dispatch_guarded(vb, kb, batch, wins, slab,
                                                out, staged)
        except BaseException:
            self._ring.drain()
            raise
        return edges

    def _pump_singles(self, out: dict, staged: list,
                      only: Optional[str] = None) -> None:
        """Demoted tenants: their queued full windows (and the final
        partial one once closing) run through their own engine."""
        for tid in self._tids():
            if only is not None and tid != only:
                continue
            t = self.tenants[tid]
            if t.tier != "single" or t.closed:
                continue
            t.engine._lat_defer = self.defer_delivery
            with self._qlock:
                n = t.queued if t.closing else \
                    (t.queued // self.eb) * self.eb
                src, dst = t.src[:n], t.dst[:n]
            if n == 0:
                if t.closing:
                    t.closed = True
                continue
            with telemetry.span("tenant.single", tenant=t.tid,
                                edges=int(n)) as sp:
                summaries = t.engine.process(src, dst)
            # a demoted tenant owns its whole dispatch
            metrics.attribute_dispatch(
                sp.elapsed, [(t.tid, int(n))],
                program=telemetry.pop_dispatch_tags().get("program"))
            with self._qlock:
                t.src = t.src[n:]
                t.dst = t.dst[n:]
                t.bp_stamped = False
            t.windows_done = t.engine.windows_done
            t.closed_partial = t.engine._closed_partial
            if t.closing and t.queued == 0:
                t.closed = True
            out.setdefault(t.tid, []).extend(summaries)
            metrics.mark_tenant(t.tid, len(summaries), int(n),
                                tier="single")
            self._stage_ckpt(t, staged)

    def _tenant_engine(self, t: _Tenant) -> StreamSummaryEngine:
        """A single-tenant engine on the cohort's device seeded from the
        tenant's live state, recording on the tenant's latency lane
        without stamping admission again (feed() did)."""
        eng = StreamSummaryEngine(self.eb, t.vb, k_bucket=t.kb,
                                  device=self.device)
        eng.load_state_dict(self.tenant_state_dict(t.tid))
        eng._lat_lane = t.tid
        eng._lat_admit = False
        return eng

    def _pump_probation(self, out: dict, staged: list,
                        only: Optional[str] = None) -> int:
        """The quarantined tenants' probation: with GS_QUARANTINE_WINDOWS
        > 0, each pump gives every quarantined tenant with a full window
        queued one solo window on its own engine, seeded from its
        last-good carry. A clean window advances probation and is
        delivered; a failing or implausible one resets probation and
        drops the engine (the next probe starts again from the untouched
        carry). Only a PoisonOutput and a failure of the probe's host
        prep stage are the tenant's (`_resets_probation`); anything else
        (a device error, a fatal fault, a failed staging copy) raises
        with probation and the queue as they were. After GS_QUARANTINE_WINDOWS clean windows in a row the
        tenant re-enters the cohort. Returns the windows finalized."""
        qw = quarantine_windows()
        if qw <= 0:
            return 0
        done = 0
        for tid in self._tids():
            if only is not None and tid != only:
                continue
            t = self.tenants[tid]
            if t.tier != "quarantined" or t.closed:
                continue
            with self._qlock:
                n = (self.eb if t.queued >= self.eb
                     else (t.queued if t.closing else 0))
            if n == 0:
                if t.closing:
                    t.closed = True
                continue
            if t.engine is None:
                t.engine = self._tenant_engine(t)
            t.engine._lat_defer = self.defer_delivery
            with self._qlock:
                src, dst = t.src[:n], t.dst[:n]
            try:
                with telemetry.span("tenant.probation", tenant=t.tid,
                                    edges=int(n)) as sp:
                    summaries = t.engine.process(src, dst)
                metrics.attribute_dispatch(
                    sp.elapsed, [(t.tid, int(n))],
                    program=telemetry.pop_dispatch_tags().get("program"))
                if any(s["max_degree"] < 0 or s["num_components"] < 0
                       or s["num_components"] > t.vb + 1
                       or s["triangles"] < 0 for s in summaries):
                    raise PoisonOutput("probation window finalized "
                                       "implausible analytics", [t.tid])
            except Exception as e:
                if not _resets_probation(e):
                    # not the tenant's: probation and the queue stay, and
                    # the next probe re-seeds from the last-good carry
                    t.engine = None
                    raise
                self._probation_failed(t, e)
                continue
            # the probe engine's state is the new last-good carry
            self._break_residency(t)
            self._adopt(t, t.engine.state_dict()["carry"])
            with self._qlock:
                t.src = t.src[n:]
                t.dst = t.dst[n:]
                t.bp_stamped = False
            t.windows_done = t.engine.windows_done
            t.closed_partial = t.engine._closed_partial
            if t.closing and t.queued == 0:
                t.closed = True
            t.probation += len(summaries)
            done += len(summaries)
            out.setdefault(t.tid, []).extend(summaries)
            metrics.mark_tenant(t.tid, len(summaries), int(n),
                                tier="quarantined")
            telemetry.event("quarantine_probe", tenant=t.tid,
                            clean=t.probation, required=qw)
            self._stage_ckpt(t, staged)
            if t.probation >= qw:
                t.tier = "cohort"
                t.engine = None
                t.quarantine_reason = None
                t.probation = 0
                telemetry.event("quarantine_released", durable=True,
                                tenant=t.tid, windows_done=t.windows_done)
                metrics.counter_inc("gs_tenant_quarantine_releases_total")
                metrics.gauge_set("gs_tenant_quarantined", 0, tenant=t.tid)
        return done

    def _probation_failed(self, t: _Tenant, err) -> None:
        t.probation = 0
        t.engine = None     # the next probe re-seeds from the last-good carry
        telemetry.event("quarantine_probe_failed", durable=True,
                        tenant=t.tid, error="%s: %s" % (
                            type(err).__name__, str(err)[:200]))
        metrics.counter_inc("gs_tenant_probation_failures_total")

    def close(self, tenant_id) -> List[dict]:
        """Cut the tenant's final (possibly partial) window and retire
        it. Drains only this tenant: other tenants' queued windows stay
        for the next pump(). The reorder hold is released first."""
        t = self._tenant(tenant_id)
        if t.closed:
            return []
        early = self._ooo_flush(t) if t.ooo_ts.size else []
        t.closing = True
        if t.queued == 0 and t.tier == "cohort":
            t.closed = True
            return early
        return early + self.pump(only=t.tid).get(t.tid, [])

    # ------------------------------------------------------------------
    # demotion (cohort → single-tenant engine)
    # ------------------------------------------------------------------
    def _demote(self, t: _Tenant, reason: str) -> None:
        if t.tier == "single":
            return
        self._break_residency(t)    # its carry leaves the device stack
        t.engine = self._tenant_engine(t)
        t.tier = "single"
        resilience.record_demotion("tenant:%s" % t.tid, "cohort", "single",
                                   t.windows_done, reason, tenant=t.tid)

    def demote(self, tenant_id, reason: str = "operator") -> None:
        """Pull one tenant off the cohort onto its own
        StreamSummaryEngine on the cohort's device, seeded from its live
        carry (exact), with a demotion record; the cohort keeps
        dispatching everyone else."""
        self._demote(self._tenant(tenant_id), reason)

    # ------------------------------------------------------------------
    # checkpoints (per tenant; the engines' layout)
    # ------------------------------------------------------------------
    def _state_of(self, t: _Tenant, carry) -> dict:
        """`t`'s state in the engines' layout over the host carry
        leaves `carry`."""
        state = {
            "edge_bucket": self.eb,
            "vertex_bucket": t.vb,
            "windows_done": int(t.windows_done),
            "closed_partial": bool(t.closed_partial),
            # the journal offset at this window boundary: recover()
            # replays strictly past it
            "wal_offset": int(t.windows_done) * self.eb,
            "carry": tuple(np.array(a, np.int32) for a in carry),
        }
        if t.tier == "quarantined":
            # the bulkhead rides the checkpoint (an engine ignores the
            # key): a restored cohort keeps the poison stream suspended
            state["quarantine"] = {"probation": int(t.probation),
                                   "reason": t.quarantine_reason or ""}
        return state

    def tenant_state_dict(self, tenant_id) -> dict:
        """One tenant's resumable state in the summary engines' layout
        (ops/scan_analytics state_dict), with a `quarantine` entry for a
        quarantined tenant, so it loads into a StreamSummaryEngine of
        either package, or a TenantCohort of either package, at equal
        buckets, and back."""
        t = self._tenant(tenant_id)
        if t.tier == "single" or (t.tier == "quarantined"
                                  and t.engine is not None):
            state = t.engine.state_dict()
            if t.tier == "quarantined":
                state["quarantine"] = {"probation": int(t.probation),
                                       "reason": t.quarantine_reason or ""}
            return state
        return self._state_of(t, (_to_host(x) for x in self._carry_of(t)))

    def load_tenant_state_dict(self, tenant_id, state: dict) -> None:
        """Adopt a tenant state of either package's cohort or summary
        engine; its `quarantine` entry (or its absence) sets the
        bulkhead state. Raises ValueError on other buckets, an
        inconsistent cursor, or a carry that is not the engines'
        layout."""
        t = self._tenant(tenant_id)
        if state["edge_bucket"] != self.eb \
                or state["vertex_bucket"] != t.vb:
            raise ValueError(
                "bucket mismatch: checkpoint was taken at eb=%d vb=%d, "
                "tenant %r runs eb=%d vb=%d" % (
                    state["edge_bucket"], state["vertex_bucket"], t.tid,
                    self.eb, t.vb))
        windows_done = int(state["windows_done"])
        woff = state.get("wal_offset")
        if woff is not None and int(woff) > windows_done * self.eb:
            raise ValueError(
                "checkpoint wal_offset %d exceeds its own window coverage "
                "(%d windows x eb=%d)" % (int(woff), windows_done, self.eb))
        carry = tuple(np.asarray(a) for a in state["carry"])
        check_summary_carry(carry, t.vb)
        t.windows_done = windows_done
        t.closed_partial = bool(state["closed_partial"])
        # the checkpoint wins: a tenant restored while the resident stack
        # holds its carry leaves the stack
        self._break_residency(t)
        self._adopt(t, carry)
        q = state.get("quarantine")
        if q is not None:
            t.tier = "quarantined"
            t.engine = None     # probes re-seed from the restored carry
            t.probation = int(q.get("probation", 0))
            t.quarantine_reason = q.get("reason") or "restored"
            metrics.gauge_set("gs_tenant_quarantined", 1, tenant=t.tid)
        elif t.tier == "quarantined":
            # a generation taken before the quarantine rewinds it
            t.tier = "cohort"
            t.engine = None
            t.probation = 0
            t.quarantine_reason = None
            metrics.gauge_set("gs_tenant_quarantined", 0, tenant=t.tid)
        if t.tier == "single":
            t.engine.load_state_dict(state)

    def state_dict(self) -> dict:
        """The whole cohort: per-tenant states under their ids."""
        return {
            "edge_bucket": self.eb,
            "tenants": {tid: self.tenant_state_dict(tid)
                        for tid in self._tids()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Adopt a cohort state of either package, admitting unknown
        tenants at their checkpointed vertex buckets."""
        if state["edge_bucket"] != self.eb:
            raise ValueError(
                "bucket mismatch: cohort checkpoint was taken at eb=%d, "
                "this cohort runs eb=%d" % (state["edge_bucket"], self.eb))
        for tid, tstate in state["tenants"].items():
            if tid not in self.tenants:
                self.admit(tid, vertex_bucket=tstate["vertex_bucket"])
            self.load_tenant_state_dict(tid, tstate)

    def enable_auto_checkpoint(self, directory: str,
                               every_n_windows: int = 16,
                               every_seconds: float = 0.0) -> None:
        """Per-tenant snapshots (`tenant_<id>.npz` under `directory`,
        atomic with the previous generation kept: utils/checkpoint) on a
        per-tenant CheckpointPolicy cadence, staged at dispatch
        boundaries and written at pump()'s clean return. A killed cohort
        resumes each tenant on its own: resume_all() / try_resume()."""
        if every_n_windows <= 0 and every_seconds <= 0:
            raise ValueError("checkpoint policy has no trigger enabled")
        os.makedirs(directory, exist_ok=True)
        self._ckpt_dir = directory
        self._ckpt_every_n = max(0, every_n_windows)
        self._ckpt_every_s = max(0.0, every_seconds)
        for t in self.tenants.values():
            if t.ckpt_policy is None:
                t.ckpt_policy = checkpoint.CheckpointPolicy(
                    every_n_windows=self._ckpt_every_n,
                    every_seconds=self._ckpt_every_s)
                t.ckpt_policy.mark(t.windows_done)

    def _ckpt_path(self, tid: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_" else "_" for c in tid)
        return os.path.join(self._ckpt_dir, "tenant_%s.npz" % safe)

    def _stage_ckpt(self, t: _Tenant, staged: list) -> None:
        if self._ckpt_due(t, t.windows_done):
            t.ckpt_policy.mark(t.windows_done)
            staged.append((t, self.tenant_state_dict(t.tid)))

    def checkpoint_all(self) -> int:
        """Write a checkpoint of every tenant now, whatever the cadence
        (a graceful drain's boundary), then move the journal's retention
        floor for every tenant in one truncation. A no-op without
        enable_auto_checkpoint. Returns the tenants saved."""
        if self._ckpt_dir is None:
            return 0
        saved = 0
        for tid in self._tids():
            t = self.tenants[tid]
            checkpoint.save(self._ckpt_path(tid), self.tenant_state_dict(tid))
            if t.ckpt_policy is not None:
                t.ckpt_policy.mark(t.windows_done)
            saved += 1
        # one call for all tenants: a per-tenant call would see the
        # others' records as uncovered and never free a shared segment
        self._wal_retention.flushed_many(
            self._wal, {tid: self.tenants[tid].windows_done * self.eb
                        for tid in self.tenants})
        return saved

    def try_resume(self, tenant_id) -> bool:
        """Restore one tenant from its newest intact checkpoint
        generation; False when nothing usable exists. After True, feed
        the tenant from `resume_offset(tenant)` edges in."""
        import warnings

        t = self._tenant(tenant_id)
        if self._ckpt_dir is None:
            return False
        try:
            got = checkpoint.load_latest(self._ckpt_path(t.tid))
        except checkpoint.CheckpointCorrupt as e:
            warnings.warn(f"{e}; no intact generation — tenant {t.tid!r} "
                          f"starts fresh")
            return False
        if got is None:
            return False
        state, used = got
        self.load_tenant_state_dict(t.tid, state)
        if t.ckpt_policy is not None:
            t.ckpt_policy.mark(t.windows_done)
        telemetry.event("resume", durable=True, component="tenant",
                        tenant=t.tid, path=used, windows_done=t.windows_done)
        return True

    def resume_all(self) -> Dict[str, bool]:
        """try_resume every admitted tenant; {tenant: resumed}."""
        return {tid: self.try_resume(tid) for tid in self._tids()}

    def resume_offset(self, tenant_id) -> int:
        """Edges already folded into the tenant's carry: a resumed caller
        feeds the stream from here."""
        return self._tenant(tenant_id).windows_done * self.eb

    # ------------------------------------------------------------------
    # the write-ahead journal (utils/wal.py)
    # ------------------------------------------------------------------
    def enable_wal(self, directory: str) -> bool:
        """Journal every accepted feed() batch under `directory` before
        it enters the tenant's queue, so a kill loses nothing the caller
        was told was accepted: recover() replays the suffix past each
        tenant's checkpoint. Returns False (a no-op) under GS_WAL=0."""
        if not wal_mod.enabled():
            return False
        self._wal_dir = directory
        self._wal = wal_mod.WriteAheadLog(directory)
        return True

    def seal_wal(self) -> None:
        """Close the journal durably (the graceful-drain marker); the
        caller drains the queues and flushes checkpoints first."""
        if self._wal is not None:
            self._wal.seal()

    def recover(self) -> dict:
        """Crash recovery over an armed journal: admit the journaled
        tenants this cohort does not know (at its default buckets: admit
        others first), resume each from its newest checkpoint, then
        replay each tenant's journal suffix past its checkpointed
        `wal_offset` into its queue, bypassing the capacity gate (the
        edges were accepted once). The next pump() gives the windows of
        a run that was never killed."""
        if self._wal_dir is None:
            raise ValueError("enable_wal() first: recover() replays the "
                             "journal the crashed process wrote")
        info = wal_mod.scan(self._wal_dir)
        for tid in sorted(info["offsets"]):
            if tid not in self.tenants:
                self.admit(tid)
        resumed = self.resume_all()
        offsets = {tid: self.resume_offset(tid) for tid in self.tenants}
        replayed: Dict[str, int] = {}
        for tid, _start, src, dst, ts in wal_mod.replay(self._wal_dir,
                                                        offsets):
            t = self.tenants.get(tid)
            if t is None or t.closed:
                continue
            with self._qlock:
                t.src = np.concatenate([t.src, src.astype(np.int32)])
                t.dst = np.concatenate([t.dst, dst.astype(np.int32)])
            # the journaled admission stamps re-seed the latency marks
            latency.on_replay(tid, len(src), ts)
            replayed[tid] = replayed.get(tid, 0) + len(src)
        telemetry.event("wal_replayed", durable=True, component="cohort",
                        dir=self._wal_dir, tenants=len(replayed),
                        edges=sum(replayed.values()), sealed=info["sealed"])
        metrics.counter_inc("gs_wal_replayed_edges_total",
                            sum(replayed.values()))
        return {"resumed": resumed, "replayed_edges": replayed,
                "sealed": info["sealed"]}

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def tenant_tier(self, tenant_id) -> str:
        return self._tenant(tenant_id).tier

    def queued_edges(self, tenant_id) -> int:
        return self._tenant(tenant_id).queued

    def windows_done(self, tenant_id) -> int:
        return self._tenant(tenant_id).windows_done


class GnnTenantCohort:
    """N tenants' windowed GNN rounds in one cohort dispatch per pump:
    each tenant owns a [vb+1, F] feature slab; a pump stacks the ready
    tenants' full windows into an [nb, wb, eb] slab (power-of-two
    buckets; padded rows and windows are inert by the round's
    empty-window hold) and folds it through
    `gnn_window.build_gnn_cohort_scan` with the cohort's one snapped
    weight layer. Per tenant the results equal a GnnSummaryEngine fed
    the same stream, and `tenant_state_dict()` is the GNN engines'
    layout (carry = (h,) plus the `gnn` section). Each dispatch runs in
    a `cohort.dispatch` span with its cost attributed per tenant, and
    each tenant window is marked and (armed) given a provenance record.

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. An unknown tenant raises
    TenantError, a full cohort (`max_tenants`, None: GS_TENANT_MAX)
    TenantRejected."""

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 feature_dim: int = 16, activation: str = "relu",
                 device=None, max_tenants: Optional[int] = None):
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.F = int(feature_dim)
        self.act = str(activation)
        if self.act not in ACTIVATIONS:
            raise ValueError("unknown GNN activation %r (exact-parity "
                             "choices: %s)" % (self.act, sorted(ACTIVATIONS)))
        if not 1 <= self.F <= 256:
            raise ValueError("feature_dim %d out of range [1, 256]" % self.F)
        self._max_tenants = max_tenants
        self._w_units, self._b_units = snap_weights(
            *default_weights(self.F), self.F)
        self._weights_changed()
        self._tenants: Dict[str, dict] = {}
        self._order: List[str] = []
        self._run = build_gnn_cohort_scan(self.eb, self.vb, self.F,
                                          self.act, self.device)
        self._stage = ChunkStager(self.device)
        self._lock = threading.RLock()

    # -- membership ----------------------------------------------------
    def admit(self, tenant_id, features=None, feature_units=None) -> None:
        """Admit one tenant with its slab: `feature_units` ([vb+1, F]
        lattice units, as they are), else `features` (real values,
        snapped), else zeros."""
        tid = str(tenant_id)
        with self._lock:
            if tid in self._tenants:
                raise TenantRejected("tenant %r already admitted" % tid,
                                     tid)
            cap = max_tenants() if self._max_tenants is None \
                else int(self._max_tenants)
            if len(self._tenants) >= cap:
                raise TenantRejected("cohort full: max_tenants=%d tenants "
                                     "admitted (GS_TENANT_MAX)" % cap, tid)
            if feature_units is not None:
                slab = np.asarray(feature_units, np.float32)
                if slab.shape != (self.vb + 1, self.F):
                    raise ValueError("unit slab must be [vb+1=%d, F=%d]; "
                                     "got %s" % (self.vb + 1, self.F,
                                                 slab.shape))
            elif features is not None:
                slab = snap_features(features, self.vb, self.F)
            else:
                slab = np.zeros((self.vb + 1, self.F), np.float32)
            self._tenants[tid] = {"carry": self._to_device(slab),
                                  "src": [], "dst": [], "queued": 0,
                                  "windows_done": 0}
            self._order.append(tid)
        telemetry.event("tenant_admitted", tenant=tid, workload="gnn")

    def _to_device(self, slab) -> torch.Tensor:
        return torch.as_tensor(np.array(slab, np.float32)).to(self.device)

    def _tenant(self, tenant_id) -> dict:
        t = self._tenants.get(str(tenant_id))
        if t is None:
            raise TenantError("unknown tenant %r" % tenant_id,
                              str(tenant_id))
        return t

    # -- weights -------------------------------------------------------
    def set_weights(self, W, b=None) -> None:
        """Adopt the cohort's shared dense layer, snapped onto the
        lattice (gnn_window.snap_weights)."""
        if b is None:
            b = np.zeros(self.F, np.float32)
        with self._lock:
            self._w_units, self._b_units = snap_weights(W, b, self.F)
            self._weights_changed()

    def _weights_changed(self) -> None:
        self._wdev = torch.from_numpy(self._w_units).to(self.device)
        self._bdev = torch.from_numpy(self._b_units).to(self.device)

    def weights(self):
        """(W_units, b_units): the snapped lattice representation."""
        return self._w_units.copy(), self._b_units.copy()

    # -- ingest --------------------------------------------------------
    def feed(self, tenant_id, src, dst) -> int:
        """Queue edges for one tenant (unbounded); returns its queued
        edges. Ids must lie in [0, vertex_bucket)."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        with self._lock:
            t = self._tenant(tenant_id)
            if len(src) and (int(min(src.min(), dst.min())) < 0
                             or int(max(src.max(), dst.max())) >= self.vb):
                raise ValueError("tenant %r ids must lie in [0, %d)"
                                 % (str(tenant_id), self.vb))
            t["src"].append(src)
            t["dst"].append(dst)
            t["queued"] += len(src)
            return t["queued"]

    def queued_edges(self, tenant_id) -> int:
        return self._tenant(tenant_id)["queued"]

    def windows_done(self, tenant_id) -> int:
        return self._tenant(tenant_id)["windows_done"]

    # -- the dispatch --------------------------------------------------
    def _take_windows(self, t: dict, drain: bool):
        """Cut the tenant's queue at the window boundary: every full
        window now, the sub-window remainder only when draining (close),
        the cut GnnSummaryEngine.process makes."""
        if not t["queued"]:
            return None
        src = np.concatenate(t["src"]) if len(t["src"]) != 1 \
            else t["src"][0]
        dst = np.concatenate(t["dst"]) if len(t["dst"]) != 1 \
            else t["dst"][0]
        take = len(src) if drain else (len(src) // self.eb) * self.eb
        if not take:
            return None
        t["src"] = [src[take:]] if take < len(src) else []
        t["dst"] = [dst[take:]] if take < len(src) else []
        t["queued"] = len(src) - take
        return seg_ops.window_stack(src[:take], dst[:take], self.eb,
                                    sentinel=self.vb)

    def _dispatch(self, batch: List[str], taken: dict,
                  out: Dict[str, list]) -> None:
        nb = seg_ops.bucket_size(len(batch))
        wb = seg_ops.bucket_size(max(t[0] for t in taken.values()))
        src = np.full((nb, wb, self.eb), self.vb, np.int32)
        dst = np.full((nb, wb, self.eb), self.vb, np.int32)
        valid = np.zeros((nb, wb, self.eb), bool)
        for i, tid in enumerate(batch):
            num_w, s, d, v = taken[tid]
            src[i, :num_w] = s
            dst[i, :num_w] = d
            valid[i, :num_w] = v
        carries = [self._tenants[tid]["carry"] for tid in batch]
        zero = torch.zeros(self.vb + 1, self.F, dtype=torch.float32,
                           device=self.device)
        carries.extend([zero] * (nb - len(batch)))
        live = [taken[tid][0] for tid in batch] + [0] * (nb - len(batch))
        with telemetry.span("cohort.dispatch", tenants=len(batch),
                            windows=sum(t[0] for t in taken.values())
                            ) as sp:
            slab_dev = (x.view(nb, wb, self.eb) for x in self._stage(
                *(a.reshape(nb * wb, self.eb) for a in (src, dst, valid))))
            hs, ys = self._run(torch.stack(carries), self._wdev, self._bdev,
                               *slab_dev, live)
            maxf, active, csum, nmsg = torch.stack(ys).cpu().numpy()
        tags = telemetry.pop_dispatch_tags()
        edges = {tid: int(np.sum(taken[tid][3])) for tid in batch}
        metrics.attribute_dispatch(
            sp.elapsed, [(tid, edges[tid]) for tid in batch],
            program=tags.get("program"), sig=tags.get("sig"))
        prov = provenance.armed()
        for i, tid in enumerate(batch):
            t = self._tenants[tid]
            t["carry"] = hs[i]
            num_w = taken[tid][0]
            rows = [{"max_feat": int(maxf[i, w]),
                     "active_vertices": int(active[i, w]),
                     "feat_checksum": int(csum[i, w]),
                     "msg_edges": int(nmsg[i, w])} for w in range(num_w)]
            out.setdefault(tid, []).extend(rows)
            if prov:
                vrows = taken[tid][3]
                for w in range(num_w):
                    lo = (t["windows_done"] + w) * self.eb
                    provenance.emit(
                        tenant=tid, window=t["windows_done"] + w, wal_lo=lo,
                        wal_hi=lo + int(np.sum(vrows[w])),
                        tier="gnn_cohort", program="gnn_round",
                        summary=rows[w])
            t["windows_done"] += num_w
            metrics.mark_window(num_w, edges[tid], engine="GnnTenantCohort",
                                tier="gnn_cohort", tenant=tid)

    def pump(self) -> Dict[str, list]:
        """Fold every tenant's full queued windows in one dispatch;
        returns {tenant: [summary, ...]} for the windows folded.
        Sub-window remainders stay queued for the next feed or close."""
        with self._lock:
            taken = {}
            batch = []
            for tid in self._order:
                got = self._take_windows(self._tenants[tid], drain=False)
                if got is not None:
                    taken[tid] = got
                    batch.append(tid)
            out: Dict[str, list] = {}
            if batch:
                self._dispatch(batch, taken, out)
            return out

    def close(self, tenant_id) -> List[dict]:
        """Drain the tenant's remainder (its final padded window, if
        any), remove it from the cohort and return the last summaries.
        The slab goes with it: checkpoint first (tenant_state_dict) to
        keep it."""
        tid = str(tenant_id)
        with self._lock:
            t = self._tenant(tid)
            out: Dict[str, list] = {}
            got = self._take_windows(t, drain=True)
            if got is not None:
                self._dispatch([tid], {tid: got}, out)
            del self._tenants[tid]
            self._order.remove(tid)
            return out.get(tid, [])

    # -- checkpoint / demotion -----------------------------------------
    def tenant_state_dict(self, tenant_id) -> dict:
        """One tenant's slab in the GNN engines' checkpoint layout,
        loadable by either package's GnnSummaryEngine / GnnHostEngine /
        GnnTenantCohort at equal buckets and feature width."""
        with self._lock:
            t = self._tenant(tenant_id)
            return {
                "edge_bucket": self.eb,
                "vertex_bucket": self.vb,
                "windows_done": int(t["windows_done"]),
                "closed_partial": False,
                "wal_offset": int(t["windows_done"]) * self.eb,
                "carry": (_to_host(t["carry"]),),
                "gnn": {"feat_dim": self.F, "act": self.act,
                        "weights": self._w_units.copy(),
                        "bias": self._b_units.copy()},
            }

    def load_tenant_state_dict(self, tenant_id, state: dict) -> None:
        """Adopt an engine or cohort checkpoint as a tenant's slab and
        window cursor (the cohort keeps its own weights)."""
        g = state.get("gnn") or {}
        if (int(state["edge_bucket"]) != self.eb
                or int(state["vertex_bucket"]) != self.vb
                or int(g.get("feat_dim", self.F)) != self.F):
            raise ValueError(
                "checkpoint shape (eb=%s, vb=%s, F=%s) does not match "
                "cohort (eb=%d, vb=%d, F=%d)"
                % (state.get("edge_bucket"), state.get("vertex_bucket"),
                   g.get("feat_dim"), self.eb, self.vb, self.F))
        (h,) = state["carry"]
        if np.shape(h) != (self.vb + 1, self.F):
            raise ValueError("carry must be (h,) with h [vb+1=%d, F=%d], "
                             "got %s" % (self.vb + 1, self.F, np.shape(h)))
        with self._lock:
            t = self._tenant(tenant_id)
            t["carry"] = self._to_device(h)
            t["windows_done"] = int(state.get("windows_done", 0))

    def demote(self, tenant_id):
        """Pop the tenant out of the cohort onto its own
        GnnSummaryEngine on the cohort's device, seeded from its live
        slab, with a demotion record. Returns (engine, folded, (src,
        dst)): full queued windows fold through the engine during the
        hand-off and their summaries come back in `folded`; the
        sub-window remainder comes back unfolded, for the caller to
        prepend to the rest of the stream (the engine's process() would
        close a partial window, which only a stream's end may do)."""
        tid = str(tenant_id)
        with self._lock:
            t = self._tenant(tid)
            state = self.tenant_state_dict(tid)
            pend_s = (np.concatenate(t["src"]) if t["src"]
                      else np.empty(0, np.int32))
            pend_d = (np.concatenate(t["dst"]) if t["dst"]
                      else np.empty(0, np.int32))
            del self._tenants[tid]
            self._order.remove(tid)
        eng = GnnSummaryEngine(self.eb, self.vb, feature_dim=self.F,
                               activation=self.act, device=self.device)
        eng.load_state_dict(state)
        resilience.record_demotion("tenant:%s" % tid, "gnn_cohort",
                                   "gnn_scan", int(state["windows_done"]),
                                   "operator", tenant=tid)
        full = (len(pend_s) // self.eb) * self.eb
        folded = eng.process(pend_s[:full], pend_d[:full]) if full else []
        return eng, folded, (pend_s[full:], pend_d[full:])

    def tenants(self) -> List[str]:
        return list(self._order)

    def state(self, tenant_id) -> np.ndarray:
        """[vb, F] feature snapshot in lattice units."""
        with self._lock:
            return _to_host(self._tenant(tenant_id)["carry"])[:self.vb]
