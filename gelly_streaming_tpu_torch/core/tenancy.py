"""Multi-tenant cohorts: N independent graph streams, one cohort dispatch
per window round.

Port of the JAX package's `core/tenancy.py`. `TenantCohort` admits up to
`max_tenants` streams, each with its own bounded ingest queue and its
own carry (deg, labels, cover) in the summary engines' layout, and
right-pads each ready tenant's next windows (at most
`windows_per_dispatch`, default 8) into one cohort slab [nb, wb, eb]
per vertex bucket group, which one call of the group's
`ops/cohort_summary.CohortSummary` folds: the cohort kernel of
csrc/cohort_summary.cu (one launch for the whole slab) and the window
counter on a card, the plain PyTorch version on the CPU. K is the
cohort's for every tenant. nb and wb are the power-of-two
buckets of the batch's tenants and windows, as in the JAX cohort; pad
rows carry a fresh state and are thrown away. Per tenant the summaries,
degrees and labels equal a `StreamSummaryEngine` fed the same stream,
and `tenant_state_dict()`
equals the JAX cohort's bit for bit (the cover's sentinel slot 2vb+1
records padded windows, so it may differ from a sequential engine's).
A window whose hubs outrun the K bucket is recounted exactly by a
`TriangleWindowKernel` at 4·K.

`GnnTenantCohort` is the same serving shape for the windowed GNN: each
tenant owns a [vb+1, F] feature slab, the cohort shares one snapped
weight layer, and a pump folds every tenant's full windows through
`gnn_window.build_gnn_cohort_scan` (the GNN kernel of csrc/gnn_round.cu
per tenant row on a card).

The JAX package's GS_TENANT_* knobs are constructor arguments here, at
the knobs' defaults. Not ported yet (ROADMAP.md): the resident cohort
tier and the tenants-per-dispatch autotuner arm (step 1.7's second
half, with the ingest ring of step 1.3); the bulkhead (quarantine,
probation, the poison gate, demotion on a failed prep), the reorder
buffer, sanitize, WAL, checkpoint files, latency, provenance, metrics
and telemetry (step 1.8c); the serving front end `core/serve.py` (step
1.9). Slabs are prepared inline on the pumping thread.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import segment as seg_ops
from ..ops.cohort_summary import CohortSummary
from ..ops.gnn_round import ACTIVATIONS
from ..ops.gnn_window import (GnnSummaryEngine, build_gnn_cohort_scan,
                              default_weights, snap_features, snap_weights)
from ..ops.scan_analytics import (StreamSummaryEngine, _to_host,
                                  check_summary_carry)
from ..ops.staging import ChunkStager
from ..ops.triangles import TriangleWindowKernel, default_kb
from ..ops.window_summary import fresh_carry
from .platform import resolve_device

__all__ = ["GnnTenantCohort", "TenantBackpressure", "TenantCohort",
           "TenantError", "TenantRejected"]

ADMISSION_POLICIES = ("reject", "drop")


class TenantError(RuntimeError):
    """Base of the typed tenancy failures; `tenant` names the stream."""

    def __init__(self, message: str, tenant):
        super().__init__(message)
        self.tenant = tenant


class TenantRejected(TenantError):
    """Admission refused: the cohort is at its cap, the id is
    unknown or closed, or a duplicate admit."""


class TenantBackpressure(TenantError):
    """A feed() overflowed the tenant's bounded queue under the `reject`
    policy. Carries `queued` and `capacity` (edges) so the caller can
    size its retry."""

    def __init__(self, message: str, tenant, queued: int, capacity: int):
        super().__init__(message, tenant)
        self.queued = queued
        self.capacity = capacity


class _Tenant:
    """One admitted stream: its bounded ingest queue, its carry in the
    engines' layout, its cursors and (after demotion) its own
    single-tenant engine."""

    __slots__ = ("tid", "vb", "src", "dst", "carry", "windows_done",
                 "closed_partial", "closing", "closed", "tier", "engine",
                 "dropped_edges", "last_ts")

    def __init__(self, tid: str, vb: int):
        self.tid = tid
        self.vb = vb
        self.src = np.zeros(0, np.int32)
        self.dst = np.zeros(0, np.int32)
        self.carry = None          # lazy: the fresh state until a dispatch
        self.windows_done = 0
        self.closed_partial = False
        self.closing = False
        self.closed = False
        self.tier = "cohort"       # "cohort" | "single"
        self.engine = None         # the demoted tenant's engine
        self.dropped_edges = 0
        self.last_ts = None        # newest accepted event-time stamp

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
    `queue_windows` (queue depth in windows of edge_bucket edges),
    `admission` ("reject": an overflowing feed raises TenantBackpressure
    and accepts nothing; "drop": it accepts what fits and counts the
    rest in the tenant's `dropped_edges`) and `tenants_per_dispatch`
    (0: every ready tenant of a group in one slab) are the JAX package's
    GS_TENANT_* knobs, at their defaults. `windows_per_dispatch` is the
    JAX cohort's window ceiling: a tenant folds at most its power-of-two
    bucket (at least 8) of windows per dispatch. `k_bucket` is every
    tenant's K (0: the analytic default for the edge bucket)."""

    MAX_WINDOWS_PER_DISPATCH = 8

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0,
                 windows_per_dispatch: Optional[int] = None, device=None,
                 max_tenants: int = 64, queue_windows: int = 8,
                 admission: str = "reject", tenants_per_dispatch: int = 0):
        if admission not in ADMISSION_POLICIES:
            raise ValueError("admission must be one of %s, got %r"
                             % (ADMISSION_POLICIES, admission))
        if max_tenants < 1 or queue_windows < 1 or tenants_per_dispatch < 0:
            raise ValueError("max_tenants and queue_windows must be ≥ 1 and "
                             "tenants_per_dispatch ≥ 0")
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.default_vb = seg_ops.bucket_size(vertex_bucket)
        self.kb = seg_ops.bucket_size(k_bucket if k_bucket
                                      else default_kb(self.eb))
        self.wc = seg_ops.bucket_size(
            windows_per_dispatch if windows_per_dispatch
            else self.MAX_WINDOWS_PER_DISPATCH)
        self.max_tenants = int(max_tenants)
        self.queue_windows = int(queue_windows)
        self.admission = admission
        self.tenants_per_dispatch = int(tenants_per_dispatch)
        self.tenants: Dict[str, _Tenant] = {}
        self._summaries = {}       # vb -> CohortSummary (one counter)
        self._fresh = {}           # vb -> fresh carry on the device
        self._tri_redo = {}        # vb -> the 4·K exact recount
        self._stage = ChunkStager(self.device)
        # feed() appends to a queue and the pump prefix-drops it under
        # this lock, so ingest threads may feed while one thread pumps
        self._qlock = threading.RLock()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def admit(self, tenant_id, vertex_bucket: Optional[int] = None) -> None:
        """Admit one stream under the `max_tenants` cap. A tenant may
        declare its own vertex bucket (the cohort dispatches one slab
        per bucket group); K is the cohort's."""
        tid = str(tenant_id)
        if tid in self.tenants:
            raise TenantRejected("tenant %r is already admitted" % tid, tid)
        live = sum(1 for t in self.tenants.values() if not t.closed)
        if live >= self.max_tenants:
            raise TenantRejected(
                "cohort is at its max_tenants=%d admission cap; tenant %r "
                "refused" % (self.max_tenants, tid), tid)
        vb = seg_ops.bucket_size(vertex_bucket if vertex_bucket
                                 else self.default_vb)
        with self._qlock:
            self.tenants[tid] = _Tenant(tid, vb)

    def _tids(self) -> list:
        """Sorted snapshot of the tenant ids, taken under the queue lock
        (admissions may land from other threads)."""
        with self._qlock:
            return sorted(self.tenants)

    def _tenant(self, tenant_id, for_feed: bool = False) -> _Tenant:
        tid = str(tenant_id)
        t = self.tenants.get(tid)
        if t is None:
            raise TenantRejected("unknown tenant %r (admit() first)" % tid,
                                 tid)
        if for_feed and (t.closed or t.closing):
            raise TenantRejected(
                "tenant %r is closed — its final (partial) window was "
                "already cut" % tid, tid)
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
        accepted. Past capacity (queue_windows × edge_bucket edges) the
        admission policy decides: `reject` raises TenantBackpressure
        accepting nothing (an atomic refusal cannot split a window
        across a retry), `drop` accepts what fits and sheds the rest.
        `ts` is an optional per-edge event-time column, checked per
        tenant (`_check_event_time`). Ids must lie in [0, the tenant's
        vertex bucket)."""
        t = self._tenant(tenant_id, for_feed=True)
        if t.closed_partial:
            # the engines' partial-window-must-be-final guard, across a
            # checkpoint taken after the short final window was cut
            raise ValueError(
                "tenant %r already closed a partial window (length not a "
                "multiple of edge_bucket); it cannot accept more of the "
                "stream" % t.tid)
        ts_col = self._check_event_time(t, src, ts)
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        if len(src) and (int(src.max()) >= t.vb or int(dst.max()) >= t.vb
                         or int(src.min()) < 0 or int(dst.min()) < 0):
            raise ValueError(
                "tenant %r ids must be dense in [0, %d) — out-of-range ids "
                "would scatter into another slot's carried state"
                % (t.tid, t.vb))
        # the capacity gate and the enqueue are one section under the
        # queue lock: a concurrent pump only ever shrinks the queue
        with self._qlock:
            capacity = self.queue_windows * self.eb
            room = capacity - t.queued
            take = len(src)
            if take > room:
                if self.admission == "reject":
                    raise TenantBackpressure(
                        "tenant %r queue is full (%d queued of %d edge "
                        "capacity); pump() the cohort or retry later"
                        % (t.tid, t.queued, capacity), t.tid,
                        queued=t.queued, capacity=capacity)
                take = max(0, room)
                t.dropped_edges += len(src) - take
            if ts_col is not None and len(ts_col):
                t.last_ts = int(ts_col[-1])
            if take:
                t.src = np.concatenate([t.src, src[:take]])
                t.dst = np.concatenate([t.dst, dst[:take]])
        return take

    # ------------------------------------------------------------------
    # carries, scans, slabs
    # ------------------------------------------------------------------
    def _fresh_carry(self, vb: int) -> tuple:
        """The zero-stream carry at vb on the device (a template: the
        dispatch copies it into the slab's stack, never updates it)."""
        got = self._fresh.get(vb)
        if got is None:
            got = self._fresh[vb] = fresh_carry(vb, self.device)
        return got

    def _carry_of(self, t: _Tenant) -> tuple:
        return t.carry if t.carry is not None else self._fresh_carry(t.vb)

    def _summary(self, vb: int) -> CohortSummary:
        """The group's cohort summary: one per vertex bucket, whatever
        the slab's nb and wb, keeping its counter's scratch across
        dispatches."""
        summ = self._summaries.get(vb)
        if summ is None:
            summ = self._summaries[vb] = CohortSummary(vb, self.kb,
                                                       self.device)
        return summ

    def _redo_kernel(self, vb: int) -> TriangleWindowKernel:
        """The exact recount of one K-overflowing window at 4·K, the
        fallback every summary engine keeps."""
        k = self._tri_redo.get(vb)
        if k is None:
            k = self._tri_redo[vb] = TriangleWindowKernel(
                self.eb, vb, k_bucket=4 * self.kb, device=self.device)
        return k

    def _take_windows(self, t: _Tenant) -> int:
        """Full windows this tenant contributes to the next slab (plus
        the final partial one once closing), at most `wc`."""
        if t.tier != "cohort" or t.closed:
            return 0
        full = t.queued // self.eb
        if t.closing and t.queued % self.eb and full < self.wc:
            return min(full + 1, self.wc)
        return min(full, self.wc)

    def _prep_slab(self, batch: List[_Tenant], wins: List[int]):
        """Right-pad each tenant's next `wins` windows into the cohort
        slab [nb, wb, eb] (power-of-two buckets of the batch). Reads the
        queues only: they are consumed at finalize."""
        nb = seg_ops.bucket_size(len(batch))
        wb = seg_ops.bucket_size(max(wins))
        vb = batch[0].vb
        s = np.full((nb, wb, self.eb), vb, np.int32)
        d = np.full((nb, wb, self.eb), vb, np.int32)
        valid = np.zeros((nb, wb, self.eb), bool)
        real = []   # (tenant, row, windows, edges) packed
        for row, (t, w) in enumerate(zip(batch, wins)):
            # a consistent snapshot: concurrent feeds only append
            with self._qlock:
                n = min(w * self.eb, t.queued)
                t_src, t_dst = t.src, t.dst
            s[row].reshape(-1)[:n] = t_src[:n]
            d[row].reshape(-1)[:n] = t_dst[:n]
            valid[row].reshape(-1)[:n] = True
            real.append((t, row, w, n))
        return nb, wb, s, d, valid, real

    def _dispatch_batch(self, vb: int, slab, out: dict) -> None:
        """One cohort dispatch and its finalize: the batch's carries
        stacked (pad rows fresh), one staged copy of the slab, one call
        of the group's cohort summary, one copy back of its [5, nb, wb]
        outputs. Each tenant keeps a copy of its own carry row, not a
        view that would hold the whole stack alive."""
        nb, wb, s, d, valid, real = slab
        by_row = {row: t for t, row, _w, _n in real}
        stacked = tuple(
            torch.stack([self._carry_of(by_row[r])[leaf] if r in by_row
                         else self._fresh_carry(vb)[leaf]
                         for r in range(nb)])
            for leaf in range(3))
        slab_dev = (x.view(nb, wb, self.eb) for x in self._stage(
            *(a.reshape(nb * wb, self.eb) for a in (s, d, valid))))
        outs = self._summary(vb)(stacked, *slab_dev)
        mdeg, ncomp, odd, tri, ovf = torch.stack(
            [x.to(torch.int32) for x in outs]).cpu().numpy()
        for t, row, w, n in real:
            summaries = []
            for j in range(w):
                tri_w = int(tri[row, j])
                if ovf[row, j]:
                    lo, hi = j * self.eb, min((j + 1) * self.eb, n)
                    tri_w = self._redo_kernel(vb).count(
                        t.src[lo:hi], t.dst[lo:hi])
                summaries.append({"max_degree": int(mdeg[row, j]),
                                  "num_components": int(ncomp[row, j]),
                                  "odd_cycle": bool(odd[row, j]),
                                  "triangles": tri_w})
            t.carry = tuple(a[row].clone() for a in stacked)
            with self._qlock:
                t.src = t.src[n:]
                t.dst = t.dst[n:]
            t.windows_done += w
            if n < w * self.eb:      # the final short window was just cut
                t.closed_partial = True
            if t.closing and t.queued == 0:
                t.closed = True
            out.setdefault(t.tid, []).extend(summaries)

    # ------------------------------------------------------------------
    # the pump
    # ------------------------------------------------------------------
    def pump(self, max_rounds: Optional[int] = None,
             only: Optional[str] = None) -> Dict[str, list]:
        """Dispatch window rounds while any tenant has a full window
        queued (plus the final partial window of closing tenants);
        demoted tenants run their own engine alongside. Each round
        groups the ready tenants by vertex bucket (K is the cohort's)
        and dispatches each group in batches of `tenants_per_dispatch`
        (all of them with 0). Returns {tenant: [summary dict, ...]} for
        every window finalized by this call. `only` restricts the pump
        to one tenant (close()'s drain)."""
        out: Dict[str, list] = {}
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            self._pump_singles(out, only=only)
            by_group: Dict[int, list] = {}
            for tid in self._tids():
                if only is not None and tid != only:
                    continue
                t = self.tenants[tid]
                if self._take_windows(t) > 0:
                    by_group.setdefault(t.vb, []).append(t)
            if not by_group:
                break
            rounds += 1
            for vb, ready in sorted(by_group.items()):
                tpd = self.tenants_per_dispatch or len(ready)
                for at in range(0, len(ready), tpd):
                    batch = ready[at:at + tpd]
                    wins = [self._take_windows(t) for t in batch]
                    self._dispatch_batch(vb, self._prep_slab(batch, wins),
                                         out)
        return out

    def _pump_singles(self, out: dict, only: Optional[str] = None) -> None:
        """Demoted tenants: their queued full windows (and the final
        partial one once closing) run through their own engine."""
        for tid in self._tids():
            if only is not None and tid != only:
                continue
            t = self.tenants[tid]
            if t.tier != "single" or t.closed:
                continue
            with self._qlock:
                n = t.queued if t.closing else \
                    (t.queued // self.eb) * self.eb
                src, dst = t.src[:n], t.dst[:n]
            if n == 0:
                if t.closing:
                    t.closed = True
                continue
            summaries = t.engine.process(src, dst)
            with self._qlock:
                t.src = t.src[n:]
                t.dst = t.dst[n:]
            t.windows_done = t.engine.windows_done
            t.closed_partial = t.engine._closed_partial
            if t.closing and t.queued == 0:
                t.closed = True
            out.setdefault(t.tid, []).extend(summaries)

    def close(self, tenant_id) -> List[dict]:
        """Cut the tenant's final (possibly partial) window and retire
        it. Drains only this tenant: other tenants' queued windows stay
        for the next pump()."""
        t = self._tenant(tenant_id)
        if t.closed:
            return []
        t.closing = True
        if t.queued == 0 and t.tier == "cohort":
            t.closed = True
            return []
        return self.pump(only=t.tid).get(t.tid, [])

    # ------------------------------------------------------------------
    # demotion (cohort → single-tenant engine)
    # ------------------------------------------------------------------
    def _demote(self, t: _Tenant) -> None:
        if t.tier == "single":
            return
        eng = StreamSummaryEngine(self.eb, t.vb, k_bucket=self.kb,
                                  device=self.device)
        eng.load_state_dict(self.tenant_state_dict(t.tid))
        t.engine = eng
        t.tier = "single"

    def demote(self, tenant_id, reason: str = "operator") -> None:
        """Pull one tenant off the cohort onto its own
        StreamSummaryEngine, seeded from its live carry (exact); the
        cohort keeps dispatching everyone else. `reason` is the JAX
        API's; the port records no event."""
        self._demote(self._tenant(tenant_id))

    # ------------------------------------------------------------------
    # checkpoints (per tenant; the engines' layout)
    # ------------------------------------------------------------------
    def tenant_state_dict(self, tenant_id) -> dict:
        """One tenant's resumable state in the summary engines' layout
        (ops/scan_analytics state_dict), so it loads into a
        StreamSummaryEngine of either package, or a TenantCohort of
        either package, at equal buckets, and back."""
        t = self._tenant(tenant_id)
        if t.tier == "single":
            return t.engine.state_dict()
        return {
            "edge_bucket": self.eb,
            "vertex_bucket": t.vb,
            "windows_done": int(t.windows_done),
            "closed_partial": bool(t.closed_partial),
            "wal_offset": int(t.windows_done) * self.eb,
            "carry": tuple(_to_host(x) for x in self._carry_of(t)),
        }

    def load_tenant_state_dict(self, tenant_id, state: dict) -> None:
        """Adopt a tenant state of either package's cohort or summary
        engine. Raises ValueError on other buckets, an inconsistent
        cursor, or a carry that is not the engines' layout."""
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
        t.carry = tuple(torch.as_tensor(np.array(a, np.int32))
                        .to(self.device) for a in carry)
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

    def resume_offset(self, tenant_id) -> int:
        """Edges already folded into the tenant's carry: a resumed caller
        feeds the stream from here."""
        return self._tenant(tenant_id).windows_done * self.eb

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
    layout (carry = (h,) plus the `gnn` section).

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. An unknown tenant raises
    TenantError, a full cohort (`max_tenants`) TenantRejected."""

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 feature_dim: int = 16, activation: str = "relu",
                 device=None, max_tenants: int = 64):
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
        self.max_tenants = int(max_tenants)
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
            if len(self._tenants) >= self.max_tenants:
                raise TenantRejected("cohort full: max_tenants=%d tenants "
                                     "admitted" % self.max_tenants, tid)
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
        slab_dev = (x.view(nb, wb, self.eb) for x in self._stage(
            *(a.reshape(nb * wb, self.eb) for a in (src, dst, valid))))
        live = [taken[tid][0] for tid in batch] + [0] * (nb - len(batch))
        hs, ys = self._run(torch.stack(carries), self._wdev, self._bdev,
                           *slab_dev, live)
        maxf, active, csum, nmsg = torch.stack(ys).cpu().numpy()
        for i, tid in enumerate(batch):
            t = self._tenants[tid]
            t["carry"] = hs[i]
            num_w = taken[tid][0]
            out.setdefault(tid, []).extend(
                {"max_feat": int(maxf[i, w]),
                 "active_vertices": int(active[i, w]),
                 "feat_checksum": int(csum[i, w]),
                 "msg_edges": int(nmsg[i, w])} for w in range(num_w))
            t["windows_done"] += num_w

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
        GnnSummaryEngine, seeded from its live slab. Returns
        (engine, folded, (src, dst)): full queued windows fold through
        the engine during the hand-off and their summaries come back in
        `folded`; the sub-window remainder comes back unfolded, for the
        caller to prepend to the rest of the stream (the engine's
        process() would close a partial window, which only a stream's
        end may do)."""
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
        full = (len(pend_s) // self.eb) * self.eb
        folded = eng.process(pend_s[:full], pend_d[:full]) if full else []
        return eng, folded, (pend_s[full:], pend_d[full:])

    def tenants(self) -> List[str]:
        return list(self._order)

    def state(self, tenant_id) -> np.ndarray:
        """[vb, F] feature snapshot in lattice units."""
        with self._lock:
            return _to_host(self._tenant(tenant_id)["carry"])[:self.vb]
