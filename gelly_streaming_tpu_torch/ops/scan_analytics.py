"""The fused summary engine: every analytic of every window from one
carried state, one device dispatch per chunk of windows.

Port of the JAX package's `ops/scan_analytics.py` (`SummaryEngineBase`
:173-845, `StreamSummaryEngine` :847-963, `SlidingSummaryEngine`
:966-1086). The carry (deg[vb+1], labels[vb+1], cover[2(vb+1)]) lives
on the device across chunks; each chunk of up to MAX_WINDOWS windows
costs one h2d of its [W, eb] stack (the standard wire, or with
`ingress="compact"` the compact one of ops/compact_ingress.py), one
`WindowSummary` call (ops/window_summary.py: the CUDA kernels on a card,
the plain PyTorch version on the CPU) and one d2h of its [5, W] outputs.
The chunks go through the ingress pipeline (ops/ingress_pipeline.py):
prep and h2d on a worker pool, dispatches in chunk order on the caller's
thread (the carry is sequential), each chunk's outputs read, and the
cursor advanced, one chunk behind. Summaries per window are cumulative
over the stream so far, as the reference's continuous aggregates are:

  max_degree      running max degree (SimpleEdgeStream getDegrees)
  num_components  touched roots (ConnectedComponents)
  odd_cycle       any odd cycle seen (BipartitenessCheck)
  triangles       exact count of this window (WindowTriangles)

A window whose hubs outrun the K bucket is recounted exactly by a
`TriangleWindowKernel` at 4·K.

`state_dict()` has the JAX engine's keys and carry layout, so a
checkpoint of either package loads into the other.

A call of more than MAX_WINDOWS windows runs under the online dispatch
tuner (ops/autotune.py, GS_AUTOTUNE on by default; the JAX engine's
`_ensure_tuner`, `_warm_arm`, `_process_tuned`, :755-845 there, and its
engaging rule :549-555): measurement rounds of GS_AUTOTUNE_ROUND chunks,
each at the tuner's (windows-per-dispatch, wire) arm. The JAX engine
runs each round as a pipeline of its own beside its static loop; here
both are one chunk loop (`_run_chunks` over an autotune.RoundPlan), each
chunk's stack built from the raw edges on the pool, the arm free to
change between chunks without draining. Summaries are the same at every
arm.
`forced_sync` freezes the tuner, an explicit `ingress=` pins the wire,
and the tuner's state rides `state_dict` as "autotune". One difference:
the JAX `_warm_arm` folds its all-padding chunk into the live carry,
which joins the cover's two sentinels (slot 2vb+1 then reads vb; no
summary reads it); the port warms on a throwaway carry, so a tuned
carry equals the static path's bit for bit.

ops/cohort_summary.py lifts the same body over a leading tenant axis
for the multi-tenant cohort (core/tenancy.py); ops/resident_engine.py
replays its super-batches as CUDA graphs.

Host hooks (the JAX engine's :373-437, :488-534, :572, :614-647,
:664-717, :831, :1030-1047), each a no-op disarmed, their knobs read
once a call: at admission the `admit` fault site, the sanitizer
(GS_SANITIZE; rejects to the dead-letter journal), the journal append
before the fold (`enable_wal`) with the admission stamp in its ts
column, and `latency.on_admit`; per chunk the latency stage stamps
(prep, h2d, dispatch) and a due auto-checkpoint staged at the dispatch
boundary; at each chunk's finalize one latency record and one
provenance record a window and `metrics.mark_window`; per tuned round
the `fused_scan.round` span. `enable_auto_checkpoint`, `try_resume`
(a durable `resume` event), `enable_wal`, `seal_wal` and
`resume_and_replay` (checkpoint, then the journal's suffix) are the
JAX engine's; a journal of either package replays into either.
The hooks read what finalize has already copied back: none waits on the
device.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Tuple

import numpy as np
import torch

from ..core.platform import resolve_device
from ..utils import checkpoint
from ..utils import faults
from ..utils import latency
from ..utils import metrics
from ..utils import provenance
from ..utils import sanitize as sanitize_mod
from ..utils import telemetry
from ..utils import wal as wal_mod
from . import autotune
from . import compact_ingress
from . import ingress_pipeline
from . import segment as seg_ops
from .staging import ChunkStager, HostCopy
from .triangles import TriangleWindowKernel, _tuned_kb, resolve_ingress
from .window_summary import WindowSummary, fresh_carry

__all__ = ["SlidingSummaryEngine", "StreamSummaryEngine",
           "SummaryEngineBase", "check_summary_carry"]

_OFF = nullcontext()    # a call's phase while nothing traces it


class SummaryEngineBase:
    """The pipelined chunk loop, the resume cursor, the checkpoint keys
    and the partial-window-must-be-final guard, for any carry.
    Subclasses set eb, vb and `ingress` ("standard" or "compact") and
    provide the carry's hooks: `_init_carry` (the fresh carry, a tuple),
    `_to_carry` (one host leaf onto the engine), `_check_carry` (raise
    ValueError for a host carry the engine cannot load),
    `_dispatch_async` (fold one staged chunk into the carry on the
    caller's thread, returning its outputs as a `HostCopy` not waited
    for) and `_finalize_summaries` (one chunk's [R, W] outputs, R chosen
    by the engine, into summary dicts). The h2d stages each chunk into
    the engine's ring `_ring` from a pool worker; an engine with no torch
    device overrides `_h2d` and `_materialize`. `StreamSummaryEngine`
    below and ops/gnn_window.py are the two."""

    MAX_WINDOWS = 64
    # the tier and program names of the health marks and provenance
    # records (the JAX engines')
    METRICS_TIER = "fused_scan"
    PROGRAM = "fused_scan"
    INFLIGHT = ingress_pipeline.DEFAULT_INFLIGHT   # pipeline look-ahead
    # prepped and copied chunks ahead of dispatch; None = INFLIGHT (the
    # resident engine reads GS_RESIDENT_SLOTS)
    INGEST_SLOTS = None
    ingress = "standard"
    _ring = None        # the staging ring of an engine on a torch device
    # the online dispatch tuner (ops/autotune.py): engines that opt in,
    # whether the wire is one of its knobs, and its cache-key family
    AUTOTUNE = False
    TUNABLE_INGRESS = False
    TUNER_FAMILY = "fused_scan"
    _pinned_ingress = False
    _tuner = None
    _calls = 0          # process() calls so far: the spans' call ordinal

    def reset(self) -> None:
        self._closed_partial = False
        self.windows_done = 0   # resume cursor
        # cumulative fed edges, rejects included: the dead-letter
        # journal's source offsets
        self._fed_edges = 0
        if not hasattr(self, "_wal"):
            # the hooks' configuration survives reset()
            self._ckpt_path = None
            self._ckpt_policy = None
            self._wal = None
            self._wal_dir = None
            self._wal_tenant = "engine"
            self._wal_retention = wal_mod.RetentionCursor()
            # the latency lane of this engine's windows (None: the
            # journal tenant), whether process() stamps admission, and
            # whether window records wait for latency.delivered()
            self._lat_lane = None
            self._lat_admit = True
            self._lat_defer = False
        elif self._ckpt_policy is not None:
            # the rewound cursor re-anchors the cadence
            self._ckpt_policy.mark(0)
        self._adopt_carry(self._init_carry())

    def state_dict(self) -> dict:
        """The resumable state: the carry as host arrays plus the
        windows_done cursor, under the JAX engine's keys; a live tuner's
        state rides along as "autotune"."""
        state = {
            "edge_bucket": self.eb,
            "vertex_bucket": self.vb,
            "windows_done": int(self.windows_done),
            "closed_partial": bool(self._closed_partial),
            "wal_offset": int(self.windows_done) * self.eb,
            "carry": tuple(_to_host(x) for x in self._carry),
        }
        if self._tuner is not None:
            state["autotune"] = self._tuner.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        """Adopt a state of this package's or the JAX package's engines
        (its "autotune" entry into this engine's tuner, where the engine
        tunes and GS_AUTOTUNE is on). Raises ValueError on other buckets,
        an inconsistent cursor, or a carry that is not the engines'
        layout."""
        if state["edge_bucket"] != self.eb \
                or state["vertex_bucket"] != self.vb:
            raise ValueError(
                "bucket mismatch: checkpoint was taken at eb=%d vb=%d, "
                "engine runs eb=%d vb=%d; count-based windows are cut "
                "by eb, so resuming across buckets would shift every "
                "window boundary" % (state["edge_bucket"],
                                     state["vertex_bucket"],
                                     self.eb, self.vb))
        woff = state.get("wal_offset")
        if woff is not None and int(woff) > int(state["windows_done"]) \
                * self.eb:
            raise ValueError(
                "checkpoint wal_offset %d exceeds its own window "
                "coverage (%d windows x eb=%d)" % (
                    int(woff), int(state["windows_done"]), self.eb))
        carry = tuple(np.asarray(a) for a in state["carry"])
        self._check_carry(carry)
        self.windows_done = int(state["windows_done"])
        self._closed_partial = bool(state["closed_partial"])
        self._adopt_carry(tuple(self._to_carry(a) for a in carry))
        if state.get("autotune") is not None and self.AUTOTUNE \
                and autotune.enabled():
            self._ensure_tuner().load_state_dict(state["autotune"])

    def resume_offset(self) -> int:
        """Edges already folded into the carry: a resumed caller feeds
        `src[offset:], dst[offset:]`."""
        return self.windows_done * self.eb

    # -- checkpoints and the journal -----------------------------------

    def enable_auto_checkpoint(self, path: str, every_n_windows: int = 16,
                               every_seconds: float = 0.0,
                               policy=None) -> None:
        """Snapshot on a CheckpointPolicy cadence, evaluated at chunk
        dispatch boundaries (where the carry covers exactly the windows
        dispatched) and written to `path` only when process() returns:
        a call's windows are delivered together, so a checkpoint never
        covers windows the caller was not handed."""
        if policy is None:
            policy = checkpoint.CheckpointPolicy(
                every_n_windows=max(0, every_n_windows),
                every_seconds=every_seconds)
        if not policy.enabled():
            raise ValueError("checkpoint policy has no trigger enabled")
        self._ckpt_path = path
        self._ckpt_policy = policy

    def try_resume(self, path: str) -> bool:
        """Restore from the newest intact checkpoint generation (the
        previous one when the newest is damaged); False when nothing
        usable exists. After True, feed the stream from
        `resume_offset()` edges in."""
        import warnings

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
        telemetry.event("resume", durable=True, component="engine",
                        path=used, windows_done=self.windows_done)
        return True

    def enable_wal(self, directory: str, tenant: str = "engine") -> bool:
        """Journal every process() call's edges under `directory` before
        they fold (utils/wal.py): after a kill, `resume_and_replay()`
        restores the newest checkpoint and feeds the journal's suffix
        again, reproducing the lost windows bit for bit. False (a no-op)
        under GS_WAL=0."""
        if not wal_mod.enabled():
            return False
        self._wal_dir = directory
        self._wal_tenant = str(tenant)
        self._wal = wal_mod.WriteAheadLog(directory)
        return True

    def seal_wal(self) -> None:
        """Close the journal durably (the clean-drain marker)."""
        if self._wal is not None:
            self._wal.seal()

    def resume_and_replay(self, ckpt_path: str) -> list:
        """Recovery of a journal-armed engine: `try_resume` the newest
        checkpoint, then process the journal's records past its
        `resume_offset()`. Returns the replayed windows' summaries:
        those the lost process computed or accepted but never delivered,
        equal to the uninterrupted run's."""
        self.try_resume(ckpt_path)
        if self._wal_dir is None:
            return []
        off = self.resume_offset()
        parts_s, parts_d = [], []
        for tid, _start, src, dst, ts in wal_mod.replay(
                self._wal_dir, {self._wal_tenant: off}):
            if tid != self._wal_tenant:
                continue
            parts_s.append(src)
            parts_d.append(dst)
            # the journaled admission stamps re-seed the latency marks
            latency.on_replay(self._lat_lane or self._wal_tenant,
                              len(src), ts)
        edges = sum(len(p) for p in parts_s)
        telemetry.event("wal_replayed", durable=True, component="engine",
                        dir=self._wal_dir, edges=edges)
        metrics.counter_inc("gs_wal_replayed_edges_total", edges)
        if not edges:
            return []
        # the replayed edges are in the journal already, and their
        # admission marks were re-seeded above
        live, self._wal = self._wal, None
        admit_prev, self._lat_admit = self._lat_admit, False
        try:
            return self.process(np.concatenate(parts_s),
                                np.concatenate(parts_d))
        finally:
            self._wal = live
            self._lat_admit = admit_prev

    def _stage_ckpt_at(self, base: int, at: int, staged: list) -> None:
        """Stage a due checkpoint at a chunk's dispatch boundary: the
        carry there covers exactly windows base + at. Written when
        process() returns."""
        if (self._ckpt_path is not None and at
                and self._ckpt_policy.due(base + at)):
            self._ckpt_policy.mark(base + at)
            snap = self.state_dict()
            snap["windows_done"] = base + at
            snap["closed_partial"] = False
            staged.append(snap)

    def _init_carry(self) -> tuple:
        raise NotImplementedError

    def _adopt_carry(self, carry: tuple) -> None:
        """Make `carry` the engine's carry (the resident engines copy it
        into the buffers their graphs bind)."""
        self._carry = tuple(carry)

    def _to_carry(self, a):
        raise NotImplementedError

    def _check_carry(self, carry) -> None:
        raise NotImplementedError

    def _h2d(self, args, ordinal: int):
        return self._ring.put(args, ordinal)

    def _dispatch_async(self, staged, wire: str):
        raise NotImplementedError

    def _materialize(self, raw) -> np.ndarray:
        return raw.numpy()

    def _finalize_summaries(self, at: int, res: np.ndarray, src, dst,
                            out: list) -> None:
        raise NotImplementedError

    def _validate(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Raise ValueError for ids the engine cannot fold (main thread,
        before the pipeline)."""
        _validate_ids(src, dst, self.vb)

    def process(self, src: np.ndarray, dst: np.ndarray) -> list:
        """Fold the stream's `edge_bucket`-sized windows; returns one
        summary dict per window.

        A call whose length is not a multiple of `edge_bucket` closes
        its partial trailing window (count-based tumbling windows), so it
        must be the stream's last call: feed mid-stream chunks in
        edge_bucket multiples. Ids must lie in [0, vertex_bucket) (with
        GS_SANITIZE armed, the others are rejected to the dead-letter
        journal instead).

        The call is the `engine.call` span, its admission `engine.admit`
        and its chunk loop `engine.chunks` (the tuner's arm, the round
        plan, the ingress pipeline and its unwinding), each with the
        call's ordinal and first window (the chunks' spans carry the same
        ids); made while the recorder or a sink is armed, or a
        torch.profiler capture records, and then also entered in that
        capture."""
        self._calls += 1
        profile = telemetry.profiling()
        if not (profile or telemetry.active()):
            return self._process(src, dst, None)
        with telemetry.span("engine.call", profile=profile,
                            call=self._calls,
                            window=self.windows_done) as sp:
            return self._process(src, dst, sp)

    def _process(self, src, dst, call_span) -> list:
        """process() inside its `engine.call` span (None untraced)."""
        with (telemetry.span("engine.admit", profile=call_span.profile,
                             **call_span.attrs) if call_span else _OFF):
            admitted = self._admit(src, dst)
        if admitted is None:
            return []
        src, dst = admitted
        n = len(src)
        self._closed_partial = n % self.eb != 0
        out: list = []
        staged: list = []       # checkpoints due mid-call
        num_w = -(-n // self.eb)
        if call_span:
            call_span.attrs.update(windows=num_w, edges=n)
        with (telemetry.span("engine.chunks", profile=call_span.profile,
                             **call_span.attrs) if call_span else _OFF):
            # long calls run under the tuner, which picks each round's
            # (windows per dispatch, wire); GS_AUTOTUNE=0 or a short call
            # runs the static arm, with the same summaries
            tuner = (self._ensure_tuner()
                     if self.AUTOTUNE and autotune.enabled()
                     and num_w > self.MAX_WINDOWS else None)
            self._run_chunks(src, dst, num_w, tuner, out, staged)
        if self._ckpt_path is not None:
            if self._ckpt_policy.due(self.windows_done):
                self._ckpt_policy.mark(self.windows_done)
                staged.append(self.state_dict())
            # only the last two can survive save's rotation
            for snap in staged[-2:]:
                checkpoint.save(self._ckpt_path, snap)
                # journal retention (GS_WAL_RETAIN): what the snapshot's
                # replay cursor covers
                self._wal_retention.flushed(
                    self._wal, self._wal_tenant,
                    int(snap["windows_done"]) * self.eb)
        return out

    def _admit(self, src, dst):
        """Admission: the `admit` fault site, the sanitizer, the int32
        arrays, the partial-window guard, the id check, the journal
        append and `latency.on_admit`. Returns the admitted (src, dst),
        or None for an empty call."""
        lat = latency.enabled()
        t_admit = latency.clock() if lat else 0.0
        metrics.on_stream_start(type(self).__name__)
        got = faults.fire("admit", (self._wal_tenant, src, dst))
        if got is not None:
            _t, src, dst = got
        if sanitize_mod.enabled():
            try:
                rep = sanitize_mod.sanitize(
                    src, dst, self.vb, tenant=self._wal_tenant,
                    origin="engine", offset=self._fed_edges,
                    dlq=sanitize_mod.resolve_dlq())
            except sanitize_mod.BatchRejected as e:
                self._fed_edges += e.size
                raise
            self._fed_edges += rep.accepted + rep.rejected
            src, dst = rep.src, rep.dst
        else:
            self._fed_edges += len(np.atleast_1d(np.asarray(src)))
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        n = len(src)
        if n == 0:
            return None
        if self._closed_partial:
            raise ValueError(
                "a previous process() call closed a partial window "
                "(length not a multiple of edge_bucket); reset() before "
                "feeding more of the stream")
        self._validate(src, dst)
        if self._wal is not None:
            # journal before the fold; the admission stamp rides the ts
            # column, so replayed windows keep their admission time
            self._wal.append(
                self._wal_tenant, src, dst,
                np.full(n, latency.admit_ns(t_admit), np.int64)
                if lat else None)
            faults.fire("wal_enqueue", self._wal_tenant)
        if lat and self._lat_admit:
            latency.on_admit(self._lat_lane or self._wal_tenant, n,
                             t0=t_admit)
        return src, dst

    def _run_chunks(self, src, dst, num_w: int, tuner, out: list,
                    staged: list) -> None:
        """The one chunk loop: windows [0, num_w) through the ingress
        pipeline over an autotune.RoundPlan (the static arm
        (MAX_WINDOWS, ingress), or the tuner's arm a round, warmed
        first). Each chunk's stack is built from the raw edges in its
        prep on the pool (a ragged tail pads its window axis to a power
        of two with empty windows, which fold as no-ops apart from the
        cover's sentinel join, as in the JAX engine) and copied to its
        staging slot; dispatches go in chunk order on this thread; each
        chunk's outputs are read, its windows counted into
        `windows_done` and its hooks run one chunk behind. A checkpoint
        due at a chunk's dispatch goes to `staged`."""

        def on_round(arm, windows):
            if tuner is not None:
                self._warm_arm(arm)
            self._prepare_round(_round_widths(windows, arm["wb"]),
                                arm["ingress"])

        base = self.windows_done
        plan = autotune.RoundPlan(
            num_w, {"wb": self.MAX_WINDOWS, "ingress": self.ingress}, tuner,
            on_round=on_round, span="fused_scan.round", base=base)
        eb = self.eb
        # the hooks' knobs, read once a call
        lat = latency.enabled()
        prov = provenance.armed()
        marks = metrics.enabled()
        lane = self._lat_lane or self._wal_tenant

        def prep(ch):
            st = {} if lat else None
            latency.stamp(st, "start")
            wb, wire = ch.arm["wb"], ch.arm["ingress"]
            lo, hi_e = ch.at * eb, min(ch.hi * eb, len(src))
            if wire == "compact":
                m, *stack = compact_ingress.window_stack(
                    src[lo:hi_e], dst[lo:hi_e], eb)
                sc, dc, vc, real = compact_ingress.pad_chunk(
                    *stack, 0, m, wb, eb)
            else:
                m, *stack = seg_ops.window_stack(
                    src[lo:hi_e], dst[lo:hi_e], eb, sentinel=self.vb)
                sc, dc, vc, real = seg_ops.pad_window_chunk(
                    *stack, 0, m, wb, eb, self.vb)
            latency.stamp(st, "prep")
            return ch, real, (sc, dc, vc), st

        def h2d(payload):
            ch, real, args, st = payload
            dev = self._h2d(args, ch.seq)
            latency.stamp(st, "h2d")
            return ch, real, dev, st

        def dispatch(dev_payload):
            ch, real, dev, st = dev_payload
            self._stage_ckpt_at(base, ch.at, staged)
            raw = self._dispatch_async(dev, ch.arm["ingress"])
            latency.stamp(st, "dispatch")
            return ch, real, raw, st

        def finalize(item):
            ch, real, raw, st = item
            done0 = self.windows_done
            self._finalize_summaries(ch.at, self._materialize(raw)[:, :real],
                                     src, dst, out)
            lo_c = ch.at * eb
            if lat or prov:
                for w in range(real):
                    lo_w = lo_c + w * eb
                    n_w = min(lo_w + eb, len(src)) - lo_w
                    if lat:
                        latency.on_window(lane, edges=n_w, st=st,
                                          ordinal=done0 + w,
                                          defer=self._lat_defer)
                    if prov:
                        lo = (done0 + w) * eb
                        provenance.emit(
                            tenant=lane, window=done0 + w, wal_lo=lo,
                            wal_hi=lo + n_w, tier=self.METRICS_TIER,
                            program=self.PROGRAM,
                            summary=out[len(out) - real + w])
            if marks:
                metrics.mark_window(
                    real, min(lo_c + real * eb, len(src)) - lo_c,
                    engine=type(self).__name__, tier=self.METRICS_TIER)
            plan.done(ch, (ch.hi - ch.at) * eb)

        slots = self.INGEST_SLOTS
        try:
            ingress_pipeline.run_pipeline(
                plan, prep, h2d, dispatch, finalize,
                timers=self.stage_timers,
                inflight=self.INFLIGHT if slots is None else slots,
                call=self._calls, first_window=base)
        except BaseException:
            if self._ring is not None:
                self._ring.release_all()
            raise
        plan.close()

    def _ring_slots(self) -> int:
        """Staging slots of the engine's ring: one more than the
        look-ahead, so chunk i + look-ahead + 1 waits for chunk i."""
        slots = self.INGEST_SLOTS
        return (self.INFLIGHT if slots is None else slots) + 1

    def _prepare_round(self, widths, wire: str) -> None:
        """Hook as a round of chunks of `widths` windows on `wire` is
        decided, before its first chunk is prepped (the resident engines
        capture their graphs here)."""

    # -- online autotuning (ops/autotune.py) ---------------------------

    def _ensure_tuner(self) -> autotune.DispatchTuner:
        """The engine's tuner: wb rungs {MAX/4, MAX/2, MAX} and, where
        the wire is tunable and not pinned, both wires (compact where
        the vertex bucket fits uint16)."""
        if self._tuner is None:
            wbm = self.MAX_WINDOWS
            wbs = autotune.rungs(wbm)
            ing = [self.ingress]
            if self.TUNABLE_INGRESS and not self._pinned_ingress:
                ing = ["standard"]
                if compact_ingress.supports(self.vb):
                    ing.append("compact")
            init = {"wb": wbm, "ingress": (self.ingress if self.ingress
                                           in ing else "standard")}
            self._tuner = autotune.DispatchTuner(
                "%s:eb=%d:vb=%d" % (self.TUNER_FAMILY, self.eb, self.vb),
                {"wb": wbs, "ingress": ing}, init,
                backend=self._tuner_backend())
        return self._tuner

    def _tuner_backend(self) -> str:
        return getattr(getattr(self, "device", None), "type", "cpu")

    def _warm_arm(self, arm: dict) -> None:
        """Before an arm's first timed round: one all-padding chunk at
        its shape through the kernels, on a throwaway carry (the live
        carry is not touched), waited for. A no-op on the CPU, where
        there is nothing to build."""


class StreamSummaryEngine(SummaryEngineBase):
    """Carried-state analytics over chunks of windows at fixed buckets
    (edge_bucket, vertex_bucket, k_bucket), one `WindowSummary` call per
    MAX_WINDOWS windows. Exact: triangle windows whose hubs overflow K
    are recounted by a `TriangleWindowKernel` at 4·K.

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. `ingress` "standard" is
    the standard wire; "compact" the compact one, which raises
    ValueError for vertex_bucket > 65536; None routes by the device's
    `ingress_ab` rows (ops/triangles.resolve_ingress; standard without
    them). `k_bucket=0` is ops/triangles._tuned_kb (the analytic default
    without `k_sweep` rows)."""

    AUTOTUNE = True
    TUNABLE_INGRESS = True

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, device=None, ingress: str = None):
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.kb = seg_ops.bucket_size(
            k_bucket if k_bucket else _tuned_kb(self.eb, self.device))
        self.ingress = resolve_ingress(ingress, self.vb, self.device)
        # an explicit wire pins it for the tuner too
        self._pinned_ingress = ingress is not None
        self._tuner = None
        self._warmed = set()
        self.stage_timers = ingress_pipeline.StageTimers()
        self._summary = WindowSummary(self.vb, self.kb, self.device)
        self._ring = ChunkStager(self.device, slots=self._ring_slots())
        self._tri_fallback = TriangleWindowKernel(
            self.eb, self.vb, k_bucket=4 * self.kb, device=self.device)
        # the dispatch of each wire, under the metrics' shape watch
        self._runs = {
            wire: metrics.wrap_dispatch(
                name, lambda carry, *stack, wire=wire:
                self._fold(carry, stack, wire))
            for wire, name in (("standard", "fused_scan"),
                               ("compact", "fused_scan_compact"))}
        self.reset()

    def _init_carry(self):
        return fresh_carry(self.vb, self.device)

    def _to_carry(self, a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.int32)).to(self.device)

    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(degrees[vb], cc_labels[vb], odd[vb]) snapshots."""
        deg, labels, cover = (x.cpu().numpy().copy() for x in self._carry)
        odd = cover[:self.vb] == cover[self.vb + 1:2 * self.vb + 1]
        return deg[:self.vb], labels[:self.vb], odd

    def _check_carry(self, carry) -> None:
        check_summary_carry(carry, self.vb)

    def warm_fallback(self) -> None:
        """Build the overflow recount's kernels before a stream needs
        them."""
        self._redo(np.array([0]), np.array([1]))

    def _validate(self, src, dst) -> None:
        """On the compact wire through compact_ingress.validate_ids: an
        id the uint16 cast would wrap is refused on the main thread, with
        the standard wire's message (vb ≤ 65536 there)."""
        if self.ingress == "compact":
            compact_ingress.validate_ids(src, dst, self.vb, "summary engine")
        else:
            _validate_ids(src, dst, self.vb)

    def _dispatch_async(self, staged, wire: str):
        out = self._launch(self._ring.take(staged), wire,
                           self._ring.slot_index(staged))
        self._ring.done(staged)
        return HostCopy(out)

    def _launch(self, tensors, wire: str, slot: int) -> torch.Tensor:
        """Fold one staged chunk into the carry: its [5, W] int32 outputs
        (`slot`, the chunk's staging slot, names the resident engine's
        graph)."""
        return self._runs[wire](self._carry, *tensors)

    def _fold(self, carry, tensors, wire: str) -> torch.Tensor:
        """The summary call on one chunk, its five [W] outputs as one
        [5, W] int32 tensor."""
        return torch.stack([x.to(torch.int32) for x in
                            self._summary(carry, *tensors, wire)])

    def _warm_arm(self, arm: dict) -> None:
        key = (arm["wb"], arm["ingress"])
        if self.device.type != "cuda" or key in self._warmed:
            return
        w, eb, dev = arm["wb"], self.eb, self.device
        if arm["ingress"] == "compact":
            z16 = torch.zeros(w, eb, dtype=torch.uint16, device=dev)
            stack = (z16, z16.clone(),
                     torch.zeros(w, dtype=torch.int32, device=dev))
        else:
            pad = torch.full((w, eb), self.vb, dtype=torch.int32, device=dev)
            stack = (pad, pad.clone(),
                     torch.zeros(w, eb, dtype=torch.bool, device=dev))
        self._summary(fresh_carry(self.vb, dev), *stack, arm["ingress"])
        torch.cuda.synchronize(dev)
        self._warmed.add(key)

    def _redo(self, src, dst) -> int:
        """Exact triangle count of one window."""
        return self._tri_fallback.count(src, dst)

    def _finalize_summaries(self, at: int, res: np.ndarray, src, dst,
                            out: list) -> None:
        """One chunk's [5, real] outputs (`res`, from `_materialize`; the
        chunk's first window is window `at` of this call) into summary
        dicts, each overflowing window's triangles recounted exactly."""
        mdeg, ncomp, odd, tri, k_ovf = res
        tri = tri.copy()
        for w in np.nonzero(k_ovf)[0]:
            lo = (at + int(w)) * self.eb
            tri[w] = self._redo(src[lo:lo + self.eb], dst[lo:lo + self.eb])
        for w in range(res.shape[1]):
            out.append({"max_degree": int(mdeg[w]),
                        "num_components": int(ncomp[w]),
                        "odd_cycle": bool(odd[w]),
                        "triangles": int(tri[w])})
        self.windows_done += res.shape[1]


class SlidingSummaryEngine:
    """Sliding windows by pane composition (`slide=`): an inner
    StreamSummaryEngine at edge_bucket=slide folds each edge into its
    pane once. The cumulative analytics (max_degree, num_components,
    odd_cycle) read the carry at every pane boundary; the per-window
    analytic (triangles) recounts each emission over a ring of the last
    panes_per_window − 1 pane slabs plus the fresh pane, through a
    TriangleWindowKernel at the full window bucket. Both run the standard
    wire.

    One summary dict per emission: every `slide` edges, the window over
    the trailing `edge_bucket` edges (growing at the head of the
    stream, ragged on a final partial pane). The ring rides
    state_dict()/load_state_dict()."""

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 slide: int, k_bucket: int = 0, device=None):
        eb = seg_ops.bucket_size(edge_bucket)
        slide = int(slide)
        if slide <= 0 or slide > eb or eb % slide \
                or slide & (slide - 1):
            raise ValueError(
                "slide must be a power of two dividing the window "
                "size (%d), got %d" % (eb, slide))
        self.eb = eb
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.slide = slide
        self.panes_per_window = eb // slide
        self.inner = StreamSummaryEngine(slide, self.vb, k_bucket=k_bucket,
                                         device=device)
        self._tri = TriangleWindowKernel(eb, self.vb, k_bucket=k_bucket,
                                         device=device)
        self._ring = []   # the last panes_per_window − 1 (src, dst) panes

    @property
    def windows_done(self) -> int:
        """Emissions done (the inner engine's pane cursor)."""
        return self.inner.windows_done

    def reset(self) -> None:
        self.inner.reset()
        self._ring = []

    def resume_offset(self) -> int:
        return self.inner.windows_done * self.slide

    def process(self, src, dst) -> list:
        """Fold the stream's slide-sized panes; one summary per pane.
        Mid-stream calls must be multiples of `slide`; a ragged call
        closes the stream with a final partial emission."""
        if sanitize_mod.enabled():
            # sanitized here, so the pane slabs below slice the arrays
            # the inner engine folds (its own pass finds them clean);
            # before the int32 cast, which would wrap an id past 2^31
            # into a small one (the JAX engine casts first)
            rep = sanitize_mod.sanitize(
                src, dst, self.vb, tenant=self.inner._wal_tenant,
                origin="engine", offset=self.inner._fed_edges,
                dlq=sanitize_mod.resolve_dlq())
            src, dst = rep.src, rep.dst
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        summaries = self.inner.process(src, dst)
        wp, s = self.panes_per_window, self.slide
        out = []
        spans = telemetry.active()
        for i, pane_sum in enumerate(summaries):
            lo, hi = i * s, min((i + 1) * s, len(src))
            pane = (src[lo:hi], dst[lo:hi])
            slab = self._ring + [pane]
            t0 = telemetry.clock()
            tri = self._tri.count(np.concatenate([p[0] for p in slab]),
                                  np.concatenate([p[1] for p in slab]))
            if spans:
                telemetry.record_span(
                    "sliding.emit", t0, telemetry.clock() - t0,
                    panes=len(slab), edges=sum(len(p[0]) for p in slab))
            row = dict(pane_sum)
            row["triangles"] = int(tri)
            out.append(row)
            self._ring = slab[-(wp - 1):] if wp > 1 else []
        return out

    def state_dict(self) -> dict:
        return {
            "slide": self.slide,
            "edge_bucket": self.eb,
            "vertex_bucket": self.vb,
            "ring_src": [np.asarray(s) for s, _d in self._ring],
            "ring_dst": [np.asarray(d) for _s, d in self._ring],
            "inner": self.inner.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        ck = (int(state["slide"]), int(state["edge_bucket"]),
              int(state["vertex_bucket"]))
        if ck != (self.slide, self.eb, self.vb):
            raise ValueError(
                "sliding checkpoint was taken at slide=%d eb=%d vb=%d; "
                "engine runs slide=%d eb=%d vb=%d" % (
                    ck + (self.slide, self.eb, self.vb)))
        self._ring = [(np.asarray(s, np.int32), np.asarray(d, np.int32))
                      for s, d in zip(state["ring_src"],
                                      state["ring_dst"])]
        self.inner.load_state_dict(state["inner"])


def check_summary_carry(carry, vb: int) -> None:
    """Raise ValueError for a host carry the summary kernels cannot load:
    they take int32-valued deg[vb+1] ≥ 0, and labels[vb+1],
    cover[2(vb+1)] each pointing every slot at an equal or smaller one
    (the forest the union-find relies on). They read the summaries
    incrementally (csrc/summary_body.cuh), which rests on two more
    invariants of every carry the engines of either package make: a
    vertex of degree 0 is a singleton root in labels (no u with
    labels[u] != u where deg[u] == 0 or deg[labels[u]] == 0), and the
    cover's sets are closed under the mirror v <-> v+vb+1 (the mirrors
    of one set's members lie in one set)."""
    if len(carry) != 3:
        raise ValueError("carry must be (deg, labels, cover)")
    deg, labels, cover = (np.asarray(a) for a in carry)
    for name, a, n in (("deg", deg, vb + 1), ("labels", labels, vb + 1),
                       ("cover", cover, 2 * (vb + 1))):
        if a.shape != (n,) or not np.issubdtype(a.dtype, np.integer):
            raise ValueError("carry %s must be an integer array of %d "
                             "slots, got %s %s" % (name, n, a.dtype,
                                                   a.shape))
    if deg.min() < 0 or deg.max() >= 2 ** 31:
        raise ValueError("carry deg out of int32 range")
    for name, a in (("labels", labels), ("cover", cover)):
        if a.min() < 0 or np.any(a > np.arange(len(a))):
            raise ValueError("carry %s must point every slot at an "
                             "equal or smaller slot" % name)
    moved = labels != np.arange(vb + 1)
    if np.any(moved & ((deg == 0) | (deg[labels] == 0))):
        raise ValueError("carry labels must keep every vertex of degree 0 "
                         "a singleton root")
    root = cover.astype(np.int64)
    while True:                      # pointer jumping to the roots
        up = root[root]
        if np.array_equal(up, root):
            break
        root = up
    mirror = (np.arange(2 * (vb + 1)) + vb + 1) % (2 * (vb + 1))
    if np.any(root[mirror] != root[mirror[root]]):
        raise ValueError("carry cover's sets must be closed under the "
                         "mirror v <-> v+vb+1")


def _round_widths(num_w: int, wb: int) -> set:
    """The window counts of the chunks of a run of num_w windows in
    chunks of wb (a ragged tail padded as pad_window_chunk pads it)."""
    widths = {wb} if num_w >= wb else set()
    if num_w % wb:
        widths.add(min(seg_ops.bucket_size(num_w % wb), wb))
    return widths


def _to_host(x) -> np.ndarray:
    """A copy of one carry leaf as a host array (a tensor on any device,
    or a numpy array: the host twins' carry)."""
    return np.array(x.cpu() if isinstance(x, torch.Tensor) else x)


def _validate_ids(src: np.ndarray, dst: np.ndarray, vb: int) -> None:
    """Raise ValueError for an id outside [0, vb): it would fold into the
    sentinel's or another vertex's carried state."""
    bot = int(min(src.min(), dst.min()))
    top = int(max(src.max(), dst.max()))
    if bot < 0 or top >= vb:
        raise ValueError("vertex id %d outside [0, %d) in summary engine "
                         "input" % (bot if bot < 0 else top, vb))

