"""Exact per-window triangle counting over an edge stream: the port's
main path.

Port of the JAX package's `ops/triangles.py` (:287-438, :783-1305):
`TriangleWindowKernel.count_stream` cuts the stream into tumbling
windows of `edge_bucket` edges, stacks them [W, eb] on the standard or
the compact wire (`ingress`, ops/compact_ingress.py) and counts them in
chunks of up to MAX_STREAM_WINDOWS through the ingress pipeline
(ops/ingress_pipeline.py: chunk prep and h2d on a worker pool, the
window counter dispatched in chunk order, each chunk's outputs read one
chunk behind). The counter is ops/window_counter.py: the CUDA kernels on
a card, the plain PyTorch version on the CPU. A window whose hubs
outrun the K bucket (overflow > 0) is recounted exactly: up the K
ladder to `kb_max`, then by `triangle_count_sparse`, a host CSR build
intersected on the device. `triangle_count` counts one window of any
size: the dense contraction (ops/dense_triangles.py) up to
2·DENSE_LIMIT vertices, the sparse path past it.

Stream tiers (`stream_tier=` of `TriangleWindowKernel`): "device" (the
kernels above), "host" (the numpy counter, ops/host_triangles.py) or
"native" (the C++ counter of native/ingest.cpp, one call per slice of
windows on the ingress pool). All three give the same counts for ids
below the vertex bucket. A pinned "native" raises where the library
cannot load; it never becomes "host".

Measured adoption (the JAX package's :166-229, :449-657, utils/evidence.py
here): what the caller leaves unset is routed by the rows measured on the
engine's device, and adopted only where every row shows parity and a 5%
win (`rows_clear_bar`); with no evidence file every default stands.
`stream_tier=None` resolves through `_resolve_stream_impl(eb, device)`
(`host_stream` rows: on the CPU one tier for the process, on a card one
per edge bucket from that bucket's rows), `ingress=None` through
`resolve_ingress` (`ingress_ab` rows, gated by the vertex bucket),
`k_bucket=0` through `_tuned_kb` and the windows per call through
`_tuned_chunk` (the fastest `window`/`chunk_deep` sweep row of the
bucket; `default_kb` and MAX_STREAM_WINDOWS where none). The JAX
package's compile caps (`compile_cap`, `capped_chunk`) are caps of a TPU
compiler and have no counterpart.

A device-tier `count_stream` of more than MAX_STREAM_WINDOWS windows runs
under the online dispatch tuner (ops/autotune.py, GS_AUTOTUNE on by
default; the JAX kernel's `_tuner_space`, `_ensure_tuner`, `_warm_arm`
and `_run_stack_tuned`, triangles.py:1040-1140 there, engaged as at
:1240-1248): rounds of GS_AUTOTUNE_ROUND chunks, each at the tuner's arm
of wb rungs {16, 32, 64}, the first three K rungs of the escalation
ladder and both wires where vb ≤ 65536. The JAX kernel runs each round
as a pipeline of its own; here the tuned and the static call are one
chunk loop (`_run_stack_loop` over an autotune.RoundPlan) whose arm may
change between chunks without draining. Counts are the same at every
arm (the overflow recount keeps them exact at any K). A pinned
`k_bucket=` or `ingress=` freezes its dimension; `forced_sync` freezes
the tuner.

Hooks: `count_stream` marks its windows for the health plane
(`metrics.mark_window`, engine "triangle_stream", its tier) and a tuned
call records a `triangles.round` span a round (the JAX kernel's
:1134, :1214-1231); each counter call is a launch of the cost
observatory (ops/window_counter.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import native
from ..core.platform import resolve_device
from ..utils import evidence
from ..utils import metrics
from . import autotune
from . import compact_ingress
from . import host_triangles
from . import ingress_pipeline
from . import intersect as _intersect
from . import segment as seg_ops
from .dense_triangles import triangle_count_dense
from .staging import ChunkStager, HostCopy
from .window_counter import (WindowCounter, dedupe_and_positions,
                             orient_by_degree)

__all__ = ["DENSE_LIMIT", "STREAM_TIERS", "TriangleWindowKernel",
           "build_window_counter", "rows_clear_bar",
           "default_kb", "dedupe_and_positions", "orient_by_degree",
           "resolve_ingress", "triangle_count", "triangle_count_dense",
           "triangle_count_sparse"]

# the JAX package's XLA dense limit; its fused contraction, which the
# port's dense kernel replaces, is exact to twice it
DENSE_LIMIT = 2048

STREAM_TIERS = ("device", "host", "native")


def check_stream_tier(tier: str) -> str:
    """`tier` if it is one of STREAM_TIERS and can run here: a "native"
    tier needs the C++ library and raises without it."""
    if tier not in STREAM_TIERS:
        raise ValueError("unknown stream tier %r (choices: %s)"
                         % (tier, ", ".join(STREAM_TIERS)))
    if tier == "native" and not native.available():
        raise RuntimeError("native stream tier pinned, but the native "
                           "library is unavailable: %s"
                           % native.build_error())
    return tier


def _native_count(src: np.ndarray, dst: np.ndarray, eb: int) -> list:
    counts = native.triangle_count_stream(src, dst, eb)
    if counts is None:
        raise RuntimeError("native library unavailable: %s"
                           % native.build_error())
    return [int(x) for x in counts]


def _native_window(window) -> int:
    """The native count of one (src, dst) window."""
    src, dst = window
    counts = _native_count(src, dst, max(len(src), 1))
    return counts[0] if counts else 0


def _native_count_stream_parallel(src: np.ndarray, dst: np.ndarray,
                                  eb: int) -> list:
    """The native tier of count_stream across the ingress pool: the
    stream cut into window-aligned slices, one C++ call each (ctypes
    drops the GIL), the counts joined in order; where the pipeline is
    off (`ingress_pipeline.pipeline_enabled()`: forced_sync,
    GS_STREAM_PREFETCH=0, no workers) one call for the whole stream. The
    same counts either way."""
    if not ingress_pipeline.pipeline_enabled():
        return _native_count(src, dst, eb)
    num_w = -(-len(src) // eb)
    # ~4 slices a worker keeps the pool busy through uneven windows
    groups = max(1, min(num_w,
                        4 * max(1, ingress_pipeline.worker_count())))
    per = -(-num_w // groups)

    def one(at):
        return _native_count(src[at * eb:(at + per) * eb],
                             dst[at * eb:(at + per) * eb], eb)

    parts = ingress_pipeline.map_ordered(one, range(0, num_w, per))
    return [c for part in parts for c in part]


def default_kb(eb: int) -> int:
    """The analytic starting K of an edge bucket: min(128, 2·⌊√eb⌋)
    (the JAX package's fallback when no tuning evidence exists)."""
    return min(128, 2 * math.isqrt(eb))


rows_clear_bar = evidence.rows_clear_bar

# ----------------------------------------------------------------------
# measured adoption (the JAX package's :449-657)
# ----------------------------------------------------------------------


def _reset_stream_impl() -> None:
    """Test hook: forget the memoized stream tiers."""
    evidence.forget("stream_impl")


def _reset_ingress() -> None:
    """Test hook: forget the memoized wire selections."""
    evidence.forget("ingress")


def _reset_tuned() -> None:
    """Test hook: forget the memoized K and chunk selections."""
    evidence.forget("tuned_kb")
    evidence.forget("tuned_chunk")


def _pick_host_tier(rows, card: bool = False) -> str:
    """The tier of a set of `host_stream` rows: "host" where the numpy
    counter clears the device path on every row, "native" where the C++
    counter also clears both and its library loads, else "device". On a
    card (`card`) the rows clear in their worst turns
    (`evidence.worst_clears_bar`)."""
    if card:
        host = evidence.worst_clears_bar(rows, "host", "device")
        nat = evidence.worst_clears_bar(rows, "native", ("device", "host"),
                                        parity_key="native_parity")
    else:
        host = rows_clear_bar(rows, "host_edges_per_s", "device_edges_per_s")
        nat = rows_clear_bar(rows, "native_edges_per_s",
                             lambda r: max(r.get("device_edges_per_s") or 0,
                                           r.get("host_edges_per_s") or 0),
                             parity_key="native_parity")
    if nat and native.triangles_available():
        return "native"
    return "host" if host else "device"


def _resolve_stream_impl(eb: int = None, device=None) -> str:
    """The stream tier of a kernel given none, from the `host_stream`
    rows of its device: on the CPU one tier for the process from all its
    rows; on a card one tier per edge bucket from that bucket's rows
    (`eb=None` there is "device"). "device" without evidence."""

    def whole(perf, label):
        return _pick_host_tier(perf.get("host_stream", []))

    def bucket(perf, label):
        rows = [r for r in perf.get("host_stream", [])
                if r.get("edge_bucket") == eb]
        return _pick_host_tier(rows, card=True) if rows else "device"

    if not evidence.on_card(evidence.device_label(device)):
        return evidence.choose("stream_impl", device, whole, "device")
    if eb is None:
        return "device"
    return evidence.choose("stream_impl", device, bucket, "device", key=eb)


def _fastest_sweep_row(perf: dict, eb: int, sweep_key: str, value_key: str,
                       default):
    """The value of the fastest measured row (least per_window_ms, its
    recounts included) of this bucket's `sweep_key` sweeps in the
    `window` and `chunk_deep` sections of `perf`; `default` where none.
    Rows without the value key are skipped; the value is at least 1."""
    rows = (list(perf.get("window", []) or [])
            + list(perf.get("chunk_deep", []) or []))
    measured = [s for row in rows
                if isinstance(row, dict) and row.get("edge_bucket") == eb
                for s in row.get(sweep_key, []) or []
                if s.get("per_window_ms") and s.get(value_key)]
    if not measured:
        return default
    return max(1, int(min(measured,
                          key=lambda s: s["per_window_ms"])[value_key]))


def _tuned_kb(eb: int, device=None) -> int:
    """The starting K of an edge bucket: the fastest `k_sweep` row of
    the device's evidence for it, else `default_kb(eb)`."""
    return evidence.choose(
        "tuned_kb", device,
        lambda perf, label: _fastest_sweep_row(perf, eb, "k_sweep",
                                               "k_bucket", default_kb(eb)),
        default_kb(eb), key=eb)


def _tuned_chunk(eb: int, device=None) -> int:
    """Windows per count_stream call: the fastest `chunk_sweep` row of
    the device's evidence for the bucket, else MAX_STREAM_WINDOWS (the
    class default, read live)."""
    got = evidence.choose(
        "tuned_chunk", device,
        lambda perf, label: _fastest_sweep_row(
            perf, eb, "chunk_sweep", "windows_per_dispatch", None),
        None, key=eb)
    return TriangleWindowKernel.MAX_STREAM_WINDOWS if got is None else got


def resolve_ingress(ingress, vb: int, device=None) -> str:
    """The wire of a stream engine at vertex bucket vb: "standard" or
    "compact" as pinned (a pinned "compact" raises ValueError where ids
    may not fit uint16, the JAX engines' message); None is "compact"
    only where the device's `ingress_ab` rows all show parity and a 5%
    win (on a card, in their worst turns) and the ids of vb fit uint16,
    else "standard"."""
    if ingress is None:

        def gate(perf, label):
            rows = perf.get("ingress_ab", [])
            if evidence.on_card(label):
                won = evidence.worst_clears_bar(rows, "compact", "std")
            else:
                won = rows_clear_bar(rows, "speedup", lambda r: 1.0)
            return "compact" if won else "standard"

        if (evidence.choose("ingress", device, gate, "standard")
                == "compact" and compact_ingress.supports(vb)):
            return "compact"
        return "standard"
    if ingress == "standard":
        return "standard"
    if ingress != "compact":
        raise ValueError("unknown ingress %r (choices: 'standard', "
                         "'compact')" % (ingress,))
    if not compact_ingress.supports(vb):
        raise ValueError("compact ingress is lossy for vertex_bucket %d "
                         "(ids must fit uint16)" % vb)
    return "compact"


def build_window_counter(vb: int, kb: int, device=None) -> WindowCounter:
    """The window counter at (vb, kb) on `device`: counter(src[W, eb],
    dst, valid) -> (count[W], overflow[W]) int32, keeping its device
    scratch across calls."""
    return WindowCounter(vb, kb, resolve_device(device))


def triangle_count_sparse(src: np.ndarray, dst: np.ndarray,
                          num_vertices: int, device=None) -> int:
    """Exact count of one window of any size: undirect + dedupe, orient
    by (degree, id), CSR rows on the host (numpy, as the JAX package's
    :287-327), then the row intersection on `device`."""
    device = resolve_device(device)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if len(src) == 0:
        return 0
    # undirect + dedupe
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    und = np.unique(lo * num_vertices + hi)
    lo, hi = und // num_vertices, und % num_vertices
    # orient low-rank → high-rank by (degree, id)
    deg = np.bincount(np.concatenate([lo, hi]), minlength=num_vertices)
    rank = np.argsort(np.argsort(deg.astype(np.int64) * num_vertices
                                 + np.arange(num_vertices)))
    a = np.where(rank[lo] < rank[hi], lo, hi).astype(np.int32)
    b = np.where(rank[lo] < rank[hi], hi, lo).astype(np.int32)
    e = len(a)
    order = np.argsort(a.astype(np.int64) * num_vertices + b, kind="stable")
    a, b = a[order], b[order]
    counts = np.bincount(a, minlength=num_vertices)
    starts = np.zeros(num_vertices + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    max_out = seg_ops.bucket_size(int(counts.max()))
    vb = seg_ops.bucket_size(num_vertices)
    nbr = np.full((vb + 1, max_out), vb, np.int32)
    nbr[a, np.arange(e) - starts[a]] = b  # ascending within each row
    ep = seg_ops.bucket_size(e)
    args = (nbr, seg_ops.pad_to(a, ep, fill=vb),
            seg_ops.pad_to(b, ep, fill=vb),
            seg_ops.pad_to(np.ones(e, bool), ep, fill=False))
    count = _intersect.intersect_local(
        *(torch.from_numpy(x).to(device) for x in args), ascending=True)
    return int(count)


def triangle_count(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   device=None) -> int:
    """Exact triangle count of one window: the dense contraction for
    num_vertices ≤ 2·DENSE_LIMIT (where its float32 partials stay
    exact), `triangle_count_sparse` above. Where the CPU's `host_stream`
    evidence routes the stream tier to "native" or "host"
    (`_resolve_stream_impl()`: on a card, always "device"), that tier
    counts the window instead: the same count."""
    tier = _resolve_stream_impl(device=device)
    if tier == "native":
        counts = native.triangle_count_stream(
            np.asarray(src), np.asarray(dst), max(len(src), 1))
        if counts is not None:
            return int(counts[0]) if len(counts) else 0
        tier = "host"
    if tier == "host":
        return host_triangles.window_count(src, dst)
    if num_vertices <= 2 * DENSE_LIMIT:
        return triangle_count_dense(src, dst, num_vertices, device)
    return triangle_count_sparse(src, dst, num_vertices, device)


class TriangleWindowKernel:
    """Exact triangle counts of an unbounded stream of windows over fixed
    buckets (edge_bucket, vertex_bucket, k_bucket).

    The host sends only the raw COO stack of a chunk, on the standard
    wire (9 bytes per slot: int32 src, int32 dst, bool valid) or, with
    `ingress="compact"`, the compact one (4 bytes per slot: uint16 ids,
    plus one int32 valid count per window; vertex_bucket ≤ 65536). Stream
    chunks go through the ingress pipeline: prep and one pinned copy per
    chunk on the pool's workers (a ring of `INFLIGHT + 1` staging slots,
    ops/staging.ChunkStager), the counter dispatched in chunk order, the
    (count, overflow) of each window copied back and read one chunk
    behind. `overflow` > 0 means some vertex's oriented out-degree
    exceeded k_bucket; that window is recounted exactly up the K ladder
    (`_escalation_ladder`, 4·K per rung up to kb_max, on the standard
    wire) and, past it, by `triangle_count_sparse`.

    `device=None` means the CUDA card and raises when there is none;
    `device="cpu"` runs the plain PyTorch path. `stream_tier` picks who
    counts `count_stream` and `count_windows` (STREAM_TIERS; `count`,
    the one-window recount, stays on the device). What is left unset
    (`stream_tier=None`, `ingress=None`, `k_bucket=0`, and the windows
    per call) is routed by the device's evidence (module docstring):
    without it "device", the standard wire, `default_kb` and
    MAX_STREAM_WINDOWS.
    """

    MAX_STREAM_WINDOWS = 64  # windows per device call in count_stream
    INFLIGHT = ingress_pipeline.DEFAULT_INFLIGHT   # pipeline look-ahead

    def __init__(self, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, device=None, ingress: str = None,
                 stream_tier: str = None):
        self.device = resolve_device(device)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.stream_tier = check_stream_tier(
            stream_tier if stream_tier is not None
            else _resolve_stream_impl(self.eb, self.device))
        self.kb = seg_ops.bucket_size(
            k_bucket if k_bucket else _tuned_kb(self.eb, self.device))
        self.kb_max = seg_ops.bucket_size(2 * math.isqrt(self.eb))
        # an instance attribute where the device's chunk sweep measured
        # this bucket
        self.MAX_STREAM_WINDOWS = _tuned_chunk(self.eb, self.device)
        self.ingress = resolve_ingress(ingress, self.vb, self.device)
        # an explicit K or wire freezes that dimension for the tuner
        self._pinned_kb = bool(k_bucket)
        self._pinned_ingress = ingress is not None
        self.tuner = None
        self._warmed = set()
        # per-stage wall time of every pipelined stream run through here
        self.stage_timers = ingress_pipeline.StageTimers()
        self._counters = {}
        # the counts a failed call had finalized (its first windows, in
        # order): where a demoting caller counts on from
        self.drained_counts = None
        self._stage = ChunkStager(self.device)         # count(): one slot
        self._ring = ChunkStager(self.device, slots=self.INFLIGHT + 1)

    def _counter(self, kb: int) -> WindowCounter:
        counter = self._counters.get(kb)
        if counter is None:
            counter = build_window_counter(self.vb, kb, self.device)
            self._counters[kb] = counter
        return counter

    def _escalation_ladder(self):
        """K values to try in order: kb, 4·kb, ... up to kb_max."""
        ks, k = [], self.kb
        while k < self.kb_max:
            ks.append(k)
            k *= 4
        ks.append(max(self.kb, self.kb_max))
        return ks

    def _count_stack(self, kb: int, s, d, valid) -> np.ndarray:
        """(count, overflow) of a staged [W, eb] stack at K=kb, as one
        [2, W] host array (one copy back)."""
        c, o = self._counter(kb)(*self._stage(s, d, valid))
        return torch.stack((c, o)).cpu().numpy()

    def count(self, src: np.ndarray, dst: np.ndarray,
              min_k: int = 0) -> int:
        """Exact triangle count of one window batch (dense ids < vb).

        `min_k` skips ladder rungs already known to overflow (count_stream's
        recount passes the K that just failed)."""
        n = len(src)
        if n == 0:
            return 0
        if n > self.eb:
            raise ValueError(f"window of {n} edges exceeds edge bucket "
                             f"{self.eb}")
        s = seg_ops.pad_to(np.asarray(src, np.int32), self.eb, fill=self.vb)
        d = seg_ops.pad_to(np.asarray(dst, np.int32), self.eb, fill=self.vb)
        valid = seg_ops.pad_to(np.ones(n, bool), self.eb, fill=False)
        for kb in self._escalation_ladder():  # widen K only when a hub
            if kb <= min_k:                   # outruns the current table
                continue
            (count,), (overflow,) = self._count_stack(
                kb, s[None], d[None], valid[None])
            if not overflow:
                return int(count)
        return triangle_count_sparse(src, dst, self.vb, self.device)

    def _run_stack_loop(self, num_w: int, make_chunk, get_window,
                        tuner=None) -> list:
        """The one pipelined chunk loop of both wires
        (ingress_pipeline.run_pipeline over an autotune.RoundPlan: the
        static arm (MAX_STREAM_WINDOWS, kb, ingress), or the tuner's arm
        a round): prep `make_chunk(at, hi, wb, wire)` -> (host stacks of
        windows [at:hi] on `wire`, n real windows; a ragged last chunk
        pads its window axis to a power of two) and its h2d into ring
        slot seq run on a worker; the dispatch launches the counter at
        the chunk's K and enqueues the copy back of (count, overflow);
        the finalize, one chunk behind, reads it and recounts exactly
        each window w whose overflow is > 0, from its edges
        `get_window(w)`, up the ladder past that K.
        ingress_pipeline.forced_sync gives the same counts."""
        counts: list = []
        self.drained_counts = counts     # grows as chunks finalize
        plan = autotune.RoundPlan(
            num_w, {"wb": self.MAX_STREAM_WINDOWS, "kb": self.kb,
                    "ingress": self.ingress}, tuner,
            on_round=None if tuner is None
            else lambda arm, _windows: self._warm_arm(arm),
            span="triangles.round")

        def prep(ch):
            args, n = make_chunk(ch.at, ch.hi, ch.arm["wb"],
                                 ch.arm["ingress"])
            return ch, n, args

        def h2d(payload):
            ch, n, args = payload
            return ch, n, self._ring.put(args, ch.seq)

        def dispatch(dev_payload):
            ch, n, staged = dev_payload
            c, o = self._counter(ch.arm["kb"])(*self._ring.take(staged),
                                               wire=ch.arm["ingress"])
            self._ring.done(staged)
            return ch, n, HostCopy(torch.stack((c, o)))

        def finalize(raw):
            ch, n, res = raw
            res = res.numpy()
            c, o = res[0, :n].copy(), res[1, :n]
            for w in np.nonzero(o)[0]:  # rare hub overflow: exact redo
                c[w] = self.count(*get_window(ch.at + int(w)),
                                  min_k=ch.arm["kb"])
            counts.extend(int(x) for x in c)
            plan.done(ch, (ch.hi - ch.at) * self.eb)

        try:
            ingress_pipeline.run_pipeline(
                plan, prep, h2d, dispatch, finalize,
                timers=self.stage_timers, inflight=self.INFLIGHT)
        except BaseException:
            self._ring.release_all()
            raise
        plan.close()
        return counts

    def _run_stack(self, s, d, valid, get_window) -> list:
        """A standard-wire window stack through _run_stack_loop."""

        def make_chunk(at, hi, wb, _wire):
            sc, dc, vc, n = seg_ops.pad_window_chunk(
                s, d, valid, at, hi, wb, self.eb, self.vb)
            return (sc, dc, vc), n

        return self._run_stack_loop(s.shape[0], make_chunk, get_window)

    def _run_stack_compact(self, num_w, s16, d16, nvalid,
                           get_window) -> list:
        """Compact-wire stacks (ops/compact_ingress) through the same
        _run_stack_loop."""

        def make_chunk(at, hi, wb, _wire):
            sc, dc, nv, n = compact_ingress.pad_chunk(
                s16, d16, nvalid, at, hi, wb, self.eb)
            return (sc, dc, nv), n

        return self._run_stack_loop(num_w, make_chunk, get_window)

    # ---- online autotuning (ops/autotune.py) -------------------------

    def _tuner_space(self) -> dict:
        """The arm space: wb rungs under MAX_STREAM_WINDOWS, the first
        three K rungs of the escalation ladder, and both wires (compact
        where the vertex bucket fits uint16); a pinned K or wire is a
        single value."""
        wbs = autotune.rungs(self.MAX_STREAM_WINDOWS)
        kbs = [self.kb] if self._pinned_kb else self._escalation_ladder()[:3]
        ing = [self.ingress]
        if not self._pinned_ingress:
            ing = ["standard"]
            if compact_ingress.supports(self.vb):
                ing.append("compact")
        return {"wb": wbs, "kb": sorted(set(kbs)), "ingress": ing}

    def _ensure_tuner(self) -> autotune.DispatchTuner:
        if self.tuner is None:
            self.tuner = autotune.DispatchTuner(
                "triangle_stream:eb=%d:vb=%d" % (self.eb, self.vb),
                self._tuner_space(),
                {"wb": self.MAX_STREAM_WINDOWS, "kb": self.kb,
                 "ingress": self.ingress}, backend=self.device.type)
        return self.tuner

    def _warm_arm(self, arm: dict) -> None:
        """Before an arm's first timed round: its counter launched once
        on an all-padding chunk at its shape, waited for (the scratch
        sized, the kernel built). A no-op on the CPU."""
        key = (arm["wb"], arm["kb"], arm["ingress"])
        if self.device.type != "cuda" or key in self._warmed:
            return
        w, eb, dev = arm["wb"], self.eb, self.device
        if arm["ingress"] == "compact":
            z16 = torch.zeros(w, eb, dtype=torch.uint16, device=dev)
            stack = (z16, z16, torch.zeros(w, dtype=torch.int32, device=dev))
        else:
            pad = torch.full((w, eb), self.vb, dtype=torch.int32, device=dev)
            stack = (pad, pad, torch.zeros(w, eb, dtype=torch.bool,
                                           device=dev))
        self._counter(arm["kb"])(*stack, wire=arm["ingress"])
        torch.cuda.synchronize(dev)
        self._warmed.add(key)

    def count_stream(self, src: np.ndarray, dst: np.ndarray) -> list:
        """Exact counts of every tumbling `edge_bucket`-sized window of
        the stream (a shorter last window included)."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if len(src) == 0:
            return []
        eb = self.eb
        if self.stream_tier == "native":
            counts = _native_count_stream_parallel(src, dst, eb)
        elif self.stream_tier == "host":
            counts = host_triangles.count_stream(src, dst, eb)
        else:
            counts = self._count_stream_device(src, dst)
        # the health mark lives at this entry only: the chunk loop under
        # it also serves count_windows (the driver's flush), whose
        # windows their owner marks
        metrics.mark_window(len(counts), len(src),
                            engine="triangle_stream",
                            tier=self.stream_tier)
        return counts

    def _count_stream_device(self, src: np.ndarray,
                             dst: np.ndarray) -> list:
        """The device tier of count_stream."""
        eb = self.eb

        n = len(src)
        num_w = -(-n // eb)
        # long streams run under the tuner (the same counts);
        # GS_AUTOTUNE=0 or a short stream runs the static arm
        tuner = (self._ensure_tuner() if autotune.enabled()
                 and num_w > self.MAX_STREAM_WINDOWS else None)

        def get_window(w):
            return src[w * eb:(w + 1) * eb], dst[w * eb:(w + 1) * eb]

        def make_chunk(at, hi, wb, wire):
            # windows [at, hi) stacked from the raw edges, on the worker
            lo, hi_e = at * eb, min(hi * eb, n)
            if wire == "compact":
                m, s16, d16, nv = compact_ingress.window_stack(
                    src[lo:hi_e], dst[lo:hi_e], eb)
                sc, dc, nvc, m = compact_ingress.pad_chunk(
                    s16, d16, nv, 0, m, wb, eb)
                return (sc, dc, nvc), m
            m, s, d, valid = seg_ops.window_stack(
                src[lo:hi_e], dst[lo:hi_e], eb, sentinel=self.vb)
            sc, dc, vc, m = seg_ops.pad_window_chunk(
                s, d, valid, 0, m, wb, eb, self.vb)
            return (sc, dc, vc), m

        return self._run_stack_loop(num_w, make_chunk, get_window, tuner)

    def count_windows(self, windows) -> list:
        """Exact counts of a list of (src, dst) window batches of varying
        lengths (each ≤ edge_bucket), stacked and counted in chunks. If
        it raises, `drained_counts` holds the counts of the windows it
        had finalized, in order (None: none)."""
        self.drained_counts = None
        if not windows:
            return []
        if self.stream_tier == "native":
            # one C++ call a window across the pool, in window order
            return ingress_pipeline.map_ordered(_native_window, windows)
        if self.stream_tier == "host":
            return host_triangles.count_windows(windows)
        if self.ingress == "compact":
            s16, d16, nv = compact_ingress.stack_window_list(windows,
                                                             self.eb)
            return self._run_stack_compact(len(windows), s16, d16, nv,
                                           lambda w: windows[w])
        s, d, valid = seg_ops.stack_window_list(windows, self.eb, self.vb)
        return self._run_stack(s, d, valid, lambda w: windows[w])
