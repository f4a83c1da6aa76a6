"""Columnar windowed neighborhood reduce: `reduceOnEdges` over tumbling
`edge_bucket`-sized windows of a COO value stream at stream rate
(BASELINE.json config #2).

Port of the JAX package's `ops/windowed_reduce.py` (:132-824).
`WindowedEdgeReduce.process_stream(src, dst, val)` returns one (cells,
counts) pair a window: cells[v] the monoid (sum, min, max) of the values
of the window's edges at dense vertex v in the direction (out groups by
src, in by dst, all by both: each edge counts at both ends), counts[v]
how many there were (0: absent; its cell holds the fill, so compare by
counts). A user fn declared associative (`fn=`) takes the flagged scan
of ops/segment.py instead of a monoid.

Tiers, by the `tier=` argument (the JAX package routes by committed
evidence files, `_resolve_reduce_impl` :43; the port reads none of
them):
- "device" (the default): the stream in chunks of up to 64 windows
  through the ingress pipeline (ops/ingress_pipeline.py: prep and h2d on
  the worker pool into a ring of staging slots, dispatch in chunk order,
  outputs read one chunk behind) into the cell-reduce kernel
  (ops/cell_reduce.py, csrc/cell_reduce.cu), on the standard wire
  (int32 cell ids) or with `ingress="compact"` the compact one (uint16
  ids, one valid count a window, vb <= 65536), and back as full rows or
  with `egress="delta"` the touched-cell wire. Values are int32 or
  float32 there, as the JAX package's device tier runs with x64 off, and
  counts int32;
- "host": numpy (bincounts, ufunc.at), the values' own dtype;
- "native": the C++ fused pass of native/ingest.cpp, for signed
  integer values (other values raise: nothing falls back).
All three give the same (cells, counts) a window as the JAX tiers.
Sliding windows (`slide=`, a power of two dividing the window) fold each
edge once into its slide-sized pane (this engine at edge_bucket=slide,
same tier) and compose the last size/slide panes per emission on the
host. `cohort_step` folds N tenants' next windows in one launch.

Ids outside [0, vb] are refused with ValueError on every tier. Not
ported: the telemetry spans (ROADMAP step 1.8) and the evidence routing
of tiers, wires and egress (step 1.7).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import native
from ..core.platform import resolve_device
from . import compact_ingress
from . import ingress_pipeline
from . import segment as seg_ops
from .cell_reduce import cell_reduce, cell_reduce_compact
from .staging import ChunkStager, HostCopy
from .triangles import resolve_ingress

_DIRECTIONS = ("out", "in", "all")
TIERS = ("device", "host", "native")
EGRESS = ("full", "delta")


def _device_cell_fill(name: str, dtype):
    """What an untouched cell of the device tier holds: XLA's
    empty-segment identity (0; +inf / iinfo.max for min; -inf /
    iinfo.min for max). The delta wire's rows are refilled with it, so
    both egress forms are bit-identical cell for cell."""
    dtype = np.dtype(dtype)
    if name == "sum":
        return dtype.type(0)
    if np.issubdtype(dtype, np.floating):
        return np.inf if name == "min" else -np.inf
    info = np.iinfo(dtype)
    return info.max if name == "min" else info.min


def _host_identity(name: str, dtype):
    """Monoid identity of the host tiers and the reference oracle."""
    dtype = np.dtype(dtype)
    if name == "sum":
        return 0
    if np.issubdtype(dtype, np.integer):
        return (np.iinfo(dtype).max if name == "min"
                else np.iinfo(dtype).min)
    return np.inf if name == "min" else -np.inf


def _check_ids(src, dst, vbp: int) -> None:
    if len(src) == 0:
        return
    top = int(max(src.max(), dst.max()))
    bot = int(min(src.min(), dst.min()))
    if bot < 0 or top >= vbp:
        raise ValueError("vertex id %d outside [0, %d) in windowed reduce "
                         "input" % (bot if bot < 0 else top, vbp))


class WindowedEdgeReduce:
    """Per-window per-vertex reduce over tumbling `edge_bucket`-sized
    windows of a COO value stream (see the module docstring).

    `device=None` means the CUDA card (the device tier only; the host
    and native tiers need none); `device="cpu"` runs the kernel's plain
    version. `ingress=None` is the standard wire, `egress=None` full
    rows.
    """

    MAX_STREAM_WINDOWS = 64
    INFLIGHT = ingress_pipeline.DEFAULT_INFLIGHT   # pipeline look-ahead

    def __init__(self, vertex_bucket: int, edge_bucket: int,
                 name: str = "sum", direction: str = "out",
                 fn=None, ingress: str = None, egress: str = None,
                 slide: int = None, tier: str = "device", device=None):
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {_DIRECTIONS}")
        egress = egress or "full"
        if egress not in EGRESS:
            raise ValueError(f"unknown egress: {egress!r}")
        if tier not in TIERS:
            raise ValueError("unknown tier %r (choices: %s)"
                             % (tier, ", ".join(TIERS)))
        if fn is not None:
            name = None
            if tier != "device":
                raise ValueError("a user fn runs on the device tier only")
        if name not in (None, "sum", "min", "max"):
            raise ValueError("unknown monoid %r" % (name,))
        if tier == "native" and not native.windowed_reduce_available():
            raise RuntimeError("native tier pinned, but the native library "
                               "is unavailable: %s" % native.build_error())
        self.vb = seg_ops.bucket_size(vertex_bucket)
        self.eb = seg_ops.bucket_size(edge_bucket)
        self.slide = None
        if slide is not None and int(slide) != 0:
            slide = int(slide)
            if name is None:
                raise ValueError(
                    "slide= needs a monoid name (sum/min/max): pane "
                    "composition relies on the named identity fills")
            if (slide <= 0 or slide > self.eb or self.eb % slide
                    or slide & (slide - 1)):
                raise ValueError(
                    "slide must be a power of two dividing the "
                    "window size (%d), got %d" % (self.eb, slide))
            self.slide = slide
        self.name = name
        self.fn = fn
        self.direction = direction
        self.tier = tier
        self.ingress = resolve_ingress(ingress, self.vb)
        self.egress = egress
        self._device_arg = device
        self.device = resolve_device(device) if tier == "device" else None
        self.stage_timers = ingress_pipeline.StageTimers()
        self._ring = (ChunkStager(self.device, slots=self.INFLIGHT + 1)
                      if self.device is not None else None)
        self.panes_per_window = (self.eb // self.slide
                                 if self.slide else 1)
        self._pane_engine = None
        self._full_engine = None

    # ---- sliding windows (pane composition) ---------------------------

    def _twin(self, eb: int) -> "WindowedEdgeReduce":
        return WindowedEdgeReduce(
            self.vb, eb, name=self.name, direction=self.direction,
            ingress=self.ingress, egress=self.egress, tier=self.tier,
            device=self._device_arg)

    def _pane_eng(self) -> "WindowedEdgeReduce":
        if self._pane_engine is None:
            self._pane_engine = self._twin(self.slide)
        return self._pane_engine

    def _full_eng(self) -> "WindowedEdgeReduce":
        if self._full_engine is None:
            self._full_engine = self._twin(self.eb)
        return self._full_engine

    def _compose_panes(self, panes):
        """One emission per pane: emission i composes panes
        [max(0, i-wp+1), i], cells under the monoid, counts summed (the
        fills are identities, so untouched cells stay untouched)."""
        wp = self.panes_per_window
        op = {"sum": np.add, "min": np.minimum,
              "max": np.maximum}[self.name]
        out = []
        for i in range(len(panes)):
            cells, counts = panes[i]
            cells, counts = cells.copy(), counts.copy()
            for c2, n2 in panes[max(0, i - wp + 1):i]:
                op(cells, c2, out=cells)
                counts += n2
            out.append((cells, counts))
        return out

    def process_stream_naive(self, src, dst, val):
        """The refold twin of the sliding path: every emission reduces
        its whole window slice again through the tumbling engine."""
        if self.slide is None:
            return self.process_stream(src, dst, val)
        src, dst, val = (np.asarray(a) for a in (src, dst, val))
        n = len(src)
        out = []
        eng, s = self._full_eng(), self.slide
        for i in range(-(-n // s)):
            lo = max(0, (i + 1) * s - self.eb)
            hi = min((i + 1) * s, n)
            out.extend(eng.process_stream(src[lo:hi], dst[lo:hi],
                                          val[lo:hi]))
        return out

    # ---- entry ---------------------------------------------------------

    def _delta_cap(self) -> int:
        """Exact touched-cell bound of a window's delta row: one cell a
        contribution (two an edge for "all"), at most the row."""
        per = self.eb * (2 if self.direction == "all" else 1)
        return min(per, self.vb + 1)

    def process_stream(self, src, dst, val) -> List[Tuple[np.ndarray,
                                                        np.ndarray]]:
        src0, dst0, val = (np.asarray(a) for a in (src, dst, val))
        if not len(src0) == len(dst0) == len(val):
            raise ValueError("src/dst/val length mismatch")
        if len(src0) == 0:
            return []
        if self.slide is not None:
            panes = self._pane_eng().process_stream(src0, dst0, val)
            return self._compose_panes(panes)
        if self.tier == "native":
            if not np.issubdtype(val.dtype, np.signedinteger):
                raise ValueError("the native tier folds signed integer "
                                 "values, not %s" % val.dtype)
            return self._native_process_stream(src0, dst0, val)
        src64 = src0.astype(np.int64, copy=False)
        dst64 = dst0.astype(np.int64, copy=False)
        if self.tier == "host":
            return self._host_process_stream(src64, dst64, val)
        return self._device_process_stream(src64, dst64, val)

    # ---- native tier ---------------------------------------------------

    def _native_process_stream(self, src, dst, val):
        """The C++ fused tier, chunked to bound its dense [chunk, vbp]
        scratch (~64 MB); cells cast back to the value dtype."""
        eb, vbp = self.eb, self.vb + 1
        n = len(src)
        num_w = -(-n // eb)
        ident = int(_host_identity(self.name, val.dtype))
        out = []
        chunk_w = max(1, min(1024, (64 << 20) // (vbp * 16)))
        for at in range(0, num_w, chunk_w):
            lo, hi = at * eb, min((at + chunk_w) * eb, n)
            got = native.windowed_reduce(src[lo:hi], dst[lo:hi],
                                         val[lo:hi], eb, vbp, self.name,
                                         self.direction, ident)
            if got is None:
                raise RuntimeError("native library unavailable: %s"
                                   % native.build_error())
            cells, counts = got
            cells = cells.astype(val.dtype, copy=False)
            out.extend((cells[w], counts[w]) for w in range(cells.shape[0]))
        return out

    # ---- device tier ---------------------------------------------------

    def _chunks(self, num_w: int):
        chunks, at = [], 0
        while at < num_w:
            wb = seg_ops.bucket_size(min(self.MAX_STREAM_WINDOWS,
                                         num_w - at))
            chunks.append((at, wb))
            at += wb
        return chunks

    def _cell_ids(self, src, dst, win, valid, vbp, n_cells):
        """Flattened (window, vertex) cell id a contribution, the trash
        id n_cells for padding; direction "all" doubles the stream."""
        vtx = {"out": [src], "in": [dst], "all": [src, dst]}[self.direction]
        ids = [np.where(valid, win * vbp + v, n_cells) for v in vtx]
        return np.concatenate(ids).astype(np.int32), len(vtx)

    def _standard_chunk(self, src, dst, val, at: int, wb: int):
        """The standard wire of windows [at, at+wb): cell ids and values
        [rep, wb, eb] flattened."""
        eb, vbp, n = self.eb, self.vb + 1, len(src)
        lo, hi = at * eb, min((at + wb) * eb, n)
        s = seg_ops.pad_to(src[lo:hi], wb * eb)
        d = seg_ops.pad_to(dst[lo:hi], wb * eb)
        v = seg_ops.pad_to(val[lo:hi], wb * eb)
        valid = seg_ops.pad_to(np.ones(hi - lo, bool), wb * eb,
                               fill=False)
        win = np.arange(wb * eb) // eb
        ids, rep = self._cell_ids(s, d, win, valid, vbp, wb * vbp)
        return ids, np.concatenate([v] * rep)

    def _device_process_stream(self, src, dst, val):
        """The device tier (see the module docstring)."""
        n = len(src)
        eb, vbp = self.eb, self.vb + 1
        num_w = -(-n // eb)
        chunks = self._chunks(num_w)
        _check_ids(src, dst, vbp)
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        if self.name is None:
            return self._assoc_process_stream(src, dst, val, chunks)
        kval = seg_ops.x64_off_values(val)
        compact = self.ingress == "compact"
        if compact:
            compact_ingress.validate_ids(src, dst, vbp, "windowed reduce")
        delta = self.egress == "delta"
        cap = self._delta_cap()
        ring = self._ring

        def prep(item):
            at, wb = item
            if compact:
                lo, hi = at * eb, min((at + wb) * eb, n)
                _w, s16, d16, nv = compact_ingress.window_stack(
                    src[lo:hi], dst[lo:hi], eb)
                v = seg_ops.pad_to(kval[lo:hi], wb * eb).reshape(wb, eb)
                return at, wb, (seg_ops.pad_to(s16, wb),
                                seg_ops.pad_to(d16, wb),
                                seg_ops.pad_to(nv, wb), v)
            return at, wb, self._standard_chunk(src, dst, kval, at, wb)

        def h2d(payload):
            at, wb, arrays = payload
            return at, wb, ring.put(arrays, at // self.MAX_STREAM_WINDOWS)

        def dispatch(dev_payload):
            at, wb, staged = dev_payload
            t = ring.take(staged)
            egress = "delta" if delta else "full"
            if compact:
                res = cell_reduce_compact(*t, vbp, self.name,
                                          self.direction, egress, cap)
            else:
                res = cell_reduce(*t, wb, eb, vbp, self.name, egress, cap)
            ring.done(staged)
            return at, wb, [HostCopy(x) for x in res]

        def finalize(raw):
            at, wb, copies = raw
            res = [c.numpy() for c in copies]
            n_w = min(wb, num_w - at)
            if delta:
                # the touched cells of every window scattered into rows
                # refilled with the device's empty-cell identity
                cnt, idx, cv, cn = res
                used = np.arange(idx.shape[1])[None, :] < cnt[:n_w, None]
                rows = np.nonzero(used)[0]
                cells = np.full((n_w, vbp),
                                _device_cell_fill(self.name, cv.dtype),
                                cv.dtype)
                counts = np.zeros((n_w, vbp), cn.dtype)
                cells[rows, idx[:n_w][used]] = cv[:n_w][used]
                counts[rows, idx[:n_w][used]] = cn[:n_w][used]
            else:
                cells, counts = res
            for w in range(n_w):
                out.append((cells[w], counts[w]))

        try:
            ingress_pipeline.run_pipeline(
                chunks, prep, h2d, dispatch, finalize,
                timers=self.stage_timers, inflight=self.INFLIGHT)
        except BaseException:
            ring.release_all()
            raise
        return out

    def _assoc_process_stream(self, src, dst, val, chunks):
        """The associative user-fn tier: each chunk's cell ids sorted on
        the host, the flagged scan of ops/segment.py on the device."""
        eb, vbp, n = self.eb, self.vb + 1, len(src)
        num_w = -(-n // eb)
        out = []
        for at, wb in chunks:
            n_cells = wb * vbp
            ids, vals = self._standard_chunk(src, dst, val, at, wb)
            order = np.argsort(ids, kind="stable")
            res, _has = seg_ops.segmented_reduce_associative(
                self.fn, ids[order], vals[order], n_cells, self.device)
            cells = res.reshape(wb, vbp)
            counts = np.bincount(ids[ids < n_cells],
                                 minlength=n_cells).reshape(wb, vbp)
            for w in range(min(wb, num_w - at)):
                out.append((cells[w], counts[w]))
        return out

    def cohort_step(self, rows: List[tuple]) -> List[Tuple[np.ndarray,
                                                           np.ndarray]]:
        """N tenants' next windows (each <= eb edges) in one launch: the
        cohort is more windows in the stack. `rows` is a list of (src,
        dst, val); returns one (cells, counts) pair a row, full rows,
        bit-equal to each row's own single-window run (float sums up to
        their reordering)."""
        if not rows:
            return []
        if self.name is None:
            raise ValueError("cohort_step serves the monoid stack "
                             "kernels; user-fn reduces run per tenant")
        if self.device is None:
            raise ValueError("cohort_step runs on the device tier")
        eb, vbp = self.eb, self.vb + 1
        nb = seg_ops.bucket_size(len(rows))
        s = np.zeros(nb * eb, np.int64)
        d = np.zeros(nb * eb, np.int64)
        vdt = np.result_type(*(np.asarray(val).dtype
                               for _s, _d, val in rows))
        v = np.zeros(nb * eb, seg_ops.x64_off_values(np.zeros(0, vdt)).dtype)
        valid = np.zeros(nb * eb, bool)
        for row, (src, dst, val) in enumerate(rows):
            src = np.asarray(src, np.int64)
            dst = np.asarray(dst, np.int64)
            val = np.asarray(val)
            if not len(src) == len(dst) == len(val):
                raise ValueError("row %d: src/dst/val length mismatch"
                                 % row)
            if len(src) > eb:
                raise ValueError(
                    "row %d: %d edges exceed the %d-edge window bucket"
                    % (row, len(src), eb))
            _check_ids(src, dst, vbp)
            lo = row * eb
            s[lo:lo + len(src)] = src
            d[lo:lo + len(dst)] = dst
            v[lo:lo + len(val)] = val
            valid[lo:lo + len(src)] = True
        win = np.arange(nb * eb) // eb
        ids, rep = self._cell_ids(s, d, win, valid, vbp, nb * vbp)
        vals = np.concatenate([v] * rep)
        cells, counts = cell_reduce(
            torch.from_numpy(ids).to(self.device),
            torch.from_numpy(vals).to(self.device), nb, eb, vbp, self.name)
        cells, counts = cells.cpu().numpy(), counts.cpu().numpy()
        return [(cells[r], counts[r]) for r in range(len(rows))]

    # ---- host (numpy) tier -------------------------------------------

    def _host_process_stream(self, src, dst, val):
        """numpy: one bincount a window for sums that float64 holds
        exactly, ufunc.at otherwise (integer sums then wrap like the
        device's). Same cells and counts as the device tier."""
        out = []
        eb, vbp = self.eb, self.vb + 1
        _check_ids(src, dst, vbp)
        n = len(src)
        num_w = -(-n // eb)
        ident = _host_identity(self.name, val.dtype)
        per_cell = eb * (2 if self.direction == "all" else 1)
        if np.issubdtype(val.dtype, np.integer):
            limit = min(1 << 53, int(np.iinfo(val.dtype).max))
            exact_bincount = (self.name == "sum" and n > 0
                              and int(np.abs(val).max()) * per_cell
                              <= limit)
        else:
            exact_bincount = self.name == "sum"
        if exact_bincount:
            for lo in range(0, n, eb):
                s, d, v = src[lo:lo + eb], dst[lo:lo + eb], \
                    val[lo:lo + eb]
                if self.direction == "out":
                    ids, vals = s, v
                elif self.direction == "in":
                    ids, vals = d, v
                else:
                    ids = np.concatenate([s, d])
                    vals = np.concatenate([v, v])
                counts = np.bincount(ids, minlength=vbp)
                cells = np.bincount(
                    ids, weights=vals, minlength=vbp).astype(val.dtype)
                out.append((cells, counts))
            return out
        op = {"sum": np.add, "min": np.minimum,
              "max": np.maximum}[self.name]
        for at in range(0, num_w, self.MAX_STREAM_WINDOWS):
            hi_w = min(at + self.MAX_STREAM_WINDOWS, num_w)
            lo, hi = at * eb, min(hi_w * eb, n)
            s, d, v = src[lo:hi], dst[lo:hi], val[lo:hi]
            win = np.arange(hi - lo) // eb
            vtx = {"out": [s], "in": [d], "all": [s, d]}[self.direction]
            ids = np.concatenate([win * vbp + x for x in vtx])
            vals = np.concatenate([v] * len(vtx))
            wb = hi_w - at
            n_cells = wb * vbp
            counts = np.bincount(ids, minlength=n_cells).reshape(wb, vbp)
            flat = np.full(n_cells, ident, val.dtype)
            op.at(flat, ids, vals)
            cells = flat.reshape(wb, vbp)
            for w in range(wb):
                out.append((cells[w], counts[w]))
        return out


def numpy_reference(src, dst, val, eb: int, direction: str = "out",
                    name: str = "sum"
                    ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Per-window host port of the reference's windowed neighborhood
    reduce (GraphWindowStream.java:101-121): a per-edge fold into a
    per-vertex slot, arrays sized by the stream's largest id. Cells with
    count 0 hold the monoid identity (compare by counts)."""
    op = {"sum": np.add, "min": np.minimum, "max": np.maximum}[name]
    ident = _host_identity(name, np.asarray(val).dtype)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    val = np.asarray(val)
    nv = int(max(src.max(), dst.max())) + 1 if len(src) else 1
    out = []
    for lo in range(0, len(src), eb):
        s, d, v = src[lo:lo + eb], dst[lo:lo + eb], val[lo:lo + eb]
        if direction == "out":
            pairs = [(s, v)]
        elif direction == "in":
            pairs = [(d, v)]
        else:
            pairs = [(s, v), (d, v)]
        acc = np.full(nv, ident, val.dtype)
        cnt = np.zeros(nv, np.int64)
        for vtx, vv in pairs:
            op.at(acc, vtx, vv)
            np.add.at(cnt, vtx, 1)
        out.append((acc, cnt))
    return out


def sliding_numpy_reference(src, dst, val, eb: int, slide: int,
                            direction: str = "out", name: str = "sum"
                            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Independent sliding oracle: one emission per completed (or final
    ragged) pane, each a whole refold of its window slice
    [max(0, (i+1)·slide − eb), (i+1)·slide) through numpy_reference."""
    src, dst, val = (np.asarray(a) for a in (src, dst, val))
    n = len(src)
    out = []
    for i in range(-(-n // slide)):
        lo = max(0, (i + 1) * slide - eb)
        hi = min((i + 1) * slide, n)
        out.extend(numpy_reference(src[lo:hi], dst[lo:hi],
                                   val[lo:hi], eb, direction, name))
    return out
