"""Admission sanitizer and dead-letter journal.

Port of the JAX package's `utils/sanitize.py`, with the same reason
codes, reports and dead-letter records. `sanitize()` is a vectorized
validator run at the engines' admission (SummaryEngineBase.process, the
sliding engine's process) before the write-ahead journal sees the batch,
so the journal only holds edges the sanitizer vouched for. Each rejected
edge gets one typed reason (first match in severity order):

    length_mismatch   src/dst lengths differ (whole batch refused)
    non_integer       non-numeric dtype, NaN/inf, or fractional ids
    id_negative       id < 0
    id_overflow       id >= 2^31 (would wrap the int32 device cast)
    id_out_of_range   id >= the vertex bucket
    self_loop         src == dst (strict mode only)
    duplicate_flood   the same (src, dst) pair more than DUP_FLOOD_KEEP
                      times in one batch (strict mode only)
    batch_overflow    the batch exceeds GS_MAX_BATCH_EDGES (whole batch
                      refused with typed `BatchRejected`)

Rejected records go to a dead-letter journal (`dlq_<n>.seg` under
GS_DLQ_DIR: an 8-byte magic, then CRC-framed records of origin tenant,
source offsets, reason and the edges), so nothing is dropped unseen.
Segments rotate at GS_WAL_SEGMENT_BYTES; GS_DLQ_RETAIN bounds the closed
segments kept (0 = all).

`GS_SANITIZE=off` (the default) skips the sanitizer: every admission
runs as before, bit for bit. `on` rejects structurally invalid records;
`strict` adds the self-loop and duplicate-flood policies.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import knobs
from . import metrics
from . import telemetry

# typed reason codes, in per-edge assignment severity order (an edge
# that is both negative AND a self-loop reports id_negative)
REASONS = ("length_mismatch", "non_integer", "id_negative",
           "id_overflow", "id_out_of_range", "self_loop",
           "duplicate_flood", "batch_overflow")

# strict mode keeps the first this-many copies of an identical
# (src, dst) pair per batch; the excess is a duplicate flood. A fixed
# constant, not a knob: determinism matters more than tunability here
# (the same batch must always split the same way).
DUP_FLOOD_KEEP = 8

_INT32_CEIL = 1 << 31


# ----------------------------------------------------------------------
# knobs (utils/knobs.py registry; live per-call reads)
# ----------------------------------------------------------------------
def mode() -> str:
    """GS_SANITIZE: `off` (default — every boundary runs its legacy
    path bit-identically), `on` (structural validation), `strict`
    (adds the self-loop + duplicate-flood policies)."""
    return knobs.get_str("GS_SANITIZE")


def enabled() -> bool:
    return mode() != "off"


def dlq_dir() -> Optional[str]:
    """GS_DLQ_DIR: directory of the dead-letter journal; unset (or the
    conventional `0`) = rejected records are counted and dropped."""
    d = knobs.get_path("GS_DLQ_DIR")
    return None if d in (None, "0") else d


def dlq_retain() -> int:
    """GS_DLQ_RETAIN: closed DLQ segments kept after rotation
    (0 = keep all)."""
    return knobs.get_int("GS_DLQ_RETAIN")


def max_batch_edges() -> int:
    """GS_MAX_BATCH_EDGES: admission batch-size bound (whole batches
    past it are refused with typed `BatchRejected` and journaled);
    0 = unbounded."""
    return knobs.get_int("GS_MAX_BATCH_EDGES")


class BatchRejected(ValueError):
    """A whole admission batch was refused (oversized or structurally
    unusable). Carries `tenant`, `reason` (a REASONS code) and `size`
    so the serving front-end can surface a typed wire error.
    Construction stamps the flight-recorder event + counter — every
    raise site is covered by construction (the TenantError pattern)."""

    def __init__(self, message: str, tenant: str, reason: str,
                 size: int, limit: int = 0):
        super().__init__(message)
        self.tenant = str(tenant)
        self.reason = reason
        self.size = int(size)
        self.limit = int(limit)
        telemetry.event("sanitize_reject", tenant=self.tenant,
                        reason=reason, rejected=self.size,
                        whole_batch=True)
        metrics.counter_inc("gs_sanitize_rejected_edges_total",
                            self.size, reason=reason)


class SanitizeReport:
    """One batch's admission verdict: the accepted arrays (int64,
    every id proven in [0, vb)) plus per-reason rejection counts."""

    __slots__ = ("src", "dst", "ts", "keep", "accepted", "rejected",
                 "reasons", "rejects")

    def __init__(self, src, dst, ts, keep, rejected: int,
                 reasons: Dict[str, int], rejects):
        self.src = src
        self.dst = dst
        self.ts = ts
        self.keep = keep      # bool mask over the ORIGINAL batch, so
        self.accepted = len(src)  # callers can filter aligned arrays
        self.rejected = int(rejected)
        self.reasons = reasons
        # the rejected records themselves, per reason — what
        # commit_report() journals once the caller ACCEPTS the batch
        # (a backpressure-refused feed must journal nothing, or the
        # client's retry double-journals every reject)
        self.rejects = rejects  # [(reason, offsets, src, dst), ...]

    @property
    def clean(self) -> bool:
        return self.rejected == 0

    def wire_fields(self) -> dict:
        """The typed-rejection fields the serving front-end adds to a
        feed response ({} for a clean batch — disarmed/clean replies
        stay byte-identical)."""
        if self.clean:
            return {}
        return {"rejected": self.rejected, "reasons": dict(self.reasons)}


def _to_int64(a, ceiling: int) -> "tuple":
    """(values int64, ok_mask, overflow_mask, negative_mask):
    canonicalize one id array. Non-integer floats / NaN / inf fail
    `ok`; magnitudes at or past `ceiling` (including huge floats,
    past-int64 Python ints and uint64 values an astype would wrap)
    land in `overflow`; `negative` carries the PRE-cast sign (a
    -2^40 id must report id_negative, not the overflow its masked
    cast value would suggest). All masks are computed BEFORE any
    cast, so a 2^40 id can never wrap into a plausible small one.
    `ceiling` is 2^31 for the dense-id planes (the device int32
    cast) and 2^63 for the driver's external-id plane (the int64
    representability bound)."""
    a = np.asarray(a)
    if a.dtype.kind not in "iufb":
        # object/str arrays (hostile JSON): try an elementwise parse;
        # unparseable entries are non_integer, parseable-but-huge
        # ones are overflow
        vals = np.zeros(len(a), np.int64)
        ok = np.zeros(len(a), bool)
        over = np.zeros(len(a), bool)
        neg = np.zeros(len(a), bool)
        for i, x in enumerate(a.tolist()):
            try:
                v = int(x)
            except (TypeError, ValueError, OverflowError):
                continue
            ok[i] = True
            neg[i] = v < 0
            if -ceiling <= v < ceiling and -(1 << 63) <= v < (1 << 63):
                vals[i] = v
            else:
                over[i] = True
        return vals, ok, over, neg
    if a.dtype.kind == "f":
        ok = np.isfinite(a)
        intish = np.zeros(len(a), bool)
        intish[ok] = np.equal(a[ok], np.floor(a[ok]))
        ok &= intish
        over = ok & (np.abs(a) >= float(ceiling))
        neg = ok & (a < 0)
        safe = np.where(ok & ~over, a, 0.0)
        return safe.astype(np.int64), ok, over, neg
    if a.dtype.kind == "u" and a.dtype.itemsize == 8:
        over = a >= np.uint64(min(ceiling, (1 << 63) - 1))
        safe = np.where(over, np.uint64(0), a)
        return (safe.astype(np.int64), np.ones(len(a), bool), over,
                np.zeros(len(a), bool))
    vals = a.astype(np.int64)
    ones = np.ones(len(a), bool)
    if ceiling >= (1 << 63):
        return vals, ones, np.zeros(len(a), bool), vals < 0
    return vals, ones, np.abs(vals) >= ceiling, vals < 0


def sanitize(src, dst, vb: Optional[int], *, tenant: str = "",
             origin: str = "", offset: int = 0, ts=None,
             dlq: Optional["DeadLetterJournal"] = None,
             commit: bool = True) -> SanitizeReport:
    """Validate one admission batch against the vertex bucket `vb`.
    Returns the accepted sub-batch (order preserved) and — with
    `commit=True`, the default — journals every rejected record to
    `dlq` (when armed) with its origin tenant, absolute source
    offsets (`offset` + position) and reason code, stamping the
    rejection counters/event. `commit=False` defers that side effect
    to an explicit `commit_report()` call: a caller with its own
    acceptance gate after validation (the cohort's queue-capacity
    check) must journal only batches it actually accepted, or a
    backpressure retry double-journals every reject. Raises typed
    `BatchRejected` for whole-batch refusals (length mismatch,
    GS_MAX_BATCH_EDGES overflow) — the refused batch is journaled
    first (refusals are terminal, never retried-as-is), so even a
    refusal is recoverable.

    `vb=None` is the driver's EXTERNAL-id plane: ids are arbitrary
    int64 keys the interner densifies, so the range/negative/int32
    checks don't apply — only representability (non-integer, NaN/inf,
    past-int64 magnitudes), the batch bound and the strict-mode
    policies run."""
    ceiling = _INT32_CEIL if vb is not None else (1 << 63)
    sv, s_ok, s_over, s_neg = _to_int64(src, ceiling)
    dv, d_ok, d_over, d_neg = _to_int64(dst, ceiling)
    if len(sv) != len(dv):
        raise BatchRejected(
            "src/dst length mismatch (%d vs %d)" % (len(sv), len(dv)),
            tenant, "length_mismatch", max(len(sv), len(dv)))
    n = len(sv)
    tv = None if ts is None else np.asarray(ts)
    bound = max_batch_edges()
    if bound and n > bound:
        if dlq is not None:
            dlq.append(tenant, origin, "batch_overflow",
                       offset + np.arange(n, dtype=np.int64), sv, dv)
        raise BatchRejected(
            "batch of %d edges exceeds GS_MAX_BATCH_EDGES=%d for "
            "tenant %r" % (n, bound, tenant),
            tenant, "batch_overflow", n, limit=bound)
    # one reason per edge, assigned in severity order (REASONS index)
    reason = np.full(n, -1, np.int8)

    def mark(mask, code: str):
        m = mask & (reason < 0)
        if m.any():
            reason[m] = REASONS.index(code)

    mark(~(s_ok & d_ok), "non_integer")
    if vb is not None:
        # the documented severity order: a -2^40 id is id_negative
        # (the pre-cast sign masks), not the overflow its magnitude
        # would also trip
        mark(s_neg | d_neg | (sv < 0) | (dv < 0), "id_negative")
        mark(s_over | d_over
             | (sv >= _INT32_CEIL) | (dv >= _INT32_CEIL),
             "id_overflow")
        mark((sv >= vb) | (dv >= vb), "id_out_of_range")
    else:
        mark(s_over | d_over, "id_overflow")
    if mode() == "strict" and n:
        mark(sv == dv, "self_loop")
        live = reason < 0
        if live.any():
            # occurrence index per identical (src, dst) pair among the
            # still-accepted edges: stable lexsort the pairs, the rank
            # within each equal-pair run is position - run_start
            idx = np.flatnonzero(live)
            order = np.lexsort((dv[idx], sv[idx]))
            ss, dd = sv[idx][order], dv[idx][order]
            run_start = np.zeros(len(ss), np.int64)
            new_run = np.flatnonzero((np.diff(ss) != 0)
                                     | (np.diff(dd) != 0)) + 1
            run_start[new_run] = new_run
            np.maximum.accumulate(run_start, out=run_start)
            occ = np.arange(len(ss), dtype=np.int64) - run_start
            flood = np.zeros(n, bool)
            flood[idx[order[occ >= DUP_FLOOD_KEEP]]] = True
            mark(flood, "duplicate_flood")
    bad = reason >= 0
    n_rej = int(bad.sum())
    reasons: Dict[str, int] = {}
    rejects = []
    if n_rej:
        offs = offset + np.arange(n, dtype=np.int64)
        for code_i in np.unique(reason[bad]):
            code = REASONS[int(code_i)]
            m = reason == code_i
            reasons[code] = int(m.sum())
            rejects.append((code, offs[m], sv[m], dv[m]))
    keep = ~bad
    report = SanitizeReport(
        sv[keep], dv[keep],
        None if tv is None else tv[keep],
        keep, n_rej, reasons, rejects)
    if commit:
        commit_report(report, tenant=tenant, origin=origin, dlq=dlq)
    return report


def commit_report(report: SanitizeReport, *, tenant: str = "",
                  origin: str = "",
                  dlq: Optional["DeadLetterJournal"] = None) -> None:
    """Journal a report's rejected records and stamp the rejection
    counters/event — the acceptance-time half of a
    `sanitize(commit=False)` call. Idempotence is the CALLER's
    contract: commit exactly once per accepted batch."""
    if not report.rejected:
        return
    for code, offs, rs, rd in report.rejects:
        metrics.counter_inc("gs_sanitize_rejected_edges_total",
                            len(rs), reason=code)
        if dlq is not None:
            dlq.append(tenant, origin, code, offs, rs, rd)
    telemetry.event("sanitize_reject", tenant=str(tenant),
                    origin=origin, rejected=report.rejected,
                    reasons=report.reasons)


# ----------------------------------------------------------------------
# the dead-letter journal (WAL-style segments; utils/wal discipline)
# ----------------------------------------------------------------------
_MAGIC = b"GSDLQSG1"
_HEAD = struct.Struct("<II")           # crc32, payload_len
_SEG_FMT = "dlq_%08d.seg"


def _encode(tenant: str, origin: str, reason: str,
            offs: np.ndarray, src: np.ndarray,
            dst: np.ndarray) -> bytes:
    tb, ob, rb = tenant.encode(), origin.encode(), reason.encode()
    head = struct.pack(
        "<BH%dsH%dsH%dsI" % (len(tb), len(ob), len(rb)),
        1, len(tb), tb, len(ob), ob, len(rb), rb, len(src))
    payload = b"".join([
        head,
        np.ascontiguousarray(offs, np.int64).tobytes(),
        np.ascontiguousarray(src, np.int64).tobytes(),
        np.ascontiguousarray(dst, np.int64).tobytes()])
    return _HEAD.pack(zlib.crc32(payload), len(payload)) + payload


def _decode(payload: bytes) -> dict:
    off = 1
    out = {}
    for field in ("tenant", "origin", "reason"):
        (ln,) = struct.unpack_from("<H", payload, off)
        off += 2
        out[field] = payload[off:off + ln].decode()
        off += ln
    (n,) = struct.unpack_from("<I", payload, off)
    off += 4
    for field in ("offsets", "src", "dst"):
        out[field] = np.frombuffer(payload, np.int64, n, off)
        off += 8 * n
    return out


def _segments(directory: str) -> List[str]:
    try:
        names = sorted(f for f in os.listdir(directory)
                       if f.startswith("dlq_") and f.endswith(".seg"))
    except FileNotFoundError:
        return []
    return [os.path.join(directory, f) for f in names]


def replay(directory: str) -> Iterator[dict]:
    """Every intact DLQ record in append order. Damage (a torn tail
    from a crash mid-append, or an externally truncated segment) stops
    the iteration of THAT segment with a telemetry event — a rejected
    record was never acknowledged anywhere, so dropping a torn one is
    exact; later segments still replay."""
    for path in _segments(directory):
        with open(path, "rb") as f:
            data = f.read()
        if not data.startswith(_MAGIC):
            telemetry.event("dlq_torn", segment=os.path.basename(path),
                            problem="bad segment magic")
            continue
        off = len(_MAGIC)
        while off < len(data):
            tail = len(data) - off
            if tail < _HEAD.size:
                telemetry.event("dlq_torn",
                                segment=os.path.basename(path),
                                problem="partial record header")
                break
            crc, length = _HEAD.unpack_from(data, off)
            payload = data[off + _HEAD.size:off + _HEAD.size + length]
            if len(payload) < length or zlib.crc32(payload) != crc:
                telemetry.event("dlq_torn",
                                segment=os.path.basename(path),
                                problem="truncated or CRC-failing "
                                        "record")
                break
            yield _decode(payload)
            off += _HEAD.size + length


def scan(directory: str) -> dict:
    """DLQ summary: record/edge totals, per-reason and per-tenant edge
    counts, segment count."""
    records = edges = 0
    by_reason: Dict[str, int] = {}
    by_tenant: Dict[str, int] = {}
    for rec in replay(directory):
        records += 1
        n = len(rec["src"])
        edges += n
        by_reason[rec["reason"]] = by_reason.get(rec["reason"], 0) + n
        by_tenant[rec["tenant"]] = by_tenant.get(rec["tenant"], 0) + n
    return {"records": records, "edges": edges,
            "by_reason": by_reason, "by_tenant": by_tenant,
            "segments": len(_segments(directory))}


class DeadLetterJournal:
    """Appender over one DLQ directory. Thread-safe (several admission
    threads may reject at once); every append is fsync'd — the
    "every rejected record is recoverable" contract is only worth
    stating if a crash right after the rejection can't lose it, and
    rejection is off the hot path by definition."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        segs = _segments(directory)
        self._seg_no = (max(int(os.path.basename(p)[4:-4])
                            for p in segs) + 1) if segs else 0
        self._file = None
        self._file_bytes = 0
        info = scan(directory)
        self.records = info["records"]
        self.edges = info["edges"]
        self.by_reason: Dict[str, int] = dict(info["by_reason"])

    def _ensure_segment(self):
        if self._file is not None \
                and self._file_bytes >= knobs.get_int(
                    "GS_WAL_SEGMENT_BYTES"):
            self._file.close()
            self._file = None
            self._retain()
        if self._file is None:
            path = os.path.join(self.dir, _SEG_FMT % self._seg_no)
            self._seg_no += 1
            self._file = open(path, "ab")
            self._file.write(_MAGIC)
            self._file.flush()
            self._file_bytes = len(_MAGIC)
        return self._file

    def _retain(self) -> None:
        """GS_DLQ_RETAIN: drop the oldest CLOSED segments past the
        bound (the open segment never counts). 0 keeps everything."""
        keep = dlq_retain()
        if keep <= 0:
            return
        closed = _segments(self.dir)
        if self._file is not None and closed \
                and closed[-1] == self._file.name:
            closed = closed[:-1]
        for path in closed[:-keep] if len(closed) > keep else []:
            os.unlink(path)

    def append(self, tenant: str, origin: str, reason: str,
               offsets, src, dst) -> None:
        """Journal one rejected record (origin tenant + absolute
        source offsets + reason + the edges themselves)."""
        rec = _encode(str(tenant), str(origin), str(reason),
                      np.asarray(offsets, np.int64),
                      np.asarray(src, np.int64),
                      np.asarray(dst, np.int64))
        with self._lock:
            f = self._ensure_segment()
            f.write(rec)
            f.flush()
            os.fsync(f.fileno())
            self._file_bytes += len(rec)
            self.records += 1
            self.edges += len(np.atleast_1d(src))
            self.by_reason[reason] = (self.by_reason.get(reason, 0)
                                      + len(np.atleast_1d(src)))
        metrics.counter_inc("gs_dlq_records_total")
        metrics.counter_inc("gs_dlq_edges_total",
                            len(np.atleast_1d(src)))
        metrics.gauge_set("gs_dlq_depth_records", self.records)

    def status(self) -> dict:
        """Live depth of the journal."""
        with self._lock:
            return {"dir": self.dir, "records": self.records,
                    "edges": self.edges,
                    "by_reason": dict(self.by_reason)}

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# process-global journal registry keyed by directory: every admission
# boundary resolving the same GS_DLQ_DIR shares one appender (and its
# depth counters), the way the telemetry/metrics registries behave
_DLQS: Dict[str, DeadLetterJournal] = {}
_DLQ_LOCK = threading.Lock()


def resolve_dlq() -> Optional[DeadLetterJournal]:
    """The shared journal for the current GS_SANITIZE/GS_DLQ_DIR
    configuration; None when the sanitizer or the journal is
    disarmed (rejections are then counted and dropped)."""
    if not enabled():
        return None
    d = dlq_dir()
    if d is None:
        return None
    with _DLQ_LOCK:
        j = _DLQS.get(d)
        if j is None:
            j = _DLQS[d] = DeadLetterJournal(d)
        return j


def dlq_status() -> Optional[dict]:
    """The live journal's depth (None when the journal is disarmed or
    was never opened): the serving front end's `dlq` health cell."""
    d = dlq_dir()
    if d is None:
        return None
    with _DLQ_LOCK:
        j = _DLQS.get(d)
    return j.status() if j is not None else None


def reset() -> None:
    """Test hook: close and forget every registered journal."""
    with _DLQ_LOCK:
        for j in _DLQS.values():
            j.close()
        _DLQS.clear()
