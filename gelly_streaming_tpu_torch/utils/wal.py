"""Write-ahead edge journal: the durable, replayable source of a
live-fed engine.

Port of the JAX package's `utils/wal.py`, in its on-disk format, so a
journal written by either package replays in the other. Edges are
appended before they fold (SummaryEngineBase.enable_wal), each
checkpoint records the journal offset at its window boundary
(`wal_offset` = edges folded into the carry), and recovery
(`resume_and_replay`) replays exactly the suffix the checkpoint does not
cover, so the recovered windows equal the uninterrupted run's.

Format: segment files `wal_<NNNNNNNN>.seg` under one directory, each
starting with an 8-byte magic, then records back to back:

    [u32 crc32(payload)] [u32 payload_len] [payload]

    payload: u8  kind        (1 = edges, 2 = seal)
             u16 tenant_len, tenant utf-8 bytes
             u64 seq         (per-tenant record ordinal, 1-based)
             u64 start       (per-tenant cumulative edge offset of
                              the record's first edge)
             u32 n           (edge count)
             u8  itemsize    (4 = int32 ids, 8 = int64 ids)
             u8  has_ts
             n×id src, n×id dst, [n×i64 ts]

Records never split across segments; rotation happens between appends
once a segment passes GS_WAL_SEGMENT_BYTES. GS_WAL_FSYNC_S=0 (the
default) fsyncs every append; >0 at most one fsync per interval. Fsync
time lands in the `gs_wal_fsync_seconds` histogram.

The reader tolerates a torn tail (a partial or CRC-failing record at the
end of the last segment, the only place a crash can tear) by dropping
that one record, with a durable `wal_torn_tail` event; the same damage
anywhere else, or a per-tenant sequence gap, raises `WalCorrupt`.

`GS_WAL=0` is the kill switch: `enable_wal()` degrades to a no-op.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import knobs
from . import metrics
from . import telemetry

_MAGIC = b"GSWALSG1"
_HEAD = struct.Struct("<II")          # crc32, payload_len
_SEG_FMT = "wal_%08d.seg"

KIND_EDGES = 1
KIND_SEAL = 2


def enabled() -> bool:
    """GS_WAL=0 is the kill switch: every enable_wal() site no-ops
    and the ingest paths stay bit-identical to a journal-less run."""
    return knobs.get_bool("GS_WAL")


class RetentionCursor:
    """Checkpoint-flush-driven journal retention (GS_WAL_RETAIN).

    Each flush site (the engines' auto-checkpoint) reports the per-tenant replay offset
    its just-SAVED checkpoint covers; the cursor remembers the last
    TWO reported offsets per tenant and truncates the journal at the
    OLDER one. Two, because utils/checkpoint.save keeps two
    generations (current + `.prev`) and load_latest falls back one on
    corruption — a recovery landing on `.prev` must still find its
    whole replay suffix, so the deletable prefix is only what even
    the previous generation no longer needs. A tenant's FIRST flush
    truncates nothing (floor 0): with only one generation on disk
    there is no `.prev` to fall back to, and a damaged sole
    checkpoint means recovery starts fresh and replays from offset
    0 — which must still be possible. Disarmed (the GS_WAL_RETAIN
    default) every call is a no-op, live per call so tests and
    operators can flip it mid-process."""

    def __init__(self):
        self._hist: Dict[str, List[int]] = {}

    def flushed_many(self, wal: Optional["WriteAheadLog"],
                     offsets: Dict[str, int]) -> int:
        """Record one flush boundary covering `offsets` (per-tenant
        cumulative edges) and truncate; returns segments removed. The
        offsets map must name EVERY tenant the flush covers, because
        truncate_covered treats an unnamed tenant's records as offset 0
        (uncovered)."""
        if wal is None or not knobs.get_bool("GS_WAL_RETAIN"):
            return 0
        floors: Dict[str, int] = {}
        for tid, off in offsets.items():
            h = self._hist.setdefault(str(tid), [])
            h.append(int(off))
            del h[:-2]
            # older of the last TWO flushes; a single-entry history
            # floors at 0 — see the class docstring
            floors[str(tid)] = h[0] if len(h) == 2 else 0
        return wal.truncate_covered(floors)

    def flushed(self, wal: Optional["WriteAheadLog"], tenant: str,
                offset: int) -> int:
        """Single-tenant form (the engines' journals)."""
        return self.flushed_many(wal, {str(tenant): int(offset)})


def fsync_interval_s() -> float:
    """GS_WAL_FSYNC_S: 0 (default) fsyncs every append; >0 batches
    fsyncs to at most one per interval."""
    return knobs.get_float("GS_WAL_FSYNC_S")


def segment_bytes() -> int:
    """GS_WAL_SEGMENT_BYTES: rotate to a fresh segment file once the
    current one passes this size (records never split)."""
    return knobs.get_int("GS_WAL_SEGMENT_BYTES")


class WalCorrupt(RuntimeError):
    """Journal damage outside the torn-tail window: a CRC failure or
    truncation NOT at the end of the last segment, or a per-tenant
    sequence gap. `path` names the damaged segment."""

    def __init__(self, path: str, problem: str):
        super().__init__("WAL segment %r is corrupt: %s"
                         % (path, problem))
        self.path = path


def _encode(kind: int, tenant: str, seq: int, start: int,
            src: np.ndarray, dst: np.ndarray,
            ts: Optional[np.ndarray]) -> bytes:
    tb = tenant.encode()
    itemsize = src.dtype.itemsize if len(src) else 4
    head = struct.pack(
        "<BH%dsQQIBB" % len(tb), kind, len(tb), tb, seq, start,
        len(src), itemsize, 0 if ts is None else 1)
    parts = [head, src.tobytes(), dst.tobytes()]
    if ts is not None:
        parts.append(np.asarray(ts, np.int64).tobytes())
    payload = b"".join(parts)
    return _HEAD.pack(zlib.crc32(payload), len(payload)) + payload


def _decode(payload: bytes) -> dict:
    kind, tlen = struct.unpack_from("<BH", payload, 0)
    off = 3
    tenant = payload[off:off + tlen].decode()
    off += tlen
    seq, start, n, itemsize, has_ts = struct.unpack_from(
        "<QQIBB", payload, off)
    off += 22
    dt = np.int32 if itemsize == 4 else np.int64
    src = np.frombuffer(payload, dt, n, off)
    off += n * itemsize
    dst = np.frombuffer(payload, dt, n, off)
    off += n * itemsize
    ts = None
    if has_ts:
        ts = np.frombuffer(payload, np.int64, n, off)
    return {"kind": kind, "tenant": tenant, "seq": seq,
            "start": start, "src": src, "dst": dst, "ts": ts}


def _segments(directory: str) -> List[str]:
    try:
        names = sorted(f for f in os.listdir(directory)
                       if f.startswith("wal_") and f.endswith(".seg"))
    except FileNotFoundError:
        return []
    return [os.path.join(directory, f) for f in names]


def _iter_segment(path: str, is_last: bool) -> Iterator[dict]:
    """Records of one segment. Damage at the TAIL of the last segment
    yields a final {"torn": ...} marker instead of records; damage
    anywhere else raises WalCorrupt."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(_MAGIC) or not data.startswith(_MAGIC):
        if is_last and len(data) < len(_MAGIC) \
                and _MAGIC.startswith(data):
            # segment created, header write torn by the crash
            yield {"torn": "segment header",
                   "dropped_bytes": len(data), "valid_bytes": 0}
            return
        raise WalCorrupt(path, "bad segment magic")
    off = len(_MAGIC)
    while off < len(data):
        tail = len(data) - off
        torn = None
        if tail < _HEAD.size:
            torn = "partial record header (%d bytes)" % tail
        else:
            crc, length = _HEAD.unpack_from(data, off)
            if tail - _HEAD.size < length:
                torn = ("record body truncated (%d of %d bytes)"
                        % (tail - _HEAD.size, length))
            else:
                payload = data[off + _HEAD.size:
                               off + _HEAD.size + length]
                if zlib.crc32(payload) != crc:
                    torn = "record CRC mismatch"
        if torn is not None:
            if not is_last:
                raise WalCorrupt(path, torn + " mid-journal")
            yield {"torn": torn, "dropped_bytes": tail,
                   "valid_bytes": off}
            return
        yield _decode(payload)
        off += _HEAD.size + length


def _scan_records(directory: str) -> Iterator[dict]:
    """Every record of the journal in append order, with seq-gap
    checking per tenant; a torn tail (last segment only) stamps the
    durable `wal_torn_tail` event once and stops."""
    segs = _segments(directory)
    seqs: Dict[str, int] = {}
    for i, path in enumerate(segs):
        for rec in _iter_segment(path, is_last=(i == len(segs) - 1)):
            if "torn" in rec:
                telemetry.event("wal_torn_tail", durable=True,
                                segment=os.path.basename(path),
                                problem=rec["torn"],
                                dropped_bytes=rec["dropped_bytes"])
                metrics.counter_inc("gs_wal_torn_tail_total")
                rec["segment"] = path
                yield rec
                return
            if rec["kind"] == KIND_EDGES:
                prev = seqs.get(rec["tenant"])
                if prev is not None and rec["seq"] != prev + 1:
                    raise WalCorrupt(
                        path, "tenant %r sequence gap (%d after %d)"
                        % (rec["tenant"], rec["seq"], prev))
                seqs[rec["tenant"]] = rec["seq"]
            yield rec


def scan(directory: str) -> dict:
    """Journal summary without materializing edge data: per-tenant
    end offsets (cumulative edges) and record seqs, record/segment
    counts, and whether a seal record closes the journal."""
    offsets: Dict[str, int] = {}
    seqs: Dict[str, int] = {}
    records = 0
    sealed = False
    torn = None
    for rec in _scan_records(directory):
        if "torn" in rec:
            torn = {"segment": rec["segment"],
                    "problem": rec["torn"],
                    "dropped_bytes": rec["dropped_bytes"],
                    "valid_bytes": rec["valid_bytes"]}
            break
        if rec["kind"] == KIND_SEAL:
            sealed = True
            continue
        sealed = False  # edges after a seal re-open the stream
        records += 1
        offsets[rec["tenant"]] = rec["start"] + len(rec["src"])
        seqs[rec["tenant"]] = rec["seq"]
    return {"offsets": offsets, "seqs": seqs, "records": records,
            "segments": len(_segments(directory)), "sealed": sealed,
            "torn": torn}


def replay(directory: str,
           offsets: Optional[Dict[str, int]] = None
           ) -> Iterator[Tuple[str, int, np.ndarray, np.ndarray,
                               Optional[np.ndarray]]]:
    """Yield `(tenant, start, src, dst, ts)` for every journaled edge
    past each tenant's `offsets` entry (cumulative edges; missing
    tenant = 0 = everything). A record straddling its tenant's offset
    is trimmed, so the replayed suffix begins EXACTLY at the
    checkpointed boundary."""
    offsets = offsets or {}
    for rec in _scan_records(directory):
        if "torn" in rec or rec["kind"] != KIND_EDGES:
            continue
        off = int(offsets.get(rec["tenant"], 0))
        start, n = rec["start"], len(rec["src"])
        if start + n <= off:
            continue
        cut = max(0, off - start)
        yield (rec["tenant"], start + cut, rec["src"][cut:],
               rec["dst"][cut:],
               None if rec["ts"] is None else rec["ts"][cut:])


class WriteAheadLog:
    """Appender over one journal directory. Reopening an existing
    directory recovers the per-tenant offsets/seqs from a tolerant
    scan and continues in a FRESH segment — a torn tail is never
    appended after (the damaged bytes stay quarantined in their own
    segment, and replay drops exactly that one record)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        info = scan(directory)
        if info["torn"] is not None:
            # quarantine the torn bytes PHYSICALLY: once a fresh
            # segment follows this one, a leftover damaged tail would
            # read as mid-journal corruption (WalCorrupt) instead of
            # the tolerated one-record fallback. The record was never
            # acknowledged durable, so cutting it is exact.
            torn = info["torn"]
            if torn["valid_bytes"] < len(_MAGIC):
                os.unlink(torn["segment"])
            else:
                with open(torn["segment"], "r+b") as f:
                    f.truncate(torn["valid_bytes"])
        self._offsets: Dict[str, int] = dict(info["offsets"])
        self._seqs: Dict[str, int] = dict(info["seqs"])
        segs = _segments(directory)
        # next segment index must come from the highest EXISTING
        # name, not the count: truncate_covered() deletes prefix
        # segments, and a count-derived index would re-open a live
        # segment and write a second magic header mid-file
        self._seg_no = (max(int(os.path.basename(p)[4:-4])
                            for p in segs) + 1) if segs else 0
        self._file = None
        self._file_bytes = 0
        self._last_fsync = 0.0
        self._pending_sync = False
        self.sealed = False

    # -- segment management -------------------------------------------
    def _ensure_segment(self):
        if self._file is not None \
                and self._file_bytes >= segment_bytes():
            self._rotate()
        if self._file is None:
            path = os.path.join(self.dir, _SEG_FMT % self._seg_no)
            self._seg_no += 1
            self._file = open(path, "ab")
            self._file.write(_MAGIC)
            self._file.flush()
            self._file_bytes = len(_MAGIC)
            metrics.gauge_set("gs_wal_segments",
                              len(_segments(self.dir)))
        return self._file

    def _rotate(self) -> None:
        self._fsync(force=True)
        self._file.close()
        self._file = None
        self._file_bytes = 0

    def _fsync(self, force: bool = False) -> None:
        if self._file is None or not self._pending_sync:
            return
        now = time.monotonic()
        interval = fsync_interval_s()
        if not force and interval > 0 \
                and now - self._last_fsync < interval:
            return
        t0 = time.perf_counter()
        os.fsync(self._file.fileno())
        metrics.observe("gs_wal_fsync_seconds",
                        time.perf_counter() - t0)
        self._last_fsync = now
        self._pending_sync = False

    # -- the append path ----------------------------------------------
    def append(self, tenant: str, src, dst,
               ts=None) -> Tuple[int, int]:
        """Journal one batch of edges for `tenant` BEFORE they enter
        any queue. Returns `(start, end)` — the batch's cumulative
        per-tenant edge offsets; `end` is the offset a checkpoint
        taken after these edges fold would record."""
        src = np.ascontiguousarray(src)
        dst = np.ascontiguousarray(dst)
        if len(src) != len(dst):
            raise ValueError("src/dst length mismatch")
        if src.dtype != dst.dtype or src.dtype.kind != "i" \
                or src.dtype.itemsize not in (4, 8):
            # one itemsize is framed for BOTH id arrays: mismatched
            # or exotic dtypes would serialize fine and replay
            # garbage (a CRC-valid record with wrong data defeats
            # the journal) — canonicalize to int64 instead
            src = src.astype(np.int64)
            dst = dst.astype(np.int64)
        with self._lock:
            if self.sealed:
                raise ValueError(
                    "journal %r is sealed (drained); open a fresh "
                    "WriteAheadLog to accept a new stream" % self.dir)
            f = self._ensure_segment()
            tenant = str(tenant)
            start = self._offsets.get(tenant, 0)
            seq = self._seqs.get(tenant, 0) + 1
            rec = _encode(KIND_EDGES, tenant, seq, start, src, dst,
                          None if ts is None
                          else np.asarray(ts, np.int64))
            f.write(rec)
            f.flush()
            self._pending_sync = True
            self._fsync()
            self._file_bytes += len(rec)
            self._offsets[tenant] = start + len(src)
            self._seqs[tenant] = seq
            metrics.counter_inc("gs_wal_records_total")
            metrics.counter_inc("gs_wal_bytes_total", len(rec))
            return start, start + len(src)

    def sync(self) -> None:
        """Force the batched fsync now (the drain path; also what a
        caller with its own durability boundary uses)."""
        with self._lock:
            self._fsync(force=True)

    def offsets(self) -> Dict[str, int]:
        """Per-tenant cumulative edges journaled so far."""
        with self._lock:
            return dict(self._offsets)

    def seal(self) -> None:
        """Close the journal durably: append the seal record, fsync,
        close — the graceful-drain marker (`wal_sealed` durable
        event). A sealed journal refuses further appends."""
        with self._lock:
            if self.sealed:
                return
            f = self._ensure_segment()
            f.write(_encode(KIND_SEAL, "", 0, 0,
                            np.zeros(0, np.int32),
                            np.zeros(0, np.int32), None))
            f.flush()
            self._pending_sync = True
            self._fsync(force=True)
            self._file.close()
            self._file = None
            self.sealed = True
        telemetry.event("wal_sealed", durable=True, dir=self.dir,
                        tenants=len(self._offsets),
                        edges=sum(self._offsets.values()))

    def close(self) -> None:
        """Close without sealing (the journal stays open for a
        successor process — a crash looks exactly like this plus a
        possibly-torn tail)."""
        with self._lock:
            if self._file is not None:
                self._fsync(force=True)
                self._file.close()
                self._file = None

    # -- retention -----------------------------------------------------
    def truncate_covered(self, offsets: Dict[str, int]) -> int:
        """Delete CLOSED segments every record of which is covered by
        `offsets` (per-tenant cumulative edges a flushed checkpoint
        recorded) — bounded-disk retention that can never delete an
        un-checkpointed edge. Returns segments removed."""
        removed = 0
        with self._lock:
            open_path = (self._file.name
                         if self._file is not None else None)
            for path in _segments(self.dir):
                if path == open_path:
                    continue
                covered = True
                try:
                    for rec in _iter_segment(path, is_last=False):
                        if rec["kind"] != KIND_EDGES:
                            continue
                        end = rec["start"] + len(rec["src"])
                        if end > int(offsets.get(rec["tenant"], 0)):
                            covered = False
                            break
                except WalCorrupt:
                    covered = False  # keep damage for the post-mortem
                if not covered:
                    # segments are append-ordered: the first
                    # uncovered one bounds the deletable prefix
                    break
                os.unlink(path)
                removed += 1
        if removed:
            metrics.gauge_set("gs_wal_segments",
                              len(_segments(self.dir)))
        return removed
