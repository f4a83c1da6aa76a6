"""Per-window provenance ledger: a durable record, per finalized window,
of what was computed, where, and from which journal span.

Port of the JAX package's `utils/provenance.py`, in its format: segment
files `prov_<NNNNNNNN>.seg` under one directory, an 8-byte magic, then
records back to back:

    [u32 crc32(payload)] [u32 payload_len] [payload]

    payload: canonical JSON (sorted keys, compact separators) of
             {digest, knobs, program, sig, tenant, tier,
              wal_hi, wal_lo, window}

The engines emit one record a finalized window at the journal's cursor
arithmetic (`wal_lo` = windows_done × eb), under the JAX engines' tier
and program names, with `digest` the sha256 of the summary's canonical
JSON; the columnar driver emits one a window with `wal_lo` / `wal_hi`
at its edges_done cursor and `digest` its `result_digest`. On equal
input the port's records equal the JAX package's in
every field but `knobs`, the fingerprint of the registry of the process
that computed the window (each package registers its own knobs).
Records carry no wall-clock field, so a kill, a resume and a journal
replay re-emit byte-identical payloads for the replayed windows.

Records never split across segments; rotation follows
GS_WAL_SEGMENT_BYTES and GS_PROVENANCE_RETAIN bounds the closed
segments kept (0 = all). The reader tolerates a torn tail of the last
segment (a durable `provenance_torn_tail` event); damage elsewhere
raises `ProvenanceCorrupt`. Reopening a damaged directory truncates the
torn bytes.

`GS_PROVENANCE=0` (the default), or no GS_PROVENANCE_DIR, disarms
`emit()`: a guarded no-op.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib
from typing import Dict, Iterator, List, Optional

from . import knobs
from . import metrics
from . import telemetry

_MAGIC = b"GSPRVSG1"
_HEAD = struct.Struct("<II")          # crc32, payload_len
_SEG_FMT = "prov_%08d.seg"

# record fields, in canonical (sorted) order — _encode_payload writes
# exactly these keys, so every writer produces byte-identical payloads
# for identical records regardless of call-site dict ordering
FIELDS = ("digest", "knobs", "program", "sig", "tenant", "tier",
          "wal_hi", "wal_lo", "window")


def enabled() -> bool:
    """GS_PROVENANCE=0 (default) is the kill switch: every emit()
    site no-ops and finalize paths stay ledger-less."""
    return knobs.get_bool("GS_PROVENANCE")


def directory() -> Optional[str]:
    """GS_PROVENANCE_DIR: where the ledger segments live; unset
    disarms emit() even with GS_PROVENANCE=1 (nowhere to write)."""
    return knobs.get_path("GS_PROVENANCE_DIR")


def armed() -> bool:
    return enabled() and directory() is not None


class ProvenanceCorrupt(RuntimeError):
    """Ledger damage outside the torn-tail window: a CRC failure or
    truncation NOT at the end of the last segment. `path` names the
    damaged segment."""

    def __init__(self, path: str, problem: str):
        super().__init__("provenance segment %r is corrupt: %s"
                         % (path, problem))
        self.path = path


# ----------------------------------------------------------------------
# digests
# ----------------------------------------------------------------------
def summary_digest(summary) -> str:
    """sha256 hex of one window summary's canonical JSON (sorted
    keys, compact separators) — the cross-tier comparison key. Every
    tier's summary dicts are plain host scalars by the time they are
    handed to the caller, so canonical JSON is total and stable."""
    blob = json.dumps(summary, sort_keys=True,
                      separators=(",", ":"), default=_jsonable)
    return hashlib.sha256(blob.encode()).hexdigest()


def result_digest(res) -> str:
    """sha256 hex of a driver WindowResult's analytic content, as the
    JAX package computes it: window_start, num_edges, the raw bytes of
    the degree, label and odd-flag snapshots (an absent one hashes as a
    presence marker) and the triangle count ("-" while the call's
    triangle flush is still pending, as at every finalize)."""
    import numpy as np

    h = hashlib.sha256()
    h.update(b"%d|%d" % (int(res.window_start), int(res.num_edges)))
    for name in ("degrees", "cc_labels", "bipartite_odd"):
        a = getattr(res, name, None)
        h.update(b"|" + name.encode() + b":")
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    t = getattr(res, "triangles", None)
    h.update(b"|tri:" + (b"-" if t is None else b"%d" % int(t)))
    return h.hexdigest()


def _jsonable(x):
    # numpy scalars reach summaries on some host paths; canonicalize
    # to the python value so host and device tiers hash identically
    if hasattr(x, "item"):
        return x.item()
    raise TypeError("summary field %r is not canonically hashable"
                    % (type(x).__name__,))


_FP_LOCK = threading.Lock()
_FP_CACHE: Dict[tuple, str] = {}


def knob_fingerprint() -> str:
    """sha256 hex prefix over every registered knob's EFFECTIVE raw
    text (unset = its registered default) — the configuration
    identity a record was computed under. Two processes with equal
    fingerprints ran the same knob surface, so digest divergence
    between their records is a real computation difference, never a
    config drift. PATH-kind knobs (trace dirs, cache dirs, this
    ledger's own directory) are deployment-local and never change a
    computed value, so they are excluded — the fingerprint must
    survive a tenant migration to a host with different paths, and a
    crash recovery into a fresh workdir. Cached per
    effective-environment snapshot (reads are live; tests flip knobs
    mid-process)."""
    names = sorted(n for n in knobs.REGISTRY
                   if knobs.REGISTRY[n].kind != "path")
    snap = tuple(knobs._raw(n) for n in names)
    with _FP_LOCK:
        got = _FP_CACHE.get(snap)
        if got is not None:
            return got
        blob = "\n".join(
            "%s=%s" % (n, v if v is not None
                       else repr(knobs.REGISTRY[n].default))
            for n, v in zip(names, snap))
        fp = hashlib.sha256(blob.encode()).hexdigest()[:16]
        if len(_FP_CACHE) > 64:
            _FP_CACHE.clear()
        _FP_CACHE[snap] = fp
        return fp


# ----------------------------------------------------------------------
# framing
# ----------------------------------------------------------------------
def _encode_payload(rec: dict) -> bytes:
    return json.dumps({k: rec.get(k) for k in FIELDS},
                      sort_keys=True,
                      separators=(",", ":")).encode()


def _frame(payload: bytes) -> bytes:
    return _HEAD.pack(zlib.crc32(payload), len(payload)) + payload


def _segments(dirpath: str) -> List[str]:
    try:
        names = sorted(f for f in os.listdir(dirpath)
                       if f.startswith("prov_") and f.endswith(".seg"))
    except FileNotFoundError:
        return []
    return [os.path.join(dirpath, f) for f in names]


def _iter_segment(path: str, is_last: bool) -> Iterator[dict]:
    """Records of one segment. Damage at the TAIL of the last segment
    yields a final {"torn": ...} marker; damage anywhere else raises
    ProvenanceCorrupt (silent mid-ledger loss would hide an audit
    hole)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < len(_MAGIC) or not data.startswith(_MAGIC):
        if is_last and len(data) < len(_MAGIC) \
                and _MAGIC.startswith(data):
            yield {"torn": "segment header",
                   "dropped_bytes": len(data), "valid_bytes": 0}
            return
        raise ProvenanceCorrupt(path, "bad segment magic")
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
                raise ProvenanceCorrupt(path, torn + " mid-ledger")
            yield {"torn": torn, "dropped_bytes": tail,
                   "valid_bytes": off}
            return
        yield json.loads(payload)
        off += _HEAD.size + length


def scan(dirpath: str) -> dict:
    """Every intact record in append order plus damage status:
    {"records": [...], "segments": n, "torn": None | {...}}. A torn
    tail (last segment only) stamps the durable `provenance_torn_tail`
    event once and stops the scan there."""
    records: List[dict] = []
    torn = None
    segs = _segments(dirpath)
    for i, path in enumerate(segs):
        for rec in _iter_segment(path, is_last=(i == len(segs) - 1)):
            if "torn" in rec:
                telemetry.event("provenance_torn_tail", durable=True,
                                segment=os.path.basename(path),
                                problem=rec["torn"],
                                dropped_bytes=rec["dropped_bytes"])
                metrics.counter_inc("gs_provenance_torn_tail_total")
                torn = {"segment": path, "problem": rec["torn"],
                        "dropped_bytes": rec["dropped_bytes"],
                        "valid_bytes": rec["valid_bytes"]}
                break
            records.append(rec)
        if torn is not None:
            break
    return {"records": records, "segments": len(segs), "torn": torn}


# ----------------------------------------------------------------------
# the appender
# ----------------------------------------------------------------------
class ProvenanceLedger:
    """Appender over one ledger directory. Reopening an existing
    directory quarantines a torn tail physically (truncate/unlink —
    the record was never acknowledged) and continues in a FRESH
    segment, exactly the WAL's reopen contract."""

    def __init__(self, dirpath: str):
        self.dir = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self._lock = threading.Lock()
        info = scan(dirpath)
        if info["torn"] is not None:
            torn = info["torn"]
            if torn["valid_bytes"] < len(_MAGIC):
                os.unlink(torn["segment"])
            else:
                with open(torn["segment"], "r+b") as f:
                    f.truncate(torn["valid_bytes"])
        segs = _segments(dirpath)
        # next index from the highest EXISTING name, not the count:
        # retention deletes prefix segments, and a count-derived index
        # would re-open a live segment mid-file (the WAL's lesson)
        self._seg_no = (max(int(os.path.basename(p)[5:-4])
                            for p in segs) + 1) if segs else 0
        self._file = None
        self._file_bytes = 0

    def _ensure_segment(self):
        if self._file is not None \
                and self._file_bytes >= knobs.get_int(
                    "GS_WAL_SEGMENT_BYTES"):
            self._file.close()
            self._file = None
            self._file_bytes = 0
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
        """GS_PROVENANCE_RETAIN: keep at most that many CLOSED
        segments (0 = keep all). Runs at rotation, so the open
        segment is never a candidate."""
        keep = knobs.get_int("GS_PROVENANCE_RETAIN")
        if keep <= 0:
            return
        closed = _segments(self.dir)
        for path in closed[:-keep] if len(closed) > keep else []:
            os.unlink(path)

    def append(self, rec: dict) -> None:
        """Durably append one record (fsync per append: a finalize
        already synced its WAL span, and records are ~200 bytes)."""
        frame = _frame(_encode_payload(rec))
        with self._lock:
            f = self._ensure_segment()
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
            self._file_bytes += len(frame)
        metrics.counter_inc("gs_provenance_records_total")

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# ----------------------------------------------------------------------
# the module singleton every finalize owner writes through
# ----------------------------------------------------------------------
_LOCK = threading.Lock()
_LEDGER: Optional[ProvenanceLedger] = None


def _ledger() -> Optional[ProvenanceLedger]:
    global _LEDGER
    d = directory()
    if d is None:
        return None
    with _LOCK:
        if _LEDGER is None or _LEDGER.dir != d:
            if _LEDGER is not None:
                _LEDGER.close()
            _LEDGER = ProvenanceLedger(d)
        return _LEDGER


def emit(*, tenant: str, window: int, wal_lo: int, wal_hi: int,
         tier: str, program: str, summary=None,
         digest: Optional[str] = None,
         sig: Optional[str] = None) -> None:
    """Record one finalized window. A guarded no-op unless armed
    (GS_PROVENANCE=1 AND GS_PROVENANCE_DIR set) — the single call
    every finalize owner makes, cheap enough to sit on the hot path
    disarmed. Pass `summary` (digested here) or a precomputed
    `digest`."""
    if not armed():
        return
    if digest is None:
        digest = summary_digest(summary)
    led = _ledger()
    if led is None:
        return
    led.append({
        "tenant": str(tenant),
        "window": int(window),
        "wal_lo": int(wal_lo),
        "wal_hi": int(wal_hi),
        "tier": str(tier),
        "program": str(program),
        "sig": None if sig is None else str(sig),
        "knobs": knob_fingerprint(),
        "digest": digest,
    })


def reset() -> None:
    """Close and forget the singleton (tests / directory swaps)."""
    global _LEDGER
    with _LOCK:
        if _LEDGER is not None:
            _LEDGER.close()
            _LEDGER = None
    with _FP_LOCK:
        _FP_CACHE.clear()
