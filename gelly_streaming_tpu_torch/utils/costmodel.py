"""Per-launch cost observatory: each launch wrapper's measured time beside
the bytes and operations its call needs and the card's bound for them.

Port of the JAX package's `utils/costmodel.py`. There the rows come from
XLA's `cost_analysis()` of each compiled program (or a stated analytic
model for the Pallas kernels, `record_analytic`) joined with the
dispatch spans of the run ledger. Here every row is an analytic model:

- The launch wrappers on the engine paths — `WindowCounter.__call__`
  (ops/window_counter.py, row 2 of PERF.md §6), `WindowSummary.__call__`
  (ops/window_summary.py, row 3: the summary kernel and its counter, one
  call), `GnnRound.__call__` (ops/gnn_round.py, row 5),
  `WindowSnapshot.__call__` (ops/window_snapshot.py, row S: the
  driver's snapshot kernel, as "window_snapshot" on full rows,
  "window_snapshot_masks" with the changed-slot masks and
  "window_snapshot_delta" on the delta wire) — open a
  `launch(program, tensors, work)` scope around their launches. Armed,
  the scope records a CUDA event on the current stream before and after
  them (the host clock on the CPU, where the plain versions run
  synchronously) and keys the row by (program, the shape signature of
  `tensors`). A resident super-batch's CUDA graph replay
  (ops/resident_engine.SuperBatchGraphs) is one launch of its graph
  family, its work the sum of what its capture launched.
- The bytes and operations of a call come from `counter_work`,
  `summary_work`, `gnn_work` and `snapshot_work`: the counts chip_smoke.py's `kernels`
  line computes its bound from (each input read once, each output
  written once; the operations its data needs). A launch wrapper knows
  only the shapes, so it counts the data-dependent operations (valid
  slots, row compares) as 0: its operations are a lower bound, its bytes
  exact. The counter, summary and snapshot rows are bound by their
  bytes and the
  GNN round's operations depend on its shape alone, so each row's bound
  equals the kernels line's at the same shape (chip_smoke.py's phase
  costmodel_health checks it).
- The peaks come from one table, `PEAKS`, keyed by the card's name
  (`torch.cuda.get_device_name`); `bound()` is the one roofline both the
  rows and chip_smoke.py use. On the CPU, or a card not in the table,
  the bound fields are None.

No sync is added on the dispatch path: ended events are read with
`Event.query()` as later launches come, and `report()` (never called by
the engines) waits for the rest. Nested wrappers (the summary call's
counter) record nothing of their own. Disarmed (`GS_COSTMODEL=0`, the
default), `launch` returns a shared no-op scope after one knob read, and
results are bit-identical.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import knobs
from . import telemetry

# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): HBM bytes/s; the float32 rate outside the tensor cores, taken
# as the rate of 32-bit scalar operations (compares, adds); the dense
# tensor-core rates at fp16 (exact for the GNN lattice's products) and
# at int8 (exact for 0/1 adjacency products). Keyed by the name
# torch.cuda.get_device_name gives the card.
H100 = "NVIDIA H100 80GB HBM3"
PEAKS: Dict[str, Dict[str, float]] = {
    H100: {"bytes_s": 3.35e12, "scalar": 67e12, "fp16_tc": 989e12,
           "int8_tc": 1979e12},
}


def enabled() -> bool:
    """GS_COSTMODEL arms the observatory."""
    return knobs.get_bool("GS_COSTMODEL")


def bound(nbytes: float, ops: float, kind: str = "scalar",
          card: str = H100) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of `nbytes` over the card's
    memory rate and `ops` over its peak rate for operations of `kind`
    ("scalar", "fp16_tc", "int8_tc"); bound_by is "bytes" or
    "operations"."""
    peak = PEAKS[card]
    t_bytes, t_ops = nbytes / peak["bytes_s"], ops / peak[kind]
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


# ----------------------------------------------------------------------
# the work of one call (shared with chip_smoke.py's kernels line)
# ----------------------------------------------------------------------
def slab_bytes(windows: int, eb: int, wire: str = "standard") -> int:
    """Device bytes of a [windows, eb] chunk on `wire`: 9 a slot on the
    standard wire (int32 src, int32 dst, bool valid), 4 a slot plus 4 a
    window on the compact one."""
    if wire == "compact":
        return windows * eb * 4 + windows * 4
    return windows * eb * 9


def counter_work(windows: int, eb: int, wire: str = "standard",
                 compares: int = 0) -> Tuple[int, int, str]:
    """(bytes, operations, kind) of one window-counter call: the slab
    read once and two ints a window written; one operation a slot and
    the row compares of its distinct oriented edges (`compares`, known
    only from the data)."""
    return (slab_bytes(windows, eb, wire) + 8 * windows,
            windows * eb + compares, "scalar")


def summary_work(windows: int, eb: int, vb: int, wire: str = "standard",
                 slots: int = 0, compares: int = 0,
                 rows: int = 1) -> Tuple[int, int, str]:
    """(bytes, operations, kind) of one summary call, its triangle stage
    included, over `rows` carry rows of `windows` windows each: the slab
    read once, each carry row (16(vb+1) bytes) read and written once,
    20 bytes out a window; per valid slot (`slots`, known from the data)
    2 degree adds and 3 unions; per carry slot one pass of 3 root walks
    in the whole call; the triangle stage's one operation a slot and its
    row compares."""
    total = rows * windows * eb
    nbytes = rows * (slab_bytes(windows, eb, wire)
                     + 2 * 16 * (vb + 1) + 20 * windows)
    ops = 5 * slots + 3 * rows * (vb + 1) + total + compares
    return nbytes, ops, "scalar"


def gnn_work(windows: int, eb: int, vb: int,
             feat: int) -> Tuple[int, int, str]:
    """(bytes, operations, kind) of one GNN round call: the edge slab,
    the [vb+1, F] feature slab in and out, W and b, the [4, W] sums; the
    dense update's 2(vb+1)F² operations a window on the fp16 tensor
    cores."""
    nbytes = (windows * 9 * eb + 2 * 4 * (vb + 1) * feat
              + 4 * feat * (feat + 1) + 16 * windows)
    return nbytes, windows * 2 * (vb + 1) * feat * feat, "fp16_tc"


def snapshot_work(windows: int, eb: int, vb: int, egress: str = "full",
                  cap: int = 0, fields=(True, True, True),
                  masks: bool = False, slots: int = 0
                  ) -> Tuple[int, int, str]:
    """(bytes, operations, kind) of one call of the driver's snapshot
    kernel over `windows` windows of `eb` slots, with the analytics
    `fields` (degrees, labels, the cover's odd flag) on: the slab read
    once; each carry on (4(vb+1) bytes of degrees, 4(vb+1) of labels,
    8(vb+1) of cover) read and written once; and per window, on full
    rows, each field's row of vb slots (4, 4 and 1 bytes a slot) and
    with `masks` its changed-slot mask (1 byte a slot), or on the delta
    wire each field's count (4 bytes) and its index and value rows at
    `cap` (4 + 4, 4 + 4 and 4 + 1 bytes an entry: the rows the kernel
    may fill, since how many it fills is known only after the call).
    Operations: per valid slot (`slots`, known from the data) 2 degree
    adds and 3 unions, per slot and window 3 root walks."""
    width = (4, 4, 1)
    carry = (4, 4, 8)
    nbytes = slab_bytes(windows, eb) + sum(
        2 * c * (vb + 1) for c, on in zip(carry, fields) if on)
    for w, on in zip(width, fields):
        if not on:
            continue
        if egress == "delta":
            nbytes += windows * (4 + cap * (4 + w))
        else:
            nbytes += windows * vb * (w + (1 if masks else 0))
    return nbytes, 5 * slots + 3 * vb * windows, "scalar"


# ----------------------------------------------------------------------
# signature rendering (the row key and the dispatch-span tag)
# ----------------------------------------------------------------------
_DTYPE_ABBR = {
    "int32": "i32", "int64": "i64", "uint16": "u16", "uint32": "u32",
    "float32": "f32", "float64": "f64", "bfloat16": "bf16",
    "bool": "b1", "bool_": "b1", "int8": "i8", "uint8": "u8",
    "float16": "f16",
}


def _render_leaf(leaf) -> str:
    if isinstance(leaf, tuple) and leaf:
        if leaf[0] == "arr":
            _tag, shape, dtype = leaf
            dtype = str(dtype).replace("torch.", "")
            return "%s[%s]" % (_DTYPE_ABBR.get(dtype, dtype),
                               ",".join(str(d) for d in shape))
        if leaf[0] == "seq":
            return "(%s)" % ",".join(_render_leaf(e) for e in leaf[1:])
        if leaf[0] == "map":
            return "{%s}" % ",".join(
                "%s=%s" % (k, _render_leaf(v)) for k, v in leaf[1:])
        if leaf[0] == "py":
            return leaf[1]
    return str(leaf)


def sig_key(sig: tuple) -> str:
    """Compact deterministic string of a `metrics.abstract_sig`
    signature (e.g. ``i32[64,32768],i32[64,32768],b1[64,32768]``): the
    `sig` of a row and of the dispatch spans' tags."""
    return ",".join(_render_leaf(leaf) for leaf in sig)


def shape_sig(*specs) -> str:
    """The signature of a launch over arrays of (dtype, shape) `specs`
    (dtype a torch or numpy dtype, or its name), as `sig_key` renders
    them: what a wrapper's row is keyed by."""
    return ",".join(
        _render_leaf(("arr", tuple(int(d) for d in shape),
                      _dtype_name(dtype)))
        for dtype, shape in specs)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str) or "torch." in str(dtype):
        return str(dtype)
    import numpy as np

    return np.dtype(dtype).name


def tensor_sig(tensors) -> str:
    """shape_sig of a sequence of tensors."""
    return shape_sig(*((t.dtype, t.shape) for t in tensors))


# ----------------------------------------------------------------------
# the process-global registry
# ----------------------------------------------------------------------
class _Registry:
    def __init__(self):
        self.lock = threading.RLock()
        # (program, sig) -> cost entry dict
        self.programs: Dict[Tuple[str, str], dict] = {}
        # (program, sig) -> {"count": n, "total_s": s} measured launches
        self.measured: Dict[Tuple[str, str], dict] = {}
        # launches whose end event has not been read yet:
        # [(key, start event, end event)], oldest first
        self.pending: List[tuple] = []


_REG: Optional[_Registry] = None
_REG_LOCK = threading.Lock()
_TLS = threading.local()


def _reg() -> _Registry:
    global _REG
    if _REG is None:
        with _REG_LOCK:
            if _REG is None:
                _REG = _Registry()
    return _REG


def reset() -> None:
    """Test hook: drop every row and measurement."""
    global _REG
    with _REG_LOCK:
        _REG = None


def classify(entry: dict) -> dict:
    """Attach the roofline verdict to one entry in place, in the JAX
    package's keys (`flops` holds the operations, `bound` is "bytes" or
    "flops", `roofline_s` the bound in seconds) and the kernels line's
    (`bound_ms`, `bound_by`), against the card named in `card`. An
    entry without both counts, or of a card not in PEAKS, gets bound
    "unknown" and None fields."""
    entry.setdefault("flops", None)
    entry.setdefault("bytes_accessed", None)
    flops, nbytes = entry.get("flops"), entry.get("bytes_accessed")
    peak = PEAKS.get(entry.get("card"))
    kind = entry.get("kind", "scalar")
    if peak is None or flops is None or nbytes is None:
        entry.update(machine_balance_flops_per_byte=None,
                     arith_intensity_flops_per_byte=None,
                     bound="unknown", roofline_s=None, bound_ms=None,
                     bound_by=None)
        return entry
    balance = peak[kind] / peak["bytes_s"]
    entry["machine_balance_flops_per_byte"] = round(balance, 3)
    entry["arith_intensity_flops_per_byte"] = (
        round(flops / nbytes, 4) if nbytes else None)
    ms, by = bound(nbytes, flops, kind, entry["card"])
    entry["bound_ms"], entry["bound_by"] = ms, by
    entry["bound"] = "bytes" if by == "bytes" else "flops"
    entry["roofline_s"] = ms / 1e3
    return entry


def record_analytic(program: str, sig: str, flops, bytes_accessed,
                    kind: str = "scalar", card: Optional[str] = None,
                    **extra) -> None:
    """Register the stated cost of `program` at signature `sig`: `flops`
    operations of `kind`, `bytes_accessed` bytes, on the card named
    `card` (None: the CPU). A row with no launch yet, which later
    launches at that signature join. Idempotent per (program, sig);
    armed only."""
    if not enabled():
        return
    key = (program, str(sig))
    reg = _reg()
    with reg.lock:
        if key in reg.programs:
            return
        entry = {"program": program, "sig": key[1], "model": "analytic",
                 "flops": None if flops is None else int(flops),
                 "bytes_accessed": (None if bytes_accessed is None
                                    else int(bytes_accessed)),
                 "kind": kind, "card": card}
        entry.update(extra)
        reg.programs[key] = classify(entry)
    telemetry.event("costmodel.capture", program=program, sig=key[1],
                    flops=entry.get("flops"),
                    bytes_accessed=entry.get("bytes_accessed"),
                    bound=entry.get("bound"), model="analytic")


def card_of(device) -> Optional[str]:
    """The name of the card `device` is (None for the CPU)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


# ----------------------------------------------------------------------
# the launch scope
# ----------------------------------------------------------------------
class _NoScope:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoScope()


class _Scope:
    """One armed launch: events (or host clock) around the wrapper's
    launches, then the row's bookkeeping."""

    __slots__ = ("key", "work", "device", "start", "t0")

    def __init__(self, key, work, device):
        self.key, self.work, self.device = key, work, device
        self.start = self.t0 = None

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        if self.device.type == "cuda":
            import torch

            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        else:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        _TLS.depth -= 1
        if exc_type is not None:
            return False
        end_t = None
        end = None
        if self.start is not None:
            import torch

            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
        else:
            end_t = time.perf_counter() - self.t0
        _note(self.key, self.work, self.device)
        telemetry.tag_dispatch(program=self.key[0], sig=self.key[1])
        reg = _reg()
        with reg.lock:
            if end is not None:
                reg.pending.append((self.key, self.start, end))
            else:
                _add_measure(reg, self.key, end_t)
            _harvest(reg, wait=False)
        return False


class _Collect:
    """A CUDA graph capture's scope: the work of every outermost launch
    made inside it is summed, nothing is timed."""

    __slots__ = ("work",)

    def __init__(self):
        self.work = [0, 0, None]

    def __enter__(self):
        _TLS.collect = self
        return self

    def __exit__(self, *exc):
        _TLS.collect = None
        return False


class _Collected:
    __slots__ = ("coll", "work")

    def __init__(self, coll, work):
        self.coll, self.work = coll, work

    def __enter__(self):
        _TLS.depth = getattr(_TLS, "depth", 0) + 1
        return self

    def __exit__(self, exc_type, *exc):
        _TLS.depth -= 1
        if exc_type is None:
            nbytes, ops, kind = self.work()
            acc = self.coll.work
            acc[0] += nbytes
            acc[1] += ops
            acc[2] = kind if acc[2] in (None, kind) else "scalar"
        return False


def collect() -> _Collect:
    """Scope of a CUDA graph capture: `.work` is then (bytes, operations,
    kind) of the launches captured (each outermost wrapper's call)."""
    return _Collect()


def launch(program: str, tensors, work, device):
    """The scope a launch wrapper opens around its launches: `tensors`
    key the row's signature, `work()` gives (bytes, operations, kind) of
    the call. A no-op disarmed, inside another wrapper's scope, or (but
    for the work sum) inside a graph capture."""
    coll = getattr(_TLS, "collect", None)
    if getattr(_TLS, "depth", 0):
        return _NOOP
    if coll is not None:
        return _Collected(coll, work)
    if not enabled():
        return _NOOP
    import torch

    return _Scope((program, tensor_sig(tensors)), work,
                  torch.device(device))


def replay(program: str, sig: str, work: tuple, device):
    """The scope of one CUDA graph replay of `program` (a graph family)
    whose capture launched `work` ((bytes, operations, kind))."""
    if getattr(_TLS, "depth", 0) or not enabled() or work[2] is None:
        return _NOOP
    import torch

    return _Scope((program, sig), lambda: tuple(work),
                  torch.device(device))


def _note(key, work, device) -> None:
    """Create the row of `key` at its first launch."""
    reg = _reg()
    with reg.lock:
        if key in reg.programs:
            return
    nbytes, ops, kind = work()
    record_analytic(key[0], key[1], ops, nbytes, kind=kind,
                    card=card_of(device))


def _add_measure(reg, key, seconds: float) -> None:
    d = reg.measured.setdefault(key, {"count": 0, "total_s": 0.0})
    d["count"] += 1
    d["total_s"] += seconds


def _harvest(reg, wait: bool) -> None:
    """Fold the ended launches' event times into the rows, oldest first,
    stopping at the first still running unless `wait` (the lock is
    held)."""
    done = 0
    for key, start, end in reg.pending:
        if wait:
            end.synchronize()
        elif not end.query():
            break
        _add_measure(reg, key, start.elapsed_time(end) / 1e3)
        done += 1
    del reg.pending[:done]


# ----------------------------------------------------------------------
# reporting
# ----------------------------------------------------------------------
def programs() -> Dict[Tuple[str, str], dict]:
    reg = _reg()
    with reg.lock:
        return {k: dict(v) for k, v in reg.programs.items()}


def join_measure(entry: dict, count: int, total_s: float) -> dict:
    """Attach measured economics to one classified entry: launches,
    mean seconds a launch, achieved GFLOP/s and GB/s, and the bound's
    share of the mean (`roofline_frac`)."""
    entry["dispatches"] = count
    entry["measured_total_s"] = round(total_s, 6)
    if not count or total_s <= 0:
        return entry
    mean_s = total_s / count
    entry["measured_mean_s"] = round(mean_s, 9)
    flops, nbytes = entry.get("flops"), entry.get("bytes_accessed")
    if flops:
        entry["achieved_gflops"] = round(flops / mean_s / 1e9, 3)
    if nbytes:
        entry["achieved_gbps"] = round(nbytes / mean_s / 1e9, 3)
    roof = entry.get("roofline_s")
    if roof:
        entry["roofline_frac"] = round(roof / mean_s, 6)
    return entry


def report() -> List[dict]:
    """One row per (program, signature): the stated cost, its bound and
    the launches measured so far (waiting for the ones still running),
    sorted by measured time, then program and signature."""
    reg = _reg()
    with reg.lock:
        _harvest(reg, wait=True)
        progs = {k: dict(v) for k, v in reg.programs.items()}
        meas = {k: dict(v) for k, v in reg.measured.items()}
    rows = []
    for key, entry in progs.items():
        d = meas.get(key)
        rows.append(join_measure(entry, d["count"] if d else 0,
                                 d["total_s"] if d else 0.0))
    rows.sort(key=lambda r: (-r.get("measured_total_s", 0.0),
                             r.get("program") or "", r.get("sig") or ""))
    return rows
