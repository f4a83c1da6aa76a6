"""ctypes bindings of the native host runtime (native/ingest.cpp): edge
parsing, tumbling-window assignment, the vertex interner, the carried
snapshot fold, the exact triangle stream counter and the fused windowed
reduce.

Port of the JAX package's `native/__init__.py` (:26-425). ingest.cpp
and its Makefile are copies of that package's. g++ builds the library
at first use with the Makefile's CXX and CXXFLAGS into
`gelly_streaming_tpu_torch/_build/libgsnative-<hash>.so` (listed in
.gitignore; the hash covers the source and the flags, so an edited
source builds anew). Parsing, window assignment and interning keep a
Python form with the same results where the library cannot build;
`available()` says which form is live (`triangles_available()`,
`snapshot_available()` and `windowed_reduce_available()` for the three
folds), and `build_error()` why the library is missing. `snapshot_windows`, `triangle_count_stream`
and `windowed_reduce` return None without the library: their callers
(ops/host_snapshot.py, ops/triangles.py, ops/windowed_reduce.py) decide
what stands in, and a pinned native tier raises there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "ingest.cpp"
BUILD_DIR = _DIR.parent / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_lock = threading.Lock()        # one build, whichever thread asks first


def _make_vars() -> Tuple[str, list]:
    """(CXX, CXXFLAGS) as the Makefile sets them."""
    found = {"CXX": "g++", "CXXFLAGS": ""}
    for line in (_DIR / "Makefile").read_text().splitlines():
        m = re.match(r"\s*(CXX|CXXFLAGS)\s*\?=\s*(.*)$", line)
        if m:
            found[m.group(1)] = m.group(2).strip()
    return found["CXX"], found["CXXFLAGS"].split()


def library_path() -> Path:
    cxx, flags = _make_vars()
    h = hashlib.sha256(" ".join([cxx] + flags).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / ("libgsnative-%s.so" % h.hexdigest()[:16])


def _build(path: Path) -> None:
    """g++ with the Makefile's flags into `path` (atomic: a tmp name per
    process, then a rename)."""
    cxx, flags = _make_vars()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name("%s.%d.tmp.so" % (path.stem, os.getpid()))
    try:
        subprocess.run([cxx, *flags, "-shared", "-o", str(tmp),
                        str(_SOURCE)], check=True, capture_output=True,
                       text=True, timeout=300)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_SIGNATURES = {
    "gs_parse_edges": (ctypes.c_int64, [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int64, _I64P, _I64P,
                                        _I64P]),
    "gs_assign_windows": (None, [_I64P, ctypes.c_int64, ctypes.c_int64,
                                 _I64P]),
    "gs_interner_new": (ctypes.c_void_p, []),
    "gs_interner_free": (None, [ctypes.c_void_p]),
    "gs_interner_size": (ctypes.c_int64, [ctypes.c_void_p]),
    "gs_interner_intern": (None, [ctypes.c_void_p, _I64P, ctypes.c_int64,
                                  _I32P]),
    "gs_interner_lookup": (None, [ctypes.c_void_p, _I32P, ctypes.c_int64,
                                  _I64P]),
    "gs_triangle_count_stream": (ctypes.c_int64, [_I64P, _I64P,
                                                  ctypes.c_int64,
                                                  ctypes.c_int64, _I64P]),
    "gs_snapshot_windows": (ctypes.c_int64, [
        _I32P, _I32P, _I64P, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, _I32P, _I32P, _I32P, _I32P, _I32P, _I32P]),
    # windowed reduce: ids, ids, values, n, eb, vbp, op, direction,
    # cells, counts (the suffix names the id, value and output widths)
    "gs_windowed_reduce": (ctypes.c_int64, [
        _I64P, _I64P, _I64P] + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2
        + [_I64P, _I64P]),
    "gs_windowed_reduce_i32": (ctypes.c_int64, [
        _I32P, _I32P, _I32P] + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2
        + [_I64P, _I64P]),
    "gs_windowed_reduce_i32o": (ctypes.c_int64, [
        _I32P, _I32P, _I32P] + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2
        + [_I32P, _I32P]),
    "gs_windowed_reduce_i64i32o": (ctypes.c_int64, [
        _I64P, _I64P, _I32P] + [ctypes.c_int64] * 3 + [ctypes.c_int32] * 2
        + [_I32P, _I32P]),
}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if not _tried:
            _lib = _open()
            _tried = True
    return _lib


def _open() -> Optional[ctypes.CDLL]:
    """The library, built first where missing; None (and `_error` set)
    where it cannot build or load."""
    global _error
    path = library_path()
    try:
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
    except subprocess.CalledProcessError as e:
        _error = "g++ failed:\n%s" % e.stderr
        return None
    except (OSError, subprocess.SubprocessError) as e:
        _error = "%s: %s" % (type(e).__name__, e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """True when the library is built and loaded (else the Python forms
    of parsing, window assignment and interning are live)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available, or None when it is."""
    _load()
    return _error


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(_I64P)


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(_I32P)


def parse_edge_bytes(data: bytes) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Parse 'src dst [ts]' lines into int64 COO arrays (ts = -1 where a
    line has no third field); a line that does not parse is dropped."""
    lib = _load()
    if lib is None:
        return _parse_edge_bytes_py(data)
    max_edges = data.count(b"\n") + 1
    src = np.empty(max_edges, np.int64)
    dst = np.empty(max_edges, np.int64)
    ts = np.empty(max_edges, np.int64)
    n = lib.gs_parse_edges(data, len(data), max_edges, _i64ptr(src),
                           _i64ptr(dst), _i64ptr(ts))
    return src[:n].copy(), dst[:n].copy(), ts[:n].copy()


def parse_edge_file(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        return parse_edge_bytes(f.read())


def _parse_edge_bytes_py(data: bytes):
    """The Python form of gs_parse_edges, with the same results."""
    src_l, dst_l, ts_l = [], [], []
    for line in data.decode().splitlines():
        fields = line.split()
        if len(fields) >= 2:
            try:  # the whole line first, so a bad field drops it all
                row = (int(fields[0]), int(fields[1]),
                       int(fields[2]) if len(fields) > 2 else -1)
            except ValueError:
                continue
            src_l.append(row[0])
            dst_l.append(row[1])
            ts_l.append(row[2])
    return (np.array(src_l, np.int64), np.array(dst_l, np.int64),
            np.array(ts_l, np.int64))


def assign_windows(ts: np.ndarray, size_ms: int) -> np.ndarray:
    """Tumbling window start of each timestamp (Flink's TimeWindow
    floor)."""
    ts = np.ascontiguousarray(ts, np.int64)
    lib = _load()
    if lib is None:
        return ts - np.mod(ts, size_ms)
    out = np.empty(len(ts), np.int64)
    lib.gs_assign_windows(_i64ptr(ts), len(ts), size_ms, _i64ptr(out))
    return out


def triangles_available() -> bool:
    """True when the library (with its triangle stream counter) is
    loaded."""
    lib = _load()
    return lib is not None and hasattr(lib, "gs_triangle_count_stream")


def snapshot_available() -> bool:
    """True when the library (with its carried snapshot fold) is
    loaded."""
    lib = _load()
    return lib is not None and hasattr(lib, "gs_snapshot_windows")


def triangle_count_stream(src: np.ndarray, dst: np.ndarray,
                          eb: int) -> Optional[np.ndarray]:
    """Exact triangle count of every tumbling `eb`-edge window of the
    stream (the C++ compact-forward counter), or None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    num_w = (len(src) + eb - 1) // eb
    counts = np.empty(max(num_w, 1), np.int64)
    w = lib.gs_triangle_count_stream(_i64ptr(src), _i64ptr(dst), len(src),
                                     eb, _i64ptr(counts))
    return counts[:w]


def snapshot_windows(src: np.ndarray, dst: np.ndarray,
                     offsets: np.ndarray, vb: int,
                     deg: np.ndarray = None, cc: np.ndarray = None,
                     cov: np.ndarray = None):
    """The carried snapshot fold in C++, or None without the library:
    window w is the [offsets[w], offsets[w+1]) slice of the flat edge
    arrays; deg [vb], cc [vb] and cov [2·vb] (the driver's layouts,
    (-) at vb + v) are int32 carries updated in place, None to skip an
    analytic. Returns {"deg": [W, vb], "labels": [W, vb], "cover":
    [W, 2·vb]} int32 for the analytics given."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    num_w = len(offsets) - 1
    if num_w < 0 or int(offsets[-1]) != len(src):
        raise ValueError("offsets must span the flat edge arrays")
    for name, a, ln in (("deg", deg, vb), ("cc", cc, vb),
                        ("cov", cov, 2 * vb)):
        if a is not None and (a.dtype != np.int32 or len(a) != ln
                              or not a.flags["C_CONTIGUOUS"]):
            raise ValueError("carried %s must be contiguous int32[%d]"
                             % (name, ln))
    null = _I32P()
    flags = ((1 if deg is not None else 0) | (2 if cc is not None else 0)
             | (4 if cov is not None else 0))
    od = np.empty((num_w, vb), np.int32) if deg is not None else None
    oc = np.empty((num_w, vb), np.int32) if cc is not None else None
    ov = np.empty((num_w, 2 * vb), np.int32) if cov is not None else None

    def ptr(a):
        return null if a is None else _i32ptr(a)

    w = lib.gs_snapshot_windows(
        _i32ptr(src), _i32ptr(dst), _i64ptr(offsets), num_w, vb, flags,
        ptr(deg), ptr(cc), ptr(cov), ptr(od), ptr(oc), ptr(ov))
    if w != num_w:
        raise RuntimeError("native snapshot_windows wrote %d of %d windows"
                           % (w, num_w))
    return {k: a for k, a in (("deg", od), ("labels", oc), ("cover", ov))
            if a is not None}


class NativeInterner:
    """Incremental int64-id interner on the C++ hash map, with the
    contract of utils/interning.IncrementalInterner."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable: %s" % _error)
        self._lib = lib
        self._handle = lib.gs_interner_new()

    def __len__(self) -> int:
        return int(self._lib.gs_interner_size(self._handle))

    def intern_array(self, ids: np.ndarray) -> np.ndarray:
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty(len(ids), np.int32)
        self._lib.gs_interner_intern(self._handle, _i64ptr(ids), len(ids),
                                     _i32ptr(out))
        return out

    def ids_of(self, dense: np.ndarray) -> np.ndarray:
        dense = np.ascontiguousarray(dense, np.int32)
        out = np.empty(len(dense), np.int64)
        self._lib.gs_interner_lookup(self._handle, _i32ptr(dense),
                                     len(dense), _i64ptr(out))
        return out

    def id_of(self, dense: int) -> int:
        return int(self.ids_of(np.array([dense], np.int32))[0])

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle is not None:
            self._lib.gs_interner_free(handle)


_REDUCE_OPS = {"sum": 0, "min": 1, "max": 2}
_REDUCE_DIRS = {"out": 0, "in": 1, "all": 2}


def windowed_reduce_available() -> bool:
    """True when the library (with its windowed reduce) is loaded."""
    return _load() is not None


def windowed_reduce(src: np.ndarray, dst: np.ndarray, val: np.ndarray,
                    eb: int, vbp: int, name: str, direction: str,
                    ident: int):
    """(cells [num_w, vbp], counts [num_w, vbp]) of every tumbling
    `eb`-edge window in one C++ pass (ingest.cpp gs_windowed_reduce*):
    the native tier of ops/windowed_reduce.WindowedEdgeReduce for
    integer values, cells pre-filled with `ident`; None without the
    library. The slabs are int32 where the values are int32 and the
    largest cell sum (max|val| × the most contributions a cell takes,
    2·eb for "all") fits int32, int64 otherwise, decided per call (the
    JAX loader's rule, native/__init__.py :233-324). Ids outside
    [0, vbp) raise ValueError."""
    lib = _load()
    if lib is None:
        return None
    n = len(src)
    num_w = -(-n // eb) if n else 0
    src, dst, val = (np.asarray(a) for a in (src, dst, val))
    ids_i32 = src.dtype == np.int32 and dst.dtype == np.int32
    ids_i64 = src.dtype == np.int64 and dst.dtype == np.int64
    per_cell = eb * (2 if direction == "all" else 1)
    out_i32 = (val.dtype == np.int32 and (ids_i32 or ids_i64)
               and per_cell <= np.iinfo(np.int32).max)
    if out_i32 and name == "sum" and n:
        # exact max|val| in Python ints (np.abs wraps on INT32_MIN)
        maxabs = max(int(val.max()), -int(val.min()))
        out_i32 = maxabs * per_cell <= np.iinfo(np.int32).max
    out_dt = np.int32 if out_i32 else np.int64
    if ident == 0:
        cells = np.zeros((max(num_w, 1), vbp), out_dt)
    else:
        cells = np.full((max(num_w, 1), vbp), ident, out_dt)
    counts = np.zeros((max(num_w, 1), vbp), out_dt)
    op, how = _REDUCE_OPS[name], _REDUCE_DIRS[direction]
    if out_i32 and ids_i32:
        s32, d32, v32 = (np.ascontiguousarray(a) for a in (src, dst, val))
        oob = lib.gs_windowed_reduce_i32o(
            _i32ptr(s32), _i32ptr(d32), _i32ptr(v32), n, eb, vbp, op, how,
            _i32ptr(cells), _i32ptr(counts))
    elif out_i32:
        s64, d64 = np.ascontiguousarray(src), np.ascontiguousarray(dst)
        v32 = np.ascontiguousarray(val)
        oob = lib.gs_windowed_reduce_i64i32o(
            _i64ptr(s64), _i64ptr(d64), _i32ptr(v32), n, eb, vbp, op, how,
            _i32ptr(cells), _i32ptr(counts))
    elif ids_i32 and val.dtype == np.int32:
        s32, d32, v32 = (np.ascontiguousarray(a) for a in (src, dst, val))
        oob = lib.gs_windowed_reduce_i32(
            _i32ptr(s32), _i32ptr(d32), _i32ptr(v32), n, eb, vbp, op, how,
            _i64ptr(cells), _i64ptr(counts))
    else:
        s64 = np.ascontiguousarray(src, np.int64)
        d64 = np.ascontiguousarray(dst, np.int64)
        v64 = np.ascontiguousarray(val, np.int64)
        oob = lib.gs_windowed_reduce(
            _i64ptr(s64), _i64ptr(d64), _i64ptr(v64), n, eb, vbp, op, how,
            _i64ptr(cells), _i64ptr(counts))
    if oob:
        raise ValueError(
            "%d vertex id(s) outside [0, %d) in windowed_reduce input"
            % (oob, vbp))
    return cells[:num_w], counts[:num_w]
