"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _build/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources (the .cu and every .cuh)
and the flags, so an edited kernel builds anew and an unchanged one is
found again. The build happens at first use, under
`gelly_streaming_tpu_torch/_build/` (listed in .gitignore); `build()`
starts one nvcc per source, all at once. The libraries are loaded with
ctypes and called with tensor pointers and PyTorch's current stream.

A failed build, a missing nvcc and an error code returned by a C entry
point raise `KernelError`: utils/resilience never retries it, wraps it or
demotes on it.

`LAUNCHES` counts, per kernel (`KERNELS`: each library's, and the
compact-wire forms of the counter and the summary kernel and the
summary library's union-find entry apart), the
launches its wrapper made: each wrapper adds one where it launches its
kernel and nowhere else. A CUDA graph of the resident tier
(ops/resident_engine.SuperBatchGraphs) runs its captured launches
without the wrappers: each replay adds the launches its capture made to
`LAUNCHES`, and one to its family's count in `REPLAYS`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C entry points of each library: name -> argtypes (restype is int, the
# cudaError_t of the call)
SIGNATURES = {
    "intersect": {
        "gs_intersect": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _P, _I, _P],
    },
    "window_counter": {
        "gs_counter_plan": [_I, _I, _I, _I, _P],
        "gs_window_counter": [_P, _P, _P, _I, _I, _I, _I, _P, _LL, _P, _P,
                              _I, _P],
        "gs_window_counter_compact": [_P, _P, _P, _I, _I, _I, _I, _P, _LL,
                                      _P, _P, _I, _P],
    },
    "window_summary": {
        "gs_window_summary": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                              _P],
        "gs_window_summary_compact": [_P, _P, _P, _I, _I, _I, _P, _P, _P,
                                      _P, _I, _P],
        "gs_cc_plan": [_I, _LL, _I, _P],
        "gs_cc_fixpoint": [_P, _I, _P, _P, _LL, _I, _P, _I, _P],
    },
    "window_snapshot": {
        "gs_window_snapshot": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                               _I, _P],
    },
    "cohort_summary": {
        "gs_cohort_summary": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                              _I, _P],
    },
    "gnn_round": {
        "gs_gnn_rounds": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _I, _P],
    },
    "dense_triangles": {
        "gs_six_t_partials": [_P, _I, _P, _I, _P],
    },
    "cell_reduce": {
        "gs_cell_reduce_plan": [_I, _I, _I, _I, _I, _P],
        "gs_cell_reduce": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _P],
        "gs_cell_reduce_compact": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _P, _I, _P],
    },
}

# the kernels whose launches are counted: one per library (the cell
# reduce's two wires together), and the compact-wire forms of the counter
# and the summary kernel and the union-find entry of the summary library
# (`cc_fixpoint`) apart
KERNELS = ("intersect", "window_counter", "window_counter_compact",
           "window_summary", "window_summary_compact", "cc_fixpoint",
           "window_snapshot", "cohort_summary", "gnn_round",
           "dense_triangles", "cell_reduce")
LAUNCHES = {name: 0 for name in KERNELS}
# CUDA graph replays of the resident tier, per graph family
GRAPH_FAMILIES = ("resident_summary", "gnn_resident", "driver_resident",
                  "cohort_resident")
REPLAYS = {name: 0 for name in GRAPH_FAMILIES}

_LIBS: dict = {}


class KernelError(RuntimeError):
    """A kernel library failed to build, or a C entry point returned a
    CUDA error."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in REPLAYS:
        REPLAYS[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH); the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds: named by a hash of the sources and
    the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every library in `names` (default: all) that is not built
    yet, one nvcc process per source, all started together. Returns
    {name: nvcc's diagnostics} for what was compiled (ptxas reports each
    kernel's registers and shared memory there). Raises on a failed
    build."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_name("%s.%d.tmp.so" % (out.stem, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for name, (tmp, out, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise KernelError("nvcc failed for %s:\n%s" % (
            ", ".join(failed), "\n".join(logs[n] for n in failed)))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise KernelError when a C entry point of library `name` returned
    a CUDA error."""
    if code:
        msg = library(name).gs_error_string(code).decode()
        raise KernelError("%s kernel: CUDA error %d (%s)"
                           % (name, code, msg))


def stream_of(t) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
