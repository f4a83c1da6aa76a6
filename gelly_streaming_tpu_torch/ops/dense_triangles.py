"""The dense window triangle count: 6·T = Σ (A @ A) ⊙ A over the window's
simple undirected adjacency A.

Port of the JAX package's `ops/pallas_triangles.py` (`_six_t_partials`
:57-77, `_adjacency_six_t` :80-98, `triangle_count_dense_pallas`
:101-114), the dense path of `ops/triangles.py` (`triangle_count_dense`
:68) for windows of at most 4096 vertices. `six_t_partials` launches the
CUDA kernel of csrc/dense_triangles.cu (int8 tensor cores) on a
symmetric CUDA int8 matrix and runs `six_t_partials_plain`, the plain
PyTorch version, on a CPU one; it never falls back from one to the
other. Both return the TPU kernel's [g, g·128] float32 partials, exact:
each is an integer ≤ 128·vp ≤ 2^19.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..core.platform import resolve_device
from . import segment as seg_ops

TILE = 128


def adjacency(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The simple undirected adjacency of the edges (src, dst) on their
    device: [vp, vp] of 0/1 in `dtype` (the kernel takes int8), vp =
    num_vertices rounded up to a multiple of TILE; symmetric, zero
    diagonal (self-loops and duplicates drop out), an edge with an
    endpoint outside [0, num_vertices) dropped."""
    v = int(num_vertices)
    vp = -(-v // TILE) * TILE
    src, dst = src.long(), dst.long()
    keep = (src >= 0) & (src < v) & (dst >= 0) & (dst < v)
    s, d = src[keep], dst[keep]
    a = torch.zeros(vp, vp, dtype=dtype, device=src.device)
    a[s, d] = 1
    a[d, s] = 1
    a.fill_diagonal_(0)
    return a


def six_t_partials_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain version: (a @ a) ⊙ a summed over each 128-row tile,
    float32 [g, g·128], for an int8 or float32 0/1 matrix (the same
    partials for both; symmetric or not, as the TPU kernel). The product
    runs in float32; with 0/1 entries and sums ≤ vp < 2^24 it is exact
    whatever PyTorch's TF32 setting (TF32 holds 0 and 1 exactly and
    accumulates in float32)."""
    if a.dtype not in (torch.int8, torch.float32):
        raise ValueError("a must be int8 or float32, got %s" % a.dtype)
    a = a.to(torch.float32)
    vp = a.shape[0]
    masked = torch.mm(a, a) * a
    return masked.view(vp // TILE, TILE, vp).sum(dim=1)


def six_t_partials(a: torch.Tensor) -> torch.Tensor:
    """The partials of `six_t_partials_plain` for a symmetric 0/1
    matrix, such as `adjacency` builds: the CUDA kernel for a CUDA
    matrix, which must be int8 (no cast is made for the caller), the
    plain version for a CPU one. The kernel relies on the symmetry (it
    reads A's rows as the columns of the right operand and computes
    only the tiles i ≤ j), so a matrix that is not symmetric raises
    ValueError on either device; entries other than 0 and 1 are not
    checked."""
    if a.device.type != "cpu":
        _check(a)
    _check_symmetric(a)
    return _symmetric_partials(a)


def _symmetric_partials(a: torch.Tensor) -> torch.Tensor:
    """`six_t_partials` without its symmetry check, for a matrix that is
    symmetric 0/1 by construction (and, on CUDA, one `_check` takes)."""
    if a.device.type == "cpu":
        return six_t_partials_plain(a)
    vp = a.shape[0]
    out = torch.empty(vp // TILE, vp, dtype=torch.float32, device=a.device)
    lib = kernels.library("dense_triangles")
    code = lib.gs_six_t_partials(a.data_ptr(), vp, out.data_ptr(),
                                 a.device.index, kernels.stream_of(a))
    kernels.check("dense_triangles", code)
    kernels.LAUNCHES["dense_triangles"] += 1
    return out


def triangle_count_dense(src, dst, num_vertices: int, device=None) -> int:
    """Exact triangle count of one window through the dense contraction,
    over the vertex bucket of num_vertices as the JAX package's
    `triangle_count_dense_pallas` takes it (ids in [num_vertices, bucket)
    count as vertices, ids past the bucket are dropped). Partials summed
    in int64, divided by 6."""
    device = resolve_device(device)
    vb = seg_ops.bucket_size(num_vertices)
    s, d = (torch.from_numpy(np.asarray(x, np.int64)).to(device)
            for x in (src, dst))
    # adjacency is symmetric by construction, and comparing A with A.T
    # costs more than the kernel on the card (PERF.md §6), so the
    # wrapper's check is left out here
    partials = _symmetric_partials(adjacency(s, d, vb, torch.int8))
    return int(partials.to(torch.int64).sum()) // 6


def _check(a: torch.Tensor) -> None:
    if a.device.type != "cuda":
        raise ValueError("the dense triangle kernel takes a CUDA tensor, "
                         "got %s" % a.device)
    if a.dtype != torch.int8 or a.dim() != 2 \
            or a.shape[0] != a.shape[1] or a.shape[0] % TILE \
            or a.shape[0] == 0 or not a.is_contiguous():
        raise ValueError("a must be a contiguous square int8 tensor "
                         "whose side is a positive multiple of %d, got %s "
                         "%s" % (TILE, tuple(a.shape), a.dtype))


def _check_symmetric(a: torch.Tensor) -> None:
    if a.dim() != 2 or a.shape[0] != a.shape[1] \
            or not torch.equal(a, a.T):
        raise ValueError("six_t_partials takes a symmetric matrix (the "
                         "kernel reads A's rows as columns); use "
                         "six_t_partials_plain for any other")
