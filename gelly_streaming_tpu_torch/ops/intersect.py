"""Per-edge neighbor-row intersection: for each valid oriented edge
(a, b), |N_out(a) ∩ N_out(b)|, summed.

Port of the JAX package's `triangles.intersect_local` (triangles.py:82-
109) and of its Pallas kernel `pallas_intersect.intersect_local_pallas`.
`intersect_local` launches the CUDA kernel of `csrc/intersect.cu` on a
CUDA table and runs `intersect_local_plain`, the plain PyTorch version,
on a CPU one; it never falls back from one to the other. A caller whose
rows are strictly ascending says so (`ascending=True`, as
`triangles.triangle_count_sparse` does) and the kernel merges each pair
of rows, the device code of the window counter's last stage; rows in any
order take the compare form. Both give the plain version's count.
"""

from __future__ import annotations

import torch

from .. import kernels

EDGE_CHUNK = 4096   # edges per step of the plain compare
K_CHUNK = 128       # compare-chunk width, as triangles.intersect_rows


def intersect_local_plain(nbr: torch.Tensor, ea: torch.Tensor,
                          eb: torch.Tensor, emask: torch.Tensor,
                          sentinel: int = None) -> torch.Tensor:
    """The chunked broadcast equality compare of the JAX package
    (triangles.py:112-135), on whatever device the tensors lie on.

    nbr:   [V+1, K] int32 deduplicated out-neighbor rows, fill = V (row V
           is the pad row); rows need not be sorted.
    ea/eb: [Ep] int32 oriented edge endpoints; emask: [Ep] bool.
    `sentinel` (default V) is the fill: entries of row a below it count.
    A table of gathered row pairs (the sharded owner mode) has another
    number of rows than vertices, so it names its fill (the JAX
    package's `intersect_rows`, :112).
    Returns a 0-dim int32 tensor."""
    if sentinel is None:
        sentinel = nbr.shape[0] - 1
    k = nbr.shape[1]
    total = torch.zeros((), dtype=torch.int64, device=nbr.device)
    for e0 in range(0, ea.shape[0] if k else 0, EDGE_CHUNK):
        e1 = e0 + EDGE_CHUNK
        ra = nbr[ea[e0:e1]]
        rb = nbr[eb[e0:e1]]
        va = (ra < sentinel) & emask[e0:e1, None]
        for c in range(0, k, K_CHUNK):
            # rows are deduplicated: an entry of row a matches at most
            # one entry of row b, so `any` counts it once
            hit = (ra[:, c:c + K_CHUNK, None] == rb[:, None, :]).any(dim=2)
            total += (hit & va[:, c:c + K_CHUNK]).sum()
    return total.to(torch.int32)


def intersect_local(nbr: torch.Tensor, ea: torch.Tensor,
                    eb: torch.Tensor, emask: torch.Tensor,
                    ascending: bool = False,
                    sentinel: int = None) -> torch.Tensor:
    """Same contract as `intersect_local_plain`: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones. `ascending=True` promises
    that every row is strictly ascending with its fill at the end, which
    lets the kernel merge rows instead of comparing every pair."""
    if sentinel is None:
        sentinel = nbr.shape[0] - 1
    if nbr.device.type == "cpu":
        return intersect_local_plain(nbr, ea, eb, emask, sentinel)
    _check(nbr, ea, eb, emask)
    out = torch.empty(1, dtype=torch.int32, device=nbr.device)
    lib = kernels.library("intersect")
    code = lib.gs_intersect(
        nbr.data_ptr(), nbr.shape[0], nbr.shape[1], sentinel,
        ea.data_ptr(), eb.data_ptr(), emask.data_ptr(), ea.shape[0],
        int(ascending), out.data_ptr(), nbr.device.index,
        kernels.stream_of(out))
    kernels.check("intersect", code)
    kernels.LAUNCHES["intersect"] += 1
    return out[0]


def _check(nbr, ea, eb, emask) -> None:
    dev = nbr.device
    if dev.type != "cuda":
        raise ValueError("the intersect kernel takes CUDA tensors, got "
                         "%s" % dev)
    for name, t, dtype, ndim in (("nbr", nbr, torch.int32, 2),
                                 ("ea", ea, torch.int32, 1),
                                 ("eb", eb, torch.int32, 1),
                                 ("emask", emask, torch.bool, 1)):
        if t.device != dev or t.dtype != dtype or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(
                "%s must be a contiguous %d-d %s tensor on %s, got %s %s "
                "on %s" % (name, ndim, dtype, dev, tuple(t.shape),
                           t.dtype, t.device))
    if not (ea.shape == eb.shape == emask.shape):
        raise ValueError("ea, eb and emask differ in length: %s %s %s"
                         % (tuple(ea.shape), tuple(eb.shape),
                            tuple(emask.shape)))
    if nbr.shape[0] < 1 or ea.shape[0] >= 2 ** 31:
        raise ValueError("table of %d rows, %d edges: out of range"
                         % (nbr.shape[0], ea.shape[0]))
