"""The benchmark's edge streams, made on the device from a seed.

`make_pool` follows the law of the repository's `bench.py` `make_stream`:
both endpoints drawn independently from a Zipf law of exponent 1.1 over
the vertex ids, a self-loop's destination drawn again until it differs,
then every id sent through one seeded permutation, so that the heavy
vertices lie scattered over the id space. It is written in PyTorch so
that a pool of tens of millions of edges is made on the card in a few
calls; the same seed on the same kind of device gives the same pool.
"""

from __future__ import annotations

import torch

ZIPF_EXPONENT = 1.1


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on `device` seeded with `seed` (any integer in
    [0, 2**63))."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def make_pool(num_edges: int, num_vertices: int, gen: torch.Generator):
    """(src, dst), two int32 tensors of `num_edges` ids in
    [0, num_vertices) on the generator's device: Zipf endpoints, no
    self-loop, ids permuted."""
    if num_vertices < 2 or num_edges < 1:
        raise ValueError("a pool needs at least one edge and two vertices, "
                         "got %d edges over %d" % (num_edges, num_vertices))
    dev = gen.device
    weights = torch.arange(1, num_vertices + 1, dtype=torch.float64,
                           device=dev).pow_(-ZIPF_EXPONENT)
    cdf = torch.cumsum(weights, 0)
    cdf /= cdf[-1].clone()
    del weights

    def draw(n: int) -> torch.Tensor:
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=dev)
        return torch.searchsorted(cdf, u, right=True).clamp_max_(
            num_vertices - 1)

    src = draw(num_edges)
    dst = draw(num_edges)
    loops = torch.nonzero(src == dst).squeeze(1)
    while loops.numel():
        dst[loops] = draw(loops.numel())
        loops = loops[src[loops] == dst[loops]]
    perm = torch.randperm(num_vertices, generator=gen, device=dev)
    return perm[src].int(), perm[dst].int()
