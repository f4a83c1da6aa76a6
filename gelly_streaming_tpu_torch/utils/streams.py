"""Synthetic edge streams: the data the port is measured and checked on.

`make_stream` is bit-identical to the JAX package's `bench.make_stream`
(the tests hold it so), so both packages consume the same stream from
the same seed.
"""

from __future__ import annotations

import numpy as np


def make_stream(num_edges: int, num_vertices: int, seed: int = 7):
    """Power-law-ish edge stream: endpoints drawn from a Zipf-like
    distribution over the vertex space (heavy hitters like a social
    stream), no self-loops. Returns (src, dst) int64 arrays."""
    rng = np.random.default_rng(seed)
    # exponent ~1.1 keeps candidate counts representative but bounded
    weights = 1.0 / np.arange(1, num_vertices + 1) ** 1.1
    weights /= weights.sum()
    src = rng.choice(num_vertices, size=num_edges, p=weights)
    dst = rng.choice(num_vertices, size=num_edges, p=weights)
    # no self-loops (match real graph datasets): redraw collisions
    loops = src == dst
    while loops.any():
        dst[loops] = rng.choice(num_vertices, size=int(loops.sum()),
                                p=weights)
        loops = src == dst
    # remap so hot vertices are scattered over the id space
    perm = rng.permutation(num_vertices)
    return perm[src], perm[dst]
