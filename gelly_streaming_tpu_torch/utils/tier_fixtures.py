"""Inputs that the snapshot, union-find and cell-reduce kernels' plans
make risky, built once for both sizes they run at: small vertex buckets
in the CPU tests (tests/test_torch_kernel_tiers.py and
tests/test_torch_cell_reduce.py, plain versions against the JAX
package) and the card's sizes in chip_smoke.py (kernels against the
plain versions).

The snapshot kernel's grid (csrc/window_snapshot.cu `owned`) splits the
slots over its C blocks in contiguous runs of `run_length`, one run a
block in the emit and the delta wire (the rule mirrored here): what
these fixtures stress is where that split shows, and the unions that
cross it in both kernels. The cell reduce (csrc/cell_reduce.cu `plan`,
mirrored by ops/cell_reduce.plan_mirror) splits a window's vertices over
a cluster of C blocks of `span` vertices, pass after pass, and streams
the window's slots through a ring of tiles: its fixtures stress the
ranges' edges, the row at its shared-memory capacity, the tiles'
ragged and unaligned tails, the valid counts, more windows than
clusters, and hub vertices. Every fixture function is seeded and
returns numpy arrays.
"""

from __future__ import annotations

import numpy as np


def run_length(n: int, C: int) -> int:
    """The slots each of C blocks owns (csrc/window_snapshot.cu
    `owned`): ceil(n / C)."""
    return -(-n // C)


def runs(n: int, C: int) -> list:
    """[(lo, hi)] of the C blocks over slots [0, n); a run may be empty."""
    per = run_length(n, C)
    return [(min(n, r * per), min(n, r * per + per)) for r in range(C)]


def _live_runs(n: int, C: int) -> list:
    return [(lo, hi) for lo, hi in runs(n, C) if hi > lo]


def cross_rank_edges(rng, n: int, C: int, m: int):
    """m edges whose ends lie in runs of two different blocks (of the
    runs over [0, n) that hold a slot; one run: any two slots)."""
    live = _live_runs(n, C)
    if len(live) < 2:
        return (rng.integers(0, n, m).astype(np.int32),
                rng.integers(0, n, m).astype(np.int32))
    a = rng.integers(0, len(live), m)
    b = (a + rng.integers(1, len(live), m)) % len(live)

    def pick(which):
        lo = np.array([live[k][0] for k in which])
        hi = np.array([live[k][1] for k in which])
        return (lo + rng.integers(0, 1 << 30, m) % (hi - lo)).astype(np.int32)

    return pick(a), pick(b)


def rank_chain(n: int, C: int, offset: int):
    """A path through one slot of every block's run, from the last run to
    the first (each edge joins two runs, the hooks walk down the ranks),
    as (src, dst) of len(runs) - 1 edges; `offset` moves the slots."""
    pts = [lo + offset % (hi - lo) for lo, hi in _live_runs(n, C)][::-1]
    return (np.array(pts[:-1], np.int32).reshape(-1),
            np.array(pts[1:], np.int32).reshape(-1))


def zipf_edges(rng, n: int, m: int, a: float = 1.3):
    """m edges with Zipf-distributed ends over [0, n): a few hubs take
    most of them."""
    return tuple(((rng.zipf(a, m) - 1) % n).astype(np.int32)
                 for _ in range(2))


SNAPSHOT_KINDS = ("ragged", "cross_ranks", "chains", "zipf", "one_window",
                  "past_cap")


def snapshot_windows(kind: str, vb: int, eb: int, C: int, seed: int,
                     windows: int = 3) -> list:
    """[(src, dst)] per window of fixture `kind` at vertex bucket vb and
    at most eb edges a window, its blocks' runs those of a grid of C:
    - ragged: uniform windows of eb, eb // 3, 1 and 0 edges (the caller
      picks a vb that is no multiple of 4 or of C);
    - cross_ranks: every edge between two blocks' runs;
    - chains: a path through every run from the last to the first in
      each window, beside cross-run edges;
    - zipf: Zipf hubs (one hub's degree adds from every block);
    - one_window: one window of eb uniform edges;
    - past_cap: windows whose changed slots pass a small delta cap (eb
      uniform edges over the whole bucket)."""
    rng = np.random.default_rng(seed)
    if kind == "one_window":
        windows = 1
    out = []
    for w in range(windows):
        if kind == "ragged":
            m = (eb, eb // 3, 1, 0)[w % 4]
            s, d = (rng.integers(0, vb, m).astype(np.int32)
                    for _ in range(2))
        elif kind == "cross_ranks":
            s, d = cross_rank_edges(rng, vb, C, eb)
        elif kind == "chains":
            cs, cd = rank_chain(vb, C, 7 * w + 3)
            xs, xd = cross_rank_edges(rng, vb, C, eb - len(cs))
            s, d = np.concatenate([cs, xs]), np.concatenate([cd, xd])
        elif kind == "zipf":
            s, d = zipf_edges(rng, vb, eb)
        elif kind in ("one_window", "past_cap"):
            s, d = (rng.integers(0, vb, eb).astype(np.int32)
                    for _ in range(2))
        else:
            raise ValueError("unknown snapshot fixture %r" % kind)
        out.append((np.asarray(s, np.int32), np.asarray(d, np.int32)))
    return out


def chained_forest(labels: np.ndarray) -> np.ndarray:
    """The same sets as the canonical `labels` (each slot at its set's
    smallest), but each member pointing at the member before it: a valid
    forest (p[v] <= v, each root its set's smallest) that is not
    compressed, its chains as long as its sets."""
    labels = np.asarray(labels)
    order = np.lexsort((np.arange(len(labels)), labels))
    root = labels[order]
    same = np.r_[False, root[1:] == root[:-1]]
    out = np.arange(len(labels), dtype=np.int32)
    out[order[same]] = order[np.flatnonzero(same) - 1]
    return out


def driver_mirrors(vb: int, seed: int, compressed: bool = True,
                   edges: int = None) -> tuple:
    """Driver-layout carry mirrors (deg [vb], labels [vb], cover [2·vb],
    (-) at vb+v) of a stream that has run a while: the fold of `edges`
    (default vb // 2) cross-run and uniform edges; with compressed=False
    labels and cover hold the same sets as chains (chained_forest)."""
    rng = np.random.default_rng(seed)
    m = vb // 2 if edges is None else edges
    s = rng.integers(0, vb, m)
    d = rng.integers(0, vb, m)
    deg = (np.bincount(s, minlength=vb)
           + np.bincount(d, minlength=vb)).astype(np.int32)
    lab = canonical(np.arange(vb), s, d)
    cov = canonical(np.arange(2 * vb), np.concatenate([s, s + vb]),
                    np.concatenate([d + vb, d]))
    if not compressed:
        lab, cov = chained_forest(lab), chained_forest(cov)
    return deg, lab.astype(np.int32), cov.astype(np.int32)


def canonical(slots: np.ndarray, src, dst) -> np.ndarray:
    """The canonical labels of the forest `slots` (p[v] <= v) joined with
    the edges: each slot's smallest slot reachable (the port's plain
    fixpoint on the CPU), for fixture carries."""
    import torch

    from ..ops import unionfind

    return unionfind.cc_fixpoint_plain(
        torch.from_numpy(np.asarray(slots, np.int32)),
        torch.from_numpy(np.asarray(src, np.int32)),
        torch.from_numpy(np.asarray(dst, np.int32)), carried=True).numpy()


def in_range_edges(src, dst, n: int):
    """The edges the union-find kernel folds: both ends in [0, n)."""
    src, dst = np.asarray(src), np.asarray(dst)
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    return src[keep].astype(np.int32), dst[keep].astype(np.int32)


UNION_FIND_KINDS = ("one_slot", "no_edges", "out_of_range", "long_chains",
                    "cross_ranks")


def union_find_case(kind: str, n: int, ne: int, C: int, seed: int) -> tuple:
    """(labels0 [n], src [E], dst [E], carried) of fixture `kind` over n
    slots (one_slot: 1) and about ne edges (ne exactly but for
    cross_ranks, which adds C - 1 links), the blocks' runs those of a
    grid of C:
    - one_slot: n = 1, no edge;
    - no_edges: a carried forest of chains, no edge;
    - out_of_range: fresh, a third of the edges with an end at -1, n or
      past it (the kernel skips them: compare on in_range_edges);
    - long_chains: carried, labels0[v] = v - 1 (one chain through every
      block's run), cross-run edges;
    - cross_ranks: fresh, every edge between two blocks' runs, each
      block's first slot chained to the previous block's last."""
    rng = np.random.default_rng(seed)
    if kind == "one_slot":
        z = np.zeros(0, np.int32)
        return np.zeros(1, np.int32), z, z, False
    if kind == "no_edges":
        z = np.zeros(0, np.int32)
        s = rng.integers(0, n, n // 2)
        d = rng.integers(0, n, n // 2)
        return chained_forest(canonical(np.arange(n), s, d)), z, z, True
    if kind == "out_of_range":
        s = rng.integers(0, n, ne).astype(np.int32)
        d = rng.integers(0, n, ne).astype(np.int32)
        bad = rng.random(ne) < 1 / 3
        s[bad & (rng.random(ne) < 0.5)] = -1
        d[bad] = n + rng.integers(0, 3, ne)[bad]
        return np.arange(n, dtype=np.int32), s, d, False
    if kind == "long_chains":
        s, d = cross_rank_edges(rng, n, C, ne)
        return np.maximum(np.arange(n) - 1, 0).astype(np.int32), s, d, True
    if kind == "cross_ranks":
        s, d = cross_rank_edges(rng, n, C, ne)
        live = _live_runs(n, C)
        links = [(live[k][0], live[k - 1][1] - 1) for k in range(1, len(live))]
        if links:
            ls, ld = np.array(links, np.int32).T
            s, d = np.concatenate([s, ls]), np.concatenate([d, ld])
        return np.arange(n, dtype=np.int32), s, d, False
    raise ValueError("unknown union-find fixture %r" % kind)


CELL_KINDS = ("boundaries", "one_block", "ragged", "nvalid", "hub", "zipf",
              "uniform")


def block_ranges(vbp: int, cluster: int, span: int, passes: int) -> list:
    """[(lo, hi)] of every (pass, block) of a cell-reduce plan: block r
    owns [(k·C + r)·span, +span) in pass k, clipped to [0, vbp)."""
    out = []
    for k in range(passes):
        for r in range(cluster):
            lo = min((k * cluster + r) * span, vbp)
            out.append((lo, min(lo + span, vbp)))
    return out


def capacity_vbps(max_span: int, cluster: int) -> tuple:
    """The row widths around C blocks' capacity of max_span vertices
    each: C·max_span - 1, C·max_span and C·max_span + 1 (the last takes
    a wider cluster or another pass)."""
    full = cluster * max_span
    return full - 1, full, full + 1


def cell_stack(kind: str, wb: int, eb: int, vb: int, seed: int,
               cluster: int = 1, span: int = None):
    """(src [wb, eb], dst [wb, eb], nvalid [wb]) int32 of fixture `kind`
    over vertices [0, vb); padding past nvalid holds ids like any slot's.
    A plan of `cluster` blocks of `span` vertices (default one block
    over the whole row) places the edges of the range kinds:
    - boundaries: uniform ids, a third of them on the first and last
      vertex of every block's range and its neighbours, 0 and vb-1;
    - one_block: every id in the last block's range;
    - ragged: uniform, full windows but the last, which holds eb - 3
      (the caller's eb sets the tiles' alignment);
    - nvalid: valid counts cycling 0, 1, eb - 1, eb, eb // 2 + 3;
    - hub: window 0 all on one vertex, the rest half on it;
    - zipf: Zipf(1.1) ids, a few hubs take most contributions;
    - uniform: uniform ids (more windows than clusters: the caller's
      wb)."""
    rng = np.random.default_rng(seed)
    span = span or vb + 1
    src = rng.integers(0, vb, (wb, eb))
    dst = rng.integers(0, vb, (wb, eb))
    nvalid = np.full(wb, eb, np.int64)
    if kind == "boundaries":
        edges = []
        for lo, hi in block_ranges(vb + 1, cluster, span, -(-(vb + 1)
                                   // (cluster * span))):
            edges += [lo - 1, lo, lo + 1, hi - 2, hi - 1, hi]
        edges = np.clip(np.array(edges + [0, vb - 1]), 0, vb - 1)
        pick = rng.random((2, wb, eb)) < 1 / 3
        src = np.where(pick[0], rng.choice(edges, (wb, eb)), src)
        dst = np.where(pick[1], rng.choice(edges, (wb, eb)), dst)
    elif kind == "one_block":
        lo, hi = [(a, b) for a, b in block_ranges(vb, cluster, span, 1)
                  if b > a][-1]
        src = rng.integers(lo, hi, (wb, eb))
        dst = rng.integers(lo, hi, (wb, eb))
    elif kind == "ragged":
        nvalid[-1] = max(eb - 3, 0)
    elif kind == "nvalid":
        cycle = np.array([0, 1, eb - 1, eb, eb // 2 + 3])
        nvalid = np.clip(cycle[np.arange(wb) % len(cycle)], 0, eb)
    elif kind == "hub":
        h = int(rng.integers(0, vb))
        src[0] = dst[0] = h
        half = rng.random((2, wb, eb)) < 0.5
        src = np.where(half[0], h, src)
        dst = np.where(half[1], h, dst)
    elif kind == "zipf":
        weights = 1.0 / np.arange(1, vb + 1) ** 1.1
        perm = rng.permutation(vb)
        src, dst = (perm[rng.choice(vb, (wb, eb), p=weights / weights.sum())]
                    for _ in range(2))
    elif kind != "uniform":
        raise ValueError("unknown cell-reduce fixture %r" % kind)
    return (src.astype(np.int32), dst.astype(np.int32),
            nvalid.astype(np.int32))


def cell_values(dtype: str, wb: int, eb: int, seed: int) -> np.ndarray:
    """[wb, eb] values: int32 in [-1000, 1000), or float32 normals ·
    100."""
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-1000, 1000, (wb, eb)).astype(np.int32)
    return (rng.standard_normal((wb, eb)) * 100).astype(np.float32)


def cell_wires(src, dst, nvalid, val, vb: int, direction: str) -> dict:
    """Both wires of a stack, as the device tier stages them: standard
    (ids [rep·wb·eb] int32, w·vbp + v or the trash id wb·vbp past
    nvalid; values repeated rep times) and compact (s16, d16 [wb, eb]
    uint16, nvalid, values [wb, eb])."""
    wb, eb = src.shape
    vbp = vb + 1
    valid = np.arange(eb)[None, :] < nvalid[:, None]
    base = (np.arange(wb) * vbp)[:, None]
    vtx = {"out": [src], "in": [dst], "all": [src, dst]}[direction]
    ids = np.concatenate([np.where(valid, base + v, wb * vbp).reshape(-1)
                          for v in vtx]).astype(np.int32)
    return {"standard": (ids, np.concatenate([val.reshape(-1)] * len(vtx))),
            "compact": (src.astype(np.uint16), dst.astype(np.uint16),
                        nvalid.astype(np.int32), val)}
