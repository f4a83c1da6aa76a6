"""Host-side (numpy) layout helpers of the window kernels (power-of-two
buckets, padding, the [W, eb] window stacks every batched window
dispatch consumes) and the segment folds and reduces of the
neighborhood API.

The layout helpers are copies of the numpy-only helpers of the JAX
package's `ops/segment.py` (the port imports nothing of that package,
whose `__init__` imports JAX); the tests hold them equal to the
originals. The fold/reduce half ports its :51-211 to torch tensors:

- `segment_reduce`, `degree_update`: plain tensor ops (the columnar
  paths reduce through the cell-reduce kernel, ops/cell_reduce.py);
- `segmented_fold`: the JAX package's `lax.scan` of one step an edge
  becomes a stepped fold: edges grouped in runs of equal segment id,
  step t applies the user fn to the t-th edge of every run still
  active, as one batch of 1-D tensors (L steps for the longest run L,
  not E), so each segment still folds in arrival order;
- `segmented_reduce_associative`: the flagged associative scan as a
  log-step (Hillis-Steele) scan on tensors;
- `segmented_reduce`: the stepped fold seeded from each run's first
  value.

Values take the JAX package's x64-off types on the device: integers as
int32, floats as float32 (`device_values`). Like the JAX kernels, a
segment's result is the fold of its last run (the ids come sorted, so
of all its edges); segments without edges report has_any False.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.platform import resolve_device

_MIN_BUCKET = 8


def bucket_size(n: int) -> int:
    """Next power-of-two ≥ n (min 8)."""
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


def pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    if arr.shape[0] == size:
        return arr
    pad = np.full((size - arr.shape[0],) + arr.shape[1:], fill,
                  dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def window_stack(src: np.ndarray, dst: np.ndarray, eb: int,
                 sentinel: int):
    """Pad a COO stream to whole `eb`-sized windows and reshape to
    [W, eb] stacks plus the validity mask."""
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    n = len(src)
    num_w = -(-n // eb)
    s = pad_to(src, num_w * eb, fill=sentinel).reshape(num_w, eb)
    d = pad_to(dst, num_w * eb, fill=sentinel).reshape(num_w, eb)
    valid = pad_to(np.ones(n, bool), num_w * eb,
                   fill=False).reshape(num_w, eb)
    return num_w, s, d, valid


def stack_window_list(windows, eb: int, sentinel: int):
    """Pad a list of (src, dst) window batches of varying lengths
    (each ≤ eb) into [W, eb] stacks + validity mask."""
    num_w = len(windows)
    s = np.full((num_w, eb), sentinel, np.int32)
    d = np.full((num_w, eb), sentinel, np.int32)
    valid = np.zeros((num_w, eb), bool)
    for w, (ws, wd) in enumerate(windows):
        n = len(ws)
        if n > eb:
            raise ValueError(f"window of {n} edges exceeds edge "
                             f"bucket {eb}")
        s[w, :n] = ws
        d[w, :n] = wd
        valid[w, :n] = True
    return s, d, valid


def stack_window_rows(pairs, wb: int, eb: int, sentinel: int):
    """Pack a chunk's dense (src, dst) window arrays into [wb, eb]
    stacks + validity mask (rows past len(pairs) stay all-sentinel)."""
    s_w = np.full((wb, eb), sentinel, np.int32)
    d_w = np.full((wb, eb), sentinel, np.int32)
    valid = np.zeros((wb, eb), bool)
    for i, (s, d) in enumerate(pairs):
        s_w[i, :len(s)] = s
        d_w[i, :len(d)] = d
        valid[i, :len(s)] = True
    return s_w, d_w, valid


def pad_window_chunk(s, d, valid, at: int, hi: int, max_w: int,
                     eb: int, sentinel: int):
    """Slice [at:hi] of a [W, eb] stack and pad the window axis to a
    power-of-two bucket (≤ max_w) with all-invalid rows. Returns
    (s, d, valid, n) with n = the real window count."""
    n = hi - at
    wb = min(bucket_size(n), max_w)
    if n == wb:  # full chunk (the steady state): zero-copy views
        return s[at:hi], d[at:hi], valid[at:hi], n
    sc = np.full((wb, eb), sentinel, np.int32)
    dc = np.full((wb, eb), sentinel, np.int32)
    vc = np.zeros((wb, eb), bool)
    sc[:n], dc[:n], vc[:n] = s[at:hi], d[at:hi], valid[at:hi]
    return sc, dc, vc, n


def intern(*id_arrays: np.ndarray):
    """Map arbitrary numeric vertex ids in the given arrays to dense
    0..V-1 ints. Returns (unique_ids, [dense_arrays...])."""
    stacked = np.concatenate([np.asarray(a) for a in id_arrays])
    uniq, inv = np.unique(stacked, return_inverse=True)
    out = []
    off = 0
    for a in id_arrays:
        n = np.asarray(a).shape[0]
        out.append(inv[off:off + n].astype(np.int32))
        off += n
    return uniq, out


# ----------------------------------------------------------------------
# segment folds and reduces (torch)
# ----------------------------------------------------------------------

def x64_off_values(a) -> np.ndarray:
    """A host array in the JAX package's x64-off types, as its device
    tiers fold it: integers as int32, floats as float32, bools as bool."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return a
    dtype = np.float32 if np.issubdtype(a.dtype, np.floating) else np.int32
    return a.astype(dtype, copy=False)


def device_values(a, device) -> torch.Tensor:
    """`x64_off_values(a)` on `device`."""
    return torch.from_numpy(np.ascontiguousarray(x64_off_values(a))).to(
        device)


def cell_fill(kind: str, dtype: torch.dtype):
    """What an empty segment holds: XLA's identity of the reduce (0 for
    sum; +inf / iinfo.max for min; -inf / iinfo.min for max)."""
    if kind == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def segment_reduce(values: torch.Tensor, segment_ids: torch.Tensor,
                   num_segments: int, kind: str = "sum") -> torch.Tensor:
    """Parallel segment reduction on the tensors' device; ids outside
    [0, num_segments) are dropped, empty segments hold the XLA identity
    (0, or the dtype's extremes / ±inf for min and max)."""
    ids = segment_ids.long()
    keep = (ids >= 0) & (ids < num_segments)
    ids = torch.where(keep, ids, num_segments)
    if kind == "count":
        values, kind = torch.ones_like(values), "sum"
    if kind not in ("sum", "min", "max"):
        raise ValueError(kind)
    out = torch.full((num_segments + 1,), cell_fill(kind, values.dtype),
                     dtype=values.dtype, device=values.device)
    if kind == "sum":
        out.index_add_(0, ids, values)
    else:
        out.scatter_reduce_(0, ids, values,
                            "amin" if kind == "min" else "amax",
                            include_self=True)
    return out[:num_segments]


def degree_update(state: torch.Tensor, src: torch.Tensor,
                  dst: torch.Tensor) -> torch.Tensor:
    """A new degree vector: `state` plus one at every src and dst (the
    continuous-degree fold of one window batch; padding carries the
    sentinel id len(state)-1)."""
    ones = torch.ones(src.shape, dtype=state.dtype, device=state.device)
    return state.clone().index_add_(0, src.long(), ones).index_add_(
        0, dst.long(), ones)


def flatten_tree(tree):
    """(leaves, rebuild) of a tree of tuples, lists and dicts."""
    if isinstance(tree, (tuple, list)):
        parts = [flatten_tree(t) for t in tree]
        leaves = [x for p, _r in parts for x in p]
        sizes = [len(p) for p, _r in parts]
        kind = type(tree)

        def rebuild(xs):
            out, at = [], 0
            for (_p, r), k in zip(parts, sizes):
                out.append(r(xs[at:at + k]))
                at += k
            return kind(out)
        return leaves, rebuild
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, rebuild_t = flatten_tree(tuple(tree[k] for k in keys))
        return leaves, lambda xs: dict(zip(keys, rebuild_t(xs)))
    return [tree], lambda xs: xs[0]


def _runs(seg: np.ndarray):
    """Runs of equal consecutive ids: (starts, lengths, the last run of
    each id present, the ids present)."""
    n = len(seg)
    is_start = np.ones(n, bool)
    is_start[1:] = seg[1:] != seg[:-1]
    starts = np.flatnonzero(is_start)
    lens = np.diff(np.append(starts, n))
    ids = seg[starts]
    # the last run of each id: ids of later runs overwrite earlier ones
    present, last_of = np.unique(ids[::-1], return_index=True)
    return starts, lens, len(starts) - 1 - last_of, present


def segmented_fold(fold_fn, init_tree, segment_ids: np.ndarray,
                   fields, num_segments: int, device=None):
    """fold_fn(acc_tree, *field_lanes) -> acc_tree over 1-D tensors (one
    lane a segment; a fn written for scalars with torch.where runs
    unchanged), folded over each segment's edges in arrival order.
    segment_ids sorted (stable), host arrays. Returns (result tree of
    numpy [num_segments], has_any [num_segments])."""
    dev = resolve_device(device)
    seg = np.asarray(segment_ids, np.int64)
    leaves0, rebuild = flatten_tree(init_tree)
    init = [torch.as_tensor(x).to(dev) for x in leaves0]
    has_any = np.zeros(num_segments, bool)
    if len(seg) == 0:
        res = [np.repeat(x.cpu().numpy()[None], num_segments, 0)
               for x in init]
        return rebuild(res), has_any
    starts, lens, last_run, present = _runs(seg)
    # runs longest first: the runs active at step t are a prefix
    by_len = np.argsort(-lens, kind="stable")
    lens_sorted = lens[by_len]
    starts_t = torch.from_numpy(starts[by_len]).to(dev)
    lanes = [device_values(f, dev) for f in fields]
    acc = [x.expand(len(starts)).clone() for x in init]
    for t in range(int(lens_sorted[0])):
        k = int(np.searchsorted(-lens_sorted, -t, side="left"))
        at = starts_t[:k] + t
        new, _ = flatten_tree(fold_fn(rebuild([a[:k] for a in acc]),
                                  *(f[at] for f in lanes)))
        for a, x in zip(acc, new):
            a[:k] = x
    # back to run order, then each segment's last run
    pos = np.empty(len(starts), np.int64)
    pos[by_len] = np.arange(len(starts))
    keep = present < num_segments
    has_any[present[keep]] = True
    pick = torch.from_numpy(pos[last_run[keep]]).to(dev)
    res = []
    for a, x in zip(acc, init):
        col = np.repeat(x.cpu().numpy()[None], num_segments, 0)
        col[present[keep]] = a[pick].cpu().numpy()
        res.append(col)
    return rebuild(res), has_any


def segmented_reduce_associative(reduce_fn, segment_ids: np.ndarray,
                                 values, num_segments: int, device=None):
    """Per-segment reduce for a fn DECLARED associative: a flagged
    inclusive scan in log2(E) steps (each step combines every element
    with the one 2^k before it unless a run starts between them), the
    result at each run's last element. Same contract as
    `segmented_reduce`: returns (results, has_any) as numpy
    [num_segments]."""
    dev = resolve_device(device)
    seg = np.asarray(segment_ids, np.int64)
    v = device_values(values, dev)
    has_any = np.zeros(num_segments, bool)
    out = np.zeros(num_segments, v.cpu().numpy().dtype)
    n = len(seg)
    if n == 0:
        return out, has_any
    starts, _lens, last_run, present = _runs(seg)
    flag = torch.zeros(n, dtype=torch.bool, device=dev)
    flag[torch.from_numpy(starts).to(dev)] = True
    d = 1
    while d < n:
        fa, fb, va, vb = flag[:-d], flag[d:], v[:-d], v[d:]
        comb = torch.where(fb, vb, reduce_fn(va, vb).to(v.dtype))
        v = torch.cat([v[:d], comb])
        flag = torch.cat([flag[:d], fa | fb])
        d *= 2
    ends = np.append(starts[1:], n) - 1
    keep = present < num_segments
    has_any[present[keep]] = True
    out[present[keep]] = v[torch.from_numpy(ends[last_run[keep]]).to(dev)
                           ].cpu().numpy()
    return out, has_any


def segmented_reduce(reduce_fn, segment_ids: np.ndarray, values,
                     num_segments: int, device=None):
    """Per-segment reduce of edge values in arrival order for any fn:
    the stepped fold seeded from each segment's first value
    (acc = (value, seen)). Returns (results, has_any) as numpy
    [num_segments]."""
    dev = resolve_device(device)
    dtype = device_values(np.asarray(values)[:0], "cpu").dtype
    init = (torch.zeros((), dtype=dtype), torch.zeros((), dtype=torch.bool))

    def fold(acc, v):
        val, seen = acc
        return (torch.where(seen, reduce_fn(val, v).to(dtype), v),
                torch.ones_like(seen))

    (res, _seen), has_any = segmented_fold(fold, init, segment_ids,
                                           (values,), num_segments, dev)
    return res, has_any


def warm_stream_buckets(kernel) -> None:
    """Nothing to warm in the port: the JAX package compiles a program
    for each stream-chunk bucket ahead of time; PyTorch runs eagerly and
    the CUDA kernels are built once, at first use (kernels.py), for
    every shape."""
