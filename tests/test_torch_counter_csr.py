"""A CPU model of the CUDA window counter's algorithm
(gelly_streaming_tpu_torch/csrc/window_counter.cu, its shared-memory
tier), stage by stage, held against the port's plain version
`count_windows_plain` and the JAX package's `build_window_counter`: the
XLA body and, with GS_PALLAS_WINDOW=on, the `_counter_call` kernel in
interpret mode (the `jax_counter` fixture of test_torch_window_counter).

The kernel cannot run here (no nvcc, no card); chip_smoke.py holds it
against the plain version on the card. This model does what the kernel
does, so that the algorithm, not only its plain twin, is tested on the
CPU: uint16 degrees packed two to a 32-bit word (the premise deg <= eb
keeps each half from carrying into the other), per-source CSR rows with
duplicates by an exclusive scan and cursor adds (in a random order: the
kernel's atomics land in any order), each row sorted and deduplicated in
place by the thread, lane, bitonic or selection form the row's length
picks, the
places of removed duplicates set to 0, rows read up to kb entries, and
a merge that ends a row at its first entry not above its predecessor,
each place's row found by a binary search of the row ends.
Counts are integers: equality, no tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu_torch.ops import compact_ingress as ci
from gelly_streaming_tpu_torch.ops import segment as seg
from gelly_streaming_tpu_torch.ops import window_counter as wc
from gelly_streaming_tpu_torch.utils.streams import make_stream


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_counter(request, monkeypatch):
    """build(vb, kb) -> the JAX package's jitted one-window counter, as
    test_torch_window_counter.py's fixture of the same name."""
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    if request.param == "xla":
        monkeypatch.delenv("GS_PALLAS_WINDOW", raising=False)
    else:
        monkeypatch.setenv("GS_PALLAS_WINDOW", "on")
    pw._reset_pallas_window()

    def build(vb, kb):
        fn = jax_tri.build_window_counter(vb, kb)
        assert bool(getattr(fn, "pallas_window", False)) == (
            request.param == "pallas_interpret")
        return jax.jit(fn)

    yield build
    pw._reset_pallas_window()


def jax_counts(fn, s, d, v):
    out = [fn(jnp.asarray(s[w]), jnp.asarray(d[w]), jnp.asarray(v[w]))
           for w in range(s.shape[0])]
    return (np.array([int(c) for c, _ in out], np.int32),
            np.array([int(o) for _, o in out], np.int32))


# the longest row one thread sorts (kThreadRow of csrc/window_counter.cu);
# a warp sorts the longer ones by a bitonic network of 32, 64, 128 or 256
# entries (an entry a lane up to 32), by selection past 256. Every form
# gives the same row.
THREAD_ROW, LANE_ROW, BITONIC_ROW = 8, 32, 256


def pack_add(words, v):
    """The kernel's add of 1 to uint16 entry v of the packed table: a
    32-bit add of 1 << 16·(v & 1) to word v >> 1; returns the entry
    before."""
    sh = 16 * (v & 1)
    old = int(words[v >> 1])
    words[v >> 1] = np.uint32((old + (1 << sh)) & 0xFFFFFFFF)
    return (old >> sh) & 0xFFFF


def entries(words, n):
    """The packed table seen as its uint16 entries [0, n)."""
    return words.view("<u2")[:n].astype(np.int64)


# Batcher's odd-even merge network for 8 entries (sort_row_thread)
NET8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7),
        (1, 2), (5, 6), (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5),
        (1, 2), (3, 4), (5, 6))


def sort_row_thread(r):
    """Up to eight entries padded with INT_MAX through NET8, then the
    first of each value."""
    x = list(r) + [2 ** 31 - 1] * (THREAD_ROW - len(r))
    for i, j in NET8:
        x[i], x[j] = min(x[i], x[j]), max(x[i], x[j])
    return [x[0]] + [x[k] for k in range(1, len(r)) if x[k] != x[k - 1]]


def bitonic(x):
    """A bitonic network over len(x) (a power of two) entries in place,
    partner e ^ j, ascending where e & k == 0."""
    k = 2
    while k <= len(x):
        j = k // 2
        while j:
            for e in range(len(x)):
                p = e ^ j
                if p > e and (x[e] > x[p]) == ((e & k) == 0):
                    x[e], x[p] = x[p], x[e]
            j //= 2
        k *= 2
    return x


def sort_row_lanes(r):
    """An entry a lane, padded to 32: the bitonic network, then each
    entry unequal to the one below it."""
    x = bitonic(list(r) + [2 ** 31 - 1] * (LANE_ROW - len(r)))
    return [v for i, v in enumerate(x[:len(r)]) if i == 0 or v != x[i - 1]]


def sort_row_bitonic(r):
    """Two, four or eight entries a lane, padded to 64, 128 or 256: the
    same."""
    size = LANE_ROW
    while size < len(r):
        size *= 2
    x = bitonic(list(r) + [2 ** 31 - 1] * (size - len(r)))
    return [v for i, v in enumerate(x[:len(r)]) if i == 0 or v != x[i - 1]]


def sort_row_warp(r):
    """Repeated selection of the smallest entry above the last one taken
    (one warp-wide min a step): the distinct entries in order, in d
    steps."""
    r = np.asarray(r)
    out, last = [], -1
    while (r > last).any():
        last = int(r[r > last].min())
        out.append(last)
    return out


def merge_count(col, sa, la, sb, lb, sentinel):
    """row_intersect.cuh's merge: rows end at their length, at an entry
    not above its predecessor, or at the sentinel."""
    i = j = hits = 0
    pa = pb = -(1 << 31)
    while i < la and j < lb:
        x, y = col[sa + i], col[sb + j]
        if x <= pa or y <= pb or x >= sentinel or y >= sentinel:
            break
        hits += x == y
        if x <= y:
            pa, i = x, i + 1
        if y <= x:
            pb, j = y, j + 1
    return hits


def first_above(end, p):
    """The kernel's binary search for a place's row: the first v with
    end[v] > p."""
    lo, hi = 0, len(end) - 1
    while lo < hi:
        mid = (lo + hi) >> 1
        if end[mid] > p:
            hi = mid
        else:
            lo = mid + 1
    return lo


def model_window(src, dst, valid, vb, kb, rng, forms=None):
    """One window through the kernel's six stages -> (count, overflow).
    `forms`, if given, collects the form each row of two or more entries
    took."""
    eb = len(src)
    assert vb <= 65536 and eb <= 65535          # the shared-memory tier
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    ok = (valid & (src != dst) & (src >= 0) & (src < vb) & (dst >= 0)
          & (dst < vb))
    words = np.zeros((vb + 2) // 2 + 1, np.uint32)
    # 1. degrees, in any order
    for i in rng.permutation(eb):
        if ok[i]:
            pack_add(words, src[i])
            pack_add(words, dst[i])
    deg = entries(words, vb)
    assert deg.max(initial=0) <= eb
    # 2. orient: key a << 16 | b
    no_key = 0xFFFFFFFF
    keys = np.full(eb, no_key, np.int64)
    for i in np.flatnonzero(ok):
        lo, hi = min(src[i], dst[i]), max(src[i], dst[i])
        swap = deg[lo] > deg[hi] or (deg[lo] == deg[hi] and lo > hi)
        a, b = (hi, lo) if swap else (lo, hi)
        keys[i] = a << 16 | b
    # 3. out-edges per source with duplicates, then an exclusive scan
    words[:] = 0
    for i in rng.permutation(eb):
        if keys[i] != no_key:
            pack_add(words, keys[i] >> 16)
    counts = entries(words, vb)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    total = int(counts.sum())
    words.view("<u2")[:vb] = starts
    # 4. each key to its column by a cursor add, in any order
    col = np.zeros(eb, np.int64)
    for i in rng.permutation(eb):
        if keys[i] != no_key:
            a = keys[i] >> 16
            pos = pack_add(words, a)
            col[pos] = keys[i] & 0xFFFF
    end = entries(words, vb)
    start = np.concatenate([[0], end[:-1]])
    # 5. every row sorted and deduplicated in place; removed places to 0
    overflow = 0
    for v in np.flatnonzero(end - start > 1):
        s, n = start[v], end[v] - start[v]
        if n <= THREAD_ROW:
            form, row = "thread", sort_row_thread(col[s:s + n])
        elif n <= LANE_ROW:
            form, row = "lanes", sort_row_lanes(col[s:s + n])
        elif n <= BITONIC_ROW:
            form, row = "bitonic", sort_row_bitonic(col[s:s + n])
        else:
            form, row = "warp", sort_row_warp(col[s:s + n])
            # d·n <= 2·eb: every target's degree is at least n
            assert len(row) * n <= 2 * eb
        if forms is not None:
            forms.add(form)
        d = len(row)
        col[s:s + n] = list(row) + [0] * (n - d)
        overflow += max(0, d - kb)
    # 6. each distinct (a, b): R(a) ∩ R(b), rows read up to kb entries
    count = 0
    for p in range(total):
        a = first_above(end, p)
        if p != start[a] and col[p] <= col[p - 1]:
            continue
        b = col[p]
        count += merge_count(col, start[a], min(end[a] - start[a], kb),
                             start[b], min(end[b] - start[b], kb), vb)
    return count, overflow


def model_counts(s, d, v, vb, kb, seed=0, forms=None):
    rng = np.random.default_rng(seed)
    out = [model_window(s[w], d[w], v[w], vb, kb, rng, forms)
           for w in range(s.shape[0])]
    return (np.array([c for c, _ in out], np.int32),
            np.array([o for _, o in out], np.int32))


def plain_counts(s, d, v, vb, kb):
    c, o = wc.count_windows_plain(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in (s, d, v)),
        vb, kb)
    return c.numpy(), o.numpy()


def assert_all_agree(jax_counter, s, d, v, vb, kb, forms=None):
    mc, mo = model_counts(s, d, v, vb, kb, forms=forms)
    pc, po = plain_counts(s, d, v, vb, kb)
    np.testing.assert_array_equal(mo, po)
    np.testing.assert_array_equal(mc, pc)
    if jax_counter is not None:
        jc, jo = jax_counts(jax_counter(vb, kb), s, d, v)
        np.testing.assert_array_equal(mo, jo)
        np.testing.assert_array_equal(mc, jc)
    return mc, mo


def special_windows(eb, vb):
    """One edge repeated eb times (a row of eb entries, one distinct: two
    selection steps of the warp form); a star of eb distinct edges from vertex 0 (a hub of
    degree eb); vertex 0 joined to a clique on 1..m (a row of m distinct
    entries past kb); ids 0 and vb-1 closing a triangle; padding only;
    self-loops only; one edge repeated both ways."""
    s = np.full((7, eb), vb, np.int32)
    d = np.full((7, eb), vb, np.int32)
    v = np.zeros((7, eb), bool)
    s[0], d[0], v[0] = 5, 9, True
    s[1], d[1], v[1] = 0, np.arange(1, eb + 1) % vb, True
    m = int((np.sqrt(8 * eb + 1) - 1) // 2)       # m + m(m-1)/2 <= eb
    u, w = np.triu_indices(m, 1)
    s[2, :m], d[2, :m] = 0, np.arange(1, m + 1)
    s[2, m:m + len(u)], d[2, m:m + len(u)] = u + 1, w + 1
    v[2, :m + len(u)] = True
    s[3, :3], d[3, :3], v[3, :3] = (0, vb - 1, 7), (vb - 1, 7, 0), True
    s[5], d[5], v[5] = 4, 4, True
    s[6, ::2], d[6, ::2], s[6, 1::2], d[6, 1::2] = 3, 9, 9, 3
    v[6] = True
    return s, d, v


@pytest.mark.parametrize("eb,vb,kb,seed", [(512, 1024, 8, 1),
                                           (512, 1024, 32, 2),
                                           (256, 256, 16, 3)])
def test_zipf_windows(jax_counter, eb, vb, kb, seed):
    src, dst = make_stream(3 * eb - 37, vb, seed=seed)
    _w, s, d, v = seg.window_stack(src, dst, eb, sentinel=vb)
    c, _o = assert_all_agree(jax_counter, s, d, v, vb, kb)
    assert c.sum() > 0


def test_k14_clique_at_kb8(jax_counter):
    """The K14-clique window of test_pallas_window.py:130-138: vertex 0's
    row holds 13 distinct entries past kb=8; count and overflow equal."""
    ks, kd = np.triu_indices(14, k=1)
    rng = np.random.default_rng(5)
    src = np.concatenate([ks, rng.integers(0, 128, 200)]).astype(np.int32)
    dst = np.concatenate([kd, rng.integers(0, 128, 200)]).astype(np.int32)
    _w, s, d, v = seg.window_stack(src, dst, 128, sentinel=128)
    c, o = assert_all_agree(jax_counter, s, d, v, 128, 8)
    assert o[0] > 0 and c[0] > 0


def test_special_windows(jax_counter):
    """The repeated edge, the star, a row past kb, ids 0 and vb-1,
    padding, self-loops and a duplicate both ways, at eb=1024: every row
    form runs."""
    eb, vb, kb = 1024, 1024, 8
    s, d, v = special_windows(eb, vb)
    forms = set()
    c, o = assert_all_agree(jax_counter, s, d, v, vb, kb, forms)
    assert forms == {"thread", "lanes", "bitonic", "warp"}
    assert list(c[[0, 1, 4, 5, 6]]) == [0] * 5 and c[3] == 1
    assert o[2] > 0 and c[2] > 0


def test_ids_outside_range_are_padding():
    """Valid slots with an id outside [0, vb) count as padding in the
    kernel and in the plain version alike (the JAX package leaves such
    ids undefined)."""
    e, vb = 256, 256
    rng = np.random.default_rng(7)
    s = (np.arange(e) % 300 - 20).astype(np.int32)[None]
    d = (np.arange(e) % 7).astype(np.int32)[None]
    s = np.concatenate([s, rng.integers(-5, vb + 5, (1, e))]).astype(np.int32)
    d = np.concatenate([d, rng.integers(-5, vb + 5, (1, e))]).astype(np.int32)
    v = np.ones_like(s, bool)
    mc, mo = model_counts(s, d, v, vb, 8)
    pc, po = plain_counts(s, d, v, vb, 8)
    np.testing.assert_array_equal(mc, pc)
    np.testing.assert_array_equal(mo, po)
    inside = (s >= 0) & (s < vb) & (d >= 0) & (d < vb)
    np.testing.assert_array_equal(
        mc, model_counts(np.where(inside, s, vb), np.where(inside, d, vb),
                         inside, vb, 8)[0])


def test_compact_wire_through_widen_stack(jax_counter):
    """The compact wire (uint16 ids, a valid count a window) decoded by
    `widen_stack`, as the kernel decodes it slot by slot, at vb=65536
    with ids 0 and 65535 in use."""
    eb, vb, kb = 256, 65536, 16
    src, dst = make_stream(3 * eb, vb, seed=12)
    _w, s, d, v = seg.window_stack(src, dst, eb, sentinel=vb)
    s[1, :3], d[1, :3] = (0, vb - 1, 9), (vb - 1, 9, 0)
    v[2, eb // 2:] = False
    nvalid = v.sum(axis=1).astype(np.int32)
    s16 = np.where(v, s, 0).astype(np.uint16)
    d16 = np.where(v, d, 0).astype(np.uint16)
    ws, wd, wv = (x.numpy() for x in ci.widen_stack(
        torch.from_numpy(s16), torch.from_numpy(d16),
        torch.from_numpy(nvalid), eb, vb))
    np.testing.assert_array_equal(wv, v)
    c, _o = assert_all_agree(jax_counter, ws, wd, wv, vb, kb)
    assert c[1] >= 1


def test_degree_packing_premise():
    """Two vertices of one word at degree eb = 65535, the most the
    shared-memory tier takes: neither half carries into the other. At
    eb = 65536 the low half would carry, which is why such windows take
    the L2 tier."""
    words = np.zeros(1, np.uint32)
    for _ in range(65535):
        pack_add(words, 0)
        pack_add(words, 1)
    assert list(entries(words, 2)) == [65535, 65535]
    pack_add(words, 0)                      # a 65536th edge
    assert list(entries(words, 2)) == [0, 0]
