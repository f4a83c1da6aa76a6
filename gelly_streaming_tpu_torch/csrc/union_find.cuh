// The lock-free union-find, the warp reductions and the per-window fold
// and settle of the two summary kernels (csrc/window_summary.cu,
// csrc/cohort_summary.cu): one copy of the device code that folds a
// window's edges into a carry (deg[vb+1], labels[vb+1], cover[2(vb+1)])
// and reads the window's summaries off it.
//
// A forest here is an int array p with p[v] <= v, each tree's root its
// smallest member pointing at itself: the carried CC labels and double
// cover of the summary engines are such forests (window_summary.cu says
// why the union-find gives the fixpoint's canonical labels).
#pragma once

#include "common.cuh"

// Root of x in the parent forest p, where p[v] <= v and a root points at
// itself. A link that points up (p[x] > x, which a valid carry never
// holds) is taken as a root, so the walk always ends. With `halve` each
// visited slot is pointed at its grandparent, an ancestor in the same
// set, which keeps the forest valid under concurrent walks and hooks.
template <bool halve>
__device__ __forceinline__ int find_root(volatile int* p, int x) {
    int parent = p[x];
    while (parent < x) {
        const int grand = p[parent];
        if (grand >= parent) return parent;
        if (halve) p[x] = grand;
        x = grand;
        parent = p[x];
    }
    return x;
}

// Joins the sets of a and b: the larger root is hooked under the smaller
// with a compare-and-swap on its own slot, which fails only when another
// thread changed that slot first; then both walks start again.
__device__ __forceinline__ void unite(int* p, int a, int b) {
    volatile int* vp = p;
    while (true) {
        a = find_root<true>(vp, a);
        b = find_root<true>(vp, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int pb = vp[b];
        if (pb < b) continue;          // hooked meanwhile: walk again
        if (atomicCAS(p + b, pb, a) == pb) return;
    }
}

__device__ __forceinline__ bool in_range(int v, int n) {
    return v >= 0 && v < n;
}

__device__ __forceinline__ int warp_max(int x) {
    for (int o = kWarp / 2; o > 0; o /= 2)
        x = max(x, __shfl_xor_sync(kFullMask, x, o));
    return x;
}

__device__ __forceinline__ int warp_sum(int x) {
    for (int o = kWarp / 2; o > 0; o /= 2)
        x += __shfl_xor_sync(kFullMask, x, o);
    return x;
}

// Slot i of window w, read through `wire` (common.cuh: the standard or
// the compact wire): a valid slot adds its two degrees and joins (s, d)
// in labels; every slot joins (s, d+vb+1) and (s+vb+1, d) in the cover.
// A valid slot whose ids lie outside [0, vb) (callers reject such input
// before it gets here) is taken as padding, so nothing is written
// outside the carry; the cover folds padding too: (vb, 2vb+1) joins the
// two sentinels, as the JAX body's sentinel-mapped slots do. A padded
// slot folds the same on both wires, so the carries agree bit for bit.
template <class Wire>
__device__ __forceinline__ void fold_slot(
        const Wire& wire, int w, int i, int vb, int* __restrict__ deg,
        int* labels, int* cover) {
    int s, d;
    if (wire.read(w, i, s, d) && in_range(s, vb) && in_range(d, vb)) {
        atomicAdd(deg + s, 1);
        atomicAdd(deg + d, 1);
        unite(labels, s, d);
    } else {
        s = d = vb;
    }
    unite(cover, s, d + vb + 1);
    unite(cover, s + vb + 1, d);
}

// The standard wire, with src, dst and valid pointing at one window's
// slots (csrc/cohort_summary.cu).
__device__ __forceinline__ void fold_slot(
        const int* src, const int* dst, const bool* valid, int i, int vb,
        int* __restrict__ deg, int* labels, int* cover) {
    fold_slot(StandardWire{src, dst, valid, 0}, 0, i, vb, deg, labels,
              cover);
}

// Slot v of the carry after a window's unions, called by every thread
// of the block (v past vb takes part in the reductions only). Points
// labels[v], cover[v] and cover[v+vb+1] at their roots (each slot has
// one owner thread, and the walks here do not write, so every slot ends
// at its root), then adds the block's share of window w's summaries
// into sums[0..2][w] (sums is [3, windows], cleared by the entry
// point): max_degree = max(deg[:vb]), num_components = #{v < vb :
// deg[v] > 0 and labels[v] == v}, odd = any v < vb with deg[v] > 0 and
// cover[v] == cover[v+vb+1].
__device__ __forceinline__ void settle_slot(
        int v, int vb, const int* __restrict__ deg, int* labels,
        int* cover, int* __restrict__ sums, int w, int windows) {
    int mdeg = 0, ncomp = 0, odd = 0;
    if (v <= vb) {
        const int rl = find_root<false>(labels, v);
        const int rp = find_root<false>(cover, v);
        const int rm = find_root<false>(cover, v + vb + 1);
        labels[v] = rl;
        cover[v] = rp;
        cover[v + vb + 1] = rm;
        if (v < vb) {
            const int dg = deg[v];
            mdeg = dg;
            if (dg > 0) {
                ncomp = rl == v;
                odd = rp == rm;
            }
        }
    }
    mdeg = warp_max(mdeg);
    ncomp = warp_sum(ncomp);
    odd = __any_sync(kFullMask, odd);
    __shared__ int part[3][kWarpsPerBlock];
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    if (lane == 0) {
        part[0][warp] = mdeg;
        part[1][warp] = ncomp;
        part[2][warp] = odd;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int i = 1; i < kWarpsPerBlock; ++i) {
            mdeg = max(mdeg, part[0][i]);
            ncomp += part[1][i];
            odd |= part[2][i];
        }
        if (mdeg) atomicMax(sums + w, mdeg);
        if (ncomp) atomicAdd(sums + windows + w, ncomp);
        if (odd) atomicOr(sums + 2 * windows + w, 1);
    }
}

inline unsigned blocks(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}
