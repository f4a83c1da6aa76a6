// The lock-free union-find and the warp reductions shared by the
// summary body (csrc/summary_body.cuh) and the union-find entry of
// csrc/window_summary.cu.
//
// A forest here is an int array p with p[v] <= v, each tree's root its
// smallest member pointing at itself: the carried CC labels and double
// cover of the summary engines are such forests (summary_body.cuh says
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
// thread changed that slot first; then both walks start again. Returns
// whether this call hooked: each hook joins two sets that were apart, so
// the hooks of a window count the merges it made.
__device__ __forceinline__ bool unite(int* p, int a, int b) {
    volatile int* vp = p;
    while (true) {
        a = find_root<true>(vp, a);
        b = find_root<true>(vp, b);
        if (a == b) return false;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int pb = vp[b];
        if (pb < b) continue;          // hooked meanwhile: walk again
        if (atomicCAS(p + b, pb, a) == pb) return true;
    }
}

// The root of each chain m of `live`: x[m] walks the forest p[m] as
// find_root<halve> does, every chain a step at a time, so the dependent
// loads of up to M walks are in flight together.
template <bool halve, int M>
__device__ __forceinline__ void find_roots(volatile int* const (&p)[M],
                                           int (&x)[M], unsigned live) {
    int par[M], grand[M];
#pragma unroll
    for (int m = 0; m < M; ++m)
        if (live >> m & 1) par[m] = p[m][x[m]];
    unsigned walk = 0;
#pragma unroll
    for (int m = 0; m < M; ++m)
        if ((live >> m & 1) && par[m] < x[m]) walk |= 1u << m;
    while (walk) {
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (walk >> m & 1) grand[m] = p[m][par[m]];
#pragma unroll
        for (int m = 0; m < M; ++m) {
            if (!(walk >> m & 1)) continue;
            if (grand[m] >= par[m]) {
                x[m] = par[m];
                walk &= ~(1u << m);
            } else {
                if (halve) p[m][x[m]] = grand[m];
                x[m] = grand[m];
            }
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (walk >> m & 1) par[m] = p[m][x[m]];
#pragma unroll
        for (int m = 0; m < M; ++m)
            if ((walk >> m & 1) && par[m] >= x[m]) walk &= ~(1u << m);
    }
}

// unite for K pairs at once: joins a[k] with b[k] in the forest p[k],
// every union a step at a time (its two walks among them), so their
// dependent loads and compare-and-swaps overlap; the same hooks as K
// calls of unite from K threads. Returns the bits of the unions that
// hooked.
template <int K>
__device__ __forceinline__ unsigned unite_all(int* const (&p)[K],
                                              int (&a)[K], int (&b)[K]) {
    volatile int* vp[2 * K];
#pragma unroll
    for (int k = 0; k < K; ++k) vp[2 * k] = vp[2 * k + 1] = p[k];
    unsigned live = (1u << K) - 1, hooked = 0;
    while (live) {
        int x[2 * K], pb[K], seen[K];
        unsigned chains = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            x[2 * k] = a[k];
            x[2 * k + 1] = b[k];
            if (live >> k & 1) chains |= 3u << (2 * k);
        }
        find_roots<true>(vp, x, chains);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if (!(live >> k & 1)) continue;
            a[k] = min(x[2 * k], x[2 * k + 1]);
            b[k] = max(x[2 * k], x[2 * k + 1]);
            if (a[k] == b[k]) live &= ~(1u << k);
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
            if (live >> k & 1) pb[k] = vp[2 * k][b[k]];
        unsigned tried = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            // a slot hooked meanwhile is walked again
            if (!(live >> k & 1) || pb[k] < b[k]) continue;
            seen[k] = atomicCAS(p[k] + b[k], pb[k], a[k]);
            tried |= 1u << k;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            if ((tried >> k & 1) && seen[k] == pb[k]) {
                hooked |= 1u << k;
                live &= ~(1u << k);
            }
        }
    }
    return hooked;
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

inline unsigned blocks(long long n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}
