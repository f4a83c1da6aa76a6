// The summary body, written by hand for Hopper (sm_90a): the degree
// fold, connected components and bipartiteness of every window of nb
// independent rows (tenant streams), each against its own carry, in one
// launch per call. Its two entry points are thin: csrc/window_summary.cu
// (nb = 1, either wire) and csrc/cohort_summary.cu (nb tenant rows of an
// [nb, windows, eb] slab, the standard wire).
//
// Replaces the fold and summaries of gelly_streaming_tpu/ops/
// pallas_window.py `_window_call` (:504-637, with `_final_summaries`
// :488-496, and its compact form :548-576) and `_cohort_call`
// (:640-745, the same body with the tenant axis as the outer grid
// dimension). Per window w of row n, in order: invalid slots map to the
// sentinel vb; degrees fold into the carried deg[vb+1] (a valid
// self-loop adds 2); the carried CC labels[vb+1] fold the edges (s, d);
// the carried double cover cover[2(vb+1)] folds (s, d+vb+1) and
// (s+vb+1, d); then, from the state after window w,
// max_degree = max(deg[:vb]), num_components = #{v < vb : deg[v] > 0 and
// labels[v] == v} and odd = any v < vb with deg[v] > 0 and
// cover[v] == cover[v+vb+1]. After the call every slot of labels and
// cover points at the smallest member of its set.
//
// The TPU kernel ran each min-label fixpoint as rounds of scatter-min
// over the carry in VMEM. The fixpoint converges to every vertex
// labelled with the smallest vertex reachable through the edges plus
// the carried forest's links, whatever the schedule; the carried labels
// and cover are forests (p[v] <= v, each root the smallest member of its
// tree). So a lock-free union-find gives the same labels with no rounds
// (union_find.cuh): each edge hooks the larger of its two roots under
// the smaller with atomicCAS, a root stays the minimum of its set, and
// one pass at the end of the call points every slot at its root.
//
// Summaries read incrementally. Only a window's endpoints can change a
// summary, so no pass over the carry runs per window. One pass at the
// start of a call takes the carry's own summaries (max degree, roots
// among touched vertices, odd); then per window:
// - max degree: the degree add returns the old value, and old + added
//   is that vertex's degree so far; degrees only grow, so the window's
//   max is the running max of these, joined with the base.
// - components: ncomp_w = ncomp_{w-1} + (vertices whose degree left 0
//   in window w) - (successful hooks in labels in window w). This rests
//   on an invariant of every carry the engines make, which the hosts'
//   check_summary_carry enforces on loaded ones: a vertex with deg 0 is
//   a singleton root in labels (only valid edges join labels, and both
//   endpoints gain degree). So every set is all touched or one
//   untouched vertex; a newly touched vertex adds one touched set and
//   each hook joins two touched sets.
// - odd: monotone. A set of the cover becomes its own mirror (v and
//   v+vb+1 joined) only by a union of window w, so it holds one of the
//   window's endpoints (the cover's sets are closed under the mirror
//   v <-> v+vb+1, as every carry the engines make is, and the hosts'
//   check enforces): after window w's unions and a barrier each valid
//   slot checks find(cover, s) == find(cover, s+vb+1); a second barrier
//   keeps window w+1's unions out of w's flag. A row whose flag is set
//   skips the check, and when every row's is at the top of a window, the
//   check's barrier goes too: every block of the grid reads the flags
//   there, where none is being written, so all skip it or none does.
// Each window's raw values land in sums[n][0..2][w] (max with
// atomicMax, the component delta with atomicAdd, odd with atomicOr, also
// at [2][windows-1] as the row's "odd so far"); each warp sums its
// tiles of a row first; the base goes into window 0's; a prefix (max,
// sum, or) at the end turns them into the summaries.
//
// The three unions of an edge run in lockstep (union_find.cuh:
// unite_all), so their walks' dependent loads overlap. Hub degrees are
// aggregated per warp where the carry is in device memory: lanes whose
// endpoint ids match (__match_any_sync) add their count with one
// atomic, so a Zipf hub costs one L2 atomic per warp, not one per slot;
// in shared memory the match costs more than a hub's serialised adds,
// and each lane adds its own.
//
// One launch per call, in two tiers that give the same bits, chosen by
// the size of a carry row (16(vb+1) bytes):
// - shared-memory tier, where the row fits the opt-in shared memory of
//   one block (227 KB on an H100: vb <= 14527, so the cohort's vb=8192
//   rows): one block of 1024 threads per row loads its carry once,
//   folds every window with shared-memory atomics and compare-and-swap,
//   with __syncthreads as the barrier, and writes the compressed row
//   back once;
// - L2 tier (vb=65536: the summary stream, the cohort's big tenants):
//   one persistent cooperative launch over every row, sized to the work
//   and capped at the blocks the card holds at once, with the grid
//   barrier of cooperative_groups between fold, check and next window.
//   A refused cooperative launch returns its error; nothing falls back
//   to per-window launches.
//
// What bounds it: dependent loads and atomics in L2 in the L2 tier, and
// instruction throughput on one SM per row in the shared-memory tier, not
// bytes: per valid slot two degree adds and three unions, each two root
// walks and a compare-and-swap, and the odd check's two walks until the
// row is odd; per call one carry pass at each end; per window one or
// two barriers.
#pragma once

#include <atomic>
#include <algorithm>
#include <cooperative_groups.h>

#include "union_find.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockThreads = 1024;   // the shared-memory tier's block
constexpr int kMaxDevices = 64;
constexpr int kBatch = 4;             // tiles of 32 slots a warp reads at once
constexpr int kWalks = 8;             // carry slots a thread walks at once
#ifdef GS_SUMMARY_L2_ONLY
// every call in the L2 tier: a build of utils/summary_probe.py that
// times that tier where the shared-memory tier would run
constexpr bool kSharedTier = false;
#else
constexpr bool kSharedTier = true;
#endif

// A warp's share of window w's raw values, added by lane 0 into row n's
// sums rs [3, windows].
__device__ __forceinline__ void add_window(int* rs, long long windows,
                                           long long w, int mx, int delta,
                                           bool odd, int lane) {
    if (lane) return;
    if (mx) atomicMax(rs + w, mx);
    if (delta) atomicAdd(rs + windows + w, delta);
    if (odd) {
        // atomics, not stores: thousands of warps may set one flag, and
        // same-address stores queue far longer in L2 than reductions
        atomicOr(rs + 2 * windows + w, 1);
        atomicOr(rs + 3 * windows - 1, 1);   // the row's "odd so far"
    }
}

// The rows a block of the shared-memory tier covers: one, its carry in
// shared memory (deg, labels, cover back to back), `home` the row in
// device memory. kAggregate: degree adds grouped per warp (fold_tiles);
// kOneRow: a tile's row needs no division (tile_at).
struct BlockRows {
    static constexpr bool kAggregate = false, kOneRow = true;
    int* deg;
    int* labels;
    int* cover;
    int* home_deg;
    int* home_labels;
    int* home_cover;
    int row, vb;

    __device__ int first() const { return row; }
    __device__ int count() const { return 1; }
    __device__ int* deg_of(int) const { return deg; }
    __device__ int* labels_of(int) const { return labels; }
    __device__ int* cover_of(int) const { return cover; }
    __device__ long long thread() const { return threadIdx.x; }
    __device__ long long threads() const { return blockDim.x; }
    __device__ void sync() const { __syncthreads(); }
};

// The rows of the L2 tier: all nb, in device memory, shared by the grid.
struct GridRows {
    static constexpr bool kAggregate = true, kOneRow = false;
    int* deg;
    int* labels;
    int* cover;
    int rows, vb;

    __device__ int first() const { return 0; }
    __device__ int count() const { return rows; }
    __device__ int* deg_of(int n) const {
        return deg + (long long)n * (vb + 1);
    }
    __device__ int* labels_of(int n) const {
        return labels + (long long)n * (vb + 1);
    }
    __device__ int* cover_of(int n) const {
        return cover + 2LL * n * (vb + 1);
    }
    __device__ long long thread() const {
        return (long long)blockIdx.x * blockDim.x + threadIdx.x;
    }
    __device__ long long threads() const {
        return (long long)gridDim.x * blockDim.x;
    }
    __device__ void sync() const { cg::this_grid().sync(); }
};

// The tiles of 32 slots [0, per_row·32) of every row of r, dealt to the
// warps kBatch at a time: tile k of a warp's round `round`, if it
// exists, is slot i (this lane's) of row n. The 32 lanes of a warp share
// a tile, so warp collectives over a tile see one row.
template <class Rows>
__device__ __forceinline__ bool tile_at(const Rows& r, unsigned per_row,
                                        unsigned round, int k, int& n,
                                        int& i) {
    // 32-bit: the host keeps every index of a call below 2^31
    const unsigned warps = (unsigned)r.threads() / kWarp;
    const unsigned t = (round * kBatch + k) * warps
        + (unsigned)r.thread() / kWarp;
    if (t >= (unsigned)r.count() * per_row) return false;
    unsigned j = t;
    n = r.first();
    if constexpr (!Rows::kOneRow) {
        n += (int)(t / per_row);
        j = t % per_row;
    }
    i = (int)j * kWarp + threadIdx.x % kWarp;
    return true;
}

template <class Rows>
__device__ __forceinline__ unsigned rounds_of(const Rows& r,
                                              unsigned per_row) {
    const unsigned per_round = (unsigned)r.threads() / kWarp * kBatch;
    return ((unsigned)r.count() * per_row + per_round - 1) / per_round;
}

// One round of a warp's tiles of window w, as read from the wire: ids
// and valid bits as they came, decoded only where used, so a read started
// before a barrier waits for its data only after it.
struct Tiles {
    int s[kBatch], d[kBatch];
    unsigned valid;
};

template <class Wire, class Rows>
__device__ __forceinline__ Tiles read_tiles(const Wire& wire, const Rows& r,
                                            int windows, int w,
                                            unsigned round,
                                            unsigned per_row) {
    Tiles t;
    t.valid = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
        int n, i;
        t.s[k] = t.d[k] = r.vb;
        if (tile_at(r, per_row, round, k, n, i) && i < wire.eb
                && wire.read(n * windows + w, i, t.s[k], t.d[k]))
            t.valid |= 1u << k;
    }
    return t;
}

// Tile k's slot as an edge: whether it is one with both ids in [0, vb);
// (s, d) = (vb, vb) otherwise.
__device__ __forceinline__ bool edge_of(const Tiles& t, int k, int vb,
                                        int& s, int& d) {
    s = t.s[k];
    d = t.d[k];
    const bool ok = (t.valid >> k & 1) && in_range(s, vb)
        && in_range(d, vb);
    if (!ok) s = d = vb;
    return ok;
}

// The three unions of edge (s, d) in row n, in lockstep: (s, d) in
// labels, (s, d+vb+1) and (s+vb+1, d) in the cover. Returns 1 when the
// labels union hooked.
template <class Rows>
__device__ __forceinline__ int fold_unions(const Rows& r, int n, int s,
                                           int d) {
    const int vb = r.vb;
    int* const p[3] = {r.labels_of(n), r.cover_of(n), r.cover_of(n)};
    int a[3] = {s, s, s + vb + 1}, b[3] = {d, d + vb + 1, d};
    return (int)(unite_all(p, a, b) & 1);
}

// Folds a round of tiles of window w into their rows: the degree adds,
// whose atomics are waited for only after the unions; the three unions
// of each edge in lockstep (union_find.cuh: unite_all); padding's
// sentinel join once a warp; the window's raw values into sums, once a
// row. Where the carry is in device memory (Rows::kAggregate), the
// lanes of a warp with one endpoint id (__match_any_sync) add their
// count with one atomic, so a hub costs one L2 atomic per warp; in
// shared memory each lane adds its own, as the match costs more there
// than the serialised adds of a hub.
template <class Rows>
__device__ __forceinline__ void fold_tiles(const Tiles& t, const Rows& r,
                                           unsigned per_row,
                                           unsigned round, int eb,
                                           long long W, int w, int* sums) {
    const int vb = r.vb, lane = threadIdx.x % kWarp;
    int row = -1, mx = 0, delta = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
        int n, i;
        if (!tile_at(r, per_row, round, k, n, i)) continue;  // warp-uniform
        if (n != row) {
            if (row >= 0)
                add_window(sums + row * 3 * W, W, w, warp_max(mx),
                           warp_sum(delta), false, lane);
            row = n;
            mx = delta = 0;
        }
        int* deg = r.deg_of(n);
        int* cover = r.cover_of(n);
        int s, d;
        const bool ok = edge_of(t, k, vb, s, d);
        const unsigned pads = __ballot_sync(kFullMask, !ok && i < eb);
        if constexpr (Rows::kAggregate) {
            const unsigned edges = __ballot_sync(kFullMask, ok);
            if (ok) {
                const unsigned gs = __match_any_sync(edges, s);
                const unsigned gd = __match_any_sync(edges, d);
                const bool lead_s = lane == __ffs(gs) - 1;
                const bool lead_d = lane == __ffs(gd) - 1;
                int old_s = 0, old_d = 0;
                if (lead_s) old_s = atomicAdd(deg + s, __popc(gs));
                if (lead_d) old_d = atomicAdd(deg + d, __popc(gd));
                delta -= fold_unions(r, n, s, d);
                // old + count: the degree so far; old == 0: newly touched
                if (lead_s) {
                    mx = max(mx, old_s + __popc(gs));
                    delta += old_s == 0;
                }
                if (lead_d) {
                    mx = max(mx, old_d + __popc(gd));
                    delta += old_d == 0;
                }
            }
        } else if (ok) {
            const int old_s = atomicAdd(deg + s, 1);
            const int old_d = atomicAdd(deg + d, 1);
            delta -= fold_unions(r, n, s, d);
            mx = max(mx, max(old_s, old_d) + 1);
            delta += (old_s == 0) + (old_d == 0);
        }
        if (pads && lane == __ffs(pads) - 1) unite(cover, vb, 2 * vb + 1);
    }
    if (row >= 0)
        add_window(sums + row * 3 * W, W, w, warp_max(mx), warp_sum(delta),
                   false, lane);
}

// After window w's unions: each valid slot of a row not odd yet checks
// whether s and its mirror s+vb+1 share a set.
template <class Rows>
__device__ __forceinline__ void check_tiles(const Tiles& t, const Rows& r,
                                            unsigned per_row,
                                            unsigned round, long long W,
                                            int w, int* sums) {
    const int vb = r.vb, lane = threadIdx.x % kWarp;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
        int n, i;
        if (!tile_at(r, per_row, round, k, n, i)) continue;
        int* rs = sums + n * 3 * W;
        int s, d;
        bool hit = false;
        if (edge_of(t, k, vb, s, d) && !((volatile int*)rs)[3 * W - 1]) {
            volatile int* const p[2] = {r.cover_of(n), r.cover_of(n)};
            int x[2] = {s, s + vb + 1};
            find_roots<true>(p, x, 3u);
            hit = x[0] == x[1];
        }
        add_window(rs, W, w, 0, 0, __any_sync(kFullMask, hit), lane);
    }
}

// Whether every row of r has its odd flag set. Called at the top of a
// window, where it is the same answer in every thread of the grid: the
// flags are written only by the base pass and the odd check, each
// followed by a barrier, and the fold between here and the next barrier
// writes none. (After the fold's barrier it would not be: one block could
// read a flag that another block's check of that window has just set, and
// skip the check's barrier that the others wait at.)
template <class Rows>
__device__ __forceinline__ bool all_odd(const Rows& r, const int* sums,
                                        long long windows) {
    const volatile int* vs = sums;
    int missing = 0;
    for (int k = threadIdx.x; k < r.count(); k += blockDim.x)
        missing |= !vs[(r.first() + k) * 3 * windows + 3 * windows - 1];
    return !__syncthreads_or(missing);
}

// The carry's own summaries, into window 0's raw values: max degree,
// touched roots of labels, touched vertices whose cover walks meet;
// each warp's values summed over its tiles of one row before they go
// into sums.
template <class Rows>
__device__ __forceinline__ void base_pass(const Rows& r, long long W,
                                          int* sums) {
    const int vb = r.vb, lane = threadIdx.x % kWarp;
    const unsigned per_row = (vb + kWarp - 1) / kWarp;
    const unsigned rounds = rounds_of(r, per_row);
    int row = -1, mx = 0, roots = 0;
    bool odd = false;
    for (unsigned round = 0; round < rounds; ++round) {
        int n[kBatch], v[kBatch], dg[kBatch], lab[kBatch], x[2 * kBatch];
        volatile int* p[2 * kBatch];
        unsigned live = 0, walks = 0;
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            dg[k] = 0;
            p[2 * k] = p[2 * k + 1] = r.cover_of(r.first());
            if (!tile_at(r, per_row, round, k, n[k], v[k])) continue;
            live |= 1u << k;
            if (v[k] < vb) {
                dg[k] = r.deg_of(n[k])[v[k]];
                lab[k] = r.labels_of(n[k])[v[k]];
            }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            p[2 * k] = p[2 * k + 1] = r.cover_of(live >> k & 1 ? n[k]
                                                  : r.first());
            x[2 * k] = v[k];
            x[2 * k + 1] = v[k] + vb + 1;
            if (dg[k] > 0) walks |= 3u << (2 * k);
        }
        find_roots<true>(p, x, walks);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            if (!(live >> k & 1)) continue;                   // warp-uniform
            if (n[k] != row) {
                if (row >= 0)
                    add_window(sums + row * 3 * W, W, 0, warp_max(mx),
                               warp_sum(roots), __any_sync(kFullMask, odd),
                               lane);
                row = n[k];
                mx = roots = 0;
                odd = false;
            }
            const bool touched = dg[k] > 0;
            mx = max(mx, dg[k]);
            roots += touched && lab[k] == v[k];
            odd = odd || (touched && x[2 * k] == x[2 * k + 1]);
        }
    }
    if (row >= 0)
        add_window(sums + row * 3 * W, W, 0, warp_max(mx), warp_sum(roots),
                   __any_sync(kFullMask, odd), lane);
}

// The body between the tier's load (carry rows in place, sums zeroed,
// a barrier) and its write-back: the base pass, the windows, the prefix.
template <class Wire, class Rows>
__device__ void summary_body(const Wire& wire, const Rows& r, int windows,
                             int* __restrict__ sums) {
    const long long W = windows;
    base_pass(r, W, sums);
    r.sync();

    const unsigned per_row = (wire.eb + kWarp - 1) / kWarp;
    const unsigned rounds = rounds_of(r, per_row);
    Tiles cur = read_tiles(wire, r, windows, 0, 0, per_row);
    bool odd_rows = false;          // every row odd: no check, no barrier
    for (int w = 0; w < windows; ++w) {
        // read before the fold, never after its barrier (all_odd)
        odd_rows = odd_rows || all_odd(r, sums, W);
        for (unsigned round = 0; round < rounds; ++round) {
            if (round) cur = read_tiles(wire, r, windows, w, round, per_row);
            fold_tiles(cur, r, per_row, round, wire.eb, W, w, sums);
        }
        // the next window's first round, read across the barriers
        Tiles next = cur;
        if (w + 1 < windows)
            next = read_tiles(wire, r, windows, w + 1, 0, per_row);
        r.sync();
        if (!odd_rows) {
            for (unsigned round = 0; round < rounds; ++round) {
                if (rounds > 1)
                    cur = read_tiles(wire, r, windows, w, round, per_row);
                check_tiles(cur, r, per_row, round, W, w, sums);
            }
            r.sync();
        }
        cur = next;
    }

    // raw values -> summaries: running max, sum and or over the windows,
    // a warp a row, 32 windows at a time
    const int lane = threadIdx.x % kWarp;
    for (long long k = r.thread() / kWarp; k < r.count();
         k += r.threads() / kWarp) {
        int* rs = sums + (r.first() + k) * 3 * W;
        int mx = 0, comps = 0, odd = 0;
        for (long long w0 = 0; w0 < W; w0 += kWarp) {
            const long long w = w0 + lane;
            int m = 0, c = 0, o = 0;
            if (w < W) {
                m = rs[w];
                c = rs[W + w];
                o = rs[2 * W + w];
            }
            for (int off = 1; off < kWarp; off *= 2) {
                const int m2 = __shfl_up_sync(kFullMask, m, off);
                const int c2 = __shfl_up_sync(kFullMask, c, off);
                const int o2 = __shfl_up_sync(kFullMask, o, off);
                if (lane >= off) {
                    m = max(m, m2);
                    c += c2;
                    o |= o2;
                }
            }
            m = max(m, mx);
            c += comps;
            o |= odd;
            if (w < W) {
                rs[w] = m;
                rs[W + w] = c;
                rs[2 * W + w] = o;
            }
            mx = __shfl_sync(kFullMask, m, kWarp - 1);
            comps = __shfl_sync(kFullMask, c, kWarp - 1);
            odd = __shfl_sync(kFullMask, o, kWarp - 1);
        }
    }
}

// Shared-memory tier: block n folds row n. Dynamic shared memory holds
// the row (16(vb+1) bytes), read in and written back once, kWalks slots
// a thread at a time.
template <class Wire>
__global__ void __launch_bounds__(kBlockThreads) summary_block_kernel(
        const Wire wire, int windows, int vb, int* deg, int* labels,
        int* cover, int* __restrict__ sums) {
    extern __shared__ int carry[];
    const long long n = blockIdx.x;
    const int row = vb + 1, slots = 4 * row, step = kWalks * blockDim.x;
    const BlockRows r{carry, carry + row, carry + 2 * row,
                      deg + n * row, labels + n * row, cover + 2 * n * row,
                      (int)n, vb};
    for (int k0 = threadIdx.x; k0 < slots; k0 += step) {
        int v[kWalks];
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
            const int k = k0 + m * blockDim.x;
            if (k < slots)
                v[m] = k < row ? r.home_deg[k]
                    : k < 2 * row ? r.home_labels[k - row]
                    : r.home_cover[k - 2 * row];
        }
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
            const int k = k0 + m * blockDim.x;
            if (k < slots) carry[k] = v[m];
        }
    }
    for (int k = threadIdx.x; k < 3 * windows; k += blockDim.x)
        sums[n * 3 * windows + k] = 0;
    r.sync();
    summary_body(wire, r, windows, sums);
    // home: deg as it is, every slot of labels and cover at its root (the
    // walks in shared memory do not write)
    for (int k0 = threadIdx.x; k0 < slots; k0 += step) {
        volatile int* p[kWalks];
        int x[kWalks];
        unsigned walks = 0;
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
            const int k = k0 + m * blockDim.x;
            p[m] = k < 2 * row ? r.labels : r.cover;
            x[m] = k < 2 * row ? k - row : k - 2 * row;
            if (k < slots && k >= row) walks |= 1u << m;
        }
        find_roots<false>(p, x, walks);
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
            const int k = k0 + m * blockDim.x;
            if (k >= slots) continue;
            if (k < row)
                r.home_deg[k] = carry[k];
            else if (k < 2 * row)
                r.home_labels[k - row] = x[m];
            else
                r.home_cover[k - 2 * row] = x[m];
        }
    }
}

// L2 tier: the grid folds every row in device memory. Launched
// cooperatively (the grid barrier needs every block resident).
template <class Wire>
__global__ void __launch_bounds__(kThreads) summary_grid_kernel(
        const Wire wire, int nb, int windows, int vb, int* deg, int* labels,
        int* cover, int* __restrict__ sums) {
    const GridRows r{deg, labels, cover, nb, vb};
    for (long long k = r.thread(); k < 3LL * nb * windows; k += r.threads())
        sums[k] = 0;
    r.sync();
    summary_body(wire, r, windows, sums);
    // every slot of labels and cover at its root: each slot has one
    // owner, and the walks here do not write, so every slot ends there
    const unsigned per = 3u * (vb + 1), step = (unsigned)r.threads();
    // slot t = thread + m·step of the flat [nb, per] index as (n, j),
    // advanced by step without a division
    unsigned n = (unsigned)r.thread() / per, j = (unsigned)r.thread() % per;
    const unsigned q = step / per, rem = step % per;
    while (n < (unsigned)nb) {
        volatile int* p[kWalks];
        int x[kWalks], at[kWalks];
        unsigned walks = 0;
#pragma unroll
        for (int m = 0; m < kWalks; ++m) {
            const int row = (int)min(n, (unsigned)nb - 1);
            p[m] = j <= (unsigned)vb ? r.labels_of(row) : r.cover_of(row);
            x[m] = at[m] = j <= (unsigned)vb ? (int)j : (int)j - (vb + 1);
            if (n < (unsigned)nb) walks |= 1u << m;
            j += rem;
            n += q;
            if (j >= per) {
                j -= per;
                ++n;
            }
        }
        find_roots<false>(p, x, walks);
#pragma unroll
        for (int m = 0; m < kWalks; ++m)
            if (walks >> m & 1) p[m][at[m]] = x[m];
    }
}

// Per device and wire: the SM count and the opt-in shared memory of a
// block, and the block kernel's dynamic shared memory raised to it, once.
template <class Wire>
cudaError_t prepare(int device, int& sms, int& smem) {
    static std::atomic<int> sm_count[kMaxDevices], smem_optin[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!sm_count[device].load()) {
        int n = 0, optin = 0;
        cudaError_t err = cudaDeviceGetAttribute(
            &n, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                summary_block_kernel<Wire>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
        if (err != cudaSuccess) return err;
        smem_optin[device].store(optin);
        sm_count[device].store(n);
    }
    sms = sm_count[device].load();
    smem = smem_optin[device].load();
    return cudaSuccess;
}

// Folds the windows of nb rows, read through `wire` (row n's window w
// at wire window n·windows + w), into the stacked carries deg[nb, vb+1],
// labels[nb, vb+1], cover[nb, 2(vb+1)] in place, and writes sums
// [nb, 3, windows]: one launch on `stream`, of the tier the row's size
// picks.
template <class Wire>
cudaError_t summarize_rows(const Wire wire, int nb, int windows, int vb,
                           int* deg, int* labels, int* cover, int* sums,
                           int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    // the kernels index slots, carry slots and windows in 32 bits
    const long long span = std::max<long long>(wire.eb, 3LL * (vb + 1));
    if ((long long)nb * span >= (1LL << 31)
            || (long long)nb * windows * 3 >= (1LL << 31))
        return cudaErrorInvalidValue;
    int sms = 0, optin = 0;
    if ((err = prepare<Wire>(device, sms, optin)) != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t row_bytes = 16 * (size_t)(vb + 1);
    if (kSharedTier && row_bytes <= (size_t)optin) {
        summary_block_kernel<Wire><<<nb, kBlockThreads, row_bytes, s>>>(
            wire, windows, vb, deg, labels, cover, sums);
        return cudaGetLastError();
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, summary_grid_kernel<Wire>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    // a slot a thread, at least a block an SM, at most what fits at once
    const long long want = std::max<long long>(
        sms, ((long long)nb * wire.eb + kThreads - 1) / kThreads);
    const unsigned grid =
        (unsigned)std::min<long long>(want, (long long)per_sm * sms);
    Wire w = wire;
    void* args[] = {&w, &nb, &windows, &vb, &deg, &labels, &cover, &sums};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(summary_grid_kernel<Wire>), grid,
        kThreads, args, 0, s);
}

}  // namespace
