// Triangle-only window counter, written by hand for Hopper (sm_90a): a
// window's (count, overflow) in one launch per call, one block per
// window at a time.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_counter_call`
// (:748-792) with its `_tri_stage` (:448-485), and with it the row
// intersection of gelly_streaming_tpu/ops/pallas_intersect.py
// `_intersect_tiles` (:118) that the stage ends in. For each window of a
// [W, eb] edge stack: clean (drop padding, self-loops and ids outside
// [0, vb)) -> degrees of the multigraph -> orient low(deg, id) ->
// high(deg, id) -> dedupe -> R(v), v's distinct out-neighbors truncated
// to the kb smallest ids -> count = Σ over distinct oriented edges (a, b)
// of |R(a) ∩ R(b)|, overflow = Σ_v max(0, distinct outdeg_v - kb). That
// is the TPU kernel's result bit for bit, overflowing windows included.
//
// The TPU kernel sorted a window's (a, b) pairs in VMEM and scattered
// them into a [vb+1, kb] table. Here a block builds short sorted CSR
// rows instead, in six stages separated by __syncthreads:
//   1. degrees: an add per endpoint into a per-vertex table;
//   2. orient each slot by those degrees into a key a << s | b, kept in
//      this block's device scratch (L2-resident: eb keys);
//   3. the same table, cleared, counts each source's out-edges with
//      duplicates; a block scan turns the counts into row starts and
//      lists the rows of two or more entries;
//   4. each key takes its column with an add on its row's cursor, which
//      leaves the cursor at the row's end: row v is [end(v-1), end(v));
//   5. each row is sorted and deduplicated in place: by one thread in
//      registers (up to kThreadRow = 8 entries); longer rows are listed
//      and taken by warps one at a time: a bitonic network, an entry a
//      lane (up to 32) or eight a lane (up to 256), or a selection of the
//      distinct entries in order, the smallest above the last each step
//      (d steps of n/32 reads a lane for n entries, d distinct; d·n <=
//      2·eb, so a row of one edge repeated eb times is 2 steps);
//      the places of removed duplicates are set to 0, which ends a
//      strictly ascending row (row_intersect.cuh);
//   6. each distinct entry (a, b) merges R(a) with R(b), both read up to
//      kb entries (row_intersect.cuh): la + lb steps, not la × lb; a
//      place's row a is found by a binary search of the row ends.
// A block owns its window from the first slot to the two outputs, so
// nothing is cleared in device memory and nothing is added across
// blocks: no memset, one launch.
//
// Two tiers give the same bits, chosen by shape only:
// - shared-memory tier (ids < 65536 and eb <= 65535, and the tables fit
//   the opt-in shared memory of a block: the main path's vb=65536,
//   eb=32768 and the cohort's vb=8192, eb=4096): the vertex table holds
//   uint16 entries, two to a 32-bit word added with a 32-bit shared
//   atomic of 1 or 1 << 16. A window's degree is at most eb (a slot adds
//   at most 1 to a vertex, self-loops being dropped), and so are its row
//   starts, so no half carries into its neighbor. The columns (uint16)
//   are in shared memory too; keys are 32-bit;
// - L2 tier (vb > 65536, eb >= 65536, or tables past the shared
//   memory): the same stages over int32 tables in this block's device
//   scratch, keys of 64 bits, and adds on a hub aggregated per warp
//   (__match_any_sync: one L2 atomic a warp per id).
// A window takes a cluster of C blocks, C = 1, 2, 4 or 8 chosen by W: as
// many as leave no SM idle. Each block of a cluster builds the window's
// rows in its own shared memory, and the C split the last stage; their
// counts add up in the first block's shared memory (distributed shared
// memory and one cluster barrier a window). The grid is at most the
// clusters the card holds at once, and each walks the windows; the
// device scratch is per block, so it does not grow with W.
//
// Both read the stack through a wire reader (common.cuh): the standard
// wire (int32 ids, bool valid) or the compact one (uint16 ids, one valid
// count per window; gs_window_counter_compact), decoded as each slot is
// loaded, so no widened stack exists.
//
// What bounds it: instruction issue on one SM, not bytes. Per valid
// slot: two degree adds, one count add, one cursor add in shared
// memory, a binary search and a merge; the slab is read twice (the
// second time from L2), the keys written once and read twice. Per
// vertex, the scan's two passes (vb = 65536 is twice eb = 32768). A
// window's first five stages sit on one SM.
#include <atomic>
#include <algorithm>
#include <cooperative_groups.h>

#include "common.cuh"
#include "row_intersect.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlock = 1024;                 // threads a block
constexpr int kBlockWarps = kBlock / kWarp;
constexpr int kThreadRow = 8;                // rows up to this: a thread
constexpr int kBatch = 4;                    // keys a thread loads at once
constexpr int kMaxDevices = 64;
// the number of stages run, 6 unless a build of utils/counter_probe.py
// stops early to time the stages before the cut
#ifndef GS_COUNTER_STAGES
#define GS_COUNTER_STAGES 6
#endif
constexpr int kStages = GS_COUNTER_STAGES;
#ifdef GS_COUNTER_L2_ONLY
// every call in the L2 tier: a build of utils/counter_probe.py that
// times that tier where the shared-memory tier would run
constexpr bool kSharedTier = false;
#else
constexpr bool kSharedTier = true;
#endif
constexpr int kPortableCluster = 8;          // blocks a cluster may hold
#ifdef GS_COUNTER_ONE_BLOCK
// one block a window whatever W: a build of utils/counter_probe.py that
// times the clusters' gain
constexpr int kMaxCluster = 1;
#else
constexpr int kMaxCluster = kPortableCluster;  // blocks a window, at most
#endif

// A slot holds an edge: valid, not a self-loop, both ids in [0, vb).
__device__ __forceinline__ bool edge_ok(bool v, int s, int d, int vb) {
    return v && s != d && s >= 0 && s < vb && d >= 0 && d < vb;
}

__device__ __forceinline__ int warp_sum(int x) {
    for (int o = kWarp / 2; o; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
    return x;
}

__device__ __forceinline__ int warp_inclusive_scan(int x, int lane) {
    for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
    }
    return x;
}

// The list of rows to sort, those of 2 or more entries: rows for a
// thread from the front, rows for a warp from the back; eb/2 + 1 places
// hold every one.
__host__ __device__ constexpr int list_cap(int eb) { return eb / 2 + 1; }

__host__ __device__ constexpr size_t align256(size_t n) {
    return (n + 255) & ~size_t(255);
}

// Shared-memory tier: the vertex table as uint16 entries two to a word,
// the columns as uint16 and the list of rows to sort in shared memory;
// the keys (a << 16 | b) in device scratch.
struct SharedTables {
    using Key = unsigned;
    using Id = uint16_t;
    static constexpr int kShift = 16;
    static constexpr Key kNoKey = ~0u;
    unsigned* words;
    Id* col;
    Id* list;
    Key* keys;

    static size_t smem_bytes(int eb, int vb) {
        return 4 * (size_t)((vb + 1) / 2) + 4 * (size_t)((eb + 1) / 2) +
               2 * (size_t)list_cap(eb);
    }
    static size_t block_bytes(int eb, int /*vb*/) {
        return align256(4 * (size_t)eb);
    }
    __device__ static SharedTables make(unsigned char* smem,
                                        unsigned char* scratch, int eb,
                                        int vb) {
        SharedTables t;
        t.words = reinterpret_cast<unsigned*>(smem);
        t.col = reinterpret_cast<Id*>(t.words + (vb + 1) / 2);
        t.list = t.col + 2 * ((eb + 1) / 2);
        t.keys = reinterpret_cast<Key*>(scratch);
        return t;
    }
    __device__ int get(int v) const {
        return reinterpret_cast<const uint16_t*>(words)[v];
    }
    __device__ void put(int v, int x) const {
        reinterpret_cast<uint16_t*>(words)[v] = (uint16_t)x;
    }
    __device__ void zero(int vb) const {
        for (int i = threadIdx.x; i < (vb + 1) / 2; i += kBlock) words[i] = 0;
    }
    // Adds 1 to v's entry where ok; returns the entry before. Called by
    // every lane of a warp.
    __device__ int bump(bool ok, int v) const {
        if (!ok) return 0;
        const unsigned sh = (v & 1) << 4;
        return (atomicAdd(words + (v >> 1), 1u << sh) >> sh) & 0xffffu;
    }
    __device__ int* tmp() const { return reinterpret_cast<int*>(keys); }
};

// L2 tier: every table in this block's device scratch, int32 entries,
// keys a << 32 | b.
struct GlobalTables {
    using Key = unsigned long long;
    using Id = int;
    static constexpr int kShift = 32;
    static constexpr Key kNoKey = ~0ull;
    int* words;
    Id* col;
    Id* list;
    Key* keys;

    static size_t block_bytes(int eb, int vb) {
        return align256(4 * (size_t)vb) + align256(4 * (size_t)eb) +
               align256(4 * (size_t)list_cap(eb)) + align256(8 * (size_t)eb);
    }
    __device__ static GlobalTables make(unsigned char*,
                                        unsigned char* scratch, int eb,
                                        int vb) {
        GlobalTables t;
        unsigned char* p = scratch;
        t.words = reinterpret_cast<int*>(p);
        p += align256(4 * (size_t)vb);
        t.col = reinterpret_cast<Id*>(p);
        p += align256(4 * (size_t)eb);
        t.list = reinterpret_cast<Id*>(p);
        p += align256(4 * (size_t)list_cap(eb));
        t.keys = reinterpret_cast<Key*>(p);
        return t;
    }
    __device__ int get(int v) const { return words[v]; }
    __device__ void put(int v, int x) const { words[v] = x; }
    __device__ void zero(int vb) const {
        for (int i = threadIdx.x; i < vb; i += kBlock) words[i] = 0;
    }
    // As SharedTables::bump; lanes with the same v add once.
    __device__ int bump(bool ok, int v) const {
        const unsigned peers = __match_any_sync(kFullMask, ok ? v : -1);
        if (!ok) return 0;
        const int lane = threadIdx.x % kWarp, leader = __ffs(peers) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(words + v, __popc(peers));
        base = __shfl_sync(peers, base, leader);
        return base + __popc(peers & ((1u << lane) - 1u));
    }
    __device__ int* tmp() const { return reinterpret_cast<int*>(keys); }
};

// Block-uniform values of a window.
struct BlockState {
    int next;
    int warp_a[kBlockWarps], warp_b[kBlockWarps], warp_c[kBlockWarps];
    int part[2][kPortableCluster];  // each block's count, by window parity
};

// The block's sum of each warp's `x` (lane 0's), and the part before
// this warp's.
__device__ __forceinline__ void warp_offsets(int* tot, int x, int& before,
                                             int& total) {
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) tot[warp] = x;
    __syncthreads();
    before = total = 0;
    for (int k = 0; k < kBlockWarps; ++k) {
        const int y = tot[k];
        if (k < warp) before += y;
        total += y;
    }
}

// The rows' layout from the per-source counts n(v) in the vertex table
// (stage 3): each entry turned into its row's start (the exclusive
// prefix sum), and the rows to sort listed: 2..kThreadRow entries
// from the front of the list for a thread, more from the back for a
// warp. Returns the number of places; nf, nb the rows listed (the same
// in every thread). Each warp takes a segment of 64-vertex tiles, two
// vertices a lane: one pass counts, the warps' counts give each warp its
// offsets, a second pass writes.
template <class Tables>
__device__ int build_rows(const Tables& t, int n, int cap, BlockState& st,
                          int& nf, int& nb) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    constexpr int kTile = 2 * kWarp;
    const int seg = ((n + kBlockWarps - 1) / kBlockWarps + kTile - 1) &
                    ~(kTile - 1);
    const int lo = min(warp * seg, n), hi = min(lo + seg, n);
    auto front = [](int x) { return x >= 2 && x <= kThreadRow; };
    auto back = [](int x) { return x > kThreadRow; };
    int c = 0, cf = 0, cb = 0;
    for (int v = lo + 2 * lane; v < hi; v += kTile) {
        const int x0 = t.get(v), x1 = v + 1 < hi ? t.get(v + 1) : 0;
        c += x0 + x1;
        cf += front(x0) + front(x1);
        cb += back(x0) + back(x1);
    }
    int base, total, bf, bb;
    warp_offsets(st.warp_a, warp_sum(c), base, total);
    warp_offsets(st.warp_b, warp_sum(cf), bf, nf);
    warp_offsets(st.warp_c, warp_sum(cb), bb, nb);
    const unsigned below = (1u << lane) - 1u;
    for (int v0 = lo; v0 < hi; v0 += kTile) {
        const int v = v0 + 2 * lane;
        const int x0 = v < hi ? t.get(v) : 0;
        const int x1 = v + 1 < hi ? t.get(v + 1) : 0;
        const int incl = warp_inclusive_scan(x0 + x1, lane);
        const int s0 = base + incl - x0 - x1, s1 = s0 + x0;
        if (v < hi) t.put(v, s0);
        if (v + 1 < hi) t.put(v + 1, s1);
        base += __shfl_sync(kFullMask, incl, kWarp - 1);
        // list v before v + 1: lane l's pair at 2·(rows of lanes below)
        const unsigned f0 = __ballot_sync(kFullMask, front(x0));
        const unsigned f1 = __ballot_sync(kFullMask, front(x1));
        const unsigned b0 = __ballot_sync(kFullMask, back(x0));
        const unsigned b1 = __ballot_sync(kFullMask, back(x1));
        const int pf = bf + __popc(f0 & below) + __popc(f1 & below);
        const int pb = bb + __popc(b0 & below) + __popc(b1 & below);
        if (front(x0)) t.list[pf] = v;
        if (front(x1)) t.list[pf + front(x0)] = v + 1;
        if (back(x0)) t.list[cap - 1 - pb] = v;
        if (back(x1)) t.list[cap - 1 - pb - back(x0)] = v + 1;
        bf += __popc(f0) + __popc(f1);
        bb += __popc(b0) + __popc(b1);
    }
    __syncthreads();
    return total;
}

__device__ __forceinline__ void order(int& x, int& y) {
    const int lo = min(x, y);
    y = max(x, y);
    x = lo;
}

// Sorts r[0, n), 2 <= n <= kThreadRow = 8, ascending, keeps the first of
// each value at the front and sets the rest to 0; returns the distinct
// count. One thread, in registers: the entries padded with INT_MAX
// through a network of 19 compare-exchanges.
template <class T>
__device__ int sort_row_thread(T* r, int n) {
    int x[kThreadRow];
#pragma unroll
    for (int q = 0; q < kThreadRow; ++q) x[q] = q < n ? (int)r[q] : INT_MAX;
    // Batcher's odd-even merge network for 8 entries
    order(x[0], x[1]); order(x[2], x[3]); order(x[4], x[5]);
    order(x[6], x[7]); order(x[0], x[2]); order(x[1], x[3]);
    order(x[4], x[6]); order(x[5], x[7]); order(x[1], x[2]);
    order(x[5], x[6]); order(x[0], x[4]); order(x[1], x[5]);
    order(x[2], x[6]); order(x[3], x[7]); order(x[2], x[4]);
    order(x[3], x[5]); order(x[1], x[2]); order(x[3], x[4]);
    order(x[5], x[6]);
    int d = 1;
#pragma unroll
    for (int q = 1; q < kThreadRow; ++q)
        if (q < n && x[q] != x[q - 1]) r[d++] = (T)x[q];
    r[0] = (T)x[0];
    for (int i = d; i < n; ++i) r[i] = 0;
    return d;
}

// The same by one warp for kThreadRow < n <= 32·kPer: kPer entries a
// lane in registers (entry kPer·lane + q), padded with INT_MAX, sorted by
// a bitonic network (compare-exchanges within a lane, and across lanes
// with __shfl_xor_sync), then the first of each value (unequal to the
// entry before it) compacted to the front by a warp scan of each lane's
// count. Every lane returns d.
template <int kPer, class T>
__device__ int sort_row_bitonic(T* r, int n, int lane) {
    constexpr int kSize = kWarp * kPer;
    int x[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int e = lane * kPer + q;
        x[q] = e < n ? (int)r[e] : INT_MAX;
    }
#pragma unroll
    for (int k = 2; k <= kSize; k <<= 1) {
#pragma unroll
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (j >= kPer) {               // the partner is in lane ^ j/kPer
#pragma unroll
                for (int q = 0; q < kPer; ++q) {
                    const int e = lane * kPer + q;
                    const int y = __shfl_xor_sync(kFullMask, x[q], j / kPer);
                    const bool up = (e & k) == 0, low = (e & j) == 0;
                    x[q] = low == up ? min(x[q], y) : max(x[q], y);
                }
            } else {                       // the partner is x[q | j]
#pragma unroll
                for (int q = 0; q < kPer; ++q) {
                    if (q & j) continue;
                    const int p = (q | j) & (kPer - 1);
                    const bool up = ((lane * kPer + q) & k) == 0;
                    const int lo = min(x[q], x[p]), hi = max(x[q], x[p]);
                    x[q] = up ? lo : hi;
                    x[p] = up ? hi : lo;
                }
            }
        }
    }
    int prev = __shfl_up_sync(kFullMask, x[kPer - 1], 1);
    if (lane == 0) prev = INT_MIN;
    int c = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
        c += x[q] != INT_MAX && x[q] != (q ? x[q - 1] : prev);
    const int incl = warp_inclusive_scan(c, lane);
    const int d = __shfl_sync(kFullMask, incl, kWarp - 1);
    __syncwarp();
    int pos = incl - c;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
        if (x[q] != INT_MAX && x[q] != (q ? x[q - 1] : prev))
            r[pos++] = (T)x[q];
    for (int j = d + lane; j < n; j += kWarp) r[j] = 0;
    __syncwarp();
    return d;
}

// The same by one warp for n > 256: the distinct entries, in
// order, by repeated selection of the smallest entry above the last one
// taken (a warp-wide min), collected in tmp[0, d) and copied back to the
// front of r; the rest of r set to 0. d steps of n/32 reads a lane; a
// row of n entries and d distinct targets has d·n <= 2·eb (each target's
// degree is at least n, the source's), so a long row is one of few
// distinct entries and costs few steps. Every lane returns d.
template <class T>
__device__ int sort_row_select(T* r, int* tmp, int n, int lane) {
    int d = 0;
    for (int last = -1;; ++d) {
        int m = INT_MAX;
        for (int j = lane; j < n; j += kWarp) {
            const int x = r[j];
            if (x > last && x < m) m = x;
        }
        m = __reduce_min_sync(kFullMask, m);
        if (m == INT_MAX) break;
        if (lane == 0) tmp[d] = m;
        last = m;
    }
    __syncwarp();
    for (int j = lane; j < n; j += kWarp) r[j] = j < d ? (T)tmp[j] : (T)0;
    __syncwarp();
    return d;
}

// A row of n > kThreadRow entries by one warp: a bitonic network of 32,
// 64, 128 or 256 entries, or selection past that.
template <class T>
__device__ int sort_row_warp(T* r, int* tmp, int n, int lane) {
    if (n <= kWarp) return sort_row_bitonic<1>(r, n, lane);
    if (n <= 2 * kWarp) return sort_row_bitonic<2>(r, n, lane);
    if (n <= 4 * kWarp) return sort_row_bitonic<4>(r, n, lane);
    if (n <= 8 * kWarp) return sort_row_bitonic<8>(r, n, lane);
    return sort_row_select(r, tmp, n, lane);
}

// This thread's keys of slots i0 + u·kBlock + tid, u < kBatch, loaded
// together so that their latencies overlap (kNoKey past eb).
template <class Tables>
__device__ __forceinline__ void load_keys(const Tables& t, int i0, int eb,
                                          typename Tables::Key* key) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kBlock + threadIdx.x;
        key[u] = i < eb ? t.keys[i] : Tables::kNoKey;
    }
}

template <class Wire, class Tables>
__global__ void __launch_bounds__(kBlock, 1) counter_kernel(
        const Wire wire, int windows, int vb, int kb,
        unsigned char* __restrict__ scratch, size_t block_bytes,
        int* __restrict__ count, int* __restrict__ overflow) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ BlockState st;
    using Key = typename Tables::Key;
    constexpr int sh = Tables::kShift;
    constexpr Key kLow = (Key(1) << sh) - 1;
    const int eb = wire.eb;
    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    const Tables t = Tables::make(smem, scratch + blockIdx.x * block_bytes,
                                  eb, vb);
    const int cap = list_cap(eb);
    // a cluster of C blocks a window: each builds the rows, and the C
    // split the last stage
    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();

    for (int w = blockIdx.x / C, parity = 0; w < windows;
         w += gridDim.x / C, parity ^= 1) {
        t.zero(vb);
        if (tid == 0) st.next = 0;
        __syncthreads();
        // 1. degrees of the multigraph
        for (int i0 = 0; i0 < eb; i0 += kBlock) {
            const int i = i0 + tid;
            int s = 0, d = 0;
            const bool ok = i < eb && edge_ok(wire.read(w, i, s, d), s, d, vb);
            t.bump(ok, s);
            t.bump(ok, d);
        }
        __syncthreads();
        // 2. orient: key a << sh | b, or kNoKey
        if (kStages >= 2)
            for (int i = tid; i < eb; i += kBlock) {
                int s, d;
                Key key = Tables::kNoKey;
                if (edge_ok(wire.read(w, i, s, d), s, d, vb)) {
                    const int lo = min(s, d), hi = max(s, d);
                    const int dlo = t.get(lo), dhi = t.get(hi);
                    // the tie-break of triangles.orient_by_degree
                    const bool swap = dlo > dhi || (dlo == dhi && lo > hi);
                    key = Key(swap ? hi : lo) << sh | Key(swap ? lo : hi);
                }
                t.keys[i] = key;
            }
        __syncthreads();
        // 3. out-edges per source, duplicates included -> row starts;
        // the rows to sort listed
        int total = 0, nf = 0, nb = 0;
        if (kStages >= 3) {
            t.zero(vb);
            __syncthreads();
            for (int i0 = 0; i0 < eb; i0 += kBatch * kBlock) {
                Key key[kBatch];
                load_keys(t, i0, eb, key);
#pragma unroll
                for (int u = 0; u < kBatch; ++u)
                    t.bump(key[u] != Tables::kNoKey, (int)(key[u] >> sh));
            }
            __syncthreads();
            total = build_rows(t, vb, cap, st, nf, nb);
        }
        // 4. each key to its column; the cursor ends at the row's end
        if (kStages >= 4) {
            for (int i0 = 0; i0 < eb; i0 += kBatch * kBlock) {
                Key key[kBatch];
                load_keys(t, i0, eb, key);
#pragma unroll
                for (int u = 0; u < kBatch; ++u) {
                    const bool ok = key[u] != Tables::kNoKey;
                    const int a = ok ? (int)(key[u] >> sh) : 0;
                    const int pos = t.bump(ok, a);
                    if (ok) t.col[pos] = (typename Tables::Id)(key[u] & kLow);
                }
            }
            __syncthreads();
        }
        // 5. sort and dedupe every listed row in place; overflow past
        // kb. Threads sort the short rows, warps the long ones, one at a
        // time.
        int ovf = 0;
        if (kStages >= 5) {
            for (int k = tid; k < nf; k += kBlock) {
                const int v = t.list[k];
                const int start = v ? t.get(v - 1) : 0;
                ovf += max(0, sort_row_thread(t.col + start,
                                              t.get(v) - start) - kb);
            }
            for (;;) {
                int k = 0;
                if (lane == 0) k = atomicAdd(&st.next, 1);
                k = __shfl_sync(kFullMask, k, 0);
                if (k >= nb) break;
                const int v = t.list[cap - 1 - k];
                const int start = v ? t.get(v - 1) : 0;
                const int n = t.get(v) - start;
                const int d = sort_row_warp(t.col + start, t.tmp() + start,
                                            n, lane);
                if (lane == 0) ovf += max(0, d - kb);
            }
            __syncthreads();
        }
        // 6. Σ over distinct (a, b) of |R(a) ∩ R(b)|, rows read up to kb
        int tri = 0;
        if (kStages >= 6) {
            for (int p = rank * kBlock + tid; p < total; p += C * kBlock) {
                // the row holding place p: the first v with end(v) > p
                int a = 0;
                for (int hi = vb - 1; a < hi;) {
                    const int mid = (a + hi) >> 1;
                    if (t.get(mid) > p) hi = mid;
                    else a = mid + 1;
                }
                const int sa = a ? t.get(a - 1) : 0;
                const int b = t.col[p];
                if (p != sa && b <= (int)t.col[p - 1]) continue;  // removed
                const int sb = b ? t.get(b - 1) : 0;
                tri += merge_count(t.col + sa, min(t.get(a) - sa, kb),
                                   t.col + sb, min(t.get(b) - sb, kb), vb);
            }
        }
        tri = warp_sum(tri);
        ovf = warp_sum(ovf);
        if (lane == 0) {
            st.warp_a[warp] = tri;
            st.warp_b[warp] = ovf;
        }
        __syncthreads();
        if (warp == 0) {
            tri = warp_sum(st.warp_a[lane]);
            ovf = warp_sum(st.warp_b[lane]);
            if (lane == 0 && C == 1) {
                count[w] = tri;
                overflow[w] = ovf;
            } else if (lane == 0) {
                *cluster.map_shared_rank(&st.part[parity][rank], 0) = tri;
            }
        }
        if (C > 1) {
            // the blocks' counts in the first block's shared memory; by
            // parity, so that a block a window ahead cannot overwrite one
            // before it is read
            cluster.sync();
            if (rank == 0 && tid == 0) {
                int sum = 0;
                for (int k = 0; k < C; ++k) sum += st.part[parity][k];
                count[w] = sum;
                overflow[w] = ovf;
            }
        }
        __syncthreads();
    }
}

// What a call runs: the tier, the blocks of its grid, each block's
// dynamic shared memory and device scratch.
struct Plan {
    bool shared;
    int blocks, cluster;
    size_t smem, block_bytes;
};

// Raises both wires' kernels' dynamic shared memory to what a block may
// hold beside their static shared memory; returns that size in `room`.
cudaError_t raise_smem(int optin, int& room) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(
        &attr, counter_kernel<StandardWire, SharedTables>);
    if (err != cudaSuccess) return err;
    room = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(counter_kernel<StandardWire, SharedTables>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               room);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            counter_kernel<CompactWire, SharedTables>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, room);
    return err;
}

template <class Tables>
cudaError_t blocks_per_sm(size_t smem, int& n) {
    int a = 0, b = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &a, counter_kernel<StandardWire, Tables>, kBlock, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, counter_kernel<CompactWire, Tables>, kBlock, smem);
    n = std::min(a, b);
    return err;
}

// The plan of a call of `windows` windows of eb slots at vb: the
// shared-memory tier where ids and places fit 16 bits and the tables
// fit a block, else the L2 tier; a block a window up to what the card
// holds at once.
cudaError_t plan(int windows, int eb, int vb, int device, Plan& p) {
    static std::atomic<int> sm_count[kMaxDevices], smem_room[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    cudaError_t err;
    if (!sm_count[device].load()) {
        int n = 0, optin = 0, room = 0;
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
        if (err == cudaSuccess) err = raise_smem(optin, room);
        if (err != cudaSuccess) return err;
        smem_room[device].store(room);
        sm_count[device].store(n);
    }
    p.shared = kSharedTier && vb <= 65536 && eb <= 65535 &&
               SharedTables::smem_bytes(eb, vb) <=
                   (size_t)smem_room[device].load();
    p.smem = p.shared ? SharedTables::smem_bytes(eb, vb) : 0;
    p.block_bytes = p.shared ? SharedTables::block_bytes(eb, vb)
                             : GlobalTables::block_bytes(eb, vb);
    int per_sm = 0;
    err = p.shared ? blocks_per_sm<SharedTables>(p.smem, per_sm)
                   : blocks_per_sm<GlobalTables>(p.smem, per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    // where W windows leave SMs idle, a cluster of C blocks a window
    const int sms = sm_count[device].load();
    p.cluster = 1;
    while (p.cluster < kMaxCluster && 2LL * windows * p.cluster <= sms)
        p.cluster *= 2;
    const int clusters = std::max(
        1, std::min(windows, std::max(1, per_sm * sms / p.cluster)));
    p.blocks = clusters * p.cluster;
    return cudaSuccess;
}

template <class Wire>
cudaError_t window_counter(const Wire wire, int windows, int vb, int kb,
                           void* scratch, long long scratch_bytes,
                           int* count, int* overflow, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (windows <= 0 || wire.eb <= 0) return cudaSuccess;
    Plan p;
    if ((err = plan(windows, wire.eb, vb, device, p)) != cudaSuccess)
        return err;
    if ((long long)(p.blocks * p.block_bytes) > scratch_bytes)
        return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p.blocks);
    cfg.blockDim = dim3(kBlock);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    err = p.shared
              ? cudaLaunchKernelEx(&cfg, counter_kernel<Wire, SharedTables>,
                                   wire, windows, vb, kb, sc, p.block_bytes,
                                   count, overflow)
              : cudaLaunchKernelEx(&cfg, counter_kernel<Wire, GlobalTables>,
                                   wire, windows, vb, kb, sc, p.block_bytes,
                                   count, overflow);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// out[0] = 1 for the shared-memory tier, 0 for the L2 tier; out[1] the
// blocks of the grid; out[2] the device scratch in bytes a call of
// `windows` windows of eb slots at vb needs (gs_window_counter's
// `scratch`); out[3] the blocks a window (the cluster).
GS_EXPORT int gs_counter_plan(int windows, int eb, int vb, int device,
                              long long* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Plan p;
    if ((err = plan(std::max(windows, 1), eb, vb, device, p)) != cudaSuccess)
        return err;
    out[0] = p.shared;
    out[1] = p.blocks;
    out[2] = (long long)(p.blocks * p.block_bytes);
    out[3] = p.cluster;
    return cudaSuccess;
}

// count[w], overflow[w] of each of `windows` windows of the [windows, eb]
// stack on the standard wire: one launch on `stream`. scratch holds at
// least the bytes gs_counter_plan gives; nothing needs clearing.
GS_EXPORT int gs_window_counter(const int* src, const int* dst,
                                const bool* valid, int windows, int eb,
                                int vb, int kb, void* scratch,
                                long long scratch_bytes, int* count,
                                int* overflow, int device, void* stream) {
    return window_counter(StandardWire{src, dst, valid, eb}, windows, vb, kb,
                          scratch, scratch_bytes, count, overflow, device,
                          stream);
}

// gs_window_counter on the compact wire: uint16 src16/dst16 [windows, eb]
// and nvalid[windows], slot i of window w padding iff i >= nvalid[w]
// (the decode the JAX package runs with XLA before its counter).
GS_EXPORT int gs_window_counter_compact(const uint16_t* src16,
                                        const uint16_t* dst16,
                                        const int* nvalid, int windows,
                                        int eb, int vb, int kb,
                                        void* scratch,
                                        long long scratch_bytes, int* count,
                                        int* overflow, int device,
                                        void* stream) {
    return window_counter(CompactWire{src16, dst16, nvalid, eb}, windows, vb,
                          kb, scratch, scratch_bytes, count, overflow,
                          device, stream);
}
