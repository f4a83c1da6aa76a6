// Per-(window, vertex) monoid reduce and contribution count, written by
// hand for Hopper (sm_90a): the device tier of the columnar windowed
// reduce and of the neighborhood API's named-monoid reduce.
//
// Stands in for XLA segment programs of the JAX package, which have no
// Pallas kernel: gelly_streaming_tpu/ops/windowed_reduce.py `_stack_fn`
// (:317), `_stack_fn_compact` (:341) with the delta tail `_delta_tail`
// (:307), and the segment reduces of ops/neighborhood.py (:169, :380)
// through ops/segment.py `segment_reduce` (:51). For a stack of `wb`
// windows it emits cells[wb, vbp], the sum, min or max of the values of
// each window's contributions at vertex v, and counts[wb, vbp] (int32),
// how many there were. A cell nothing reached holds the XLA empty-segment
// identity: 0 for sum, INT_MAX / INT_MIN or +inf / -inf for min / max.
//
// Two wires:
//   standard  int32 cell ids [rep, wb, eb] (w·vbp + v, or any id outside
//             window w's range [w·vbp, (w+1)·vbp), such as the trash id
//             wb·vbp, for padding) and values of the same shape: the
//             flattened ids _stack_fn takes (rep = 2 for direction "all",
//             whose values repeat);
//   compact   uint16 src and dst [wb, eb], one int32 count of valid slots
//             a window (padding is the suffix) and values [wb, eb]; the
//             direction picks src ("out"), dst ("in") or both ("all"),
//             decoded at the one load of each slot.
// and two egress forms: the full rows, or the touched-cell wire of
// ops/delta_egress.py, (cnt[wb], idx[wb, cap] ascending, cells[wb, cap],
// counts[wb, cap]), slots past cnt holding cell 0's entry; the full rows
// are then never written to device memory.
//
// Design. A window takes a cluster of C blocks (C = 1, 2, 4 or 8) that
// split its vertex range: block r owns vertices [(k·C + r)·span, +span)
// in pass k, their cells and counts in shared memory. Every block reads
// its window's contributions and folds those in its range with shared-memory
// atomics (float min and max by one integer atomic on the value's bits,
// see Monoid), then writes its part of the row once, 16 bytes a store
// (the row sits in shared memory at the 16-byte phase of its place in
// the output): no memset, no global atomics. A window of fewer than
// kRingMinBytes is read with plain loads, each thread loading four
// slots before it folds them. A larger one streams through a ring of
// 2-4 stages of 48 KB beside the row: one warp of the block copies each
// tile of the window's slots into a stage with one TMA bulk copy an
// array (ids and values of each direction, 16-byte aligned runs),
// completing on the stage's `full` mbarrier, and the 31 other warps fold
// from it and release it on its `empty` mbarrier; slots before the
// window's first 16-byte aligned slot, the tail past a multiple of 8
// slots and windows with no common alignment take plain loads. C is the
// least that holds a row in one pass (beside a two-stage ring where the
// window streams), doubled while the windows leave SMs idle; rows past 8
// blocks take more passes, the window read again each pass. The delta
// wire's ascending order comes from a block scan of the touched cells
// and the cluster's per-block totals, stored into each block's shared
// memory and signalled on an mbarrier.
//
// Measured on an H100 and dropped (utils/reduce_probe.py, PERF.md): one
// multicast copy of each tile into every block of the cluster (the
// cluster's signals cost more than the reads it saved), combining the
// lanes of a warp on one cell before the atomic (__match_any_sync, or
// the first lane's cell: slower on the Zipf and uniform streams),
// merging a thread's contributions on one cell, and a grid of as many
// clusters as the card runs at once, each walking the windows (no faster
// on the Zipf stream, 1.7x slower on a hub chunk).
//
// Float sums: shared-memory atomics add in an order that changes from
// run to run, so a float32 sum is exact only up to reordering (the port
// holds it to 1e-5 · Σ|v| a cell); integer monoids and float min/max are
// bit-equal to the plain version. Integer sums wrap modulo 2^32, as
// XLA's int32 segment_sum does.
//
// What bounds it: bytes. Each input once and the full rows once: at 64
// windows of eb = 8192, vb = 16384 (out), 12.6 MB, 3.8 us at 3.35 TB/s,
// of which an H100 reaches about half; at 64 windows of eb = 32768,
// vb = 65536 (all), 67.1 MB, 20.0 us, about a third, the four blocks of
// each cluster reading the whole window (utils/reduce_probe.py, PERF.md
// row R).
//
// A probe build (utils/reduce_probe.py --elements) moves the window size
// from which the ring streams: -DGS_CELL_RING_MIN_BYTES=N.
#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

#ifndef GS_CELL_RING_MIN_BYTES
#define GS_CELL_RING_MIN_BYTES 262144
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kFoldWarps = 31;
constexpr int kFolders = kFoldWarps * kWarp;   // threads that fold
constexpr int kBlock = kFolders + kWarp;       // and one warp that copies
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;
constexpr int kSpreadMin = 2048;   // vertices a block keeps at least
constexpr int kStageBytes = 49152;
constexpr int kMinStages = 2, kMaxStages = 4;
// windows of fewer bytes are read with plain loads
constexpr long long kRingMinBytes = GS_CELL_RING_MIN_BYTES;
constexpr int kSlotAlign = 8;      // a tile's slots: 16 bytes of uint16
constexpr int kMaxArrays = 4;
constexpr int kOpSum = 0, kOpMin = 1, kOpMax = 2;
constexpr int kDirIn = 1, kDirAll = 2;   // 0 is "out"

}  // namespace

// Outputs of one call (a host struct, passed by pointer and copied into
// the kernel's parameters): the full rows, or with `cnt` set the delta
// wire of `cap` slots a window.
struct CellOut {
    void* cells;       // [wb, vbp] value dtype
    int* counts;       // [wb, vbp]
    int* cnt;          // [wb]
    int* idx;          // [wb, cap]
    void* dcells;      // [wb, cap] value dtype
    int* dcounts;      // [wb, cap]
    int cap;
};

namespace {

// ---- mbarriers and bulk copies (PTX) --------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     smem_u32(bar)),
                 "r"(count)
                 : "memory");
}

// Arrive on `bar` expecting `bytes` more of copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// Wait for the phase of `parity` to complete: the copies into this
// block's stage (TMA's complete_tx orders them). A wait that outlasts
// kStallPolls polls (seconds; a phase takes microseconds) traps: the
// launch fails, and the wrapper raises, instead of the card hanging.
constexpr unsigned kStallPolls = 1u << 24;

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
    unsigned done;
    for (unsigned polls = 0;; ++polls) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (polls == kStallPolls) __trap();
    }
}

// The same, acquiring what the blocks that arrived released to the
// cluster (bar_publish_at).
__device__ __forceinline__ void bar_wait_cluster(uint64_t* bar, int parity) {
    unsigned done;
    for (unsigned polls = 0;; ++polls) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(smem_u32(bar)), "r"(parity)
            : "memory");
        if (done) return;
        if (polls == kStallPolls) __trap();
    }
}

// Arrive on `bar` of block `rank` of the cluster (this block's own too),
// releasing this thread's writes to the cluster's shared memory (the
// delta wire's totals) to the block that waits on `bar`.
__device__ __forceinline__ void bar_publish_at(uint64_t* bar, int rank) {
    asm volatile(
        "{\n.reg .b32 a;\n"
        "mapa.shared::cluster.u32 a, %0, %1;\n"
        "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [a];\n}" ::
            "r"(smem_u32(bar)),
        "r"(rank)
        : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this block's `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void folders_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(kFolders) : "memory");
}

// ---- the monoids ----------------------------------------------------

__device__ __forceinline__ float f_inf() { return __int_as_float(0x7f800000); }

template <class T, int Op>
struct Monoid;

template <>
struct Monoid<int, kOpSum> {
    static __device__ __forceinline__ int identity() { return 0; }
    static __device__ __forceinline__ void fold(int* a, int v) {
        atomicAdd(a, v);
    }
};
template <>
struct Monoid<int, kOpMin> {
    static __device__ __forceinline__ int identity() { return 0x7fffffff; }
    static __device__ __forceinline__ void fold(int* a, int v) {
        atomicMin(a, v);
    }
};
template <>
struct Monoid<int, kOpMax> {
    static __device__ __forceinline__ int identity() {
        return (int)0x80000000;
    }
    static __device__ __forceinline__ void fold(int* a, int v) {
        atomicMax(a, v);
    }
};
template <>
struct Monoid<float, kOpSum> {
    static __device__ __forceinline__ float identity() { return 0.f; }
    static __device__ __forceinline__ void fold(float* a, float v) {
        atomicAdd(a, v);
    }
};
// float min / max by one integer atomic on the value's bits: among
// floats whose sign bit is clear the bits order as signed ints do, among
// those whose sign bit is set in reverse as unsigned ints, and every
// set-sign pattern is below every clear one as an int and above it as an
// unsigned. So a value with a clear sign takes atomicMin (atomicMax) on
// the int, one with a set sign atomicMax (atomicMin) on the unsigned,
// and the cell ends at the smallest (largest) value whatever the order
// (NaN aside; of +0 and -0 it keeps either).
template <>
struct Monoid<float, kOpMin> {
    static __device__ __forceinline__ float identity() { return f_inf(); }
    static __device__ __forceinline__ void fold(float* a, float v) {
        const int b = __float_as_int(v);
        if (b >= 0)
            atomicMin(reinterpret_cast<int*>(a), b);
        else
            atomicMax(reinterpret_cast<unsigned*>(a), (unsigned)b);
    }
};
template <>
struct Monoid<float, kOpMax> {
    static __device__ __forceinline__ float identity() { return -f_inf(); }
    static __device__ __forceinline__ void fold(float* a, float v) {
        const int b = __float_as_int(v);
        if (b >= 0)
            atomicMax(reinterpret_cast<int*>(a), b);
        else
            atomicMin(reinterpret_cast<unsigned*>(a), (unsigned)b);
    }
};

// ---- the wires ------------------------------------------------------

// Up to four arrays of a window's slots: the window's in device memory
// or a tile's in shared memory. Picked by ternaries, so the pointers stay
// in registers.
struct View {
    const char* p[kMaxArrays];
    __device__ __forceinline__ const char* operator()(int a) const {
        return a == 0 ? p[0] : a == 1 ? p[1] : a == 2 ? p[2] : p[3];
    }
};

// A window's slots as up to four arrays (`arrays()`, element sizes
// `esize(a)`, window w's slot 0 at `base(w, a)`); slot i carries
// `per_slot()` contributions: contribution r of slot i, read from the
// View p, has the cell `cell(p, i, r)` and the value `value(p, i, r)`.
// A block folds those whose cell less its `key(w, lo)` falls in [0, n),
// its n vertices from lo: the standard wire's cell is the id itself
// (w·vbp + v: any id outside the window's range, such as padding's,
// falls outside every block's), the compact wire's the vertex.
template <class T>
struct StandardCells {
    const int* ids;
    const T* vals;
    long long plane;   // wb·eb: one direction's ids
    int eb, vbp, rep;

    __device__ __forceinline__ int per_slot() const { return rep; }
    __device__ __forceinline__ int arrays() const { return 2 * rep; }
    __device__ __forceinline__ int esize(int) const { return 4; }
    __device__ __forceinline__ int slots(int) const { return eb; }
    // arrays 2r and 2r + 1: the ids and values of direction r
    __device__ __forceinline__ const char* base(int w, int a) const {
        const long long off = (a >> 1) * plane + (long long)w * eb;
        return (a & 1) ? reinterpret_cast<const char*>(vals + off)
                       : reinterpret_cast<const char*>(ids + off);
    }
    // w·vbp + lo < wb·vbp < 2^31, so the difference of 32-bit ids is
    // exact: an id below the range wraps past any n
    __device__ __forceinline__ unsigned key(int w, int lo) const {
        return (unsigned)(w * vbp + lo);
    }
    __device__ __forceinline__ unsigned cell(const View& p, int i,
                                             int r) const {
        return (unsigned)reinterpret_cast<const int*>(p(2 * r))[i];
    }
    __device__ __forceinline__ T value(const View& p, int i, int r) const {
        return reinterpret_cast<const T*>(p(2 * r + 1))[i];
    }
};

template <class T>
struct CompactCells {
    const uint16_t* src;
    const uint16_t* dst;
    const int* nvalid;
    const T* vals;
    int eb, vbp, dir;

    __device__ __forceinline__ int per_slot() const {
        return dir == kDirAll ? 2 : 1;
    }
    __device__ __forceinline__ int arrays() const { return per_slot() + 1; }
    __device__ __forceinline__ int esize(int a) const {
        return a < per_slot() ? 2 : 4;
    }
    // padding is each window's suffix past its valid count
    __device__ __forceinline__ int slots(int w) const {
        return min(max(nvalid[w], 0), eb);
    }
    // the ids of each direction (src for "out", dst for "in", both for
    // "all"), then the values
    __device__ __forceinline__ const char* base(int w, int a) const {
        const long long off = (long long)w * eb;
        if (a == per_slot()) return reinterpret_cast<const char*>(vals + off);
        return reinterpret_cast<const char*>(
            ((dir == kDirIn || a == 1) ? dst : src) + off);
    }
    // ids at or past vbp fall outside every block's range
    __device__ __forceinline__ unsigned key(int, int lo) const {
        return (unsigned)lo;
    }
    __device__ __forceinline__ unsigned cell(const View& p, int i,
                                             int r) const {
        return reinterpret_cast<const uint16_t*>(p(r))[i];
    }
    __device__ __forceinline__ T value(const View& p, int i, int) const {
        return reinterpret_cast<const T*>(p(per_slot()))[i];
    }
};

template <class Wire>
__device__ __forceinline__ View window_view(const Wire& wire, int w) {
    View v;
#pragma unroll
    for (int a = 0; a < kMaxArrays; ++a)
        v.p[a] = a < wire.arrays() ? wire.base(w, a) : nullptr;
    return v;
}

// A stage's tile of `tile` slots: array a at tile · (the bytes a slot of
// the arrays before it).
template <class Wire>
__device__ __forceinline__ View stage_view(const Wire& wire,
                                           const unsigned char* stage,
                                           int tile) {
    View v;
    int off = 0;
#pragma unroll
    for (int a = 0; a < kMaxArrays; ++a) {
        v.p[a] = reinterpret_cast<const char*>(stage + off);
        if (a < wire.arrays()) off += tile * wire.esize(a);
    }
    return v;
}

// Where a window's slots go: [h, end) in tiles of `tile` slots through
// the ring (every array 16-byte aligned at slot h, end - h a multiple of
// kSlotAlign), the rest ([0, h) and [end, n)) by plain loads; a window
// with no common alignment has h = end = n.
struct Geometry {
    int n, h, end, tiles;
};

template <class Wire>
__device__ __forceinline__ Geometry geometry(const Wire& wire, int w,
                                             int tile) {
    Geometry g;
    g.n = wire.slots(w);
    g.h = g.n;
    g.end = g.n;
    g.tiles = 0;
    if (!tile) return g;   // no ring: every slot by plain loads
    for (int h = 0; h < kSlotAlign && h < g.n; ++h) {
        bool ok = true;
        for (int a = 0; a < wire.arrays(); ++a)
            ok = ok && ((reinterpret_cast<uintptr_t>(wire.base(w, a)) +
                         (uintptr_t)h * wire.esize(a)) & 15) == 0;
        if (ok) {
            g.h = h;
            break;
        }
    }
    g.end = g.h + (g.n - g.h) / kSlotAlign * kSlotAlign;
    g.tiles = (g.end - g.h + tile - 1) / tile;
    return g;
}

// ---- the fold -------------------------------------------------------

// The block's folds of slots [0, len) of the View p (slot i at
// slot_of(i)): each thread loads kUnroll slots' contributions before it
// folds them, so its loads overlap (shared-memory atomics between them
// would order them otherwise).
constexpr int kUnroll = 4;

template <class M, class Wire, class T, class Slot>
__device__ __forceinline__ void fold_slots(const Wire& wire, const View& p,
                                           int len, Slot slot_of,
                                           unsigned key, unsigned n,
                                           T* cells, int* counts) {
    for (int i0 = threadIdx.x; i0 < len; i0 += kUnroll * kFolders) {
        unsigned u[kUnroll][2];
        T x[kUnroll][2];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
            const int i = i0 + j * kFolders;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                u[j][r] = n;
                if (i < len && r < wire.per_slot()) {
                    u[j][r] = wire.cell(p, slot_of(i), r) - key;
                    x[j][r] = wire.value(p, slot_of(i), r);
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
                if (u[j][r] < n) {
                    M::fold(&cells[u[j][r]], x[j][r]);
                    atomicAdd(&counts[u[j][r]], 1);
                }
    }
}

struct SameSlot {
    __device__ __forceinline__ int operator()(int i) const { return i; }
};

// the loose slots of a window: [0, h), then [end, n)
struct LooseSlot {
    int h, end;
    __device__ __forceinline__ int operator()(int j) const {
        return j < h ? j : end + (j - h);
    }
};

// Inclusive sum of x over the folding threads in thread order.
__device__ __forceinline__ int fold_inclusive_scan(int x, int* part) {
    const int lane = threadIdx.x & (kWarp - 1), wid = threadIdx.x / kWarp;
    for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) part[wid] = x;
    folders_sync();
    if (wid == 0) {
        int t = lane < kFoldWarps ? part[lane] : 0;
        for (int o = 1; o < kWarp; o <<= 1) {
            const int y = __shfl_up_sync(kFullMask, t, o);
            if (lane >= o) t += y;
        }
        if (lane < kFoldWarps) part[lane] = t;
    }
    folders_sync();
    return x + (wid ? part[wid - 1] : 0);
}

// The byte offset of p past a 16-byte boundary.
__device__ __forceinline__ int phase16(const void* p) {
    return (int)(reinterpret_cast<uintptr_t>(p) & 15);
}

// n 4-byte words from shared memory to dst, 16 bytes a store between a
// scalar head and tail; src sits at dst's 16-byte phase.
template <class T>
__device__ __forceinline__ void store_row(T* dst, const T* src, int n) {
    const int tid = threadIdx.x;
    const int head = min(n, ((16 - phase16(dst)) & 15) / 4);
    for (int i = tid; i < head; i += kFolders) dst[i] = src[i];
    const int body = (n - head) >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src + head);
    int4* d4 = reinterpret_cast<int4*>(dst + head);
    for (int i = tid; i < body; i += kFolders) d4[i] = s4[i];
    for (int i = head + 4 * body + tid; i < n; i += kFolders)
        dst[i] = src[i];
}

template <class Wire, class T, int Op>
__global__ void __launch_bounds__(kBlock)
    cell_reduce_kernel(Wire wire, int vbp, int span, int passes,
                       int stages, int tile, CellOut out) {
    using M = Monoid<T, Op>;
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ uint64_t full[kMaxStages], empty[kMaxStages], totals_bar[2];
    __shared__ int totals[2][kMaxCluster];
    __shared__ int part[kFoldWarps];
    __shared__ int block_total;
    __shared__ T pad_cell;
    __shared__ int pad_count;

    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int w = blockIdx.x / C;
    const int tid = threadIdx.x;
    // the blocks of a cluster talk only through the delta wire's totals
    const bool delta = out.cnt != nullptr;

    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], kFoldWarps);
        }
        bar_init(&totals_bar[0], C);
        bar_init(&totals_bar[1], C);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    if (delta)
        cluster.sync();   // every block's barriers before any remote use
    else
        __syncthreads();

    if (tid >= kFolders) {
        // the copier: tile g of the window's passes goes to stage g % S
        // once the warps that fold released the stage's previous tile
        if (tid == kFolders) {
            int slot_bytes = 0;
            for (int a = 0; a < wire.arrays(); ++a)
                slot_bytes += wire.esize(a);
            const Geometry geo = geometry(wire, w, tile);
            const View src = window_view(wire, w);
            int g = 0;
            for (int k = 0; k < passes; ++k) {
                for (int q = 0; q < geo.tiles; ++q, ++g) {
                    const int s = g % stages, round = g / stages;
                    const int first = geo.h + q * tile;
                    const int len = min(tile, geo.end - first);
                    if (round) bar_wait(&empty[s], (round - 1) & 1);
                    bar_expect(&full[s], (unsigned)(slot_bytes * len));
                    const View dst = stage_view(
                        wire, smem + (size_t)s * kStageBytes, tile);
#pragma unroll
                    for (int a = 0; a < kMaxArrays; ++a)
                        if (a < wire.arrays())
                            bulk_copy(const_cast<char*>(dst.p[a]),
                                      src.p[a] +
                                          (size_t)first * wire.esize(a),
                                      (unsigned)(len * wire.esize(a)),
                                      &full[s]);
                }
            }
        }
        __syncwarp();
    } else {
        const int lane = tid & (kWarp - 1);
        const int cap = out.cap;
        unsigned char* rows = smem + (size_t)stages * kStageBytes;
        const size_t row_bytes = ((size_t)span * 4 + 31) & ~(size_t)15;
        int g = 0, seq = 0;
        const Geometry geo = geometry(wire, w, tile);
        const View window = window_view(wire, w);
        const int loose = geo.h + geo.n - geo.end;
        int base = 0;   // touched cells of this window in earlier passes
        for (int k = 0; k < passes; ++k) {
            const int lo = (int)min((long long)(k * C + rank) * span,
                                    (long long)vbp);
            const int n = min(span, vbp - lo);
            const long long row = (long long)w * vbp + lo;
            // the row at the 16-byte phase of its place in the output
            const int pc =
                delta ? 0 : phase16(static_cast<T*>(out.cells) + row);
            const int pn = delta ? 0 : phase16(out.counts + row);
            T* cells = reinterpret_cast<T*>(rows + pc);
            int* counts = reinterpret_cast<int*>(rows + row_bytes + pn);
            for (int i = tid; i < n; i += kFolders) {
                cells[i] = M::identity();
                counts[i] = 0;
            }
            folders_sync();
            const unsigned key = wire.key(w, lo);
            if (n > 0)
                fold_slots<M>(wire, window, loose,
                              LooseSlot{geo.h, geo.end}, key, n, cells,
                              counts);
            for (int q = 0; q < geo.tiles; ++q, ++g) {
                const int s = g % stages;
                const int len = min(tile, geo.end - (geo.h + q * tile));
                bar_wait(&full[s], (g / stages) & 1);
                if (n > 0) {
                    const View p = stage_view(
                        wire, smem + (size_t)s * kStageBytes, tile);
                    fold_slots<M>(wire, p, len, SameSlot{}, key, n, cells,
                                  counts);
                }
                __syncwarp();
                if (lane == 0) bar_arrive(&empty[s]);
            }
            folders_sync();
            if (!delta) {
                store_row(static_cast<T*>(out.cells) + row, cells, n);
                store_row(out.counts + row, counts, n);
                folders_sync();   // before the next pass clears the row
                continue;
            }
            if (k == 0 && rank == 0 && tid == 0) {   // vertex 0: padding
                pad_cell = cells[0];
                pad_count = counts[0];
            }
            // each thread a run of the block's vertices, in order
            const int per = (n + kFolders - 1) / kFolders;
            const int a = min(n, tid * per), b = min(n, a + per);
            int mine = 0;
            for (int i = a; i < b; ++i) mine += counts[i] > 0;
            const int incl = fold_inclusive_scan(mine, part);
            if (tid == kFolders - 1) block_total = incl;
            folders_sync();
            // every block's total into every block's totals[seq & 1],
            // then one arrive on each block's totals_bar[seq & 1]: a
            // block arrives for seq + 2 only after every block arrived
            // everywhere for seq + 1, so no phase takes another's
            if (tid == 0) {
                for (int r = 0; r < C; ++r)
                    *cluster.map_shared_rank(&totals[seq & 1][rank], r) =
                        block_total;
                for (int r = 0; r < C; ++r)
                    bar_publish_at(&totals_bar[seq & 1], r);
            }
            bar_wait_cluster(&totals_bar[seq & 1], (seq >> 1) & 1);
            int before = base, all = 0;
            for (int r = 0; r < C; ++r) {
                const int t = totals[seq & 1][r];
                if (r < rank) before += t;
                all += t;
            }
            ++seq;
            int pos = before + incl - mine;
            int* irow = out.idx + (long long)w * cap;
            T* vrow = static_cast<T*>(out.dcells) + (long long)w * cap;
            int* nrow = out.dcounts + (long long)w * cap;
            for (int i = a; i < b; ++i) {
                if (counts[i] > 0) {
                    if (pos < cap) {
                        irow[pos] = lo + i;
                        vrow[pos] = cells[i];
                        nrow[pos] = counts[i];
                    }
                    ++pos;
                }
            }
            base += all;
            folders_sync();   // the row is read before the next clear
        }
        if (delta && rank == 0) {
            if (tid == 0) out.cnt[w] = base;
            int* irow = out.idx + (long long)w * cap;
            T* vrow = static_cast<T*>(out.dcells) + (long long)w * cap;
            int* nrow = out.dcounts + (long long)w * cap;
            for (int p = base + tid; p < cap; p += kFolders) {
                irow[p] = 0;
                vrow[p] = pad_cell;
                nrow[p] = pad_count;
            }
        }
    }
    // no block leaves while another may still write to its totals
    if (delta) cluster.sync();
}

// A call's launch shape: C blocks a window, `span` vertices a block a
// pass, `passes` passes, a ring of `stages` stages beside the row.
struct Plan {
    int cluster, span, passes, stages;
    size_t smem;
};

// The shared memory of a plan: the ring, then the cells and the counts,
// each span words and up to 12 bytes to set its 16-byte phase.
size_t plan_smem(int span, int stages) {
    return (size_t)stages * kStageBytes +
           2 * (((size_t)span * 4 + 31) & ~(size_t)15);
}

template <class Wire, class T, int Op>
cudaError_t raise_one(int room) {
    return cudaFuncSetAttribute(cell_reduce_kernel<Wire, T, Op>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                room);
}

template <class T>
cudaError_t raise_type(int room) {
    cudaError_t err;
    if ((err = raise_one<StandardCells<T>, T, kOpSum>(room))) return err;
    if ((err = raise_one<StandardCells<T>, T, kOpMin>(room))) return err;
    if ((err = raise_one<StandardCells<T>, T, kOpMax>(room))) return err;
    if ((err = raise_one<CompactCells<T>, T, kOpSum>(room))) return err;
    if ((err = raise_one<CompactCells<T>, T, kOpMin>(room))) return err;
    return raise_one<CompactCells<T>, T, kOpMax>(room);
}

std::atomic<int> sm_count[kMaxDevices], smem_room[kMaxDevices];

cudaError_t plan(int wb, long long window_bytes, int vbp, int device,
                 Plan& p) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    cudaError_t err;
    if (!sm_count[device].load()) {
        int n = 0, optin = 0;
        cudaFuncAttributes attr;
        if ((err = cudaDeviceGetAttribute(
                 &n, cudaDevAttrMultiProcessorCount, device)) ||
            (err = cudaDeviceGetAttribute(
                 &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                 device)) ||
            (err = cudaFuncGetAttributes(
                 &attr, cell_reduce_kernel<StandardCells<float>, float,
                                           kOpSum>)))
            return err;
        // the static shared memory (barriers, the scan's parts, the pad
        // entry) is the same in every instantiation, to a few bytes:
        // keep 64 spare
        const int room = optin - (int)attr.sharedSizeBytes - 64;
        if ((err = raise_type<int>(room)) || (err = raise_type<float>(room)))
            return err;
        smem_room[device].store(room);
        sm_count[device].store(n);
    }
    const int sms = sm_count[device].load();
    const int room = smem_room[device].load();
    const bool ring = window_bytes >= kRingMinBytes;
    const int max_span =
        ((room - (ring ? kMinStages * kStageBytes : 0) - 64) / 8) & ~31;
    p.cluster = 1;
    while (p.cluster < kMaxCluster && (long long)max_span * p.cluster < vbp)
        p.cluster *= 2;
    // where the windows leave SMs idle, split each row further
    while (p.cluster < kMaxCluster && 2LL * wb * p.cluster <= sms &&
           (vbp + 2 * p.cluster - 1) / (2 * p.cluster) >= kSpreadMin)
        p.cluster *= 2;
    p.span = std::max(1, std::min(max_span,
                                  (vbp + p.cluster - 1) / p.cluster));
    const long long per_pass = (long long)p.cluster * p.span;
    p.passes = (int)((vbp + per_pass - 1) / per_pass);
    p.stages = ring ? kMaxStages : 0;
    while (plan_smem(p.span, p.stages) > (size_t)room) --p.stages;
    p.smem = plan_smem(p.span, p.stages);
    return cudaSuccess;
}

template <class Wire, class T, int Op>
cudaError_t launch_op(const Wire& wire, int wb, int vbp, int slot_bytes,
                      const Plan& p, const CellOut& out, void* stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(wb * p.cluster);
    cfg.blockDim = dim3(kBlock);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = p.cluster;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    // a tile: the slots of one stage, a multiple of kSlotAlign
    const int tile =
        p.stages ? kStageBytes / slot_bytes / kSlotAlign * kSlotAlign : 0;
    cudaError_t err =
        cudaLaunchKernelEx(&cfg, cell_reduce_kernel<Wire, T, Op>, wire, vbp,
                           p.span, p.passes, p.stages, tile, out);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <class Wire, class T>
cudaError_t launch(const Wire& wire, int wb, int eb, int vbp,
                   int slot_bytes, int op, const CellOut* out, int device,
                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) {
        cudaGetLastError();   // the next call reports its own errors only
        return err;
    }
    if (wb <= 0 || vbp <= 0) return cudaSuccess;
    if (out->cnt && out->cap <= 0) return cudaErrorInvalidValue;
    Plan p;
    if ((err = plan(wb, (long long)eb * slot_bytes, vbp, device, p)) !=
        cudaSuccess)
        return err;
    switch (op) {
        case kOpSum:
            return launch_op<Wire, T, kOpSum>(wire, wb, vbp, slot_bytes, p,
                                              *out, stream);
        case kOpMin:
            return launch_op<Wire, T, kOpMin>(wire, wb, vbp, slot_bytes, p,
                                              *out, stream);
        case kOpMax:
            return launch_op<Wire, T, kOpMax>(wire, wb, vbp, slot_bytes, p,
                                              *out, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// A call of wb windows of eb slots of slot_bytes bytes (8 a direction on
// the standard wire, 6 or 8 on the compact one) at vbp cells: out[0] the
// blocks a window (the cluster), out[1] the vertices a block holds a
// pass, out[2] the passes, out[3] the ring's stages (0: the window is
// read with plain loads), out[4] the bytes a stage, out[5] the clusters
// launched (one a window), out[6] the SMs and out[7] the shared memory a
// block may use beside the kernel's static part.
GS_EXPORT int gs_cell_reduce_plan(int wb, int eb, int slot_bytes, int vbp,
                                  int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    wb = std::max(wb, 1);
    Plan p;
    if ((err = plan(wb, (long long)eb * slot_bytes, std::max(vbp, 1), device,
                    p)) != cudaSuccess)
        return err;
    out[0] = p.cluster;
    out[1] = p.span;
    out[2] = p.passes;
    out[3] = p.stages;
    out[4] = kStageBytes;
    out[5] = wb;
    out[6] = sm_count[device].load();
    out[7] = smem_room[device].load();
    return cudaSuccess;
}

// The standard wire: ids and vals [rep, wb, eb] (vals int32, or float32
// with is_float), op 0 sum, 1 min, 2 max; one launch on `stream`.
GS_EXPORT int gs_cell_reduce(const int* ids, const void* vals, int wb,
                             int eb, int rep, int vbp, int op, int is_float,
                             const CellOut* out, int device, void* stream) {
    const long long plane = (long long)wb * eb;
    if (rep != 1 && rep != 2) return cudaErrorInvalidValue;
    if (is_float)
        return launch<StandardCells<float>, float>(
            StandardCells<float>{ids, static_cast<const float*>(vals), plane,
                                 eb, vbp, rep},
            wb, eb, vbp, 8 * rep, op, out, device, stream);
    return launch<StandardCells<int>, int>(
        StandardCells<int>{ids, static_cast<const int*>(vals), plane, eb,
                           vbp, rep},
        wb, eb, vbp, 8 * rep, op, out, device, stream);
}

// The compact wire: src16, dst16 and vals [wb, eb], nvalid[wb]; direction
// 0 out (src), 1 in (dst), 2 all (both).
GS_EXPORT int gs_cell_reduce_compact(const uint16_t* src16,
                                     const uint16_t* dst16,
                                     const int* nvalid, const void* vals,
                                     int wb, int eb, int direction, int vbp,
                                     int op, int is_float,
                                     const CellOut* out, int device,
                                     void* stream) {
    const int slot_bytes = direction == kDirAll ? 8 : 6;
    if (is_float)
        return launch<CompactCells<float>, float>(
            CompactCells<float>{src16, dst16, nvalid,
                                static_cast<const float*>(vals), eb, vbp,
                                direction},
            wb, eb, vbp, slot_bytes, op, out, device, stream);
    return launch<CompactCells<int>, int>(
        CompactCells<int>{src16, dst16, nvalid,
                          static_cast<const int*>(vals), eb, vbp, direction},
        wb, eb, vbp, slot_bytes, op, out, device, stream);
}
