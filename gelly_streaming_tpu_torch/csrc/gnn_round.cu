// One GCN message-passing round per window, written by hand for Hopper
// (sm_90a): the windowed GNN engine's body, folding a [W, eb] chunk into
// a [vb+1, F] float32 feature slab in device memory.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_gnn_call`
// (:1099-1190). Per window w, in order:
//   (a) scatter: for each valid slot i with ids in [0, vb) and each
//       feature f, m[dst[i], f] += floor(h[src[i], f] * 2^-shift) (no
//       floor when shift is 0), and msg_edges[w] = the valid slots;
//   (b) update, per row r of [0, vb]: p = min(h + min(m, 511), 511),
//       z = p @ W + b, h' = clip(act(z), 0, 511), row vb zeroed; h' is
//       written over h in place unless msg_edges[w] is 0 (the hold rule:
//       an empty window leaves the slab as it is); then max_feat (rows
//       < vb), active_vertices (rows < vb with a feature > 0) and the
//       wrapping int32 feat_checksum over all vb+1 rows, of the slab
//       after the window.
// Invalid slots send nothing: their message would land in row vb, which
// the update zeroes whatever it holds.
//
// Exactness: features and weights lie on an integer lattice
// (ops/gnn_window.py): p is an integer in [0, 511] and W an integer with
// |W| ≤ weight_cap(F) ≤ 512, both exact in fp16 (11 significant bits);
// every product is an integer below 2^18 and every partial sum of p·W,
// in any order and grouping, an integer of magnitude below 2^24, so the
// tensor cores' fp32 sums drop no bit; every aggregate is an integer
// below 2^24, so float atomics in any order are exact too. The round
// gives the JAX package's values bit for bit. bf16 (8 significant bits)
// would round W: it is not used.
//
// What bounds it: bytes. The TPU kernel held the slab in VMEM; here it
// does not fit a block, so the round is two launches, the launch
// boundary the barrier between every gather of (a) and the in-place
// writes of (b): (b) reads and writes only its own rows. Each window
// the update reads the fp32 slab and writes it back: at the benchmark's
// F = 256 and vb = 262,144 that is 536.9 MB, 0.160 ms at 3.35 TB/s, and
// at vb = 4,194,304 8.59 GB, 2.564 ms. Its product, 2(vb+1)F², is 34.4
// and 550 GFLOP, 0.035 and 0.556 ms at the fp16 tensor-core rate: about
// 64 operations a byte, against the card's 295. The aggregate m is a
// [vb+1, F] scratch, owned by the caller across calls; (a) marks each
// row it sends to in a uint8 [vb+1] scratch, and (b) reads and zeroes m
// only in marked rows and clears the marks, so both are cleared once per
// call and the update does not stream the whole of m twice a window.
//
// (b) streams the slab through a ring in shared memory, so that the
// loads of the next rows are in flight while the rows before them are
// multiplied and written back. One persistent block a SM (min(tiles,
// SMs) blocks) walks the slab's 64-row tiles, each in four 16-row
// chunks, a chunk a ring stage, with three warpgroups:
//   - the producer group: three fix warps take the block's tiles in turn
//     ahead of the copies and add min(m, 511) in place to the rows of h
//     that (a) marked, zero those rows of m and clear the marks (each
//     lane keeps eight loads in flight; a marked row's h is then read
//     again from L2); a copy warp has the copy engine bring each fixed
//     tile's rows into the ring (`cp.async.bulk`, one copy a slot of
//     contiguous rows: a tile where the ring holds two, else a chunk;
//     `cp.async` of 4 bytes a lane where F is not a multiple of 4), so
//     the ring's depth is in flight and no register waits for it;
//   - two consumer groups take the tiles in turn: each warp builds its 16
//     rows of p = min(·, 511) as fp16 in registers from its stage and
//     frees the stage at once, then the group multiplies the tile by W
//     with `wgmma.m64n64k16` (A from registers, B from shared memory, W
//     read once per 64 rows; k steps over the 64-column chunks F needs)
//     in 64-column passes; the epilogue adds b, clips (after |z| for
//     abs), zeroes row vb, gathers max / active / checksum, and writes h
//     in place through a small staging area in shared memory, four whole
//     128-byte lines a store.
// W's fp16 image (K-major, 128-byte swizzled rows, zero-padded to 64
// columns and to the k chunks F needs) is made once per call into a
// scratch the library sizes (gs_gnn_w_image_bytes) and copied whole into
// each block's shared memory by the copy engine, where it stays for the
// launch. The ring is as deep as F's shared memory leaves room for (4
// stages at F = 256, where W takes 128 KB; 8 at F ≤ 192); mbarriers pass
// each slot from copy to consumer and back, and a counter a fix warp
// passes each tile from fix to copy; the consumer groups take their
// chunks in the walk's order, so no parity wait runs two phases ahead.
// Each row belongs to one chunk and each chunk to one block, so the
// in-place writes race with nothing. Any F in [1, 256] is taken, k and n
// padded with zeros. All windows of a chunk run on the caller's stream
// with no host synchronisation.
#include "common.cuh"

#include <cuda_fp16.h>

#include <atomic>
#include <climits>

namespace {

constexpr float kCap = 511.0f;
constexpr int kMaxF = 256;
constexpr int kMaxDevices = 64;

// The update's plan: 64-row tiles (one wgmma M) in 16-row chunks (a
// warp's rows of the product), k in 128-byte rows of 64 halves, n in
// passes of 64 columns; three warpgroups a block.
constexpr int kTileRows = 64;
constexpr int kChunkRows = 16;
constexpr int kChunks = kTileRows / kChunkRows;
constexpr int kChunkK = 64;
constexpr int kRowBytes = 128;
constexpr int kNPass = 64;
constexpr int kMaxKChunks = kMaxF / kChunkK;
constexpr int kGroup = 128;                      // threads a warpgroup
constexpr int kUpdateThreads = 3 * kGroup;
constexpr int kUpdateWarps = kUpdateThreads / kWarp;
constexpr int kFixWarps = kGroup / kWarp - 1;    // producer warps less one
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;               // a block's shared memory, opted in
constexpr int kAlign = 1024;                     // the swizzle's atom
constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);  // the ring's and W's
constexpr int kTail = 4 * kMaxF + kBarBytes + 4 * kFixWarps + 12 * kUpdateWarps;
                                                 // b, bars, tiles fixed, sums
constexpr int kFixLoads = 8;                     // loads of h, of m a fix lane
constexpr int kWPiece = 16384;                   // bytes a copy of W's image
constexpr int kOutCols = 32;                     // columns a store of the epilogue
constexpr int kOutStride = kOutCols + 8;         // floats a staged output row
constexpr int kOutBytes = 8 * kChunkRows * kOutStride * 4;   // 8 consumer warps

struct Plan {
    int np;           // n padded to kNPass
    int kc;           // k padded to kChunkK, in chunks of kChunkK
    int sf;           // floats a staged row: F padded to 4
    int stages;
    int group;        // chunks a copy: a tile's where the ring holds two
    int w_bytes;      // W as fp16, [kc][np][64]
    int stage_bytes;  // a chunk, [kChunkRows][sf] fp32
    int smem;
};

__host__ __device__ constexpr Plan plan_for(int F) {
    const int np = (F + kNPass - 1) / kNPass * kNPass;
    const int kc = (F + kChunkK - 1) / kChunkK;
    const int sf = (F + 3) / 4 * 4;
    const int w = np * kRowBytes * kc;
    const int st = kChunkRows * sf * 4;
    int stages = (kSmemLimit - kAlign - kTail - kOutBytes - w) / st;
    if (stages > kMaxStages) stages = kMaxStages;
    const int group = stages >= 2 * kChunks ? kChunks : 1;
    return Plan{np, kc, sf, stages, group, w, st,
                kAlign + w + stages * st + kOutBytes + kTail};
}

constexpr int max_smem() {
    int most = 0;
    for (int F = 1; F <= kMaxF; ++F) {
        const Plan p = plan_for(F);
        if (p.stages < kChunks || p.smem > kSmemLimit) return -1;
        if (p.smem > most) most = p.smem;
    }
    return most;
}
// a tile's four chunks fit the ring together at every width
static_assert(max_smem() > 0, "W and a ring of a tile's chunks fit every F");

// sums is int32 [4, windows]: max_feat, active, checksum, msg_edges.
__global__ void init_sums_kernel(int* sums, int windows) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= windows) return;
    sums[w] = INT_MIN;
    sums[windows + w] = 0;
    sums[2 * windows + w] = 0;
    sums[3 * windows + w] = 0;
}

// (a): one thread per (slot, feature) of the window; the slot's thread
// of feature 0 marks its destination row in `touched`.
__global__ void __launch_bounds__(kThreads) scatter_kernel(
        const float* __restrict__ h, const int* __restrict__ src,
        const int* __restrict__ dst, const bool* __restrict__ valid,
        int eb, int vb, int F, int shift, float* __restrict__ m,
        unsigned char* __restrict__ touched, int* __restrict__ nmsg) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long total = (long long)eb * F;
    int counts = 0;
    if (t < total) {
        const int i = (int)(t / F);
        const int f = (int)(t - (long long)i * F);
        if (valid[i]) {
            counts = f == 0;
            const int s = src[i], d = dst[i];
            if (s >= 0 && s < vb && d >= 0 && d < vb) {
                float msg = h[(long long)s * F + f];
                if (shift) msg = floorf(ldexpf(msg, -shift));
                atomicAdd(m + (long long)d * F + f, msg);
                if (f == 0) touched[d] = 1;
            }
        }
    }
    const int n = __syncthreads_count(counts);
    if (threadIdx.x == 0 && n) atomicAdd(nmsg, n);
}

__device__ __forceinline__ int warp_max(int x) {
    for (int o = kWarp / 2; o > 0; o /= 2)
        x = max(x, __shfl_xor_sync(kFullMask, x, o));
    return x;
}

__device__ __forceinline__ unsigned warp_sum(unsigned x) {
    for (int o = kWarp / 2; o > 0; o /= 2)
        x += __shfl_xor_sync(kFullMask, x, o);
    return x;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) of a K-major fp16 operand of `rows` rows
// in 128-byte swizzled rows: k in chunks of 64, each chunk `rows` rows
// of 128 bytes, the 16-byte pieces of row r XOR-ed with r mod 8.
__device__ __forceinline__ int swizzled(int rows, int r, int k) {
    return (k / kChunkK) * rows * kRowBytes + r * kRowBytes
        + ((((k % kChunkK) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2;
}

// A shared-memory matrix descriptor for that layout: 8-row groups 1024
// bytes apart, 128-byte swizzle.
__device__ __forceinline__ unsigned long long wgmma_desc(unsigned addr) {
    return (unsigned long long)((addr & 0x3FFFF) >> 4)
        | (1ull << 16)                                  // unused when swizzled
        | ((unsigned long long)(1024 >> 4) << 32)
        | (1ull << 62);                                 // 128-byte swizzle
}

// the ring's barriers, 8 bytes each: per slot of `group` stages "full"
// (its chunks' copies landed) and "empty" (read), and one for W's image
__device__ __forceinline__ unsigned full_bar(unsigned bars, int s) {
    return bars + 8 * s;
}

__device__ __forceinline__ unsigned empty_bar(unsigned bars, int s) {
    return bars + 8 * (kMaxStages + s);
}

__device__ __forceinline__ unsigned w_bar(unsigned bars) {
    return bars + 8 * 2 * kMaxStages;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
    asm volatile("{\n\t.reg .b64 st;\n\t"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n"
                 :: "r"(bar) : "memory");
}

// returns once the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                     "selp.u32 %0, 1, 0, p;\n\t}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void copy4(unsigned dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(dst), "l"(src) : "memory");
}

// one arrival that also expects `bytes` more of bulk copies
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("{\n\t.reg .b64 st;\n\t"
                 "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory by the copy engine, counted on the barrier as they land
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// an arrival on the barrier once this thread's copies so far have landed
__device__ __forceinline__ void copies_arrive(unsigned bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
    asm volatile("st.release.cta.shared.u32 [%0], %1;\n"
                 :: "r"(smem_addr(p)), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
                 : "=r"(v) : "r"(smem_addr(p)) : "memory");
    return v;
}

__device__ __forceinline__ void group_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void group_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from touching registers an asynchronous wgmma reads
// (A's fragments) or writes (the accumulators) before it has completed
template <int N>
__device__ __forceinline__ void fence_a(unsigned* a) {
#pragma unroll
    for (int i = 0; i < N; ++i)
        asm volatile("" : "+r"(a[i]) :: "memory");
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
    for (int i = 0; i < kNPass / 2; ++i)
        asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 × 64 fp32, the warpgroup's fragments) += A (64 × 16 fp16, the
// fragments a) · B (16 × 64 fp16, K-major in shared memory)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const unsigned* a,
                                                unsigned long long b) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "setp.ne.b32 p, %37, 0;\n\t"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n\t}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// p = min(x, 511) for the two columns k, k+1 as fp16, 0 past F
__device__ __forceinline__ unsigned pack_p(float2 x, int k, int F) {
    const __half2 v = __floats2half2_rn(k < F ? fminf(x.x, kCap) : 0.0f,
                                        k + 1 < F ? fminf(x.y, kCap) : 0.0f);
    return *reinterpret_cast<const unsigned*>(&v);
}

struct Summary {
    int mx = INT_MIN;
    int active = 0;
    unsigned csum = 0;
};

// The block's walk: chunk j of the block is rows r0 .. r0+15 of tile
// blockIdx.x + (j / 4)·gridDim.x, r0 = that tile's first row + 16 (j mod 4).
// A ring slot holds `group` chunks, in `group` stages in a row.
struct Walk {
    int vb, F;
    __device__ int chunks() const {
        const int tiles = (vb + kTileRows) / kTileRows;
        return kChunks * ((tiles - (int)blockIdx.x + (int)gridDim.x - 1)
                          / (int)gridDim.x);
    }
    __device__ int row0(int j) const {
        return ((int)blockIdx.x + j / kChunks * (int)gridDim.x) * kTileRows
            + j % kChunks * kChunkRows;
    }
};

// The producer's copy warp: each chunk's rows of h into its stage, once
// the fix warps have fixed its tile (where F is not a multiple of 4, by
// 4-byte copies of every lane).
__device__ __forceinline__ void copy_chunks(
        const float* __restrict__ h, const Walk& wk, bool vec,
        const Plan& pl, unsigned ring, unsigned bars, const unsigned* done) {
    const int t = threadIdx.x;                   // a lane of warp 0
    const int F = wk.F, n = wk.chunks();
    // where the copy engine takes a slot in one copy, lane 0 alone
    // waits and copies: no lane waits on a barrier it could fall behind
    if (vec && t > 0) return;
    for (int j = 0; j < n; j += pl.group) {
        const int s = j % pl.stages, slot = s / pl.group, tile = j / kChunks;
        // the tile's marked rows fixed (by fix warp tile mod kFixWarps)
        if (j % kChunks == 0)
            while (load_acquire(done + tile % kFixWarps)
                   <= unsigned(tile / kFixWarps)) {}
        mbar_wait(empty_bar(bars, slot), ((j / pl.stages) & 1) ^ 1);
        const unsigned st = ring + s * pl.stage_bytes;
        const float* src = h + (long long)wk.row0(j) * F;
        // the slot's rows: contiguous in h, and in the ring
        const int rows = max(0, min(pl.group * kChunkRows,
                                    wk.vb + 1 - wk.row0(j)));
        if (vec) {
            mbar_expect(full_bar(bars, slot), 4u * rows * F);
            if (rows) bulk_load(st, src, 4u * rows * F, full_bar(bars, slot));
        } else {
            for (int e = t; e < rows * F; e += kWarp) {
                const int r = e / F, k = e - r * F;
                copy4(st + 4 * (r * pl.sf + k), src + e);
            }
            copies_arrive(full_bar(bars, slot));
        }
    }
}

// Position of the n-th (from 0) set bit of x, n < popc(x): a binary
// search over the counts of the low halves.
__device__ __forceinline__ int nth_bit(unsigned long long x, int n) {
    int pos = 0;
#pragma unroll
    for (int w = 32; w > 0; w /= 2) {
        const int c = __popcll((x >> pos) & ((1ull << w) - 1));
        if (n >= c) {
            n -= c;
            pos += w;
        }
    }
    return pos;
}

// The producer's fix warps (f = 0 .. kFixWarps-1) take the block's tiles
// in turn (f, f + kFixWarps, ...) ahead of the copies: min(m, 511) added
// in place to the tile's rows of h that (a) marked, those rows of m
// zeroed, the marks cleared; then done[f], the warp's tiles fixed,
// releases the tile to the copy warp (a marked row's h is read again
// there, from L2). Each lane keeps kFixLoads loads of h and of m in
// flight; a warp reads its next tile's marks as it starts a tile.
__device__ __forceinline__ void fix_tiles(
        float* __restrict__ h, float* __restrict__ m,
        unsigned char* __restrict__ touched, const Walk& wk, bool vec,
        unsigned* done) {
    const int lane = threadIdx.x % kWarp;
    const int f = threadIdx.x / kWarp - 1;
    const int F = wk.F, tiles = wk.chunks() / kChunks;
    const int q = vec ? 4 : 1, per_row = F / q;   // floats, pieces a row
    // a tile's row r (of 64) read from the marks and cleared
    auto mark = [&](int tile, int r) -> int {
        const int row = wk.row0(kChunks * tile) + r;
        if (tile >= tiles || row > wk.vb) return 0;
        const int hit = touched[row];
        touched[row] = 0;
        return hit;
    };
    int lo = mark(f, lane), hi = mark(f, lane + kWarp);
    for (int tl = f, n = 1; tl < tiles; tl += kFixWarps, ++n) {
        const unsigned long long marked =
            __ballot_sync(kFullMask, lo != 0)
            | static_cast<unsigned long long>(
                  __ballot_sync(kFullMask, hi != 0)) << 32;
        lo = mark(tl + kFixWarps, lane);
        hi = mark(tl + kFixWarps, lane + kWarp);
        const long long base = (long long)wk.row0(kChunks * tl) * F;
        float* ht = h + base;
        float* mt = m + base;
        const int pieces = __popcll(marked) * per_row;
        for (int e0 = lane; e0 < pieces; e0 += kFixLoads * kWarp) {
            // the loads first, then the sums and the stores
            int at[kFixLoads];              // floats from the tile's start
            float4 hv[kFixLoads], mv[kFixLoads];
#pragma unroll
            for (int u = 0; u < kFixLoads; ++u) {
                const int e = e0 + kWarp * u, slot = e / per_row;
                at[u] = -1;
                if (e < pieces) {
                    at[u] = nth_bit(marked, slot) * F
                        + q * (e - slot * per_row);
                    if (vec) {
                        hv[u] = __ldcg(
                            reinterpret_cast<const float4*>(ht + at[u]));
                        mv[u] = __ldcg(
                            reinterpret_cast<const float4*>(mt + at[u]));
                    } else {
                        hv[u].x = __ldcg(ht + at[u]);
                        mv[u].x = __ldcg(mt + at[u]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kFixLoads; ++u) {
                if (at[u] < 0) continue;
                if (vec) {
                    float4 v = hv[u];
                    v.x += fminf(mv[u].x, kCap);
                    v.y += fminf(mv[u].y, kCap);
                    v.z += fminf(mv[u].z, kCap);
                    v.w += fminf(mv[u].w, kCap);
                    *reinterpret_cast<float4*>(ht + at[u]) = v;
                    *reinterpret_cast<float4*>(mt + at[u]) =
                        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                } else {
                    ht[at[u]] = hv[u].x + fminf(mv[u].x, kCap);
                    mt[at[u]] = 0.0f;
                }
            }
        }
        // the writes before the copy engine's reads, then the release
        asm volatile("fence.proxy.async;\n" ::: "memory");
        __syncwarp();
        if (lane == 0) store_release(done + f, n);
    }
}

// A consumer group (g = 0, 1): the block's tiles g, g+2, ... Warp wq of
// the group builds rows 16·wq .. 16·wq+15 of the tile (chunk wq) as the
// product's A, then the group multiplies and writes the tile in place.
// KC is k's chunks of 64 (the plan's kc): the product takes 4·KC k
// steps, so a narrow slab issues no wgmma over W's absent rows.
template <int KC>
__device__ __forceinline__ void consume(
        int g, float* __restrict__ h, const float* bs, const Walk& wk,
        int act, bool vec, const Plan& pl, const float* ring, float* staging,
        unsigned w_addr, unsigned bars, Summary& sm) {
    const int t = threadIdx.x % kGroup, lane = t % kWarp, wq = t / kWarp;
    const int gid = lane / 4, tig = lane % 4;
    const int F = wk.F, vb = wk.vb;
    constexpr int kSteps = 4 * KC;
    const int ksteps = (F + 15) / 16, passes = pl.np / kNPass;
    const int tiles = wk.chunks() / kChunks;
    // the warp's staging
    float* out = staging + (4 * g + wq) * kChunkRows * kOutStride;
    const unsigned long long b_desc = wgmma_desc(w_addr);
    for (int tl = g; tl < tiles; tl += 2) {
        // the groups take their tiles' chunks in the walk's order: a
        // stage's barriers are then awaited one phase at a time, never
        // two phases ahead (which a parity wait would take for done)
        if (tl > 0) group_sync(2 + g, 2 * kGroup);
        const int j = kChunks * tl + wq;
        const int s = j % pl.stages, slot = s / pl.group;
        // the chunk's rows landed
        mbar_wait(full_bar(bars, slot), (j / pl.stages) & 1);
        // A's fragments: rows gid, gid+8 of the chunk × columns 16·ks +
        // 2·tig (+1) and + 8 (+1), for every k step
        const float* x0 = ring + s * (pl.stage_bytes / 4) + gid * pl.sf
            + 2 * tig;
        const float* x1 = x0 + 8 * pl.sf;
        unsigned a[4 * kSteps];
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
            if (ks < ksteps) {
                const int k = 16 * ks + 2 * tig;
                a[4 * ks] = pack_p(
                    *reinterpret_cast<const float2*>(x0 + 16 * ks), k, F);
                a[4 * ks + 1] = pack_p(
                    *reinterpret_cast<const float2*>(x1 + 16 * ks), k, F);
                a[4 * ks + 2] = pack_p(
                    *reinterpret_cast<const float2*>(x0 + 16 * ks + 8),
                    k + 8, F);
                a[4 * ks + 3] = pack_p(
                    *reinterpret_cast<const float2*>(x1 + 16 * ks + 8),
                    k + 8, F);
            } else {
                a[4 * ks] = a[4 * ks + 1] = a[4 * ks + 2] = a[4 * ks + 3] = 0;
            }
        }
        // the stage is read: the copy warp may refill it, and the other
        // group may take the next tile
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar(bars, slot));
        if (tl + 1 < tiles) group_arrive(3 - g, 2 * kGroup);

        const int r0 = wk.row0(kChunks * tl);
        const int ra = r0 + 16 * wq + gid, rb = ra + 8;
        // per tile: the thread's sum of h' (exact in fp32: at most 128
        // values of 511) and its two rows' largest value
        float tsum = 0.0f, top_a = 0.0f, top_b = 0.0f;
        for (int pass = 0; pass < passes; ++pass) {
            // 64 columns a pass
            float d[kNPass / 2];
#pragma unroll
            for (int x = 0; x < kNPass / 2; ++x) d[x] = 0.0f;
            // A and the accumulators written before the products start
            fence_a<4 * kSteps>(a);
            fence_acc(d);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < kSteps; ++ks) {
                // W's rows 64·pass .., k step ks (descriptor in 16
                // bytes); every k step of the plan's chunks, past F too
                // (zeros), so the products issue back to back
                wgmma_m64n64k16(
                    d, a + 4 * ks,
                    b_desc + (((ks / 4) * pl.np * kRowBytes
                               + pass * kNPass * kRowBytes + (ks % 4) * 32)
                              >> 4));
            }
            wgmma_commit();
            wgmma_wait_all();
            fence_acc(d);
            fence_a<4 * kSteps>(a);
            // the epilogue in stores of 32 columns: staged in shared
            // memory, then written back a row piece a lane (four whole
            // lines a store); direct stores where F is not a multiple of 4
#pragma unroll
            for (int hp = 0; hp < kNPass / kOutCols; ++hp) {
                const int c0 = pass * kNPass + hp * kOutCols;
                if (c0 >= F) break;
#pragma unroll
                for (int jq = 0; jq < kOutCols / 8; ++jq) {
                    // fragment jn: rows ra, rb × columns c, c+1
                    const int jn = hp * (kOutCols / 8) + jq;
                    const int c = c0 + 8 * jq + 2 * tig;
                    if (c >= F) continue;
                    const bool c1 = c + 1 < F;
                    // b from shared memory: L1 is what shared memory
                    // leaves, and the streams evict it
                    const float2 bb = *reinterpret_cast<const float2*>(bs + c);
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = half ? rb : ra;
                        if (row > vb) continue;
                        // relu and identity are the clip alone
                        float z0 = d[4 * jn + 2 * half] + bb.x;
                        float z1 = d[4 * jn + 2 * half + 1] + bb.y;
                        if (act == 1) {
                            z0 = fabsf(z0);
                            z1 = fabsf(z1);
                        }
                        float v0 = fminf(fmaxf(z0, 0.0f), kCap);
                        float v1 = c1 ? fminf(fmaxf(z1, 0.0f), kCap) : 0.0f;
                        if (row == vb) v0 = v1 = 0.0f;
                        if (vec) {
                            *reinterpret_cast<float2*>(
                                out + (gid + 8 * half) * kOutStride + 8 * jq
                                + 2 * tig) = make_float2(v0, v1);
                        } else {
                            float* dst = h + (long long)row * F + c;
                            dst[0] = v0;
                            if (c1) dst[1] = v1;
                        }
                        tsum += v0 + v1;
                        if (half) top_b = fmaxf(top_b, fmaxf(v0, v1));
                        else top_a = fmaxf(top_a, fmaxf(v0, v1));
                    }
                }
                if (vec) {
                    __syncwarp();
#pragma unroll
                    for (int i = 0; i < kChunkRows * kOutCols / 4 / kWarp; ++i) {
                        // lane (row, float4): 4 rows × 128 bytes a store
                        const int rr = 4 * i + lane / 8, q = lane % 8;
                        const int row = r0 + 16 * wq + rr;
                        const float4 v = *reinterpret_cast<const float4*>(
                            out + rr * kOutStride + 4 * q);
                        if (row <= vb && c0 + 4 * q < F)
                            *reinterpret_cast<float4*>(
                                h + (long long)row * F + c0 + 4 * q) = v;
                    }
                    __syncwarp();
                }
            }
        }
        // the checksum wraps; max_feat and active cover rows below vb
        // (row vb is zero, so it moves neither); a row is active when
        // its largest value, over the four lanes that hold it, is above 0
        sm.csum += (unsigned)tsum;
        for (int o = 1; o < 4; o *= 2) {
            top_a = fmaxf(top_a, __shfl_xor_sync(kFullMask, top_a, o));
            top_b = fmaxf(top_b, __shfl_xor_sync(kFullMask, top_b, o));
        }
        if (ra <= vb) sm.mx = max(sm.mx, (int)top_a);
        if (rb <= vb) sm.mx = max(sm.mx, (int)top_b);
        if (tig == 0) sm.active += (top_a > 0.0f) + (top_b > 0.0f);
    }
}

// W as fp16, n-major with k contiguous (B of the product), zero past F,
// in the shared-memory image the update blocks copy whole: [kc][np][64]
// in 128-byte swizzled rows, a thread a (n, k pair), coalesced over n.
__global__ void w_image_kernel(const float* __restrict__ W, int F, int np,
                               int kc, unsigned char* __restrict__ img) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= np * kc * kChunkK / 2) return;
    const int k = 2 * (e / np), n = e % np;
    const float w0 = (k < F && n < F) ? W[k * F + n] : 0.0f;
    const float w1 = (k + 1 < F && n < F) ? W[(k + 1) * F + n] : 0.0f;
    *reinterpret_cast<__half2*>(img + swizzled(np, n, k)) =
        __floats2half2_rn(w0, w1);
}

// (b): persistent blocks of three warpgroups over the slab's 64-row
// tiles, the block's tiles blockIdx.x, + gridDim.x, ...
__global__ void __launch_bounds__(kUpdateThreads, 1) update_kernel(
        float* __restrict__ h, const float* __restrict__ b, int vb, int F,
        int act, float* __restrict__ m, unsigned char* __restrict__ touched,
        const unsigned char* __restrict__ wimg, int* __restrict__ sums,
        int w, int windows) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    const Plan pl = plan_for(F);
    const unsigned raw = smem_addr(smem_raw);
    unsigned char* Ws = smem_raw + (((raw + kAlign - 1) & ~(kAlign - 1)) - raw);
    unsigned char* ring = Ws + pl.w_bytes;
    float* staging = reinterpret_cast<float*>(ring + pl.stages * pl.stage_bytes);
    unsigned char* tail = reinterpret_cast<unsigned char*>(staging) + kOutBytes;
    float* bs = reinterpret_cast<float*>(tail);          // b, zero past F
    const unsigned bars = smem_addr(tail + 4 * kMaxF);
    unsigned* done = reinterpret_cast<unsigned*>(tail + 4 * kMaxF + kBarBytes);
    int* part_max = reinterpret_cast<int*>(done + kFixWarps);
    unsigned* part_sum = reinterpret_cast<unsigned*>(part_max + kUpdateWarps);
    int* part_act = reinterpret_cast<int*>(part_sum + kUpdateWarps);

    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    // uniform in every warp, as the compiler can see: the role of the
    // warp's group and whether the window is held
    const int group = __shfl_sync(kFullMask, tid / kGroup, 0);
    const bool held = __shfl_sync(kFullMask, sums[3 * windows + w], 0) == 0;
    const bool vec = F % 4 == 0
        && ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(m))
            & 15) == 0;
    const Walk wk{vb, F};
    Summary sm;

    if (held) {
        // the slab stays; only its summaries are read, a warp a row
        const int step = gridDim.x * kUpdateWarps;
        for (int row = blockIdx.x * kUpdateWarps + warp; row <= vb;
             row += step) {
            const float* hr = h + (long long)row * F;
            bool any = false;
            const int n = vec ? F / 4 : F;
            for (int q = lane; q < n; q += kWarp) {
                float v[4];
                if (vec) {
                    const float4 x = reinterpret_cast<const float4*>(hr)[q];
                    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
                } else {
                    v[0] = hr[q];
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    if (e > 0 && !vec) break;
                    const int iv = (int)v[e];
                    sm.csum += (unsigned)iv;
                    if (row < vb) {
                        sm.mx = max(sm.mx, iv);
                        any |= v[e] > 0.0f;
                    }
                }
            }
            if (__any_sync(kFullMask, any) && lane == 0) ++sm.active;
        }
    } else {
        if (tid == 0) {
            for (int s = 0; s < pl.stages / pl.group; ++s) {
                // the bulk copy's one arrival, or every copy lane's
                mbar_init(full_bar(bars, s), vec ? 1 : kWarp);
                // the consumer warps of the slot's chunks
                mbar_init(empty_bar(bars, s), pl.group);
            }
            mbar_init(w_bar(bars), 1);
            for (int f = 0; f < kFixWarps; ++f) done[f] = 0;
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
        if (group == 0) {
            if (tid < kWarp) {
                // W's image first, by the copy engine, 16 KB a copy
                if (tid == 0) {
                    mbar_expect(w_bar(bars), pl.w_bytes);
                    for (int o = 0; o < pl.w_bytes; o += kWPiece)
                        bulk_load(smem_addr(Ws) + o, wimg + o,
                                  min(kWPiece, pl.w_bytes - o), w_bar(bars));
                }
                copy_chunks(h, wk, vec, pl, smem_addr(ring), bars, done);
            } else {
                fix_tiles(h, m, touched, wk, vec, done);
            }
        } else {
            const int ct = tid - kGroup;
            for (int n = ct; n < kMaxF; n += 2 * kGroup)
                bs[n] = n < F ? b[n] : 0.0f;
            group_sync(1, 2 * kGroup);
            // W's image landed
            mbar_wait(w_bar(bars), 0);
            const float* rf = reinterpret_cast<const float*>(ring);
            const unsigned wa = smem_addr(Ws);
            static_assert(kMaxKChunks == 4, "one case a k chunk count");
            switch (pl.kc) {
            case 1:
                consume<1>(group - 1, h, bs, wk, act, vec, pl, rf, staging,
                           wa, bars, sm);
                break;
            case 2:
                consume<2>(group - 1, h, bs, wk, act, vec, pl, rf, staging,
                           wa, bars, sm);
                break;
            case 3:
                consume<3>(group - 1, h, bs, wk, act, vec, pl, rf, staging,
                           wa, bars, sm);
                break;
            default:
                consume<4>(group - 1, h, bs, wk, act, vec, pl, rf, staging,
                           wa, bars, sm);
            }
        }
    }

    // block reduction, then one atomic per summary
    int mx = warp_max(sm.mx);
    unsigned csum = warp_sum(sm.csum);
    int active = (int)warp_sum((unsigned)sm.active);
    if (lane == 0) {
        part_max[warp] = mx;
        part_sum[warp] = csum;
        part_act[warp] = active;
    }
    __syncthreads();
    if (tid == 0) {
        for (int i = 1; i < kUpdateWarps; ++i) {
            mx = max(mx, part_max[i]);
            csum += part_sum[i];
            active += part_act[i];
        }
        if (mx != INT_MIN) atomicMax(sums + w, mx);
        if (active) atomicAdd(sums + windows + w, active);
        if (csum) atomicAdd(reinterpret_cast<unsigned*>(sums + 2 * windows + w),
                            csum);
    }
}

// Per device: the update kernel's dynamic shared memory raised once to
// what the largest plan needs, and the SM count.
std::atomic<int> sm_count[kMaxDevices];

cudaError_t prepare(int device) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (sm_count[device].load()) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem());
    int n = 0;
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err == cudaSuccess) sm_count[device].store(n);
    return err;
}

}  // namespace

// Folds `windows` windows of the [windows, eb] stack, in order, into the
// slab h [vb+1, F] float32 (in place) with the layer W [F, F], b [F] and
// activation `act` (0 relu, 1 abs, 2 identity), messages shifted right
// by `shift`; writes sums int32 [4, windows] (max_feat, active_vertices,
// feat_checksum, msg_edges). m is a float32 [vb+1, F] scratch and
// touched a uint8 [vb+1] one, both zeroed first and left zero; wimg a
// scratch of gs_gnn_w_image_bytes(F) bytes for W's fp16 image, written
// first.
GS_EXPORT int gs_gnn_rounds(float* h, const float* W, const float* b,
                            const int* src, const int* dst,
                            const bool* valid, int windows, int eb, int vb,
                            int F, int act, int shift, float* m,
                            unsigned char* touched, unsigned char* wimg,
                            int* sums, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (F < 1 || F > kMaxF || shift < 0 || shift > 24)
        return cudaErrorInvalidValue;
    if ((err = prepare(device)) != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // one persistent update block a SM, or a tile each where fewer
    const int tiles = (vb + kTileRows) / kTileRows;
    const int sms = sm_count[device].load();
    const unsigned update_blocks = (unsigned)(tiles < sms ? tiles : sms);
    const size_t slab = sizeof(float) * (size_t)(vb + 1) * F;
    err = cudaMemsetAsync(m, 0, slab, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(touched, 0, vb + 1, s);
    if (err != cudaSuccess) return err;
    init_sums_kernel<<<(windows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        sums, windows);
    const Plan pl = plan_for(F);
    const int pairs_w = pl.np * pl.kc * kChunkK / 2;
    w_image_kernel<<<(pairs_w + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        W, F, pl.np, pl.kc, wimg);
    const long long pairs = (long long)eb * F;
    const unsigned scatter_blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
    const int smem = pl.smem;
    for (int w = 0; w < windows; ++w) {
        const long long off = (long long)w * eb;
        scatter_kernel<<<scatter_blocks, kThreads, 0, s>>>(
            h, src + off, dst + off, valid + off, eb, vb, F, shift, m,
            touched, sums + 3 * windows + w);
        update_kernel<<<update_blocks, kUpdateThreads, smem, s>>>(
            h, b, vb, F, act, m, touched, wimg, sums, w, windows);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}

// The bytes of the W image scratch that gs_gnn_rounds takes at width F.
GS_EXPORT int gs_gnn_w_image_bytes(int F, int* bytes) {
    if (F < 1 || F > kMaxF) return cudaErrorInvalidValue;
    *bytes = plan_for(F).w_bytes;
    return cudaSuccess;
}
