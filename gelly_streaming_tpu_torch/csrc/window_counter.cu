// Triangle-only window counter, written by hand for Hopper (sm_90a):
// everything of a window up to its neighbor table.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_counter_call`
// (:748-792) with its `_tri_stage` (:448-485). For each window of a
// [W, eb] edge stack: clean (drop padding and self-loops) -> degrees of
// the multigraph -> orient low(deg, id) -> high(deg, id) -> dedupe ->
// each distinct edge's column in its source row -> scatter into a
// [vb+1, kb] neighbor table, with overflow = Σ_v max(0, outdeg_v - kb)
// over distinct oriented out-degrees. The last stage, the row
// intersection, is the intersect kernel (csrc/intersect.cu), which the
// Python wrapper launches on the tables built here.
//
// Both kernels read the stack through a wire reader (common.cuh): the
// standard wire (int32 ids, bool valid) or the compact one (uint16 ids,
// one valid count per window; gs_window_tables_compact). The JAX package
// widened the compact wire to int32 before its counter
// (compact_ingress.py:81-93); here each slot is decoded where it is
// loaded, so the compact form reads 4 bytes a slot and makes no widened
// stack.
//
// The TPU kernel deduplicated with one lexicographic sort in VMEM. One
// window's 32768 (a, b) pairs as 8-byte keys are 256 KB, more than the
// 227 KB of shared memory a block may hold, so this design is free of
// order instead: a hash set of packed (a, b) keys per window in device
// memory, whose first insert marks the distinct edge. That edge then
// takes its column with pos = atomicAdd(&outdeg[a], 1) and is written to
// nbr[a][pos] when pos < kb, else counted as overflow. The overflow is
// exactly the sort's; the rows come out in no particular order, which
// the intersect kernel allows. (When overflow > 0 the count of the
// truncated rows is not the sort's; callers then recount at a larger K,
// as with the TPU kernel.)
//
// What bounds it: atomics, not bytes. Per edge: two degree increments,
// one compare-and-swap (more on a collision), one out-degree increment;
// the input slab is 9 bytes per slot (compact: 4, plus 4 per window) and
// is read twice. Increments on a
// hub vertex serialize in L2 (a Zipf window of 32768 edges gives its top
// vertex ~8.4K). The design keeps the rest small: two launches over an
// [eb/256, W] grid (orienting needs every degree of the window, so a
// launch boundary is the barrier), appends to the distinct-edge list and
// the overflow count aggregated per warp, and nothing cleared that is not
// read: table rows are read only up to their out-degree, so the
// [W, vb+1, kb] table is never filled.
#include "common.cuh"

namespace {

constexpr unsigned long long kEmpty = ~0ULL;

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

// A slot holds an edge: valid, not a self-loop, both ids in [0, vb).
__device__ __forceinline__ bool edge_ok(bool v, int s, int d, int vb) {
    return v && s != d && s >= 0 && s < vb && d >= 0 && d < vb;
}

// grid (x: edge blocks, y: windows)
template <class Wire>
__global__ void __launch_bounds__(kThreads) degree_kernel(
        const Wire wire, int vb, int* __restrict__ deg) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= wire.eb) return;
    int s, d;
    const bool v = wire.read(blockIdx.y, i, s, d);
    if (!edge_ok(v, s, d, vb)) return;
    int* dg = deg + (long long)blockIdx.y * (vb + 1);
    atomicAdd(dg + s, 1);
    atomicAdd(dg + d, 1);
}

// grid (x: edge blocks, y: windows). Orients each edge, keeps its first
// occurrence, places it in its source row and appends it to the window's
// distinct-edge list (edge_a, edge_b)[0:nedges[w]].
template <class Wire>
__global__ void __launch_bounds__(kThreads) insert_kernel(
        const Wire wire, int vb, int kb,
        const int* __restrict__ deg, int* __restrict__ outdeg,
        int* __restrict__ table, unsigned long long* __restrict__ hash,
        int hash_slots, int* __restrict__ edge_a,
        int* __restrict__ edge_b, int* __restrict__ nedges,
        int* __restrict__ overflow) {
    const int w = blockIdx.y;
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = threadIdx.x % kWarp;
    const long long vrow = (long long)w * (vb + 1);
    int a = 0, b = 0;
    bool fresh = false;
    const int eb = wire.eb;
    if (i < eb) {
        int s, d;
        const bool v = wire.read(w, i, s, d);
        if (edge_ok(v, s, d, vb)) {
            const int lo = min(s, d), hi = max(s, d);
            const int dlo = deg[vrow + lo], dhi = deg[vrow + hi];
            // the tie-break of triangles.orient_by_degree
            const bool swap = dlo > dhi || (dlo == dhi && lo > hi);
            a = swap ? hi : lo;
            b = swap ? lo : hi;
            const unsigned long long key =
                ((unsigned long long)(unsigned)a << 32) | (unsigned)b;
            unsigned long long* set = hash + (long long)w * hash_slots;
            unsigned h = (unsigned)mix64(key) & (unsigned)(hash_slots - 1);
            while (true) {  // linear probing; the set is at most half full
                const unsigned long long prev = atomicCAS(set + h, kEmpty, key);
                if (prev == kEmpty) {
                    fresh = true;
                    break;
                }
                if (prev == key) break;
                h = (h + 1) & (unsigned)(hash_slots - 1);
            }
        }
    }
    bool over = false;
    if (fresh) {
        const int pos = atomicAdd(outdeg + vrow + a, 1);
        if (pos < kb)
            table[(vrow + a) * kb + pos] = b;
        else
            over = true;
    }
    // one atomic per warp for the list, one for the overflow count
    const unsigned fresh_mask = __ballot_sync(kFullMask, fresh);
    if (fresh_mask) {
        const int leader = __ffs(fresh_mask) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(nedges + w, __popc(fresh_mask));
        base = __shfl_sync(kFullMask, base, leader);
        if (fresh) {
            const long long j = (long long)w * eb + base +
                                __popc(fresh_mask & ((1u << lane) - 1u));
            edge_a[j] = a;
            edge_b[j] = b;
        }
    }
    const unsigned over_mask = __ballot_sync(kFullMask, over);
    if (over_mask && lane == 0) atomicAdd(overflow + w, __popc(over_mask));
}

// Clears the scratch of `windows` windows and launches the two kernels
// on the stack `wire` carries.
template <class Wire>
cudaError_t window_tables(const Wire wire, int windows, int vb, int kb,
                          int* deg, int* outdeg, int* table,
                          unsigned long long* hash, int hash_slots,
                          int* edge_a, int* edge_b, int* nedges,
                          int* overflow, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t cells = (size_t)windows * (size_t)(vb + 1);
    if ((err = cudaMemsetAsync(deg, 0, sizeof(int) * cells, s))) return err;
    if ((err = cudaMemsetAsync(outdeg, 0, sizeof(int) * cells, s))) return err;
    if ((err = cudaMemsetAsync(hash, 0xff,
                               sizeof(unsigned long long) * (size_t)windows *
                                   (size_t)hash_slots, s)))
        return err;
    if ((err = cudaMemsetAsync(nedges, 0, sizeof(int) * (size_t)windows, s)))
        return err;
    if ((err = cudaMemsetAsync(overflow, 0, sizeof(int) * (size_t)windows, s)))
        return err;
    if (windows > 0 && wire.eb > 0) {
        dim3 grid((wire.eb + kThreads - 1) / kThreads, windows);
        degree_kernel<<<grid, kThreads, 0, s>>>(wire, vb, deg);
        insert_kernel<<<grid, kThreads, 0, s>>>(
            wire, vb, kb, deg, outdeg, table, hash, hash_slots, edge_a,
            edge_b, nedges, overflow);
    }
    return cudaGetLastError();
}

}  // namespace

// Builds, for each of `windows` windows of the [windows, eb] stack, its
// out-degrees outdeg[w][vb+1], the rows table[w][vb+1][kb] (valid up to
// min(outdeg, kb)), the distinct oriented edges edge_a/edge_b[w][0:
// nedges[w]] and overflow[w]. deg and hash are scratch; hash_slots is a
// power of two ≥ 2·eb. The stack is on the standard wire.
GS_EXPORT int gs_window_tables(const int* src, const int* dst,
                               const bool* valid, int windows, int eb,
                               int vb, int kb, int* deg, int* outdeg,
                               int* table, unsigned long long* hash,
                               int hash_slots, int* edge_a, int* edge_b,
                               int* nedges, int* overflow, int device,
                               void* stream) {
    return window_tables(StandardWire{src, dst, valid, eb}, windows, vb, kb,
                         deg, outdeg, table, hash, hash_slots, edge_a,
                         edge_b, nedges, overflow, device, stream);
}

// gs_window_tables on the compact wire: uint16 src16/dst16 [windows, eb]
// and nvalid[windows], slot i of window w padding iff i >= nvalid[w]
// (the decode the JAX package runs with XLA before its counter).
GS_EXPORT int gs_window_tables_compact(const uint16_t* src16,
                                       const uint16_t* dst16,
                                       const int* nvalid, int windows,
                                       int eb, int vb, int kb, int* deg,
                                       int* outdeg, int* table,
                                       unsigned long long* hash,
                                       int hash_slots, int* edge_a,
                                       int* edge_b, int* nedges,
                                       int* overflow, int device,
                                       void* stream) {
    return window_tables(CompactWire{src16, dst16, nvalid, eb}, windows, vb,
                         kb, deg, outdeg, table, hash, hash_slots, edge_a,
                         edge_b, nedges, overflow, device, stream);
}
