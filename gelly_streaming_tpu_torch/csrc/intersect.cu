// Per-edge neighbor-row intersection over a padded table, written by
// hand for Hopper (sm_90a): the contract of `intersect_local`.
//
// Replaces gelly_streaming_tpu/ops/pallas_intersect.py `_intersect_tiles`
// (the pallas_call at :116-145; compare loop `tile_intersect_count` :78)
// where a caller holds a [V+1, K] int32 table whose fill is the sentinel
// V: for every valid edge (a, b), the entries of row a below the
// sentinel that occur in row b, summed. (The window counter runs the
// same intersection as its own last stage, on the rows it builds:
// csrc/window_counter.cu.)
//
// Two forms, chosen by the caller:
// - ascending rows (`sorted` = 1: each row strictly ascending, its fill
//   at the end, as triangle_count_sparse builds them): one thread an
//   edge merges the two rows (row_intersect.cuh, the counter's device
//   code), la + lb steps that stop at the first sentinel;
// - rows in any order (`sorted` = 0, the TPU kernel's contract): a group
//   of g lanes an edge, g sized by K (K/4 entries of row a, up to 32
//   lanes); each lane holds up to four entries of row a in registers and
//   reads row b once through L1, comparing each of its entries with all
//   of row b: K²/g compares a lane.
// What bounds it: the dependent loads of the two rows an edge (sorted),
// and the K² compares (any order). A block sums its threads and adds
// once, atomically, into the int32 total.
#include "common.cuh"
#include "row_intersect.cuh"

namespace {

constexpr int kHeld = 4;   // entries of row a a lane holds (any order)

__device__ __forceinline__ void block_add(int acc, int* out) {
    for (int o = kWarp / 2; o; o >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, o);
    __shared__ int partial[kWarpsPerBlock];
    const int warp = threadIdx.x / kWarp;
    if (threadIdx.x % kWarp == 0) partial[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int i = 0; i < kWarpsPerBlock; ++i) sum += partial[i];
        if (sum) atomicAdd(out, sum);
    }
}

__device__ __forceinline__ bool edge_rows(const int* __restrict__ ea,
                                          const int* __restrict__ eb,
                                          const bool* __restrict__ emask,
                                          int e, int rows, int& a, int& b) {
    if (!emask[e]) return false;
    a = ea[e];
    b = eb[e];
    return a >= 0 && a < rows && b >= 0 && b < rows;
}

// ascending rows: one thread an edge
__global__ void __launch_bounds__(kThreads) merge_kernel(
        const int* __restrict__ nbr, int rows, int k, int sentinel,
        const int* __restrict__ ea, const int* __restrict__ eb,
        const bool* __restrict__ emask, int ep, int* __restrict__ out) {
    int acc = 0;
    for (int e = blockIdx.x * kThreads + threadIdx.x; e < ep;
         e += gridDim.x * kThreads) {
        int a, b;
        if (edge_rows(ea, eb, emask, e, rows, a, b))
            acc += merge_count(nbr + (long long)a * k, k,
                               nbr + (long long)b * k, k, sentinel);
    }
    block_add(acc, out);
}

// rows in any order: g lanes an edge
__global__ void __launch_bounds__(kThreads) probe_kernel(
        const int* __restrict__ nbr, int rows, int k, int sentinel,
        const int* __restrict__ ea, const int* __restrict__ eb,
        const bool* __restrict__ emask, int ep, int g,
        int* __restrict__ out) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int gl = t % g, groups = gridDim.x * (kThreads / g);
    int acc = 0;
    for (int e = t / g; e < ep; e += groups) {
        int a, b;
        if (!edge_rows(ea, eb, emask, e, rows, a, b)) continue;
        const int* ra = nbr + (long long)a * k;
        const int* rb = nbr + (long long)b * k;
        for (int ta = 0; ta < k; ta += kHeld * g) {
            int x[kHeld];
            bool hit[kHeld];
#pragma unroll
            for (int q = 0; q < kHeld; ++q) {
                const int i = ta + q * g + gl;
                x[q] = i < k ? ra[i] : sentinel;
                hit[q] = false;
            }
#pragma unroll 4
            for (int m = 0; m < k; ++m) {
                const int y = rb[m];
#pragma unroll
                for (int q = 0; q < kHeld; ++q) hit[q] |= x[q] == y;
            }
#pragma unroll
            for (int q = 0; q < kHeld; ++q) acc += hit[q] && x[q] < sentinel;
        }
    }
    block_add(acc, out);
}

}  // namespace

// out[0] = Σ over edges e with emask[e] of |row ea[e] ∩ row eb[e]| in
// the [rows, k] table nbr, counted over entries of row a below the
// sentinel; rows strictly ascending where `sorted` is 1. out is cleared
// here first: one memset and one launch on `stream`.
GS_EXPORT int gs_intersect(const int* nbr, int rows, int k, int sentinel,
                           const int* ea, const int* eb, const bool* emask,
                           int ep, int sorted, int* out, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(out, 0, sizeof(int), s);
    if (err != cudaSuccess) return err;
    if (ep <= 0 || k <= 0) return cudaSuccess;
    if (sorted) {
        merge_kernel<<<(ep + kThreads - 1) / kThreads, kThreads, 0, s>>>(
            nbr, rows, k, sentinel, ea, eb, emask, ep, out);
    } else {
        int g = 1;
        while (g < kWarp && kHeld * g < k) g *= 2;
        const int per_block = kThreads / g;
        probe_kernel<<<(ep + per_block - 1) / per_block, kThreads, 0, s>>>(
            nbr, rows, k, sentinel, ea, eb, emask, ep, g, out);
    }
    return cudaGetLastError();
}
