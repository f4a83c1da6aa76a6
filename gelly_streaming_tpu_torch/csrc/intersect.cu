// Per-edge neighbor-row intersection, written by hand for Hopper (sm_90a).
//
// Replaces gelly_streaming_tpu/ops/pallas_intersect.py `_intersect_tiles`
// (the pallas_call at :116-145; compare loop `tile_intersect_count` :78):
// for every valid oriented edge (a, b), |N_out(a) ∩ N_out(b)|, summed.
// The rows come from a [V+1, K] int32 table whose fill is the sentinel V;
// an entry of row a counts when it is < sentinel and occurs in row b.
//
// What bounds it: the compares, O(E·K²) at worst and O(E·len_a·len_b) in
// practice, plus the gather of two rows per edge from the table. On the
// main path (eb=32768 Zipf windows) rows hold a few entries and at most
// ~30, so it is the dependent loads of the gather (edge -> row length ->
// row), not the compares, that take the time.
//
// Design. The TPU kernel gathered rows outside the kernel (in XLA) and
// compared [T, Ck, K] tiles in VMEM. Here one warp owns one edge and
// gathers both rows straight from the table, so no [E, K] intermediate
// ever exists in device memory. Each lane holds one entry of row a (32 at
// a time) in a register; row b is loaded 32 entries at a time, one per
// lane, and broadcast lane by lane with __shfl_sync: no shared memory and
// no sort, so rows need not be sorted. Rows are deduplicated, so an entry
// of row a matches at most once; its hit is a flag, counted with one
// ballot, like the TPU kernel's `any` over the compare axis. Where the
// caller gives row lengths (the window counter's out-degrees) the loops
// stop there instead of at K. A block sums its warps and adds once,
// atomically, into its window's int32 total.
#include "common.cuh"

namespace {

// |row a ∩ row b| counted over entries of row a below the sentinel. All
// 32 lanes call it with the same rows and lengths; every lane returns the
// same count.
__device__ __forceinline__ int warp_row_intersect(
        const int* __restrict__ ra, int la, const int* __restrict__ rb,
        int lb, int sentinel, int lane) {
    int hits = 0;
    for (int ta = 0; ta < la; ta += kWarp) {
        const int ia = ta + lane;
        const int av = ia < la ? ra[ia] : sentinel;
        bool hit = false;
        for (int tb = 0; tb < lb; tb += kWarp) {
            const int ib = tb + lane;
            const int bv = ib < lb ? rb[ib] : sentinel;
            const int nb = min(kWarp, lb - tb);
            for (int j = 0; j < nb; ++j)
                hit |= av == __shfl_sync(kFullMask, bv, j);
        }
        hits += __popc(__ballot_sync(kFullMask, hit && av < sentinel));
    }
    return hits;
}

// grid (x: edge blocks, y: windows). Window w reads its table at
// nbr + w*table_stride and its edges at ea/eb + w*edge_stride; it has
// nedges[w] edges (ep when nedges is null), each masked by emask (all
// valid when null). lens (optional, stride lens_stride per window) caps
// each row's length below k.
__global__ void __launch_bounds__(kThreads) intersect_kernel(
        const int* __restrict__ nbr, long long table_stride, int rows,
        int k, int sentinel, const int* __restrict__ ea,
        const int* __restrict__ eb, long long edge_stride,
        const bool* __restrict__ emask, const int* __restrict__ nedges,
        int ep, const int* __restrict__ lens, long long lens_stride,
        int* __restrict__ out) {
    const int w = blockIdx.y;
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int* table = nbr + w * table_stride;
    const int* wa = ea + w * edge_stride;
    const int* wb = eb + w * edge_stride;
    const bool* wm = emask ? emask + w * edge_stride : nullptr;
    const int* wl = lens ? lens + w * lens_stride : nullptr;
    const int n = nedges ? nedges[w] : ep;

    int acc = 0;  // the same in every lane of the warp
    for (int e = blockIdx.x * kWarpsPerBlock + warp; e < n;
         e += gridDim.x * kWarpsPerBlock) {
        if (wm && !wm[e]) continue;
        const int a = wa[e], b = wb[e];
        if (a < 0 || a >= rows || b < 0 || b >= rows) continue;
        const int la = wl ? min(wl[a], k) : k;
        const int lb = wl ? min(wl[b], k) : k;
        if (la == 0 || lb == 0) continue;
        acc += warp_row_intersect(table + (long long)a * k, la,
                                  table + (long long)b * k, lb, sentinel,
                                  lane);
    }
    __shared__ int partial[kWarpsPerBlock];
    if (lane == 0) partial[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int i = 0; i < kWarpsPerBlock; ++i) sum += partial[i];
        if (sum) atomicAdd(out + w, sum);
    }
}

}  // namespace

// out[w] = Σ over window w's valid edges of |row a ∩ row b|, for
// `windows` windows; out is cleared here first.
GS_EXPORT int gs_intersect(const int* nbr, long long table_stride,
                           int rows, int k, int sentinel, const int* ea,
                           const int* eb, long long edge_stride,
                           const bool* emask, const int* nedges, int ep,
                           const int* lens, long long lens_stride,
                           int* out, int windows, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)windows, s);
    if (err != cudaSuccess) return err;
    if (ep > 0 && k > 0 && windows > 0) {
        // about four edges per warp when every slot holds an edge
        const int per_block = 4 * kWarpsPerBlock;
        dim3 grid((ep + per_block - 1) / per_block, windows);
        intersect_kernel<<<grid, kThreads, 0, s>>>(
            nbr, table_stride, rows, k, sentinel, ea, eb, edge_stride,
            emask, nedges, ep, lens, lens_stride, out);
    }
    return cudaGetLastError();
}
