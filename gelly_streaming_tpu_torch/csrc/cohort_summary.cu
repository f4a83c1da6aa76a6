// Carried window summaries of a cohort of nb independent tenant streams,
// written by hand for Hopper (sm_90a): per window round, the degree fold,
// connected components and bipartiteness of every tenant's window,
// against per-tenant carries that live in device memory.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_cohort_call`
// (:640-745), reached through `build_cohort_window_body` (:886-916):
// `_window_call` for nb tenants, the tenant axis the outer grid
// dimension, the stacked carries deg[nb, vb+1], labels[nb, vb+1],
// cover[nb, 2(vb+1)] resident across the grid. Its triangle stage is the
// window counter (csrc/window_counter.cu + csrc/intersect.cu), which the
// Python wrapper (ops/cohort_summary.py) launches on the same slab seen
// as [nb·windows, eb]: triangle counts carry no state, so any grouping
// of windows gives the same counts.
//
// Design: csrc/window_summary.cu's, unchanged (union_find.cuh holds the
// shared device code: the lock-free union-find and the per-window fold
// and settle), with the tenant axis as blockIdx.y. Per window round w
// two launches, whatever nb is: a fold over grid (⌈eb/256⌉, nb), in
// which block row n folds tenant n's window w of the [nb, windows, eb]
// slab into its own carry rows, then a settle over grid
// (⌈(vb+1)/256⌉, nb) that points every slot of every row at its root and
// adds row n's summaries into sums[n][0..2][w]. So a dispatch costs
// 2·windows launches, not 2·windows·nb: the tenant axis amortises the
// launches, as the TPU grid's outer axis amortised its steps. Rows never
// touch each other: union-find indices stay local to a row (slot numbers
// 0..vb and 0..2vb+1 of the tenant's own labels and cover, never global
// offsets), so concurrent tenants need no more care than concurrent
// edges of one tenant.
//
// What bounds it: as window_summary.cu, dependent loads and atomics in
// L2, not bytes. Per valid slot two degree increments and three unions,
// per slot of every carry row three root walks. The bound chip_smoke.py
// prints for a dispatch is window_summary.cu's taken nb times.
#include "union_find.cuh"

namespace {

// Round w's fold: block (x, n) covers slots [256x, 256x+256) of tenant
// n's window w.
__global__ void __launch_bounds__(kThreads) cohort_fold_kernel(
        const int* __restrict__ src, const int* __restrict__ dst,
        const bool* __restrict__ valid, int windows, int eb, int vb, int w,
        int* __restrict__ deg, int* labels, int* cover) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= eb) return;
    const long long n = blockIdx.y;
    const long long slab = (n * windows + w) * eb;
    const long long row = n * (vb + 1);
    fold_slot(src + slab, dst + slab, valid + slab, i, vb, deg + row,
              labels + row, cover + 2 * row);
}

// Round w's settle: block (x, n) covers slots [256x, 256x+256) of tenant
// n's carry rows and adds their share of its summaries into the
// tenant's sums[3, windows].
__global__ void __launch_bounds__(kThreads) cohort_settle_kernel(
        int vb, const int* __restrict__ deg, int* labels, int* cover,
        int* __restrict__ sums, int w, int windows) {
    const long long n = blockIdx.y;
    const long long row = n * (vb + 1);
    settle_slot(blockIdx.x * blockDim.x + threadIdx.x, vb, deg + row,
                labels + row, cover + 2 * row, sums + n * 3 * windows, w,
                windows);
}

}  // namespace

// Folds window round after window round of the [nb, windows, eb] slab
// into the carries deg[nb, vb+1], labels[nb, vb+1], cover[nb, 2(vb+1)]
// (updated in place; each row of labels and cover must hold p[v] <= v,
// as every carry the engines make does), and writes sums[n][0][w] =
// max_degree, sums[n][1][w] = num_components, sums[n][2][w] = odd (0/1)
// of tenant n's window w: sums is int32 [nb, 3, windows].
GS_EXPORT int gs_cohort_summary(const int* src, const int* dst,
                                const bool* valid, int nb, int windows,
                                int eb, int vb, int* deg, int* labels,
                                int* cover, int* sums, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(sums, 0, sizeof(int) * 3 * (size_t)nb * windows,
                          s);
    if (err != cudaSuccess) return err;
    const dim3 fold_grid(blocks(eb), nb), settle_grid(blocks(vb + 1), nb);
    for (int w = 0; w < windows; ++w) {
        cohort_fold_kernel<<<fold_grid, kThreads, 0, s>>>(
            src, dst, valid, windows, eb, vb, w, deg, labels, cover);
        cohort_settle_kernel<<<settle_grid, kThreads, 0, s>>>(
            vb, deg, labels, cover, sums, w, windows);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}
