// Carried window summaries of a cohort of nb independent tenant streams,
// written by hand for Hopper (sm_90a): per window of each tenant row, the
// degree fold, connected components and bipartiteness, against
// per-tenant carries that live in device memory.
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
// The summaries are csrc/summary_body.cuh's, the body of
// csrc/window_summary.cu too, over nb rows: one launch per dispatch,
// whatever nb and the windows are. At the cohort's default bucket
// (vb=8192) a tenant row (16(vb+1) = 131,088 bytes) fits one block's
// shared memory, so each row is one block that loads its carry once and
// writes it back once; rows too large for that (vb=65536) share one
// cooperative grid over device memory. Rows never touch each other:
// union-find indices stay local to a row (slot numbers 0..vb and
// 0..2vb+1 of the tenant's own labels and cover), so concurrent tenants
// need no more care than concurrent edges of one tenant.
#include "summary_body.cuh"

// Folds the [nb, windows, eb] slab, each tenant row's windows in order,
// into the carries deg[nb, vb+1], labels[nb, vb+1], cover[nb, 2(vb+1)]
// (updated in place; each row must be a carry the engines make, as
// csrc/window_summary.cu's gs_window_summary says), and writes
// sums[n][0][w] = max_degree, sums[n][1][w] = num_components,
// sums[n][2][w] = odd (0/1) of tenant n's window w: sums is int32
// [nb, 3, windows]. One launch.
GS_EXPORT int gs_cohort_summary(const int* src, const int* dst,
                                const bool* valid, int nb, int windows,
                                int eb, int vb, int* deg, int* labels,
                                int* cover, int* sums, int device,
                                void* stream) {
    return summarize_rows(StandardWire{src, dst, valid, eb}, nb, windows,
                          vb, deg, labels, cover, sums, device, stream);
}
