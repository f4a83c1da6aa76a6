// Carried window summaries, written by hand for Hopper (sm_90a): the
// degree fold, connected components and bipartiteness of every window of
// a chunk, against a carry that lives in device memory; and the
// union-find entry of ops/unionfind.cc_fixpoint.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_window_call`
// (:504-637) with `_final_summaries` (:488-496), in both its forms: the
// standard wire and the compact one (:548-576: uint16 ids and one valid
// count per window, decoded where each slot is loaded; common.cuh), apart
// from its triangle stage, which is the window counter
// (csrc/window_counter.cu + csrc/intersect.cu) that the Python wrapper
// launches on the same chunk, on the same wire.
//
// The summaries are csrc/summary_body.cuh's, at one row (nb = 1): one
// launch per call, in the tier the carry's size picks (at vb=65536 the
// L2 tier, one cooperative launch over the card; at vb <= 14527 one
// block with the carry in shared memory). That header says what the
// design rests on and what bounds it.
#include "summary_body.cuh"

namespace {

// cc_fixpoint's initial forest: with `carried` the identity, to which
// link_kernel then adds the links (v, labels0[v]); without it labels0
// itself where it points at an equal or smaller slot (fresh callers pass
// the identity), the identity elsewhere.
__global__ void __launch_bounds__(kThreads) init_kernel(
        const int* __restrict__ labels0, int n, bool carried,
        int* __restrict__ p) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= n) return;
    const int l = labels0[v];
    p[v] = (!carried && l >= 0 && l <= v) ? l : v;
}

__global__ void __launch_bounds__(kThreads) link_kernel(
        const int* __restrict__ labels0, int n, int* p) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= n) return;
    const int l = labels0[v];
    if (in_range(l, n)) unite(p, v, l);
}

// Edges with an endpoint outside [0, n) are skipped.
__global__ void __launch_bounds__(kThreads) edge_kernel(
        const int* __restrict__ src, const int* __restrict__ dst,
        long long ne, int n, int* p) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= ne) return;
    const int s = src[i], d = dst[i];
    if (in_range(s, n) && in_range(d, n)) unite(p, s, d);
}

__global__ void __launch_bounds__(kThreads) compress_kernel(int n, int* p) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= n) return;
    p[v] = find_root<false>(p, v);
}

}  // namespace

// Folds `windows` windows of the [windows, eb] stack (standard wire), in
// order, into the carry deg[vb+1], labels[vb+1], cover[2(vb+1)], and
// writes sums[0][w] = max_degree, sums[1][w] = num_components,
// sums[2][w] = odd (0/1) of each window: sums is int32 [3, windows]. The
// carry is updated in place and must be one the engines make (the
// hosts' check_summary_carry): labels and cover hold p[v] <= v, a vertex
// with deg 0 is a singleton root in labels, and the cover's sets are
// closed under the mirror v <-> v+vb+1. One launch.
GS_EXPORT int gs_window_summary(const int* src, const int* dst,
                                const bool* valid, int windows, int eb,
                                int vb, int* deg, int* labels, int* cover,
                                int* sums, int device, void* stream) {
    return summarize_rows(StandardWire{src, dst, valid, eb}, 1, windows,
                          vb, deg, labels, cover, sums, device, stream);
}

// gs_window_summary on the compact wire: uint16 src16/dst16 [windows, eb]
// and nvalid[windows], slot i of window w padding iff i >= nvalid[w]
// (the TPU kernel's compact form, pallas_window.py:548-576).
GS_EXPORT int gs_window_summary_compact(const uint16_t* src16,
                                        const uint16_t* dst16,
                                        const int* nvalid, int windows,
                                        int eb, int vb, int* deg,
                                        int* labels, int* cover, int* sums,
                                        int device, void* stream) {
    return summarize_rows(CompactWire{src16, dst16, nvalid, eb}, 1,
                          windows, vb, deg, labels, cover, sums, device,
                          stream);
}

// unionfind.cc_fixpoint on the card: out[n] = the canonical labels of
// labels0[n] folded with the ne edges (src, dst), each slot pointing at
// the smallest slot of its set. With `carried` the links (v, labels0[v])
// join the edges, as in the JAX package.
GS_EXPORT int gs_cc_fixpoint(const int* labels0, int n, const int* src,
                             const int* dst, long long ne, int carried,
                             int* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0) return cudaSuccess;
    init_kernel<<<blocks(n), kThreads, 0, s>>>(labels0, n, carried != 0, out);
    if (carried) link_kernel<<<blocks(n), kThreads, 0, s>>>(labels0, n, out);
    if (ne > 0)
        edge_kernel<<<blocks(ne), kThreads, 0, s>>>(src, dst, ne, n, out);
    compress_kernel<<<blocks(n), kThreads, 0, s>>>(n, out);
    return cudaGetLastError();
}
