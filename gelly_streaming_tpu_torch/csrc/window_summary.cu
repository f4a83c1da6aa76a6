// Carried window summaries, written by hand for Hopper (sm_90a): the
// degree fold, connected components and bipartiteness of every window of
// a chunk, against a carry that lives in device memory.
//
// Replaces gelly_streaming_tpu/ops/pallas_window.py `_window_call`
// (:504-637) with `_final_summaries` (:488-496), in both its forms: the
// standard wire and the compact one (:548-576: uint16 ids and one valid
// count per window, decoded where each slot is loaded; common.cuh), apart
// from its triangle stage, which is the window counter
// (csrc/window_counter.cu + csrc/intersect.cu) that the Python wrapper
// launches on the same chunk, on the same wire.
// Per window w of a [W, eb] edge stack, in order: invalid slots map to
// the sentinel vb; degrees fold into the carried deg[vb+1] (a valid
// self-loop adds 2, an invalid slot 0); the carried CC labels[vb+1] fold
// the edges (s, d); the carried double cover cover[2(vb+1)] folds
// (s, d+vb+1) and (s+vb+1, d); then, from the state after window w,
// max_degree = max(deg[:vb]), num_components = #{v < vb : deg[v] > 0 and
// labels[v] == v} and odd = any v < vb with deg[v] > 0 and
// cover[v] == cover[v+vb+1].
//
// The TPU kernel held the whole carry in VMEM and ran each min-label
// fixpoint as a loop of scatter-min rounds until nothing changed. Here
// the carry does not fit a block's shared memory (labels 256 KB, cover
// 512 KB at vb=65536, against 227 KB), and a convergence flag read by the
// host would cost one synchronisation per round per window. The design
// rests on what the fixpoint converges to: every vertex labelled with the
// smallest vertex reachable through the window's edges plus the carried
// forest's links (v, labels0[v]) (ops/host_snapshot.py:12-21 of the JAX
// package), whatever the schedule. The carried labels are such a forest:
// labels[v] <= v, each tree's root its smallest member. So a lock-free
// union-find over the carry in device memory gives the same labels with
// no rounds: each edge hooks the larger of its two roots under the
// smaller with atomicCAS (retrying when another thread won the race), so
// a root stays the minimum of its set; then a full pass over the vb+1
// and 2(vb+1) slots points every slot at its root. The pass is over every
// slot, not only the window's endpoints: a vertex that no edge of the
// window touches must still follow its root when that root was hooked.
//
// What bounds it: dependent loads and atomics in L2, not bytes. Per
// valid slot two degree increments and three unions (each two root walks
// and a compare-and-swap); per slot of the carry, three root walks.
// Windows depend on each other through the carry, so they run in order:
// two launches per window (fold + union; settle + summaries), a launch
// boundary being the barrier between the unions and the pass that reads
// them, all on the caller's stream with no host synchronisation inside a
// chunk. The 1 MB carry stays in the 50 MB L2 across the chunk.
#include "union_find.cuh"

namespace {

// One window: grid over its eb slots (union_find.cuh: fold_slot), read
// through the stack's wire.
template <class Wire>
__global__ void __launch_bounds__(kThreads) fold_kernel(
        const Wire wire, int w, int vb, int* __restrict__ deg, int* labels,
        int* cover) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= wire.eb) return;
    fold_slot(wire, w, i, vb, deg, labels, cover);
}

// After a window's unions: grid over v in [0, vb] (union_find.cuh:
// settle_slot), window w's summaries into sums [3, windows].
__global__ void __launch_bounds__(kThreads) settle_kernel(
        int vb, const int* __restrict__ deg, int* labels, int* cover,
        int* __restrict__ sums, int w, int windows) {
    settle_slot(blockIdx.x * blockDim.x + threadIdx.x, vb, deg, labels,
                cover, sums, w, windows);
}

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

// Folds window after window of the stack `wire` carries, in order, into
// the carry, two launches per window.
template <class Wire>
cudaError_t window_summary(const Wire wire, int windows, int vb, int* deg,
                           int* labels, int* cover, int* sums, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = cudaMemsetAsync(sums, 0, sizeof(int) * 3 * (size_t)windows, s);
    if (err != cudaSuccess) return err;
    for (int w = 0; w < windows; ++w) {
        fold_kernel<<<blocks(wire.eb), kThreads, 0, s>>>(wire, w, vb, deg,
                                                         labels, cover);
        settle_kernel<<<blocks(vb + 1), kThreads, 0, s>>>(
            vb, deg, labels, cover, sums, w, windows);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}

}  // namespace

// Folds `windows` windows of the [windows, eb] stack (standard wire), in
// order, into the carry deg[vb+1], labels[vb+1], cover[2(vb+1)] (updated
// in place; labels and cover must hold p[v] <= v, as every carry the
// engines make does), and writes sums[0][w] = max_degree, sums[1][w] =
// num_components, sums[2][w] = odd (0/1) of each window: sums is int32
// [3, windows].
GS_EXPORT int gs_window_summary(const int* src, const int* dst,
                                const bool* valid, int windows, int eb,
                                int vb, int* deg, int* labels, int* cover,
                                int* sums, int device, void* stream) {
    return window_summary(StandardWire{src, dst, valid, eb}, windows, vb,
                          deg, labels, cover, sums, device, stream);
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
    return window_summary(CompactWire{src16, dst16, nvalid, eb}, windows,
                          vb, deg, labels, cover, sums, device, stream);
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
