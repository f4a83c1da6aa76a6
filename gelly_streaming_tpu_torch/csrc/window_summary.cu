// Carried window summaries, written by hand for Hopper (sm_90a): the
// degree fold, connected components and bipartiteness of every window of
// a chunk, against a carry that lives in device memory; and the
// union-find entry of ops/unionfind.cc_fixpoint (gs_cc_fixpoint, which
// stands in for the JAX package's XLA while_loop, ops/unionfind.py:47):
// the lock-free union-find of union_find.cuh in device memory, one
// cooperative launch a call up to kGridEdges (131,072) edges (every call
// the models make), four grid launches above; bound by the launch and
// the walks' dependent loads, not by bytes.
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
// the links (v, labels0[v]) are then added; without it labels0 itself
// where it points at an equal or smaller slot (fresh callers pass the
// identity), the identity elsewhere.
__device__ __forceinline__ int initial_parent(const int* labels0, int v,
                                              bool carried) {
    const int l = labels0[v];
    return (!carried && l >= 0 && l <= v) ? l : v;
}

// One cooperative grid over device memory (the plan's tier up to
// kGridEdges edges): the passes of the four launches below, the carried
// links and the edges united in one, with a grid barrier after the
// initial forest and one before the compression.
__global__ void __launch_bounds__(kThreads) cc_grid_kernel(
        const int* __restrict__ labels0, int n, const int* __restrict__ src,
        const int* __restrict__ dst, long long ne, int carried, int* p) {
    cg::grid_group grid = cg::this_grid();
    const long long T = (long long)gridDim.x * blockDim.x;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    for (long long v = t; v < n; v += T)
        p[v] = initial_parent(labels0, (int)v, carried);
    grid.sync();
    if (carried) {
        for (long long v = t; v < n; v += T) {
            const int l = labels0[v];
            if (in_range(l, n)) unite(p, (int)v, l);
        }
    }
    for (long long e = t; e < ne; e += T) {
        const int s = src[e], d = dst[e];
        if (in_range(s, n) && in_range(d, n)) unite(p, s, d);
    }
    grid.sync();
    for (long long v = t; v < n; v += T)
        p[v] = find_root<false>(p, (int)v);
}

// The same passes as four grid launches (init, links, edges, compress).
__global__ void __launch_bounds__(kThreads) init_kernel(
        const int* __restrict__ labels0, int n, bool carried,
        int* __restrict__ p) {
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= n) return;
    p[v] = initial_parent(labels0, v, carried);
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

constexpr int kCcGrid = 0, kCcFour = 1;
// The edges up to which one cooperative launch beats four launches
// (utils/snapshot_probe.py --cc-tiers on an H100, uniform edges over
// 65,537 slots).
constexpr long long kGridEdges = 1LL << 17;

// What a call runs: the tier and the grid's blocks.
struct CcPlan {
    int tier, blocks;
};

// The plan of a call: one cooperative launch where ne <= kGridEdges
// (every call the models make: merge windows, carried batches), the
// four launches above. A build with GS_PIN_CC_TIER=0 or 1 takes the
// grid or the four launches at every size: the probe's builds that
// measure kGridEdges.
cudaError_t cc_plan(int n, long long ne, int device, CcPlan& p) {
    static std::atomic<int> sm_count[kMaxDevices], grid_per_sm[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    cudaError_t err;
    if (!sm_count[device].load()) {
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, device)) ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, cc_grid_kernel, kThreads, 0)))
            return err;
        grid_per_sm[device].store(per_sm);
        sm_count[device].store(sms);
    }
#ifdef GS_PIN_CC_TIER
    p.tier = GS_PIN_CC_TIER;
#else
    p.tier = ne <= kGridEdges ? kCcGrid : kCcFour;
#endif
    const int per_sm = grid_per_sm[device].load();
    if (p.tier == kCcFour) {
        p.blocks = (int)blocks(n);
        return cudaSuccess;
    }
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    // a slot or an edge a thread, at most what fits at once
    const long long want = std::max<long long>(blocks(n), blocks(ne));
    p.blocks = (int)std::min<long long>(
        want, (long long)per_sm * sm_count[device].load());
    return cudaSuccess;
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

// The plan of a cc_fixpoint call of n slots and ne edges: out[0] the
// tier (0 one cooperative grid, 1 four grid launches), out[1] the
// grid's blocks.
GS_EXPORT int gs_cc_plan(int n, long long ne, int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (n <= 0 || ne < 0) return cudaErrorInvalidValue;
    CcPlan p;
    if ((err = cc_plan(n, ne, device, p)) != cudaSuccess) return err;
    out[0] = p.tier;
    out[1] = p.blocks;
    return cudaSuccess;
}

// unionfind.cc_fixpoint on the card: out[n] = the canonical labels of
// labels0[n] folded with the ne edges (src, dst), each slot pointing at
// the smallest slot of its set. With `carried` the links (v, labels0[v])
// join the edges, as in the JAX package. One cooperative launch up to
// kGridEdges edges, four grid launches above (cc_plan); a refused launch
// returns its error.
GS_EXPORT int gs_cc_fixpoint(const int* labels0, int n, const int* src,
                             const int* dst, long long ne, int carried,
                             int* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0) return cudaSuccess;
    CcPlan p;
    if ((err = cc_plan(n, ne, device, p)) != cudaSuccess) return err;
    if (p.tier == kCcGrid) {
        void* args[] = {&labels0, &n, &src, &dst, &ne, &carried, &out};
        return cudaLaunchCooperativeKernel(
            reinterpret_cast<const void*>(cc_grid_kernel), p.blocks,
            kThreads, args, 0, s);
    }
    init_kernel<<<blocks(n), kThreads, 0, s>>>(labels0, n, carried != 0, out);
    if (carried) link_kernel<<<blocks(n), kThreads, 0, s>>>(labels0, n, out);
    if (ne > 0)
        edge_kernel<<<blocks(ne), kThreads, 0, s>>>(src, dst, ne, n, out);
    compress_kernel<<<blocks(n), kThreads, 0, s>>>(n, out);
    return cudaGetLastError();
}
