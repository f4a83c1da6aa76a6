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
// split its vertex range: block r of the cluster owns vertices
// [(k·C + r)·span, +span) in pass k, its cells and counts in shared
// memory (8 bytes a vertex; span up to ~28K vertices a block on an
// H100). Each block reads all of its window's contributions (from L2
// after the first block), folds those in its range with shared-memory
// atomics and writes its part of the row once, coalesced: no memset of
// the output, no global atomics. C is the least that holds the row in
// one pass (vb <= 28K: C = 1, the shared-memory tier; vb = 65536: C = 4),
// doubled while the windows leave SMs idle; rows past 8 blocks take more
// passes. The delta wire's ascending order comes from a block scan of
// the touched cells and the cluster's per-block totals, read through
// distributed shared memory after a cluster barrier.
//
// Float sums: shared-memory atomics add in an order that changes from
// run to run, so a float32 sum is exact only up to reordering (the port
// holds it to 1e-5 · Σ|v| a cell); integer monoids and float min/max are
// bit-equal to the plain version. Integer sums wrap modulo 2^32, as
// XLA's int32 segment_sum does.
//
// What bounds it: bytes. At 64 windows of eb = 8192, vb = 16384 (out,
// full rows): 64·8192·8 B read, 64·16385·8 B written, ~12.6 MB, ~4 us
// at 3.35 TB/s; the atomics of a hub vertex serialise in its block.
#include <algorithm>
#include <atomic>
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 1024;
constexpr int kBlockWarps = kBlock / kWarp;
constexpr int kMaxCluster = 8;
constexpr int kMaxDevices = 64;
constexpr int kSpreadMin = 2048;   // vertices a block keeps at least
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
// float min / max by compare-and-swap: the cell keeps a value only while
// another one compares smaller (larger), so the result is the smallest
// (largest) value whatever the order
template <>
struct Monoid<float, kOpMin> {
    static __device__ __forceinline__ float identity() { return f_inf(); }
    static __device__ __forceinline__ void fold(float* a, float v) {
        int* ai = reinterpret_cast<int*>(a);
        int old = *ai;
        while (v < __int_as_float(old)) {
            const int seen = atomicCAS(ai, old, __float_as_int(v));
            if (seen == old) break;
            old = seen;
        }
    }
};
template <>
struct Monoid<float, kOpMax> {
    static __device__ __forceinline__ float identity() { return -f_inf(); }
    static __device__ __forceinline__ void fold(float* a, float v) {
        int* ai = reinterpret_cast<int*>(a);
        int old = *ai;
        while (v > __int_as_float(old)) {
            const int seen = atomicCAS(ai, old, __float_as_int(v));
            if (seen == old) break;
            old = seen;
        }
    }
};

// Contribution j in [0, rep·eb) of window w: read(w, j, v, at) gives its
// vertex v in [0, vbp) and the offset of its value, or false for padding
// (or an id outside the window's range, which nothing counts).
template <class T>
struct StandardCells {
    const int* ids;
    const T* vals;
    long long plane;   // wb·eb: one direction's ids
    int eb, vbp;

    __device__ __forceinline__ bool read(int w, int j, int& v,
                                         long long& at) const {
        const int r = j / eb;
        at = r * plane + (long long)w * eb + (j - r * eb);
        const long long c = (long long)ids[at] - (long long)w * vbp;
        v = (int)c;
        return c >= 0 && c < vbp;
    }
    __device__ __forceinline__ T value(long long at) const {
        return vals[at];
    }
};

template <class T>
struct CompactCells {
    const uint16_t* src;
    const uint16_t* dst;
    const int* nvalid;
    const T* vals;
    int eb, vbp, dir;

    __device__ __forceinline__ bool read(int w, int j, int& v,
                                         long long& at) const {
        const int r = j >= eb;
        const int i = j - r * eb;
        if (i >= nvalid[w]) return false;
        at = (long long)w * eb + i;
        v = (dir == kDirIn || r) ? dst[at] : src[at];
        return v < vbp;
    }
    __device__ __forceinline__ T value(long long at) const {
        return vals[at];
    }
};

// Inclusive sum of x over the block's threads in thread order.
__device__ __forceinline__ int block_inclusive_scan(int x, int* part) {
    const int lane = threadIdx.x & (kWarp - 1), wid = threadIdx.x / kWarp;
    for (int o = 1; o < kWarp; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, x, o);
        if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) part[wid] = x;
    __syncthreads();
    if (wid == 0) {
        int t = lane < kBlockWarps ? part[lane] : 0;
        for (int o = 1; o < kWarp; o <<= 1) {
            const int y = __shfl_up_sync(kFullMask, t, o);
            if (lane >= o) t += y;
        }
        if (lane < kBlockWarps) part[lane] = t;
    }
    __syncthreads();
    return x + (wid ? part[wid - 1] : 0);
}

template <class Wire, class T, int Op>
__global__ void __launch_bounds__(kBlock)
    cell_reduce_kernel(Wire wire, int rep_eb, int vbp, int span, int passes,
                       CellOut out) {
    using M = Monoid<T, Op>;
    extern __shared__ __align__(16) unsigned char smem[];
    T* cells = reinterpret_cast<T*>(smem);
    int* counts = reinterpret_cast<int*>(smem + (size_t)span * sizeof(T));
    __shared__ int part[kBlockWarps];
    __shared__ int block_total;
    __shared__ T pad_cell;
    __shared__ int pad_count;

    cg::cluster_group cluster = cg::this_cluster();
    const int C = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int w = blockIdx.x / C;
    const int tid = threadIdx.x;
    const bool delta = out.cnt != nullptr;
    const int cap = out.cap;
    int base = 0;   // touched cells of this window in earlier passes

    for (int k = 0; k < passes; ++k) {
        const int lo = (int)min((long long)(k * C + rank) * span,
                                (long long)vbp);
        const int n = min(span, vbp - lo);
        for (int i = tid; i < n; i += kBlock) {
            cells[i] = M::identity();
            counts[i] = 0;
        }
        __syncthreads();
        if (n > 0) {
            for (int j = tid; j < rep_eb; j += kBlock) {
                int v;
                long long at;
                if (!wire.read(w, j, v, at)) continue;
                const unsigned u = (unsigned)(v - lo);
                if (u < (unsigned)n) {
                    M::fold(&cells[u], wire.value(at));
                    atomicAdd(&counts[u], 1);
                }
            }
        }
        __syncthreads();
        if (!delta) {
            T* orow = static_cast<T*>(out.cells) + (long long)w * vbp + lo;
            int* crow = out.counts + (long long)w * vbp + lo;
            for (int i = tid; i < n; i += kBlock) {
                orow[i] = cells[i];
                crow[i] = counts[i];
            }
            __syncthreads();   // before the next pass clears the row
            continue;
        }
        if (k == 0 && rank == 0 && tid == 0) {   // vertex 0: the padding
            pad_cell = cells[0];
            pad_count = counts[0];
        }
        // each thread a run of the block's vertices, in order
        const int per = (n + kBlock - 1) / kBlock;
        const int a = min(n, tid * per), b = min(n, a + per);
        int mine = 0;
        for (int i = a; i < b; ++i) mine += counts[i] > 0;
        const int incl = block_inclusive_scan(mine, part);
        if (tid == kBlock - 1) block_total = incl;
        cluster.sync();
        int before = base, all = 0;
        for (int r = 0; r < C; ++r) {
            const int t = *cluster.map_shared_rank(&block_total, r);
            if (r < rank) before += t;
            all += t;
        }
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
        cluster.sync();   // the totals and rows are read before reuse
    }
    if (delta && rank == 0) {
        if (tid == 0) out.cnt[w] = base;
        int* irow = out.idx + (long long)w * cap;
        T* vrow = static_cast<T*>(out.dcells) + (long long)w * cap;
        int* nrow = out.dcounts + (long long)w * cap;
        for (int p = base + tid; p < cap; p += kBlock) {
            irow[p] = 0;
            vrow[p] = pad_cell;
            nrow[p] = pad_count;
        }
    }
}

// A call's launch shape: C blocks a window, `span` vertices a block a
// pass, `passes` passes, span·8 bytes of dynamic shared memory a block.
struct Plan {
    int cluster, span, passes;
    size_t smem;
};

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

cudaError_t plan(int wb, int vbp, int device, Plan& p) {
    static std::atomic<int> sm_count[kMaxDevices], smem_room[kMaxDevices];
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
        // the static shared memory (the scan's parts, the pad entry) is
        // the same in every instantiation, to a few bytes: keep 64 spare
        const int room = optin - (int)attr.sharedSizeBytes - 64;
        if ((err = raise_type<int>(room)) || (err = raise_type<float>(room)))
            return err;
        smem_room[device].store(room);
        sm_count[device].store(n);
    }
    const int sms = sm_count[device].load();
    const int max_span = (smem_room[device].load() / 8) & ~31;
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
    p.smem = (size_t)p.span * 8;
    return cudaSuccess;
}

template <class Wire, class T, int Op>
cudaError_t launch_op(const Wire& wire, int wb, int rep_eb, int vbp,
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
    cudaError_t err =
        cudaLaunchKernelEx(&cfg, cell_reduce_kernel<Wire, T, Op>, wire,
                           rep_eb, vbp, p.span, p.passes, out);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <class Wire, class T>
cudaError_t launch(const Wire& wire, int wb, int rep_eb, int vbp, int op,
                   const CellOut* out, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (wb <= 0 || vbp <= 0) return cudaSuccess;
    if (out->cnt && out->cap <= 0) return cudaErrorInvalidValue;
    Plan p;
    if ((err = plan(wb, vbp, device, p)) != cudaSuccess) return err;
    switch (op) {
        case kOpSum:
            return launch_op<Wire, T, kOpSum>(wire, wb, rep_eb, vbp, p,
                                              *out, stream);
        case kOpMin:
            return launch_op<Wire, T, kOpMin>(wire, wb, rep_eb, vbp, p,
                                              *out, stream);
        case kOpMax:
            return launch_op<Wire, T, kOpMax>(wire, wb, rep_eb, vbp, p,
                                              *out, stream);
    }
    return cudaErrorInvalidValue;
}

}  // namespace

// out[0] the blocks a window (the cluster), out[1] the vertices a block
// holds a pass, out[2] the passes, of a call of wb windows at vbp cells.
GS_EXPORT int gs_cell_reduce_plan(int wb, int vbp, int device, int* out) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    Plan p;
    if ((err = plan(std::max(wb, 1), std::max(vbp, 1), device, p)) !=
        cudaSuccess)
        return err;
    out[0] = p.cluster;
    out[1] = p.span;
    out[2] = p.passes;
    return cudaSuccess;
}

// The standard wire: ids and vals [rep, wb, eb] (vals int32, or float32
// with is_float), op 0 sum, 1 min, 2 max; one launch on `stream`.
GS_EXPORT int gs_cell_reduce(const int* ids, const void* vals, int wb,
                             int eb, int rep, int vbp, int op, int is_float,
                             const CellOut* out, int device, void* stream) {
    const long long plane = (long long)wb * eb;
    if (is_float)
        return launch<StandardCells<float>, float>(
            StandardCells<float>{ids, static_cast<const float*>(vals), plane,
                                 eb, vbp},
            wb, rep * eb, vbp, op, out, device, stream);
    return launch<StandardCells<int>, int>(
        StandardCells<int>{ids, static_cast<const int*>(vals), plane, eb,
                           vbp},
        wb, rep * eb, vbp, op, out, device, stream);
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
    const int rep_eb = direction == kDirAll ? 2 * eb : eb;
    if (is_float)
        return launch<CompactCells<float>, float>(
            CompactCells<float>{src16, dst16, nvalid,
                                static_cast<const float*>(vals), eb, vbp,
                                direction},
            wb, rep_eb, vbp, op, out, device, stream);
    return launch<CompactCells<int>, int>(
        CompactCells<int>{src16, dst16, nvalid,
                          static_cast<const int*>(vals), eb, vbp, direction},
        wb, rep_eb, vbp, op, out, device, stream);
}
