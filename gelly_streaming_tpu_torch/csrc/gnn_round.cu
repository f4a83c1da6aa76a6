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
// (ops/gnn_window.py), every aggregate is an integer below 2^24 and
// |p·W| < 2^24, so float atomics in any order and FFMA partial sums in
// any order give the JAX package's values bit for bit. No tensor cores
// yet: p ≤ 511 and |W| ≤ 512 fit TF32's and fp16's significands, so a
// later version may move the product onto `mma`/`wgmma` and stay exact.
//
// What bounds it: operations. Over a 64-window chunk at vb=65536, F=64
// the product is 64·2(vb+1)F² = 3.4e10 operations, 0.035 ms at the fp16
// tensor-core rate; the bytes, each input read once and each output
// written once (the edge slab, 9·eb per window; the 16.8 MB slab in and
// out once, since it and the aggregate stay in the 50 MB L2 across
// windows), are 52 MB, 0.016 ms at 3.35 TB/s. The TPU kernel held the
// slab in VMEM; here it does not fit a block, so the round is two
// launches, the launch boundary the barrier between every gather of (a)
// and the in-place writes of (b): (b) reads and writes only its own
// rows. The aggregate m is a [vb+1, F] scratch, owned by the caller
// across calls, that (b) zeroes as it reads it, so it is cleared once
// per call.
//
// (b) is a small-K GEMM: a block owns kRows rows of the slab, stages
// their p in shared memory (a stride of F|1 floats keeps the row reads
// of neighbouring threads in distinct banks), then walks the output
// columns in passes of kCols, staging W in chunks of kDepth rows; each
// thread accumulates a 4×4 micro-tile. All windows of a chunk run on the
// caller's stream with no host synchronisation.
#include "common.cuh"

#include <atomic>
#include <climits>

namespace {

constexpr float kCap = 511.0f;
constexpr int kRows = 64;       // slab rows per update block
constexpr int kCols = 64;       // output columns per pass
constexpr int kDepth = 32;      // rows of W staged per step
constexpr int kMaxF = 256;
constexpr int kMaxDevices = 64;

__host__ __device__ inline int p_stride(int F) { return F | 1; }

inline size_t update_smem(int F) {
    return sizeof(float) * ((size_t)kRows * p_stride(F) + kDepth * kCols)
           + sizeof(int) * kRows;
}

// sums is int32 [4, windows]: max_feat, active, checksum, msg_edges.
__global__ void init_sums_kernel(int* sums, int windows) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= windows) return;
    sums[w] = INT_MIN;
    sums[windows + w] = 0;
    sums[2 * windows + w] = 0;
    sums[3 * windows + w] = 0;
}

// (a): one thread per (slot, feature) of the window.
__global__ void __launch_bounds__(kThreads) scatter_kernel(
        const float* __restrict__ h, const int* __restrict__ src,
        const int* __restrict__ dst, const bool* __restrict__ valid,
        int eb, int vb, int F, int shift, float* __restrict__ m,
        int* __restrict__ nmsg) {
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
            }
        }
    }
    const int n = __syncthreads_count(counts);
    if (threadIdx.x == 0 && n) atomicAdd(nmsg, n);
}

__device__ __forceinline__ float activate(float z, int act) {
    if (act == 0) return fmaxf(z, 0.0f);
    if (act == 1) return fabsf(z);
    return z;
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

// (b): one block per kRows rows of the slab; 256 threads as 16 × 16,
// thread (tx, ty) owning rows ty*4..+3 and columns tx*4..+3 of a pass.
__global__ void __launch_bounds__(kThreads) update_kernel(
        float* __restrict__ h, const float* __restrict__ W,
        const float* __restrict__ b, int vb, int F, int act,
        float* __restrict__ m, int* __restrict__ sums, int w,
        int windows) {
    extern __shared__ float smem[];
    const int ps = p_stride(F);
    float* P = smem;                              // [kRows][ps]
    float* Ws = P + kRows * ps;                   // [kDepth][kCols]
    int* row_active = (int*)(Ws + kDepth * kCols);  // [kRows]

    const int r0 = blockIdx.x * kRows;
    const int rows = min(kRows, vb + 1 - r0);
    const bool held = sums[3 * windows + w] == 0;
    const int tid = threadIdx.x;
    const long long base = (long long)r0 * F;

    int mx = INT_MIN;
    unsigned csum = 0;
    if (tid < kRows) row_active[tid] = 0;
    __syncthreads();

    if (held) {
        // the slab stays; only its summaries are read
        for (int e = tid; e < rows * F; e += kThreads) {
            const float v = h[base + e];
            const int r = e / F, iv = (int)v;
            csum += (unsigned)iv;
            if (r0 + r < vb) {
                mx = max(mx, iv);
                if (v > 0.0f) row_active[r] = 1;
            }
        }
    } else {
        for (int e = tid; e < kRows * F; e += kThreads) {
            const int r = e / F, c = e - r * F;
            float p = 0.0f;
            if (r < rows) {
                const float agg = m[base + e];
                m[base + e] = 0.0f;         // cleared for the next window
                p = fminf(h[base + e] + fminf(agg, kCap), kCap);
            }
            P[r * ps + c] = p;
        }
        const int tx = tid % 16, ty = tid / 16;
        for (int c0 = 0; c0 < F; c0 += kCols) {
            float acc[4][4] = {};
            for (int k0 = 0; k0 < F; k0 += kDepth) {
                __syncthreads();            // P staged / Ws free again
                for (int e = tid; e < kDepth * kCols; e += kThreads) {
                    const int kk = e / kCols, cc = e % kCols;
                    const int k = k0 + kk, c = c0 + cc;
                    Ws[e] = (k < F && c < F) ? W[k * F + c] : 0.0f;
                }
                __syncthreads();
                const int depth = min(kDepth, F - k0);
                for (int kk = 0; kk < depth; ++kk) {
                    float a[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        a[i] = P[(ty * 4 + i) * ps + k0 + kk];
                    const float4 wv = *reinterpret_cast<const float4*>(
                        Ws + kk * kCols + tx * 4);
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        acc[i][0] = fmaf(a[i], wv.x, acc[i][0]);
                        acc[i][1] = fmaf(a[i], wv.y, acc[i][1]);
                        acc[i][2] = fmaf(a[i], wv.z, acc[i][2]);
                        acc[i][3] = fmaf(a[i], wv.w, acc[i][3]);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty * 4 + i;
                if (r >= rows) continue;
                const int row = r0 + r;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = c0 + tx * 4 + j;
                    if (c >= F) continue;
                    float v = fminf(fmaxf(activate(acc[i][j] + b[c], act),
                                          0.0f), kCap);
                    if (row == vb) v = 0.0f;
                    h[(long long)row * F + c] = v;
                    const int iv = (int)v;
                    csum += (unsigned)iv;
                    if (row < vb) {
                        mx = max(mx, iv);
                        if (v > 0.0f) row_active[r] = 1;
                    }
                }
            }
        }
    }

    // block reduction, then one atomic per summary
    mx = warp_max(mx);
    csum = warp_sum(csum);
    __shared__ int part_max[kWarpsPerBlock];
    __shared__ unsigned part_sum[kWarpsPerBlock];
    const int lane = tid % kWarp, warp = tid / kWarp;
    if (lane == 0) {
        part_max[warp] = mx;
        part_sum[warp] = csum;
    }
    __syncthreads();
    const int active = __syncthreads_count(tid < kRows && row_active[tid]);
    if (tid == 0) {
        for (int i = 1; i < kWarpsPerBlock; ++i) {
            mx = max(mx, part_max[i]);
            csum += part_sum[i];
        }
        if (mx != INT_MIN) atomicMax(sums + w, mx);
        if (active) atomicAdd(sums + windows + w, active);
        if (csum) atomicAdd(reinterpret_cast<unsigned*>(sums + 2 * windows + w),
                            csum);
    }
}

// The update kernel's dynamic shared memory is raised once per device to
// what the widest F needs; every call then launches with its own F's size.
std::atomic<bool> smem_raised[kMaxDevices];

cudaError_t raise_smem(int device) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (smem_raised[device].load()) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)update_smem(kMaxF));
    if (err == cudaSuccess) smem_raised[device].store(true);
    return err;
}

}  // namespace

// Folds `windows` windows of the [windows, eb] stack, in order, into the
// slab h [vb+1, F] float32 (in place) with the layer W [F, F], b [F] and
// activation `act` (0 relu, 1 abs, 2 identity), messages shifted right
// by `shift`; writes sums int32 [4, windows] (max_feat, active_vertices,
// feat_checksum, msg_edges). m is a float32 [vb+1, F] scratch that the
// call zeroes first and leaves zero; its caller owns it across calls.
GS_EXPORT int gs_gnn_rounds(float* h, const float* W, const float* b,
                            const int* src, const int* dst,
                            const bool* valid, int windows, int eb, int vb,
                            int F, int act, int shift, float* m, int* sums,
                            int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (F < 1 || F > kMaxF || shift < 0 || shift > 24)
        return cudaErrorInvalidValue;
    if ((err = raise_smem(device)) != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = update_smem(F);
    const size_t slab = sizeof(float) * (size_t)(vb + 1) * F;
    err = cudaMemsetAsync(m, 0, slab, s);
    if (err != cudaSuccess) return err;
    init_sums_kernel<<<(windows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        sums, windows);
    const long long pairs = (long long)eb * F;
    const unsigned scatter_blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
    const unsigned update_blocks = (unsigned)((vb + 1 + kRows - 1) / kRows);
    for (int w = 0; w < windows; ++w) {
        const long long off = (long long)w * eb;
        scatter_kernel<<<scatter_blocks, kThreads, 0, s>>>(
            h, src + off, dst + off, valid + off, eb, vb, F, shift, m,
            sums + 3 * windows + w);
        update_kernel<<<update_blocks, kThreads, smem, s>>>(
            h, W, b, vb, F, act, m, sums, w, windows);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}
