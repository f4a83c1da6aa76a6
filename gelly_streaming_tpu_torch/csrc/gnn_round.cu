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
// (ops/gnn_window.py): p is an integer in [0, 511] and W an integer with
// |W| ≤ weight_cap(F) ≤ 512, both exact in fp16 (11 significant bits);
// every product is an integer below 2^18 and every partial sum of p·W,
// in any order and grouping, an integer of magnitude below 2^24, so the
// tensor cores' fp32 sums drop no bit; every aggregate is an integer
// below 2^24, so float atomics in any order are exact too. The round
// gives the JAX package's values bit for bit. bf16 (8 significant bits)
// would round W: it is not used.
//
// What bounds it: bytes. Over a 64-window chunk at vb=65536, F=64 the
// product is 64·2(vb+1)F² = 3.4e10 operations, 0.035 ms at the fp16
// tensor-core rate; each window the update reads and writes the 16.8 MB
// slab h, ≈ 10 µs at 3.35 TB/s where it misses the 50 MB L2. The TPU
// kernel held the slab in VMEM; here it does not fit a block, so the
// round is two launches, the launch boundary the barrier between every
// gather of (a) and the in-place writes of (b): (b) reads and writes
// only its own rows. The aggregate m is a [vb+1, F] scratch, owned by
// the caller across calls; (a) marks each row it sends to in a uint8
// [vb+1] scratch, and (b) reads and zeroes m only in marked rows (11%
// of them in a Zipf window of 32768 edges over 65536 vertices) and
// clears the marks, so both are cleared once per call and the update
// does not stream the whole of m twice a window.
//
// (b) is a GEMM [vb+1, F] × [F, F] on the fp16 tensor cores
// (`mma.sync.m16n8k16.f32.f16.f16.f32`, fed by `ldmatrix`) with the
// staging and the epilogue fused. Persistent blocks, as many as share
// the tiles evenly among the SMs' resident slots, each convert W to
// fp16 into shared memory once (zero-padded to a multiple of 16 in k
// and of 32 in n), then walk kRows-row tiles of the slab: p = min(h +
// min(m, 511), 511) from 16-byte loads of h and of the marked rows of m
// into a fp16 tile; each warp multiplies its 16 rows by W in passes of
// 32 columns (16 accumulators a thread, so four blocks of 8 warps fit
// an SM's registers and keep more loads in flight), then adds b,
// applies the activation, clips to [0, 511], zeroes row vb and writes h
// in place with 16-byte stores (lanes t and t^1 swap half their
// fragment, so each holds four adjacent columns of one row), gathering
// max / active / checksum on the way. Shared-memory
// rows are 16 bytes longer than their data, so the eight rows an
// `ldmatrix` phase reads fall in distinct banks. Any F in [1, 256] is
// taken: the kernel pads k and n itself, and uses 4-byte accesses where
// F is not a multiple of 4. All windows of a chunk run on the caller's
// stream with no host synchronisation.
#include "common.cuh"

#include <cuda_fp16.h>

#include <atomic>
#include <climits>

namespace {

constexpr float kCap = 511.0f;
constexpr int kRows = 128;      // slab rows per tile: 8 warps × 16
constexpr int kNPass = 32;      // output columns per pass (4 fragments)
constexpr int kMaxF = 256;
constexpr int kMaxDevices = 64;

// W's k rows padded to 16, its n columns to kNPass; each shared-memory
// row 8 halves (16 bytes) longer than its data
__host__ __device__ inline int pad_k(int F) { return (F + 15) & ~15; }
__host__ __device__ inline int pad_n(int F) {
    return (F + kNPass - 1) / kNPass * kNPass;
}
__host__ __device__ inline int w_stride(int F) { return pad_n(F) + 8; }
__host__ __device__ inline int p_stride(int F) { return pad_k(F) + 8; }

inline size_t update_smem(int F) {
    return sizeof(__half) * ((size_t)pad_k(F) * w_stride(F)
                             + (size_t)kRows * p_stride(F));
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

// (a): one thread per (slot, feature) of the window; the slot's thread
// of feature 0 marks its destination row in `touched`.
__global__ void __launch_bounds__(kThreads) scatter_kernel(
        const float* __restrict__ h, const int* __restrict__ src,
        const int* __restrict__ dst, const bool* __restrict__ valid,
        int eb, int vb, int F, int shift, float* __restrict__ m,
        unsigned char* __restrict__ touched, int* __restrict__ nmsg) {
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
                if (f == 0) touched[d] = 1;
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


__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned* r) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned* r) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16×16 f16, row-major) · b (16×8 f16, column-major), fp32 sums
__device__ __forceinline__ void mma_f16(float* d, const unsigned* a,
                                        unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float stage_p(float h, float m) {
    return fminf(h + fminf(m, kCap), kCap);
}

// (b): persistent blocks of 8 warps over kRows-row tiles of the slab;
// warp i owns rows 16i..16i+15 of each tile.
__global__ void __launch_bounds__(kThreads, 4) update_kernel(
        float* __restrict__ h, const float* __restrict__ W,
        const float* __restrict__ b, int vb, int F, int act,
        float* __restrict__ m, unsigned char* __restrict__ touched,
        int* __restrict__ sums, int w, int windows) {
    extern __shared__ __align__(16) __half smem[];
    __shared__ int row_active[kRows];
    __shared__ unsigned char row_hit[kRows];
    __shared__ int part_max[kWarpsPerBlock];
    __shared__ unsigned part_sum[kWarpsPerBlock];
    const int kp = pad_k(F), np = pad_n(F);
    const int ws = w_stride(F), ps = p_stride(F);
    __half* Ws = smem;                            // [kp][ws]: W[k][n]
    __half* P = smem + kp * ws;                   // [kRows][ps]: p

    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    const int gid = lane / 4, tig = lane % 4;
    const bool held = sums[3 * windows + w] == 0;
    const bool vec = F % 4 == 0
        && ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(m))
            & 15) == 0;
    const int tiles = (vb + kRows) / kRows;       // ⌈(vb+1) / kRows⌉

    int mx = INT_MIN, active = 0;
    unsigned csum = 0;
    if (!held) {
        // W as fp16, once per block; P zeroed once, so its padding
        // columns (k ≥ F) are zero for every tile
        for (int e = tid; e < kp * np; e += kThreads) {
            const int k = e / np, n = e - k * np;
            Ws[k * ws + n] = __float2half_rn(
                (k < F && n < F) ? W[k * F + n] : 0.0f);
        }
        for (int e = tid; e < kRows * ps; e += kThreads)
            P[e] = __float2half_rn(0.0f);
    }

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = tile * kRows;
        const int rows = min(kRows, vb + 1 - r0);
        const long long base = (long long)r0 * F;
        if (tid < kRows) {
            row_active[tid] = 0;
            // rows that received a message: only their m is read and
            // zeroed (the rest of m is zero); the marks are cleared
            if (!held && tid < rows) {
                row_hit[tid] = touched[r0 + tid];
                touched[r0 + tid] = 0;
            }
        }
        __syncthreads();            // resets seen; the last tile's P free

        if (held) {
            // the slab stays; only its summaries are read, four
            // features at a time where F allows
            const int step = vec ? 4 : 1;
            for (int e = tid * step; e < rows * F; e += kThreads * step) {
                float v[4];
                if (vec) {
                    const float4 x = *reinterpret_cast<const float4*>(
                        h + base + e);
                    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
                } else {
                    v[0] = h[base + e];
                }
                const int r = e / F;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    if (i >= step) break;
                    const int iv = (int)v[i];
                    csum += (unsigned)iv;
                    if (r0 + r < vb) {
                        mx = max(mx, iv);
                        if (v[i] > 0.0f) row_active[r] = 1;
                    }
                }
            }
        } else {
            if (vec) {
                // 16-byte loads, up to eight in flight per thread (h, and
                // m in marked rows)
                const int fq = F / 4, nq = rows * fq;
                const float4* h4 = reinterpret_cast<const float4*>(h + base);
                float4* m4 = reinterpret_cast<float4*>(m + base);
                for (int q0 = tid; q0 < nq; q0 += 4 * kThreads) {
                    float4 hv[4], mv[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int q = q0 + u * kThreads;
                        mv[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                        if (q < nq) {
                            hv[u] = h4[q];
                            if (row_hit[q / fq]) mv[u] = m4[q];
                        }
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        const int q = q0 + u * kThreads;
                        if (q >= nq) continue;
                        const int r = q / fq, c = (q - r * fq) * 4;
                        if (row_hit[r])     // cleared for the next window
                            m4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                        __half2* dst = reinterpret_cast<__half2*>(
                            P + r * ps + c);
                        dst[0] = __floats2half2_rn(stage_p(hv[u].x, mv[u].x),
                                                   stage_p(hv[u].y, mv[u].y));
                        dst[1] = __floats2half2_rn(stage_p(hv[u].z, mv[u].z),
                                                   stage_p(hv[u].w, mv[u].w));
                    }
                }
            } else {
                for (int e = tid; e < rows * F; e += kThreads) {
                    const int r = e / F;
                    float agg = 0.0f;
                    if (row_hit[r]) {
                        agg = m[base + e];
                        m[base + e] = 0.0f; // cleared for the next window
                    }
                    P[r * ps + e - r * F] =
                        __float2half_rn(stage_p(h[base + e], agg));
                }
            }
            __syncthreads();            // P staged

            if (warp * 16 < rows) {
                // ldmatrix row addresses: P's rows 16·warp + (lane mod 16)
                // at k 8·(lane / 16); W's k rows (lane mod 16) at n
                // 8·(lane / 16)
                const int lr = lane % 8 + (lane / 8) % 2 * 8, lc = lane / 16 * 8;
                const unsigned pa = smem_addr(P + (warp * 16 + lr) * ps + lc);
                const unsigned wa = smem_addr(Ws + lr * ws + lc);
                const int rl = warp * 16 + gid;   // tile rows rl, rl + 8
                for (int n0 = 0; n0 < np; n0 += kNPass) {
                    float acc[kNPass / 8][4] = {};
                    for (int k0 = 0; k0 < F; k0 += 16) {
                        unsigned a[4];
                        ldmatrix_x4(pa + 2 * k0, a);
#pragma unroll
                        for (int j = 0; j < kNPass / 16; ++j) {
                            unsigned bw[4];
                            ldmatrix_x4_trans(
                                wa + 2 * (k0 * ws + n0 + 16 * j), bw);
                            mma_f16(acc[2 * j], a, bw[0], bw[1]);
                            mma_f16(acc[2 * j + 1], a, bw[2], bw[3]);
                        }
                    }
#pragma unroll
                    for (int f = 0; f < kNPass / 8; ++f) {
                        // fragment f: rows rl, rl+8 × columns c, c+1
                        const int c = n0 + 8 * f + 2 * tig;
                        float v[4];
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            const int cc = c + (i & 1);
                            const int row = r0 + rl + (i >> 1) * 8;
                            v[i] = cc < F && row != vb
                                ? fminf(fmaxf(activate(acc[f][i] + b[cc],
                                                       act), 0.0f), kCap)
                                : 0.0f;
                        }
                        // swap halves with lane t^1: even lanes then hold
                        // row rl, columns c..c+3; odd lanes row rl+8,
                        // columns c-2..c+1
                        const bool odd = tig & 1;
                        const float s0 = __shfl_xor_sync(
                            kFullMask, odd ? v[0] : v[2], 1);
                        const float s1 = __shfl_xor_sync(
                            kFullMask, odd ? v[1] : v[3], 1);
                        const float o[4] = {odd ? s0 : v[0], odd ? s1 : v[1],
                                            odd ? v[2] : s0, odd ? v[3] : s1};
                        const int r = rl + (odd ? 8 : 0);
                        const int c0 = odd ? c - 2 : c;
                        if (r >= rows || c0 >= F) continue;
                        float* dst = h + (long long)(r0 + r) * F + c0;
                        if (vec) {
                            *reinterpret_cast<float4*>(dst) =
                                make_float4(o[0], o[1], o[2], o[3]);
                        } else {
#pragma unroll
                            for (int i = 0; i < 4; ++i)
                                if (c0 + i < F) dst[i] = o[i];
                        }
                        bool any = false;
#pragma unroll
                        for (int i = 0; i < 4; ++i) {
                            if (c0 + i >= F) continue;
                            const int iv = (int)o[i];
                            csum += (unsigned)iv;
                            if (r0 + r < vb) mx = max(mx, iv);
                            any |= o[i] > 0.0f;
                        }
                        if (any && r0 + r < vb) row_active[r] = 1;
                    }
                }
            }
        }
        __syncthreads();                // row_active complete
        active += __syncthreads_count(tid < rows && row_active[tid]);
    }

    // block reduction, then one atomic per summary
    mx = warp_max(mx);
    csum = warp_sum(csum);
    if (lane == 0) {
        part_max[warp] = mx;
        part_sum[warp] = csum;
    }
    __syncthreads();
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

// Per device: the update kernel's dynamic shared memory raised once to
// what the widest F needs, and the SM count.
std::atomic<int> sm_count[kMaxDevices];

cudaError_t prepare(int device) {
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (sm_count[device].load()) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)update_smem(kMaxF));
    int n = 0;
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err == cudaSuccess) sm_count[device].store(n);
    return err;
}

}  // namespace

// Folds `windows` windows of the [windows, eb] stack, in order, into the
// slab h [vb+1, F] float32 (in place) with the layer W [F, F], b [F] and
// activation `act` (0 relu, 1 abs, 2 identity), messages shifted right
// by `shift`; writes sums int32 [4, windows] (max_feat, active_vertices,
// feat_checksum, msg_edges). m is a float32 [vb+1, F] scratch and
// touched a uint8 [vb+1] one, both zeroed first and left zero.
GS_EXPORT int gs_gnn_rounds(float* h, const float* W, const float* b,
                            const int* src, const int* dst,
                            const bool* valid, int windows, int eb, int vb,
                            int F, int act, int shift, float* m,
                            unsigned char* touched, int* sums, int device,
                            void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (F < 1 || F > kMaxF || shift < 0 || shift > 24)
        return cudaErrorInvalidValue;
    if ((err = prepare(device)) != cudaSuccess) return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t smem = update_smem(F);
    // persistent update blocks: the tiles shared evenly over as many
    // rounds as the resident slots need
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, update_kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = (vb + kRows) / kRows;
    const int slots = per_sm * sm_count[device].load();
    const int rounds = (tiles + slots - 1) / slots;
    const unsigned update_blocks = (unsigned)((tiles + rounds - 1) / rounds);
    const size_t slab = sizeof(float) * (size_t)(vb + 1) * F;
    err = cudaMemsetAsync(m, 0, slab, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(touched, 0, vb + 1, s);
    if (err != cudaSuccess) return err;
    init_sums_kernel<<<(windows + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        sums, windows);
    const long long pairs = (long long)eb * F;
    const unsigned scatter_blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
    for (int w = 0; w < windows; ++w) {
        const long long off = (long long)w * eb;
        scatter_kernel<<<scatter_blocks, kThreads, 0, s>>>(
            h, src + off, dst + off, valid + off, eb, vb, F, shift, m,
            touched, sums + 3 * windows + w);
        update_kernel<<<update_blocks, kThreads, smem, s>>>(
            h, W, b, vb, F, act, m, touched, sums, w, windows);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
}
