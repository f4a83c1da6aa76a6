// The dense window triangle count's contraction, written by hand for
// Hopper (sm_90a): per-column partial sums of (A @ A) ⊙ A for a [vp, vp]
// 0/1 float32 adjacency, vp a multiple of 128.
//
// Replaces gelly_streaming_tpu/ops/pallas_triangles.py `_six_t_partials`
// with its body `_tri_kernel` (:37-77). Output, in the TPU kernel's
// layout: out[i, j*128 + c] = Σ_{r < 128} (A@A)[i*128 + r, j*128 + c] ·
// A[i*128 + r, j*128 + c], float32 [g, g*128] with g = vp/128; the
// caller sums it in int64 and divides by 6 (6·T = Σ (A@A) ⊙ A).
//
// Exactness: entries of A are 0 or 1, every entry of A@A is at most vp
// and every column sum at most 128·vp ≤ 2^19, all integers below 2^24,
// so float32 FFMA sums in any order are exact.
//
// What bounds it: operations, 2·vp³ multiply-adds (137 G at vp = 4096)
// against vp²·4 bytes read. The TPU kernel ran the (i, j, k) grid with k
// innermost, carrying the product tile in VMEM scratch across k steps;
// here one block owns one 128×128 output tile (i, j) and loops over k
// itself, so the carried tile lives in registers: 256 threads, each an
// 8×8 micro-tile (rows ty*4..+3 and 64+ty*4..+3, columns likewise), A's
// k-slices staged through shared memory 16 deep. The epilogue multiplies
// by A[i, j]'s tile, sums each column over its 128 rows (per thread over
// its 8 rows, then across the 16 row groups in shared memory) and writes
// 128 floats: no atomics, no second pass. Plain FFMA, no tensor cores
// yet: 0/1 is exact in fp16, bf16, fp8 and int8 with wide accumulation,
// so a later version may move the product onto `wgmma`.
#include "common.cuh"

namespace {

constexpr int kTile = 128;      // the TPU kernel's TILE
constexpr int kDepth = 16;      // k per shared-memory stage

__global__ void __launch_bounds__(kThreads) six_t_kernel(
        const float* __restrict__ a, int vp, float* __restrict__ out) {
    __shared__ __align__(16) float As[kDepth][kTile];   // A[i-rows, k]ᵀ
    __shared__ __align__(16) float Bs[kDepth][kTile];   // A[k, j-cols]
    __shared__ float colsum[16][kTile];

    const int bi = blockIdx.y, bj = blockIdx.x;
    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const long long row0 = (long long)bi * kTile, col0 = (long long)bj * kTile;

    float acc[8][8] = {};
    for (int k0 = 0; k0 < vp; k0 += kDepth) {
        // A tile rows: 128 rows × 16 k as 512 float4, two per thread,
        // stored transposed so the compute loop reads rows contiguously
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int e = tid + q * kThreads;
            const int r = e / 4, kq = (e % 4) * 4;
            const float4 v = *reinterpret_cast<const float4*>(
                a + (row0 + r) * vp + k0 + kq);
            As[kq][r] = v.x;
            As[kq + 1][r] = v.y;
            As[kq + 2][r] = v.z;
            As[kq + 3][r] = v.w;
        }
        // B tile: 16 k-rows × 128 columns, two float4 per thread
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int e = tid + q * kThreads;
            const int kk = e / 32, c = (e % 32) * 4;
            *reinterpret_cast<float4*>(&Bs[kk][c]) =
                *reinterpret_cast<const float4*>(
                    a + (long long)(k0 + kk) * vp + col0 + c);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
            float x[8], y[8];
            const float4 x0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 x1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
            const float4 y0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float4 y1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
            x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
            x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
            y[0] = y0.x; y[1] = y0.y; y[2] = y0.z; y[3] = y0.w;
            y[4] = y1.x; y[5] = y1.y; y[6] = y1.z; y[7] = y1.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
        }
        __syncthreads();
    }

    // epilogue: mask by A's (i, j) tile, sum each column over the rows
    float part[8] = {};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        const float* arow = a + (row0 + r) * vp + col0;
        const float4 m0 = *reinterpret_cast<const float4*>(arow + tx * 4);
        const float4 m1 = *reinterpret_cast<const float4*>(arow + 64 + tx * 4);
        const float mk[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) part[j] = fmaf(acc[i][j], mk[j], part[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
        colsum[ty][j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4] = part[j];
    __syncthreads();
    if (tid < kTile) {
        float s = 0.0f;
#pragma unroll
        for (int g = 0; g < 16; ++g) s += colsum[g][tid];
        out[(long long)bi * vp + col0 + tid] = s;
    }
}

}  // namespace

// out float32 [vp/128, vp] = the per-column partials of (A@A) ⊙ A for
// the float32 [vp, vp] matrix a (0/1 entries), vp a positive multiple of
// 128. One block per 128×128 output tile.
GS_EXPORT int gs_six_t_partials(const float* a, int vp, float* out,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (vp <= 0 || vp % kTile) return cudaErrorInvalidValue;
    const int g = vp / kTile;
    six_t_kernel<<<dim3(g, g), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, vp, out);
    return cudaGetLastError();
}
