// The dense window triangle count's contraction, written by hand for
// Hopper (sm_90a): per-column partial sums of (A @ A) ⊙ A for a [vp, vp]
// 0/1 int8 adjacency, vp a multiple of 128, on the int8 tensor cores.
//
// Replaces gelly_streaming_tpu/ops/pallas_triangles.py `_six_t_partials`
// with its body `_tri_kernel` (:37-77). Output, in the TPU kernel's
// layout: out[i, j*128 + c] = Σ_{r < 128} (A@A)[i*128 + r, j*128 + c] ·
// A[i*128 + r, j*128 + c], float32 [g, g*128] with g = vp/128; the
// caller sums it in int64 and divides by 6 (6·T = Σ (A@A) ⊙ A).
//
// Exactness: entries of A are 0 or 1, exact in int8; the tensor cores
// sum the products in int32, every entry of A@A is at most vp and every
// column partial at most 128·vp ≤ 2^19, an integer that float32 holds
// exactly, whatever order the split partials are added in.
//
// What bounds it: operations, 2·vp³ (137 G at vp = 4096) at the int8
// tensor-core rate, against vp² bytes of A read. The product runs on
// `mma.sync.m16n8k32.s32.s8.s8.s32`, fed by `ldmatrix` from a ring of
// kStages shared-memory stages that `cp.async` fills kStages-1 k-steps
// ahead. A is symmetric, so the B operand's K-major (column-major) tile
// is a row tile of A: both operands are 128 rows × kDepth bytes of A,
// rows i*128.. and j*128.., read row-wise; each row's 16-byte chunks
// are XOR-swizzled by (row mod 8) so the eight rows an `ldmatrix` phase
// reads fall in distinct banks. A block of 8 warps (2 × 4, each warp a
// 64 × 32 sub-tile: 4 × 4 fragments, 64 int32 accumulators) owns one
// 128×128 tile (i, j) over a range of k, and only tiles with i ≤ j run:
// M = (A@A) ⊙ A is symmetric, so the (j, i) tile's column sums are the
// (i, j) tile's row sums, and half the product is skipped. The epilogue
// masks by A's (i, j) tile and sums each column over its rows and each
// row over its columns (in registers, then shuffles within the warp,
// then across warps in shared memory), and writes 128 floats of
// out[i, j-tile] and, off the diagonal, 128 of out[j, i-tile]. The
// dispatcher's buckets (128 … 4096) give g(g+1)/2 tiles, 36 at vp =
// 1024 and 1 at 128, too few for 132 SMs: the masked sums are linear in
// the product, so k splits into `split` ranges, each block masks and
// sums its own partial product and adds it into the zeroed output with
// float atomics (exact: integers below 2^24, order-free).
#include "common.cuh"

namespace {

constexpr int kTile = 128;      // the TPU kernel's TILE: output tile side
constexpr int kDepth = 128;     // bytes of k per stage (4 mma k-steps)
constexpr int kStages = 3;      // the cp.async ring
constexpr int kStageBytes = 2 * kTile * kDepth;          // A rows + B rows
constexpr int kSmem = kStages * kStageBytes;             // 96 KB
constexpr int kMaxDevices = 64;

// Byte offset of 16-byte chunk `chunk` of row `row` in a [128][kDepth]
// tile: the chunk index XOR (row mod 8).
__device__ __forceinline__ int swz(int row, int chunk) {
    return row * kDepth + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned& r0,
                                            unsigned& r1, unsigned& r2,
                                            unsigned& r3) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a (16×32 s8, row-major) · b (32×8 s8, column-major), int32
__device__ __forceinline__ void mma_s8(int* d, const unsigned* a,
                                       unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: rows row0.. (A operand) and col0.. (B operand) of A, bytes
// k0..k0+kDepth of each, 2·128·8 chunks of 16 bytes, 8 per thread.
__device__ __forceinline__ void load_stage(const int8_t* __restrict__ a,
                                           int vp, long long row0,
                                           long long col0, int k0,
                                           unsigned stage, int tid) {
#pragma unroll
    for (int q = 0; q < 2 * kTile * (kDepth / 16) / kThreads; ++q) {
        const int e = tid + q * kThreads;
        const int half = e / (kTile * (kDepth / 16));      // 0 A, 1 B
        const int r = (e / (kDepth / 16)) % kTile;
        const int chunk = e % (kDepth / 16);
        const long long grow = (half ? col0 : row0) + r;
        cp_async16(stage + half * kTile * kDepth + swz(r, chunk),
                   a + grow * vp + k0 + chunk * 16);
    }
}

__global__ void __launch_bounds__(kThreads, 2) six_t_kernel(
        const int8_t* __restrict__ a, int vp, int split,
        float* __restrict__ out) {
    extern __shared__ __align__(128) unsigned char smem[];
    __shared__ int colsum[2][kTile];                   // per 64-row half
    __shared__ int rowsum[4][kTile];                   // per 32-column slot

    // the tile (bi, bj), bi ≤ bj, of blockIdx.x in row-major order of
    // the upper triangle
    const int g = vp / kTile;
    int bi = 0, bj = blockIdx.x;
    while (bj >= g - bi) {
        bj -= g - bi;
        ++bi;
    }
    bj += bi;
    const int ks = blockIdx.y;                         // this block's k range
    const int nk = vp / kDepth / split;                // k-steps per range
    const int kbase = ks * nk * kDepth;
    const long long row0 = (long long)bi * kTile, col0 = (long long)bj * kTile;
    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    const int wm = warp / 4, wn = warp % 4;            // 64-row, 32-col slot
    const unsigned base = smem_addr(smem);

    int acc[4][4][4] = {};                             // [mi][ni][c]

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nk)
            load_stage(a, vp, row0, col0, kbase + s * kDepth,
                       base + s * kStageBytes, tid);
        asm volatile("cp.async.commit_group;\n");
    }
    for (int kt = 0; kt < nk; ++kt) {
        asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
        __syncthreads();              // stage kt landed; kt-1's slot is free
        const int nxt = kt + kStages - 1;
        if (nxt < nk)
            load_stage(a, vp, row0, col0, kbase + nxt * kDepth,
                       base + (nxt % kStages) * kStageBytes, tid);
        asm volatile("cp.async.commit_group;\n");

        const unsigned sa = base + (kt % kStages) * kStageBytes;
        const unsigned sb = sa + kTile * kDepth;
#pragma unroll
        for (int kk = 0; kk < kDepth / 32; ++kk) {
            unsigned bf[4][2];
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                // matrices: n 0-7 × k 0-15 / 16-31, then n 8-15 likewise
                const int n = wn * 32 + np * 16 + (lane % 8)
                              + (lane / 16) * 8;
                ldmatrix_x4(sb + swz(n, kk * 2 + (lane / 8) % 2),
                            bf[2 * np][0], bf[2 * np][1],
                            bf[2 * np + 1][0], bf[2 * np + 1][1]);
            }
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                // matrices: rows 0-7 / 8-15 × k bytes 0-15 / 16-31
                const int r = wm * 64 + mi * 16 + (lane % 8)
                              + ((lane / 8) % 2) * 8;
                unsigned af[4];
                ldmatrix_x4(sa + swz(r, kk * 2 + lane / 16), af[0], af[1],
                            af[2], af[3]);
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
                    mma_s8(acc[mi][ni], af, bf[ni][0], bf[ni][1]);
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n");

    // epilogue: mask by A's (i, j) tile, M = (A@A) ⊙ A over it; fragment
    // (mi, ni) holds rows mi*16 + gid (+8) and columns ni*8 + 2*tig (+1)
    // of the warp's 64 × 32 slot. Column sums over the warp's rows, and
    // row sums over its columns: M's (j, i) tile is the transpose of its
    // (i, j) tile (A and A@A are symmetric), so the column sums of the
    // (j, i) tile are the row sums of this one.
    const int gid = lane / 4, tig = lane % 4;
    int part[4][2] = {}, rpart[4][2] = {};
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const long long r = row0 + wm * 64 + mi * 16 + gid + h * 8;
            const int8_t* arow = a + r * vp + col0 + wn * 32 + 2 * tig;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const char2 mk = *reinterpret_cast<const char2*>(arow + ni * 8);
                const int v0 = acc[mi][ni][2 * h] * mk.x;
                const int v1 = acc[mi][ni][2 * h + 1] * mk.y;
                part[ni][0] += v0;
                part[ni][1] += v1;
                rpart[mi][h] += v0 + v1;
            }
        }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            int v = part[ni][c];
            v += __shfl_xor_sync(kFullMask, v, 4);
            v += __shfl_xor_sync(kFullMask, v, 8);
            v += __shfl_xor_sync(kFullMask, v, 16);
            if (gid == 0) colsum[wm][wn * 32 + ni * 8 + 2 * tig + c] = v;
        }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            int v = rpart[mi][h];
            v += __shfl_xor_sync(kFullMask, v, 1);
            v += __shfl_xor_sync(kFullMask, v, 2);
            if (tig == 0) rowsum[wn][wm * 64 + mi * 16 + gid + h * 8] = v;
        }
    __syncthreads();
    float s;
    float* o;
    if (tid < kTile) {                  // out[i, j*128 + c]
        s = (float)(colsum[0][tid] + colsum[1][tid]);
        o = out + (long long)bi * vp + col0 + tid;
    } else {                            // out[j, i*128 + r], j > i
        if (bi == bj) return;
        const int r = tid - kTile;
        s = (float)(rowsum[0][r] + rowsum[1][r] + rowsum[2][r]
                    + rowsum[3][r]);
        o = out + (long long)bj * vp + row0 + r;
    }
    if (split == 1)
        *o = s;
    else if (s != 0.0f)
        atomicAdd(o, s);
}

int sm_count[kMaxDevices];          // 0 until first asked, per device

}  // namespace

// out float32 [vp/128, vp] = the per-column partials of (A@A) ⊙ A for
// the int8 [vp, vp] symmetric 0/1 matrix a, vp a positive multiple of
// 128. One block per 128×128 tile (i, j) with i ≤ j, g(g+1)/2 of them,
// and k range; k splits into `split` ranges (a power of two dividing
// vp/128) until the blocks fill the SMs, and then the output is zeroed
// first and summed with atomics.
GS_EXPORT int gs_six_t_partials(const int8_t* a, int vp, float* out,
                                int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (vp <= 0 || vp % kTile) return cudaErrorInvalidValue;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!sm_count[device]) {
        int n = 0;
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                     device);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(
            six_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
        if (err != cudaSuccess) return err;
        sm_count[device] = n;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int g = vp / kTile, tiles = g * (g + 1) / 2;
    int split = 1;
    while (tiles * split < sm_count[device] && g % (2 * split) == 0)
        split *= 2;
    if (split > 1) {
        err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)g * vp, s);
        if (err != cudaSuccess) return err;
    }
    six_t_kernel<<<dim3(tiles, split), kThreads, kSmem, s>>>(a, vp, split,
                                                            out);
    return cudaGetLastError();
}
