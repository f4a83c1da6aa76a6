// Per-window snapshots of the carried degrees, CC labels and
// bipartiteness, written by hand for Hopper (sm_90a): the columnar
// driver's snapshot program.
//
// Stands in for gelly_streaming_tpu/core/driver.py `_build_snapshot_scan`
// (:91-212), which has no Pallas kernel: an XLA lax.scan over a [W, eb]
// window stack carrying (degrees, labels, cover) and emitting, per
// window, the full rows or the changed-slot wire of ops/delta_egress.py.
// Here the scan is one launch per chunk over the summary body's pieces
// (csrc/summary_body.cuh: its grid rows, its tiles of the wire, the
// lock-free union-find of union_find.cuh), for any subset of the three
// analytics and with no summaries. Per window w, in order:
//   fold  each valid slot (both ids in [0, vb)) adds 1 to deg[s] and
//         deg[d] and joins (s, d) in labels, (s, d+vb+1) and (s+vb+1, d)
//         in the cover; padding touches nothing (the driver's scan maps
//         it to a sentinel self-loop), so the carry's sentinel slots vb
//         and 2vb+1 stay singletons;
//   emit  after a barrier, every slot v < vb of labels and the cover is
//         pointed at its root (the canonical labels: the root of a set
//         is its smallest member), and the row of w is written: deg[v],
//         labels[v], odd[v] = (cover[v] == cover[v+vb+1]); with the
//         changed-slot masks (SNAP_MASKS) each value is also compared
//         with window w-1's (held in `prev`, set from the carry at the
//         start of the call);
//   wire  with the delta wire (SNAP_DELTA) in place of the rows: the
//         changed slots of each analytic, counted per block, and after
//         a barrier written in ascending slot order as (idx, val) pairs,
//         the first `cap` of them, with the whole count, which the
//         driver reads to run an overflowing chunk again on full rows.
// A second barrier ends each window: the emit's in-place compression
// must not meet the next window's unions. The output depends on no
// carry invariant of the summary body (no degree-0 or mirror rule): the
// rows come from the compressed labels themselves.
//
// One tier at every vb: one cooperative grid works on the carry in
// device memory (L2), the barrier that of cooperative_groups; block b of
// the grid owns a contiguous run of slots in the emit, so the wire's
// indices ascend block after block. The summary body's one-block tier,
// the carry in one SM's shared memory, was 7.6x slower here at vb=8192
// (4.727 against 0.620 ms a 64-window chunk on an H100): one SM folds
// what the grid spreads over all of them.
//
// What bounds it: not bytes (a chunk's rows are 9 bytes a slot a
// window, about 38 MB at W=64, vb=65536: 11 us at 3.35 TB/s) but the
// two grid barriers a window and the emit's root walks, one per slot
// of each analytic a window: a window of 256 edges costs about what one
// of 32768 does (utils/snapshot_probe.py).
#include "summary_body.cuh"

namespace {

constexpr int kSnapDeg = 1, kSnapCc = 2, kSnapBip = 4;
constexpr int kSnapMasks = 8;     // full rows plus changed-slot masks
constexpr int kSnapDelta = 16;    // the delta wire instead of full rows

}  // namespace

// Outputs and scratch of one call (a host struct, passed by pointer and
// copied into the kernel's parameters). Rows are [windows, vb], wire rows
// [windows, cap]; analytic k is 0 degrees, 1 labels, 2 odd.
struct SnapshotArgs {
    int* prev;              // [3, vb] scratch: the previous window's values
    unsigned char* chg;     // [3, vb] scratch: this window's changed slots
    int* block_counts;      // [3, max_blocks] scratch: changed slots a block
    int max_blocks;
    int cap;
    int* out_deg;           // full rows
    int* out_labels;
    bool* out_odd;
    bool* chg_deg;          // changed-slot masks (SNAP_MASKS)
    bool* chg_labels;
    bool* chg_odd;
    int* cnt;               // [3, windows] changed counts (SNAP_DELTA)
    int* idx;               // [3, windows, cap] changed slots, ascending
    int* val_deg;           // [windows, cap] their new values
    int* val_labels;
    bool* val_odd;
};

namespace {

// Window w's edges into the carry: degree adds (grouped per warp where
// the carry is in device memory, as the summary body does) and the
// unions of the analytics on, in lockstep (unite_all).
template <class Rows>
__device__ __forceinline__ void snap_fold(const StandardWire& wire,
                                          const Rows& r, int windows, int w,
                                          int flags) {
    const int vb = r.vb, lane = threadIdx.x % kWarp;
    const unsigned per_row = (wire.eb + kWarp - 1) / kWarp;
    const unsigned rounds = rounds_of(r, per_row);
    int* const deg = r.deg_of(0);
    int* const labels = r.labels_of(0);
    int* const cover = r.cover_of(0);
    for (unsigned round = 0; round < rounds; ++round) {
        const Tiles t = read_tiles(wire, r, windows, w, round, per_row);
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
            int n, i;
            if (!tile_at(r, per_row, round, k, n, i)) continue;  // warp-uniform
            int s, d;
            const bool ok = edge_of(t, k, vb, s, d);
            if (flags & kSnapDeg) {
                if constexpr (Rows::kAggregate) {
                    const unsigned edges = __ballot_sync(kFullMask, ok);
                    if (ok) {
                        const unsigned gs = __match_any_sync(edges, s);
                        const unsigned gd = __match_any_sync(edges, d);
                        if (lane == __ffs(gs) - 1)
                            atomicAdd(deg + s, __popc(gs));
                        if (lane == __ffs(gd) - 1)
                            atomicAdd(deg + d, __popc(gd));
                    }
                } else if (ok) {
                    atomicAdd(deg + s, 1);
                    atomicAdd(deg + d, 1);
                }
            }
            if (!ok) continue;
            if ((flags & kSnapCc) && (flags & kSnapBip)) {
                int* const p[3] = {labels, cover, cover};
                int a[3] = {s, s, s + vb + 1}, b[3] = {d, d + vb + 1, d};
                unite_all(p, a, b);
            } else if (flags & kSnapCc) {
                int* const p[1] = {labels};
                int a[1] = {s}, b[1] = {d};
                unite_all(p, a, b);
            } else if (flags & kSnapBip) {
                int* const p[2] = {cover, cover};
                int a[2] = {s, s + vb + 1}, b[2] = {d + vb + 1, d};
                unite_all(p, a, b);
            }
        }
    }
}

// The block's sum of x (every thread of the block calls it).
__device__ __forceinline__ int block_sum(int x, int* buf) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    x = warp_sum(x);
    if (lane == 0) buf[warp] = x;
    __syncthreads();
    int total = 0;
    for (int i = 0; i < (int)blockDim.x / kWarp; ++i) total += buf[i];
    __syncthreads();
    return total;
}

// The number of threads before this one in the block with `pred`, and
// (in total) of all of them (every thread of the block calls it).
__device__ __forceinline__ int block_prefix(bool pred, int& total,
                                            int* buf) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
    const unsigned bal = __ballot_sync(kFullMask, pred);
    if (lane == 0) buf[warp] = __popc(bal);
    __syncthreads();
    int before = 0;
    total = 0;
    for (int i = 0; i < (int)blockDim.x / kWarp; ++i) {
        const int c = buf[i];
        total += c;
        if (i < warp) before += c;
    }
    __syncthreads();
    return before + __popc(bal & ((1u << lane) - 1));
}

// The slots [lo, hi) of [0, vb) this block owns in the emit.
__device__ __forceinline__ void owned(int vb, int& lo, int& hi) {
    const int per = (vb + gridDim.x - 1) / gridDim.x;
    lo = min(vb, (int)blockIdx.x * per);
    hi = min(vb, lo + per);
}

// Slot v's values after the fold (degree, label root, odd), with labels
// and cover compressed in place: each slot has one owner, and a slot
// pointed at its root stays a link to an ancestor of its set, so the
// walks of other owners stay right.
template <class Rows>
__device__ __forceinline__ void slot_values(const Rows& r, int v, int flags,
                                            int (&val)[3]) {
    const int vb = r.vb;
    if (flags & kSnapDeg) val[0] = ((volatile int*)r.deg_of(0))[v];
    if (flags & kSnapCc) {
        volatile int* const p = r.labels_of(0);
        val[1] = find_root<false>(p, v);
        p[v] = val[1];
    }
    if (flags & kSnapBip) {
        volatile int* const p[2] = {r.cover_of(0), r.cover_of(0)};
        int x[2] = {v, v + vb + 1};
        find_roots<false>(p, x, 3u);
        p[0][v] = x[0];
        p[0][v + vb + 1] = x[1];
        val[2] = x[0] == x[1];
    }
}

// The emit of window w (w < 0: the start of the call, which sets prev
// from the carry and writes nothing else).
template <class Rows>
__device__ void snap_emit(const Rows& r, int windows, int w, int flags,
                          const SnapshotArgs& a, int* buf) {
    const int vb = r.vb;
    const bool track = flags & (kSnapMasks | kSnapDelta);
    const bool full = !(flags & kSnapDelta);
    int lo, hi;
    owned(vb, lo, hi);
    int counts[3] = {0, 0, 0};
    for (int base = lo; base < hi; base += blockDim.x) {  // block-uniform
        const int v = base + threadIdx.x;
        const bool live = v < hi;
        int val[3] = {0, 0, 0};
        bool chg[3] = {false, false, false};
        if (live) {
            slot_values(r, v, flags, val);
            if (track) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    if (!(flags >> k & 1)) continue;
                    int* const pv = a.prev + (long long)k * vb + v;
                    chg[k] = w >= 0 && val[k] != *pv;
                    *pv = val[k];
                }
            }
            if (w >= 0) {
                const long long at = (long long)w * vb + v;
                if (full) {
                    if (flags & kSnapDeg) a.out_deg[at] = val[0];
                    if (flags & kSnapCc) a.out_labels[at] = val[1];
                    if (flags & kSnapBip) a.out_odd[at] = val[2];
                    if (flags & kSnapMasks) {
                        if (flags & kSnapDeg) a.chg_deg[at] = chg[0];
                        if (flags & kSnapCc) a.chg_labels[at] = chg[1];
                        if (flags & kSnapBip) a.chg_odd[at] = chg[2];
                    }
                } else {
#pragma unroll
                    for (int k = 0; k < 3; ++k)
                        if (flags >> k & 1)
                            a.chg[(long long)k * vb + v] = chg[k];
                }
            }
        }
        if (w >= 0 && !full) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
                if (flags >> k & 1)
                    counts[k] += __syncthreads_count(live && chg[k]);
        }
    }
    if (w >= 0 && !full && threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
            if (flags >> k & 1)
                a.block_counts[k * a.max_blocks + blockIdx.x] = counts[k];
    }
}

// The delta wire of window w, after the emit's barrier: each block
// writes its changed slots at its offset among all blocks', ascending,
// up to cap; block 0 writes the whole count. It reads only what the
// emit wrote (chg, prev, block_counts), never the carry, so the next
// window's fold may run beside it.
template <class Rows>
__device__ void snap_wire(const Rows& r, int windows, int w, int flags,
                          const SnapshotArgs& a, int* buf) {
    const int vb = r.vb;
    int lo, hi;
    owned(vb, lo, hi);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (!(flags >> k & 1)) continue;
        int before = 0, total = 0;
        for (int j = threadIdx.x; j < (int)gridDim.x; j += blockDim.x) {
            // written by other blocks before the barrier: read past L1
            const int c = __ldcg(a.block_counts + k * a.max_blocks + j);
            total += c;
            if (j < (int)blockIdx.x) before += c;
        }
        before = block_sum(before, buf);
        total = block_sum(total, buf);
        if (blockIdx.x == 0 && threadIdx.x == 0)
            a.cnt[(long long)k * windows + w] = total;
        int* const idx = a.idx + ((long long)k * windows + w) * a.cap;
        const long long row = (long long)w * a.cap;
        for (int base = lo; base < hi && before < a.cap;
             base += blockDim.x) {                        // block-uniform
            const int v = base + threadIdx.x;
            const bool c = v < hi && a.chg[(long long)k * vb + v];
            int tile = 0;
            const int pos = before + block_prefix(c, tile, buf);
            if (c && pos < a.cap) {
                const int nv = a.prev[(long long)k * vb + v];
                idx[pos] = v;
                if (k == 0) a.val_deg[row + pos] = nv;
                else if (k == 1) a.val_labels[row + pos] = nv;
                else a.val_odd[row + pos] = nv != 0;
            }
            before += tile;
        }
    }
}

template <class Rows>
__device__ void snapshot_body(const StandardWire& wire, const Rows& r,
                              int windows, int flags,
                              const SnapshotArgs& a, int* buf) {
    if (flags & (kSnapMasks | kSnapDelta)) {
        snap_emit(r, windows, -1, flags, a, buf);
        r.sync();
    }
    for (int w = 0; w < windows; ++w) {
        snap_fold(wire, r, windows, w, flags);
        r.sync();
        snap_emit(r, windows, w, flags, a, buf);
        r.sync();
        if (flags & kSnapDelta) snap_wire(r, windows, w, flags, a, buf);
    }
}

// L2 tier: the grid works on the carry in device memory; launched
// cooperatively (the grid barrier needs every block resident).
__global__ void __launch_bounds__(kThreads) snapshot_grid_kernel(
        const StandardWire wire, int windows, int vb, int flags, int* deg,
        int* labels, int* cover, const SnapshotArgs a) {
    __shared__ int buf[kWarp];
    const GridRows r{deg, labels, cover, 1, vb};
    snapshot_body(wire, r, windows, flags, a, buf);
}

// Per device, once: the SM count and the grid kernel's blocks an SM.
cudaError_t snapshot_prepare(int device, int& sms, int& per_sm) {
    static std::atomic<int> sm_count[kMaxDevices], grid_per_sm[kMaxDevices];
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!sm_count[device].load()) {
        int n = 0, per = 0;
        cudaError_t err = cudaDeviceGetAttribute(
            &n, cudaDevAttrMultiProcessorCount, device);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per, snapshot_grid_kernel, kThreads, 0);
        if (err != cudaSuccess) return err;
        grid_per_sm[device].store(per);
        sm_count[device].store(n);
    }
    sms = sm_count[device].load();
    per_sm = grid_per_sm[device].load();
    return cudaSuccess;
}

}  // namespace

// Folds the [windows, eb] standard-wire chunk, window by window, into
// the carry (engine layout: deg[vb+1], labels[vb+1], cover[2(vb+1)],
// int32, in place; null where the analytic is off) and writes each
// window's snapshot into *args: flags = SNAP_DEG 1 | SNAP_CC 2 |
// SNAP_BIP 4 (the analytics on), SNAP_MASKS 8 (full rows and masks),
// SNAP_DELTA 16 (the delta wire in place of full rows). After the call
// labels and cover hold the canonical labels. One launch on `stream`.
GS_EXPORT int gs_window_snapshot(const int* src, const int* dst,
                                 const bool* valid, int windows, int eb,
                                 int vb, int flags, int* deg, int* labels,
                                 int* cover, const SnapshotArgs* args,
                                 int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (windows <= 0 || eb <= 0 || vb <= 0
            || std::max<long long>(eb, 3LL * (vb + 1)) >= (1LL << 31)
            || !(flags & (kSnapDeg | kSnapCc | kSnapBip))
            || ((flags & kSnapDelta) && args->cap <= 0))
        return cudaErrorInvalidValue;
    int sms = 0, per_sm = 0;
    if ((err = snapshot_prepare(device, sms, per_sm)) != cudaSuccess)
        return err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const StandardWire wire{src, dst, valid, eb};
    const SnapshotArgs a = *args;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    // a slot a thread, at least a block an SM, at most what fits at once
    // and what block_counts holds
    const long long want = std::max<long long>(
        sms, ((long long)eb + kThreads - 1) / kThreads);
    const unsigned grid = (unsigned)std::min<long long>(
        std::min<long long>(want, (long long)per_sm * sms), a.max_blocks);
    int w = windows, e = vb, f = flags;
    StandardWire wr = wire;
    SnapshotArgs aa = a;
    void* kargs[] = {&wr, &w, &e, &f, &deg, &labels, &cover, &aa};
    return cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(snapshot_grid_kernel), grid, kThreads,
        kargs, 0, s);
}
