// Native host-runtime kernels: edge-file parsing, tumbling-window
// assignment, and incremental vertex interning.
//
// The reference delegates its host runtime to Flink's JVM (SURVEY.md §1
// L1); our host driver's hot loops — the parts that feed the TPU —
// are implemented here and exposed over a C ABI consumed via ctypes
// (gelly_streaming_tpu/native/__init__.py). Python fallbacks exist for
// every entry point.
//
// Build: make -C gelly_streaming_tpu/native   (produces libgsnative.so)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Edge text parsing: whitespace-separated "src dst [ts]" lines.
// Returns the number of edges parsed; fills src/dst/ts (ts = -1 when a
// line has only two fields). Stops at max_edges.
// ---------------------------------------------------------------------
int64_t gs_parse_edges(const char* buf, int64_t len, int64_t max_edges,
                       int64_t* src, int64_t* dst, int64_t* ts) {
    int64_t count = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end && count < max_edges) {
        // skip blank space / newlines
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
        if (p >= end) break;
        int64_t fields[3] = {0, 0, -1};
        int nfields = 0;
        // Only the first three tokens are parsed; anything after them on
        // the line (labels, extra columns) is ignored — same semantics as
        // the Python fallback (native/__init__.py), so results cannot
        // depend on whether the native library is available.
        while (p < end && *p != '\n' && nfields < 3) {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
            if (p >= end || *p == '\n') break;
            bool neg = false;
            if (*p == '-') { neg = true; ++p; }
            else if (*p == '+') { ++p; }
            int64_t v = 0;
            bool digits = false;
            while (p < end && *p >= '0' && *p <= '9') {
                v = v * 10 + (*p - '0');
                ++p;
                digits = true;
            }
            if (!digits || (p < end && *p != ' ' && *p != '\t' &&
                            *p != '\n' && *p != '\r')) {
                // malformed token among the first three: drop the line
                nfields = -1;
                break;
            }
            fields[nfields] = neg ? -v : v;
            ++nfields;
        }
        while (p < end && *p != '\n') ++p;  // discard the rest of the line
        if (nfields >= 2) {
            src[count] = fields[0];
            dst[count] = fields[1];
            ts[count] = fields[2];
            ++count;
        }
    }
    return count;
}

// ---------------------------------------------------------------------
// Tumbling-window assignment: wstart[i] = ts[i] - ts[i] % size
// (Flink TimeWindow semantics; SimpleEdgeStream.java:159-167).
// ---------------------------------------------------------------------
void gs_assign_windows(const int64_t* ts, int64_t n, int64_t size,
                       int64_t* wstart) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t t = ts[i];
        int64_t w = t % size;
        if (w < 0) w += size;  // floor semantics for negative timestamps
        wstart[i] = t - w;
    }
}

// ---------------------------------------------------------------------
// Incremental interner: stable dense slots for int64 vertex ids
// (SURVEY.md §7 "vertex-id interning at stream rate").
// ---------------------------------------------------------------------
struct GsInterner {
    std::unordered_map<int64_t, int32_t> to_dense;
    std::vector<int64_t> to_id;
};

void* gs_interner_new() { return new GsInterner(); }

void gs_interner_free(void* h) { delete static_cast<GsInterner*>(h); }

int64_t gs_interner_size(void* h) {
    return static_cast<int64_t>(static_cast<GsInterner*>(h)->to_id.size());
}

void gs_interner_intern(void* h, const int64_t* ids, int64_t n,
                        int32_t* out) {
    auto* interner = static_cast<GsInterner*>(h);
    for (int64_t i = 0; i < n; ++i) {
        auto it = interner->to_dense.find(ids[i]);
        if (it == interner->to_dense.end()) {
            int32_t slot = static_cast<int32_t>(interner->to_id.size());
            interner->to_dense.emplace(ids[i], slot);
            interner->to_id.push_back(ids[i]);
            out[i] = slot;
        } else {
            out[i] = it->second;
        }
    }
}

// dense slot -> original id (bulk)
void gs_interner_lookup(void* h, const int32_t* dense, int64_t n,
                        int64_t* out) {
    auto* interner = static_cast<GsInterner*>(h);
    for (int64_t i = 0; i < n; ++i) out[i] = interner->to_id[dense[i]];
}

// ---------------------------------------------------------------------
// Exact window triangle count — the native tier of the streaming
// counter (ops/triangles._resolve_stream_impl "native").
//
// Same counting invariant as the device kernel (ops/triangles.py
// build_window_counter) and the numpy tier (ops/host_triangles.py):
// drop self-loops, undirect + dedupe, orient each edge
// low(deg, id) -> high(deg, id), count every triangle once — at its
// min-rank edge, by two-pointer intersection of the endpoints' sorted
// out-neighbor lists ("compact forward": per-source out-degree is
// O(sqrt E) after orientation, so the scan is O(E^1.5) worst case with
// cache-friendly constant factors a single-core numpy pipeline cannot
// reach (no temporary wedge materialization, no log-factor probes).
// ---------------------------------------------------------------------
namespace {

// LSD radix sort for the window's packed (a*v + b) edge keys: the two
// key sorts dominate count_one_window at bench window sizes, and a
// counting radix over 11-bit digits beats std::sort's branchy
// comparisons ~3-4x on 32K random uint64s. Pass count adapts to the
// actual key range (v^2), so small id spaces pay 2-3 passes.
static void radix_sort_keys(std::vector<uint64_t>& a,
                            std::vector<uint64_t>& tmp,
                            uint64_t max_key) {
    constexpr int B = 11, R = 1 << B;
    if (a.size() < 2048) {  // small windows: std::sort wins
        std::sort(a.begin(), a.end());
        return;
    }
    int passes = 1;
    while (passes * B < 64 && (max_key >> (uint64_t(passes) * B)))
        ++passes;
    tmp.resize(a.size());
    int64_t cnt[R];
    uint64_t shift = 0;
    for (int p = 0; p < passes; ++p, shift += B) {
        std::fill(cnt, cnt + R, 0);
        for (uint64_t x : a) ++cnt[(x >> shift) & (R - 1)];
        int64_t run = 0;
        for (int i = 0; i < R; ++i) {
            int64_t c = cnt[i];
            cnt[i] = run;
            run += c;
        }
        for (uint64_t x : a) tmp[cnt[(x >> shift) & (R - 1)]++] = x;
        a.swap(tmp);
    }
}

int64_t count_one_window(const int64_t* src, const int64_t* dst,
                         int64_t n, std::vector<int64_t>& scratch_ids,
                         std::vector<uint64_t>& keys,
                         std::vector<int32_t>& deg,
                         std::vector<int64_t>& starts,
                         std::vector<uint64_t>& radix_tmp) {
    if (n <= 2) return 0;
    // id space: ids that are already small non-negative ints (every
    // interned stream; the bench's generated streams) index arrays
    // directly — no compression pass. Arbitrary/huge ids fall back to
    // sort-unique + binary-search compression.
    int64_t max_id = -1;
    bool direct = true;
    for (int64_t i = 0; i < n; ++i) {
        if (src[i] < 0 || dst[i] < 0) { direct = false; break; }
        if (src[i] > max_id) max_id = src[i];
        if (dst[i] > max_id) max_id = dst[i];
    }
    // direct indexing allocates O(max_id) scratch per call: only worth
    // it when the id space is within a small factor of the edge count
    if (max_id >= (int64_t(1) << 22) || max_id > 16 * n) direct = false;
    uint64_t v;
    keys.clear();
    keys.reserve(n);
    if (direct) {
        v = static_cast<uint64_t>(max_id) + 1;
        for (int64_t i = 0; i < n; ++i) {
            if (src[i] == dst[i]) continue;  // self-loop
            uint64_t a = static_cast<uint64_t>(src[i]);
            uint64_t b = static_cast<uint64_t>(dst[i]);
            if (a > b) std::swap(a, b);
            keys.push_back(a * v + b);
        }
        if (keys.empty()) return 0;
    } else {
        // local dense ids: sort-unique of all endpoints
        scratch_ids.clear();
        scratch_ids.reserve(2 * n);
        for (int64_t i = 0; i < n; ++i) {
            if (src[i] == dst[i]) continue;  // self-loop
            scratch_ids.push_back(src[i]);
            scratch_ids.push_back(dst[i]);
        }
        if (scratch_ids.empty()) return 0;
        std::sort(scratch_ids.begin(), scratch_ids.end());
        scratch_ids.erase(
            std::unique(scratch_ids.begin(), scratch_ids.end()),
            scratch_ids.end());
        v = scratch_ids.size();
        auto dense = [&](int64_t id) -> uint64_t {
            return static_cast<uint64_t>(
                std::lower_bound(scratch_ids.begin(), scratch_ids.end(),
                                 id)
                - scratch_ids.begin());
        };
        for (int64_t i = 0; i < n; ++i) {
            if (src[i] == dst[i]) continue;
            uint64_t a = dense(src[i]), b = dense(dst[i]);
            if (a > b) std::swap(a, b);
            keys.push_back(a * v + b);
        }
    }
    radix_sort_keys(keys, radix_tmp, v * v - 1);
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
    const int64_t e = static_cast<int64_t>(keys.size());

    // degrees over the deduped undirected edges
    deg.assign(v, 0);
    for (int64_t i = 0; i < e; ++i) {
        ++deg[keys[i] / v];
        ++deg[keys[i] % v];
    }

    // orient by (degree, id) and re-sort by (a, b): out-adjacency
    // lists come out sorted, ready for two-pointer intersection
    for (int64_t i = 0; i < e; ++i) {
        uint64_t lo = keys[i] / v, hi = keys[i] % v;
        if (deg[lo] > deg[hi] || (deg[lo] == deg[hi] && lo > hi))
            std::swap(lo, hi);
        keys[i] = lo * v + hi;
    }
    radix_sort_keys(keys, radix_tmp, v * v - 1);

    // CSR starts of the oriented lists
    starts.assign(v + 1, 0);
    for (int64_t i = 0; i < e; ++i) ++starts[keys[i] / v + 1];
    for (uint64_t u = 0; u < v; ++u) starts[u + 1] += starts[u];

    // for each oriented edge (a, b): |N_out(a) ∩ N_out(b)|
    int64_t count = 0;
    for (int64_t i = 0; i < e; ++i) {
        const uint64_t a = keys[i] / v, b = keys[i] % v;
        int64_t pa = starts[a], ea = starts[a + 1];
        int64_t pb = starts[b], eb2 = starts[b + 1];
        while (pa < ea && pb < eb2) {
            const uint64_t xa = keys[pa] % v, xb = keys[pb] % v;
            if (xa == xb) { ++count; ++pa; ++pb; }
            else if (xa < xb) ++pa;
            else ++pb;
        }
    }
    return count;
}

}  // namespace

// ---------------------------------------------------------------------
// Windowed edge reduce — the native tier of ops/windowed_reduce.py
// (BASELINE config #2: reduceOnEdges over tumbling count windows,
// reference hot loop GraphWindowStream.java:101-121).
//
// One fused pass: for every edge, fold its value into the (window,
// vertex) cell of the chosen endpoint(s) and bump the cell's count —
// the two outputs the engine's contract requires, produced in a single
// cache-resident loop (the numpy tier pays two full bincount passes
// plus flattened cell-id materialization).
//
// op: 0 = sum, 1 = min, 2 = max.  direction: 0 = out (src), 1 = in
// (dst), 2 = all (both endpoints).  cells/counts are [num_w, vbp]
// row-major, cells pre-filled by the CALLER with the monoid identity
// (counts with 0); vertex ids must lie in [0, vbp).
// ---------------------------------------------------------------------
}  // extern "C" (templates need C++ linkage; reopened below)

namespace {

template <int OP, bool SRC, bool DST, typename ID, typename VAL,
          typename OUT>
int64_t reduce_loop(const ID* src, const ID* dst, const VAL* val,
                    int64_t n, int64_t eb, int64_t vbp, OUT* cells,
                    OUT* counts) {
    int64_t oob = 0;   // out-of-range ids: counted, never written
    for (int64_t lo = 0, w = 0; lo < n; lo += eb, ++w) {
        const int64_t hi = (n - lo < eb) ? n : lo + eb;
        OUT* wc = cells + w * vbp;
        OUT* wn = counts + w * vbp;
        for (int64_t i = lo; i < hi; ++i) {
            const OUT v = static_cast<OUT>(val[i]);
            if (SRC) {
                // unsigned compare rejects negatives too
                if (static_cast<uint64_t>(src[i])
                        >= static_cast<uint64_t>(vbp)) { ++oob; }
                else {
                    OUT* c = wc + src[i];
                    if (OP == 0) *c += v;
                    else if (OP == 1) { if (v < *c) *c = v; }
                    else { if (v > *c) *c = v; }
                    ++wn[src[i]];
                }
            }
            if (DST) {
                if (static_cast<uint64_t>(dst[i])
                        >= static_cast<uint64_t>(vbp)) { ++oob; }
                else {
                    OUT* c = wc + dst[i];
                    if (OP == 0) *c += v;
                    else if (OP == 1) { if (v < *c) *c = v; }
                    else { if (v > *c) *c = v; }
                    ++wn[dst[i]];
                }
            }
        }
    }
    return oob;
}

template <typename ID, typename VAL, typename OUT>
int64_t reduce_dispatch(const ID* src, const ID* dst, const VAL* val,
                        int64_t n, int64_t eb, int64_t vbp, int32_t op,
                        int32_t direction, OUT* cells, OUT* counts) {
    using Fn = int64_t (*)(const ID*, const ID*, const VAL*, int64_t,
                           int64_t, int64_t, OUT*, OUT*);
    static const Fn table[3][3] = {
        {reduce_loop<0, true, false, ID, VAL, OUT>,
         reduce_loop<0, false, true, ID, VAL, OUT>,
         reduce_loop<0, true, true, ID, VAL, OUT>},
        {reduce_loop<1, true, false, ID, VAL, OUT>,
         reduce_loop<1, false, true, ID, VAL, OUT>,
         reduce_loop<1, true, true, ID, VAL, OUT>},
        {reduce_loop<2, true, false, ID, VAL, OUT>,
         reduce_loop<2, false, true, ID, VAL, OUT>,
         reduce_loop<2, true, true, ID, VAL, OUT>},
    };
    return table[op][direction](src, dst, val, n, eb, vbp, cells,
                                counts);
}

}  // namespace

extern "C" {

// Returns the number of out-of-range vertex ids encountered (the
// Python wrapper raises when nonzero — other tiers fail loudly on bad
// ids, this one must never scribble outside its slabs). op and
// endpoint selection are hoisted into compile-time specializations
// (the generic form's per-edge division + branches halved throughput).
int64_t gs_windowed_reduce(const int64_t* src, const int64_t* dst,
                           const int64_t* val, int64_t n, int64_t eb,
                           int64_t vbp, int32_t op, int32_t direction,
                           int64_t* cells, int64_t* counts) {
    return reduce_dispatch(src, dst, val, n, eb, vbp, op, direction,
                           cells, counts);
}

// int32 ids + values form: no up-conversion copies on the Python side
// (interned slots and typical weights are int32; accumulation is
// int64 either way)
int64_t gs_windowed_reduce_i32(const int32_t* src, const int32_t* dst,
                               const int32_t* val, int64_t n,
                               int64_t eb, int64_t vbp, int32_t op,
                               int32_t direction, int64_t* cells,
                               int64_t* counts) {
    return reduce_dispatch(src, dst, val, n, eb, vbp, op, direction,
                           cells, counts);
}

// All-int32 form: int32 output slabs halve the faulted/written output
// bytes and drop the Python-side astype copy entirely. Only safe when
// the caller proves the worst-case cell sum fits int32 (the wrapper's
// overflow bound, mirroring the numpy tier's exact_bincount guard) —
// min/max outputs are input values, always safe for int32 inputs.
int64_t gs_windowed_reduce_i32o(const int32_t* src, const int32_t* dst,
                                const int32_t* val, int64_t n,
                                int64_t eb, int64_t vbp, int32_t op,
                                int32_t direction, int32_t* cells,
                                int32_t* counts) {
    return reduce_dispatch(src, dst, val, n, eb, vbp, op, direction,
                           cells, counts);
}

// int64 ids + int32 values/outputs: the common bench/driver shape when
// ids arrive un-interned (int64) — avoids both the caller-side id
// downcast (two full min/max scans + casts) and the int64 output
// slabs. Out-of-range ids (including any beyond int32) hit the
// unsigned bound check and are reported, never wrapped.
int64_t gs_windowed_reduce_i64i32o(const int64_t* src,
                                   const int64_t* dst,
                                   const int32_t* val, int64_t n,
                                   int64_t eb, int64_t vbp, int32_t op,
                                   int32_t direction, int32_t* cells,
                                   int32_t* counts) {
    return reduce_dispatch(src, dst, val, n, eb, vbp, op, direction,
                           cells, counts);
}

// ---------------------------------------------------------------------
// Carried-state windowed snapshot analytics: degrees + connected-
// component labels + bipartite double cover over tumbling eb-sized
// windows, per-window snapshot rows written into caller buffers.
//
// Host tier of the driver's batched snapshot scan (core/driver.py
// _run_batched): the reference computes these in Flink operators
// (SURVEY.md §2.2-2.3); on a CPU fallback a carried union-find beats
// re-running the XLA fixpoint scan. Semantics parity with the device
// path: labels converge to the component's MINIMUM member id (union
// attaches the larger root beneath the smaller), the double cover
// joins (u,+)-(w,-) and (u,-)-(w,+) at offset `vb`, and degree state
// is int32 like the device carry. Carried arrays use the SAME layout
// as the driver's host mirrors, so checkpoints stay interchangeable
// between tiers.
// ---------------------------------------------------------------------
static inline int32_t snap_find(int32_t* p, int32_t x) {
    int32_t r = x;
    while (p[r] != r) r = p[r];
    while (p[x] != r) {  // path compression
        int32_t nxt = p[x];
        p[x] = r;
        x = nxt;
    }
    return r;
}

static inline void snap_union(int32_t* p, int32_t a, int32_t b) {
    int32_t ra = snap_find(p, a), rb = snap_find(p, b);
    if (ra == rb) return;
    if (ra < rb) p[rb] = ra; else p[ra] = rb;  // min-id root
}

// flags: bit0 degrees, bit1 cc, bit2 bipartite. Buffers for disabled
// analytics may be null. Windows are [offsets[w], offsets[w+1])
// slices of the flat COO arrays (varying lengths — the driver's
// event-time windows). Snapshot rows: out_deg/out_cc [num_w, vb],
// out_cov [num_w, 2*vb]. Returns the number of windows written.
int64_t gs_snapshot_windows(const int32_t* src, const int32_t* dst,
                            const int64_t* offsets, int64_t num_w,
                            int64_t vb, int32_t flags,
                            int32_t* deg, int32_t* cc, int32_t* cov,
                            int32_t* out_deg, int32_t* out_cc,
                            int32_t* out_cov) {
    const bool want_deg = flags & 1, want_cc = flags & 2,
               want_cov = flags & 4;
    int64_t w = 0;
    for (; w < num_w; ++w) {
        for (int64_t i = offsets[w]; i < offsets[w + 1]; ++i) {
            const int32_t s = src[i], d = dst[i];
            if (want_deg) { ++deg[s]; ++deg[d]; }
            if (want_cc) snap_union(cc, s, d);
            if (want_cov) {
                snap_union(cov, s, (int32_t)(d + vb));
                snap_union(cov, (int32_t)(s + vb), d);
            }
        }
        if (want_deg)
            std::memcpy(out_deg + w * vb, deg, vb * sizeof(int32_t));
        if (want_cc) {
            for (int64_t v = 0; v < vb; ++v)
                cc[v] = snap_find(cc, (int32_t)v);  // flatten = snapshot
            std::memcpy(out_cc + w * vb, cc, vb * sizeof(int32_t));
        }
        if (want_cov) {
            for (int64_t v = 0; v < 2 * vb; ++v)
                cov[v] = snap_find(cov, (int32_t)v);
            std::memcpy(out_cov + w * 2 * vb, cov,
                        2 * vb * sizeof(int32_t));
        }
    }
    return w;
}

// counts[w] = exact triangle count of the w-th tumbling eb-sized
// window of the stream (the trailing window may be shorter); returns
// the number of windows written.
int64_t gs_triangle_count_stream(const int64_t* src, const int64_t* dst,
                                 int64_t n, int64_t eb,
                                 int64_t* counts) {
    std::vector<int64_t> ids;
    std::vector<uint64_t> keys;
    std::vector<int32_t> deg;
    std::vector<int64_t> starts;
    std::vector<uint64_t> radix_tmp;
    int64_t w = 0;
    for (int64_t at = 0; at < n; at += eb, ++w) {
        const int64_t len = (n - at < eb) ? (n - at) : eb;
        counts[w] = count_one_window(src + at, dst + at, len, ids, keys,
                                     deg, starts, radix_tmp);
    }
    return w;
}

}  // extern "C"
