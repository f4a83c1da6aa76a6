"""The sharded engines: a window's edges split over the ranks of a mesh,
the partial results merged with collectives.

Port of the JAX package's `parallel/sharded.py` onto `torch.distributed`
(parallel/mesh.py). The parallelism strategies are the JAX package's:

- P1: a window's COO batch is split along the edge axis, each rank
  holding one contiguous slice; per-vertex grouping happens in dense
  vertex space, so no regrouping is needed;
- P2: per-shard partials merge with an all_reduce (SUM for degrees,
  counts and intersection partials; MIN for the label exchange of the
  union-find; MAX for the neighbor table);
- P3: vertex state (degrees, labels, the neighbor table) is replicated.

The execution model is SPMD, one process a rank: every rank makes the
same call with the same host arrays, stages only its own slice of the
edge axis, and returns the same replicated answer. JAX folds a whole
chunk into one program per dispatch; here each window is a sequence of
PyTorch calls and collectives on the rank's device, and the local work
runs on the port's kernels (their plain versions on the CPU):

- row 1 (ops/intersect.py `intersect_local`, the compare form: a row of
  the table is a concatenation of sorted per-shard runs) for every
  window's intersection partials, in both table modes;
- row U (ops/unionfind.py `cc_fixpoint` with `exchange=`: one union-find
  launch a round from the replicated labels, then the MIN) for every
  label fixpoint;
- row R (ops/cell_reduce.py `cell_reduce`, one launch a shard) for the
  monoid pane partials of `sliding_reduce`.

The window counter (`build_sharded_window_counter`) keeps the JAX body:
degrees (SUM), orientation, the owner hash of each oriented edge in
uint32 arithmetic (emulated in int64, bit for bit), a sort by (owner, a,
b) as one int64 key, an all_to_all of the owned edges, a local dedupe,
then the neighbor rows: "replicated" (each rank writes its kb/n column
slice of a [vb+1, kb] table, one MAX) or "owner" (an all_gather of the
row ids the owned edges touch and an all_to_all of the column slices).
`table=` pins the mode; None is `resolve_table_mode(device)` (the JAX
package's :378-428): "owner" only where the device's `sharded_table` row
(utils/evidence.py), measured on a device of that name (its `backend`),
shows `counts_match` and the owner rate at 1.05× the replicated one,
else "replicated". K where `k_bucket=0` is ops/triangles._tuned_kb.

Hooks: every sharded dispatch fires `shard_dispatch`, every copy back of
replicated outputs `shard_gather`, every mesh-bound stack `shard_wire`
(utils/faults.py); GS_MESH_WIRE_CHECK=1 range-checks each shard's slice
(`guard_wire`) on every rank, so a corrupt shard is refused by all ranks
alike. With the stage guard armed, a dispatch's and a gather's firing is
retried on a host-side failure, on the caller's thread (no deadline
thread that could launch after it was abandoned), and surfaces as a
typed StageFailed once the attempts are spent; the triangle stream
checks its wire in the pipeline's prep, so a corrupt wire is retried as
a prep. A kernel, CUDA or collective error passes through unretried
(utils/resilience.py). Nothing leaves the card.

`make_sharded_snapshot_scan` is the driver's mesh branch
(core/driver.py `mesh=`): the carried degrees, labels and cover of every
window of a chunk, one SUM of the chunk's degree partials, each fixpoint
on row U with its MIN exchange every round.

Not ported: `ICI_GBPS` and `ici_time_model` (TPU v5e link figures).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import ingress_pipeline, unionfind
from ..ops import segment as seg_ops
from ..ops.cell_reduce import cell_reduce
from ..ops.intersect import intersect_local
from ..ops.neighborhood import (assoc_window_combine, masked_combine,
                                window_stack_combine)
from ..ops.scan_analytics import SummaryEngineBase, check_summary_carry
from ..ops.staging import ChunkStager, HostCopy
from ..ops.triangles import _tuned_kb, triangle_count_sparse
from ..ops.window_counter import dedupe_and_positions, orient_by_degree
from ..ops.window_summary import fresh_carry
from ..utils import evidence, faults, metrics, resilience, telemetry
from .mesh import (Mesh, make_mesh, mesh_padded_len, pad_edges_for_mesh,
                   shard_count)

TABLE_MODES = ("replicated", "owner")
_M32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# the table mode (measured adoption)
# ----------------------------------------------------------------------
def _reset_table_mode() -> None:
    """Test hook: forget the memoized table-mode selections."""
    evidence.forget("sharded_table")


def resolve_table_mode(device=None) -> str:
    """The neighbor-row mode of a sharded counter given none: "owner"
    where the device's `sharded_table` row was measured on a device of
    the same name and shows `counts_match` and the owner rate at 1.05×
    the replicated one (on a card, in the worst turns of its `rows`);
    else "replicated". Memoized per device."""

    def gate(perf, label):
        row = perf.get("sharded_table", {})
        if row.get("backend") != label:
            return "replicated"
        if evidence.on_card(label):
            won = evidence.worst_clears_bar(
                row.get("rows"), "owner", "replicated",
                parity_key="counts_match") and row.get("counts_match") is True
        else:
            owner = row.get("owner_edges_per_s") or 0
            repl = row.get("replicated_edges_per_s") or 0
            won = (row.get("counts_match") is True and owner and repl
                   and owner >= 1.05 * repl)
        return "owner" if won else "replicated"

    return evidence.choose("sharded_table", device, gate, "replicated")


# ----------------------------------------------------------------------
# mesh fault hooks and the wire guard
# ----------------------------------------------------------------------

def fire_shard_dispatch(n_shards: int) -> None:
    """Fault hook before a sharded dispatch: one firing a dispatch, not
    a shard (a dead rank fails the whole collective; a plan names the
    shard it models through FaultSpec.shard)."""
    faults.fire("shard_dispatch", n_shards)


def fire_shard_gather(n_shards: int) -> None:
    """Fault hook before the copy back of replicated sharded outputs
    (window stacks, engine state)."""
    faults.fire("shard_gather", n_shards)


def guard_wire(arrays, n_shards: int, limit: int):
    """The mesh h2d wire hook: the host arrays through the fault plan
    (a `shard_wire` spec may corrupt one shard's slice) and, with
    GS_MESH_WIRE_CHECK=1, every shard's slice range-checked against
    `limit` (the bucket sentinel, the largest id an honest stack holds).
    Every rank holds the whole arrays and checks every slice, so every
    rank refuses a corrupt wire alike. Returns the (possibly
    transformed) arrays; raises RuntimeError naming the shard."""
    payload = faults.fire("shard_wire", (tuple(arrays), n_shards))
    if isinstance(payload, tuple) and len(payload) == 2:
        arrays = payload[0]
    if resilience.mesh_wire_check_enabled():
        _check_wire(arrays, n_shards, limit)
    return arrays


def _check_wire(arrays, n_shards: int, limit: int) -> None:
    """Range-check each shard's slice of the mesh-bound stacks: an
    integer id above `limit` is a corrupt wire."""
    for a in arrays:
        a = np.asarray(a)
        if not np.issubdtype(a.dtype, np.integer) or not a.size:
            continue
        width = a.shape[-1] // n_shards
        if not width:
            continue
        for k in range(n_shards):
            sl = a[..., k * width:(k + 1) * width]
            if sl.size and int(sl.max()) > limit:
                raise RuntimeError(
                    "corrupt shard wire: shard %d of %d carries vertex"
                    " id %d > bucket sentinel %d (GS_MESH_WIRE_CHECK)"
                    % (k, n_shards, int(sl.max()), limit))


def _guarded_dispatch(chunk, fn, stage: str = "dispatch"):
    """One pure sharded dispatch (its state rebinds on success only), or
    a fault site's firing: under the stage guard's retry when the knobs
    arm it, on this thread with no deadline; the bare call otherwise.
    Device errors and fatal faults pass through
    (resilience.call_guarded)."""
    if resilience.guard_active():
        return resilience.call_guarded(stage, chunk, fn, timeout=0)
    return fn()


def _require_member(mesh: Mesh) -> None:
    if not mesh.member:
        raise ValueError("this process (rank %d of the world) is not in "
                         "the mesh %s" % (torch.distributed.get_rank(),
                                          mesh.shape))


def _int32_local(mesh: Mesh, a) -> torch.Tensor:
    return mesh.put(mesh.local(np.asarray(a, np.int32)))


# ----------------------------------------------------------------------
# the per-window builders
# ----------------------------------------------------------------------

def make_sharded_degree_fn(mesh: Mesh, num_vertices_bucket: int):
    """fn(src, dst, counts) -> counts': src/dst this rank's slice of a
    window (tensors on the rank's device), counts the replicated running
    [vb+2] degree vector (vb+1 the padding sentinel). Returns a new
    tensor."""
    size = num_vertices_bucket + 2

    def step(src, dst, counts):
        ones = torch.ones(src.shape, dtype=torch.int32, device=src.device)
        local = (seg_ops.segment_reduce(ones, src, size)
                 + seg_ops.segment_reduce(ones, dst, size))
        return counts + mesh.all_reduce(local, "sum")

    return step


def make_sharded_cc_fn(mesh: Mesh, num_vertices_bucket: int):
    """fn(src, dst, labels) -> labels': the min-label fixpoint of the
    replicated [vb+2] labels folded with every rank's slice of the edges
    (the MIN exchange of ops/unionfind.cc_fixpoint each round). Pass the
    identity for a fresh window or the previous labels to carry."""
    n = num_vertices_bucket + 2

    def exchange(lab):
        return mesh.all_reduce(lab, "min")

    def step(src, dst, labels):
        assert labels.shape[0] == n, labels.shape
        return unionfind.cc_fixpoint(labels, src.to(torch.int32),
                                     dst.to(torch.int32), exchange=exchange)

    return step


def make_sharded_triangle_fn(mesh: Mesh):
    """fn(nbr, ea, eb, emask) -> count: the replicated neighbor table
    [V+1, K] and this rank's slice of the oriented edges; each rank's
    intersection partial (row 1) merged with one SUM. Returns a 0-dim
    int32 tensor."""

    def step(nbr, ea, eb, emask):
        local = intersect_local(nbr, ea, eb, emask).reshape(1)
        return mesh.all_reduce(local.clone(), "sum")[0]

    return step


def make_sharded_pane_reduce(mesh: Mesh, vertex_bucket: int,
                             pane_bucket: int, panes_per_window: int,
                             name: str = None, fn=None):
    """The sliding-window reduce over the mesh (the sharded form of the
    single-chip pane path, ops/neighborhood.py `_make_pane_reduce`):
    each rank reduces its slice of the edges over the flattened
    (pane, vertex) cells, the partials merge across the mesh, and each
    window combines panes_per_window shifted pane rows.

    Two tiers, as in the JAX package:
    - `name` ("sum", "min", "max"): one cell-reduce launch a shard (row
      R: wb=1, pb·(vb+1) cells, ops/neighborhood._monoid_cells' form),
      one all_reduce of the cells and one of the counts, then
      `window_stack_combine`;
    - `fn` (an fn declared associative, over tensors): the flagged
      associative scan a shard (ops/segment.segmented_reduce_associative),
      an all_gather of the cells and their presence, the presence-masked
      left fold in shard order (= edge order: the edge axis splits
      contiguously), then `assoc_window_combine`. Counts are real edge
      counts in both tiers (one SUM).

    Returns fn(src, pane, val, valid) -> (win_vals, win_counts), tensors
    [pane_bucket + panes_per_window - 1, vertex_bucket + 1] on the rank's
    device, over this rank's slice of the edge arrays (host arrays); a
    (window, vertex) cell is meaningful iff win_counts > 0. Window w
    covers dense panes [w - panes_per_window + 1, w]."""
    assert (name is None) != (fn is None)
    assert name in (None, "sum", "min", "max"), name
    vbp = vertex_bucket + 1
    pb = pane_bucket
    wp = panes_per_window
    n_cells = pb * vbp
    dev = mesh.device

    def cell_ids(src, pane, valid):
        ids = np.asarray(pane, np.int64) * vbp + np.asarray(src, np.int64)
        return np.where(np.asarray(valid, bool), ids, n_cells)

    if name is not None:
        def run(src, pane, val, valid):
            ids = mesh.put(cell_ids(src, pane, valid).astype(np.int32))
            vals = mesh.put(seg_ops.x64_off_values(val))
            cells, counts = cell_reduce(ids, vals, 1, ids.shape[0],
                                        n_cells, name)
            mesh.all_reduce(cells, name)
            mesh.all_reduce(counts, "sum")
            return window_stack_combine(cells.reshape(pb, vbp),
                                        counts.reshape(pb, vbp), wp, name)

        return run

    def run_assoc(src, pane, val, valid):
        ids = cell_ids(src, pane, valid)
        counts = mesh.put(np.bincount(ids, minlength=n_cells + 1)[:-1]
                          .astype(np.int32))
        mesh.all_reduce(counts, "sum")
        order = np.argsort(ids, kind="stable")
        cells, present = seg_ops.segmented_reduce_associative(
            fn, ids[order], np.asarray(val)[order], n_cells, dev)
        allc = mesh.all_gather(mesh.put(cells))
        allp = mesh.all_gather(mesh.put(present.astype(np.int32))).bool()
        accv, accp = allc[0], allp[0]
        for k in range(1, mesh.size):
            accv, accp = masked_combine(fn, accv, accp, allc[k], allp[k])
        return assoc_window_combine(fn, wp, accv.reshape(pb, vbp),
                                    counts.reshape(pb, vbp))

    return run_assoc


# ----------------------------------------------------------------------
# the window triangle counter (P1 + all_to_all + MAX + SUM)
# ----------------------------------------------------------------------

def window_collective_bytes(n: int, vb: int, kb: int, cap: int,
                            table: str = "replicated") -> dict:
    """Bytes each rank moves a window in every collective of
    build_sharded_window_counter (exact: the shapes are static). Ring
    all-reduces move 2·(n-1)/n of the payload a rank; all_gather and
    all_to_all (n-1)/n of the gathered or exchanged buffer. The edge
    bucket enters through `cap`, the exchange capacity a pair of
    ranks."""
    assert table in TABLE_MODES, table
    i32 = 4
    f = (n - 1) / n if n > 1 else 0.0
    m = n * cap   # owned-edge slots a rank after the exchange
    out = {
        "psum_degrees": 2 * f * (vb + 1) * i32,
        "all_to_all_pairs": 2 * f * m * i32,          # a and b
        "psum_count_and_overflow": 2 * f * 3 * i32,
    }
    if table == "replicated":
        out["pmax_table"] = 2 * f * (vb + 1) * kb * i32
    else:
        out["all_gather_row_ids"] = f * n * 2 * m * i32
        out["all_to_all_row_slices"] = f * 2 * m * kb * i32
    out["total"] = sum(out.values())
    return out


def build_sharded_window_counter(mesh: Mesh, eb: int, vb: int, kb: int,
                                 cap: int, table: str = "replicated"):
    """The per-shard one-window body: step(src, dst, valid) over this
    rank's [eb/n] slice (tensors on its device) -> an int32 [3] tensor
    (count, bucket_overflow, k_overflow), the same on every rank.

    Collectives: degrees (SUM) for the orientation; an all_to_all that
    sends each oriented edge (a, b) to its owner, the rank of a
    multiplicative pair hash, so the duplicates of an edge meet on one
    rank and each distinct edge is counted once; the neighbor rows
    (`table`, module docstring); a SUM of (count, overflows). A pair
    bucket past `cap` edges raises bucket_overflow, a row past its kb/n
    columns k_overflow; the caller widens what overflowed. Where both
    are 0 the count is exact, and it equals the JAX body's bit for bit
    in every case."""
    n = mesh.size
    assert table in TABLE_MODES, table
    if eb % n or kb % n:
        raise ValueError("eb=%d and kb=%d must split over %d ranks"
                         % (eb, kb, n))
    sent = vb
    kslice = kb // n
    me = mesh.rank
    m = n * cap

    def step(src, dst, valid):
        dev = src.device
        el = src.shape[0]
        # ---- clean: drop self-loops and padding
        valid = valid & (src != dst)
        s = torch.where(valid, src, sent)
        d = torch.where(valid, dst, sent)
        # ---- global degrees for the orientation
        ones = valid.to(torch.int32)
        deg = torch.zeros(vb + 1, dtype=torch.int32, device=dev)
        deg.index_add_(0, s, ones).index_add_(0, d, ones)
        mesh.all_reduce(deg, "sum")
        a, b = orient_by_degree(s, d, deg)
        a, b = a.long(), b.long()
        # ---- the owner: the JAX package's uint32 pair hash, each
        # product and the sum wrapped at 2^32
        h = (((a * 0x9E3779B1) & _M32) + ((b * 0x85EBCA77) & _M32)) & _M32
        owner = torch.where(a < sent, (h >> 8) % n, n)  # padding last
        # ---- bucket by owner: one sort of (owner, a, b), the position
        # of each edge within its owner's run
        key, _ = torch.sort((owner * (vb + 1) + a) * (vb + 1) + b)
        owner = torch.div(key, (vb + 1) * (vb + 1), rounding_mode="floor")
        a = torch.div(key, vb + 1, rounding_mode="floor") % (vb + 1)
        b = key % (vb + 1)
        pos = torch.arange(el, device=dev) - torch.searchsorted(owner, owner)
        real = a < sent
        ok = real & (pos < cap)
        bucket_overflow = (real & (pos >= cap)).sum()
        slot = torch.where(ok, owner * cap + pos.clamp(0, cap - 1), m)
        send = torch.full((2, m + 1), sent, dtype=torch.int32, device=dev)
        send[:, slot] = torch.stack([a, b]).to(torch.int32)
        # ---- the pair exchange: [n, 2, cap], chunk j to rank j
        recv = mesh.all_to_all(
            send[:, :m].reshape(2, n, cap).permute(1, 0, 2))
        ra, rb, rvalid, pos2 = dedupe_and_positions(
            recv[:, 0].reshape(m), recv[:, 1].reshape(m), sent, vb)
        k_overflow = ((pos2 >= kslice) & rvalid).sum()
        ok2 = rvalid & (pos2 < kslice)
        rows = torch.where(ok2, ra, vb).long()
        cols = pos2.clamp(0, kslice - 1)
        vals = torch.where(ok2, rb, -1)
        if table == "replicated":
            # ---- each rank's kb/n column slice, merged by one MAX
            nbr = torch.full((vb + 1, kb), -1, dtype=torch.int32,
                             device=dev)
            nbr[rows, me * kslice + cols] = vals
            mesh.all_reduce(nbr, "max")
            nbr = torch.where(nbr < 0, sent, nbr)
            local = intersect_local(nbr, ra, rb, rvalid)
        else:
            # ---- only the rows the owned edges touch: the requests are
            # aligned to owned-edge slots (ra then rb), so the returned
            # rows index per edge
            tab = torch.full((vb + 1, kslice), -1, dtype=torch.int32,
                             device=dev)
            tab[rows, cols] = vals
            req = mesh.all_gather(torch.cat([ra, rb]))     # [n, 2m]
            got = mesh.all_to_all(tab[req.long()])          # [n, 2m, kb/n]
            # columns shard-major, as the replicated table's rows
            pairs = got.permute(1, 0, 2).reshape(2 * m, kb)
            pairs = torch.cat([torch.where(pairs < 0, sent, pairs),
                               torch.full((1, kb), sent, dtype=torch.int32,
                                          device=dev)])
            at = torch.arange(m, dtype=torch.int32, device=dev)
            local = intersect_local(pairs, at, at + m, rvalid,
                                    sentinel=sent)
        out = torch.stack([local.reshape(()).to(torch.int32),
                           bucket_overflow.to(torch.int32),
                           k_overflow.to(torch.int32)])
        return mesh.all_reduce(out, "sum")

    return step


def make_sharded_window_triangle_fn(mesh: Mesh, eb: int, vb: int, kb: int,
                                    cap: int, table: str = "replicated"):
    """fn(src, dst, valid) -> int32 [3] (count, bucket_overflow,
    k_overflow): the whole window triangle body over one window's host
    arrays [eb], the same on every rank; each rank stages its slice and
    runs `build_sharded_window_counter`."""
    step = build_sharded_window_counter(mesh, eb, vb, kb, cap, table)

    def run(src, dst, valid):
        return step(_int32_local(mesh, src), _int32_local(mesh, dst),
                    mesh.put(mesh.local(np.asarray(valid, bool))))

    return run


class ShardedTriangleWindowKernel:
    """The triangle window kernel over a mesh: exact counts, each
    window's edges split over the ranks. A window that overflows widens
    the neighbor table (kb, 4× a rung) or the exchange capacity (cap, 2×)
    as it overflowed, and past both ends at `triangle_count_sparse` on
    the rank's device: the ladder of the JAX kernel."""

    MAX_STREAM_WINDOWS = 64
    INFLIGHT = ingress_pipeline.DEFAULT_INFLIGHT

    def __init__(self, mesh: Mesh, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, cap_factor: int = 2,
                 table: str = None):
        _require_member(mesh)
        if table is None:
            table = resolve_table_mode(mesh.device)
        if table not in TABLE_MODES:
            raise ValueError("unknown table mode %r (choices: %s)"
                             % (table, ", ".join(TABLE_MODES)))
        self.mesh = mesh
        self.n = n = shard_count(mesh)
        self.table = table
        self.device = mesh.device

        def _mult_of_n(x: int) -> int:   # the edge axis and K split
            return -(-x // n) * n        # into n slices

        self.eb = _mult_of_n(seg_ops.bucket_size(edge_bucket))
        self.vb = seg_ops.bucket_size(vertex_bucket)
        kb0 = k_bucket if k_bucket else _tuned_kb(self.eb, mesh.device)
        self.kb = _mult_of_n(seg_ops.bucket_size(kb0))
        self.kb_max = max(
            _mult_of_n(seg_ops.bucket_size(2 * math.isqrt(self.eb))),
            self.kb)
        self.cap = min(max(8, cap_factor * (self.eb // n) // n),
                       self.eb // n)
        self.stage_timers = ingress_pipeline.StageTimers()
        # the counts a failed stream call had finalized (None: clean):
        # where a demoting caller counts on from
        self.drained_counts = None
        self._fns = {}
        self._ring = ChunkStager(self.device, slots=self.INFLIGHT + 1)

    def _fn(self, kb: int, cap: int):
        key = (kb, cap)
        if key not in self._fns:
            self._fns[key] = build_sharded_window_counter(
                self.mesh, self.eb, self.vb, kb, cap, table=self.table)
        return self._fns[key]

    def _next_kb(self, kb: int) -> int:
        return min(-(-(kb * 4) // self.n) * self.n, self.kb_max)

    def _next_cap(self, cap: int) -> int:
        return min(cap * 2, self.eb // self.n)

    def count(self, src: np.ndarray, dst: np.ndarray,
              failed_kb: int = 0, failed_cap: int = 0) -> int:
        """Exact count of one window. failed_kb / failed_cap mark rungs a
        stream dispatch already saw overflow, so the ladder starts past
        them (or goes straight to the exact sparse count where that
        dimension was at its end)."""
        n = len(src)
        if n == 0:
            return 0
        if n > self.eb:
            raise ValueError(f"window of {n} edges exceeds edge bucket "
                             f"{self.eb}")
        if ((failed_kb and failed_kb >= self.kb_max)
                or (failed_cap and failed_cap >= self.eb // self.n)):
            return triangle_count_sparse(src, dst, self.vb, self.device)
        s = _int32_local(self.mesh, seg_ops.pad_to(
            np.asarray(src, np.int32), self.eb, fill=self.vb))
        d = _int32_local(self.mesh, seg_ops.pad_to(
            np.asarray(dst, np.int32), self.eb, fill=self.vb))
        valid = self.mesh.put(self.mesh.local(
            seg_ops.pad_to(np.ones(n, bool), self.eb, fill=False)))
        kb = self._next_kb(failed_kb) if failed_kb else self.kb
        cap = self._next_cap(failed_cap) if failed_cap else self.cap
        while True:
            def _disp(kb=kb, cap=cap):
                fire_shard_dispatch(self.n)
                got = self._fn(kb, cap)(s, d, valid)
                fire_shard_gather(self.n)
                return tuple(int(x) for x in got.tolist())

            count, bucket_ovf, k_ovf = _guarded_dispatch(
                ("sharded_window", kb, cap), _disp)
            if not bucket_ovf and not k_ovf:
                return int(count)
            kb_sat = kb >= self.kb_max
            cap_sat = cap >= self.eb // self.n
            if (kb_sat or not k_ovf) and (cap_sat or not bucket_ovf):
                break   # nothing left to widen: the exact sparse count
            if k_ovf and not kb_sat:
                kb = self._next_kb(kb)
            if bucket_ovf and not cap_sat:
                cap = self._next_cap(cap)
        return triangle_count_sparse(src, dst, self.vb, self.device)

    def warm_chunks(self) -> None:
        """Nothing to compile ahead (seg_ops.warm_stream_buckets): the
        kernels build at first use, for every shape."""
        seg_ops.warm_stream_buckets(self)

    def _run_stack(self, num_w: int, make_chunk, get_window) -> list:
        """Windows [0, num_w) in chunks of MAX_STREAM_WINDOWS through the
        ingress pipeline: prep `make_chunk(at, hi)` -> ((s, d, valid)
        [hi - at, eb] host stacks, through guard_wire) and the h2d of
        this rank's [W, eb/n] columns on a worker; the dispatch runs the
        window body on each window of the chunk and enqueues the copy
        back of its [W, 3] outputs; the finalize, one chunk behind,
        recounts each overflowing window `get_window(w)` down the ladder.
        On an escaping error the counts finalized before it are left on
        `drained_counts`."""
        counts: list = []
        self.drained_counts = None
        step = self._fn(self.kb, self.cap)
        chunk = self.MAX_STREAM_WINDOWS

        def prep(at):
            sc, dc, vc = make_chunk(at, min(at + chunk, num_w))
            # the wire check in the prep: a corrupt wire is retried as a
            # prep under the armed guard, and refused before any staging
            sc, dc = guard_wire((sc, dc), self.n, self.vb)
            return at, (sc, dc, vc)

        def h2d(payload):
            at, arrays = payload
            local = [self.mesh.local(a) for a in arrays]
            return at, self._ring.put(local, at // chunk)

        def dispatch(dev_payload):
            at, staged = dev_payload
            s, d, v = self._ring.take(staged)
            _guarded_dispatch(("sharded_stream", at),
                              lambda: fire_shard_dispatch(self.n))
            telemetry.event("sharded.round", engine="triangles",
                            window=at, windows=s.shape[0], mesh=self.n)
            res = torch.stack([step(s[w], d[w], v[w])
                               for w in range(s.shape[0])])
            self._ring.done(staged)
            return at, HostCopy(res)

        def finalize(raw):
            at, res = raw
            _guarded_dispatch(("sharded_stream", at),
                              lambda: fire_shard_gather(self.n),
                              stage="shard_gather")
            res = res.numpy()
            c = res[:, 0].astype(np.int64)
            for w in np.nonzero(res[:, 1] + res[:, 2])[0]:  # exact redo
                c[w] = self.count(
                    *get_window(at + int(w)),
                    failed_kb=self.kb if res[w, 2] else 0,
                    failed_cap=self.cap if res[w, 1] else 0)
            counts.extend(int(x) for x in c)

        try:
            ingress_pipeline.run_pipeline(
                range(0, num_w, chunk), prep, h2d, dispatch, finalize,
                timers=self.stage_timers, inflight=self.INFLIGHT)
        except BaseException:
            self._ring.release_all()
            self.drained_counts = list(counts)
            raise
        return counts

    def count_stream(self, src: np.ndarray, dst: np.ndarray) -> list:
        """Exact counts of every tumbling `edge_bucket`-sized window of the
        stream (a shorter last window included)."""
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        if len(src) == 0:
            return []
        eb = self.eb
        num_w = -(-len(src) // eb)

        def make_chunk(at, hi):
            _m, s, d, valid = seg_ops.window_stack(
                src[at * eb:hi * eb], dst[at * eb:hi * eb], eb,
                sentinel=self.vb)
            return s, d, valid

        with telemetry.span("sharded.stream", tier="sharded",
                            engine="triangles", mesh=self.n,
                            windows=num_w, edges=len(src)):
            counts = self._run_stack(
                num_w, make_chunk,
                lambda w: (src[w * eb:(w + 1) * eb],
                           dst[w * eb:(w + 1) * eb]))
        # the health mark at this entry only: count_windows (the
        # driver's flush) is marked by its caller
        metrics.mark_window(len(counts), len(src),
                            engine="sharded_triangles",
                            tier="sharded", mesh_shape=[self.n])
        return counts

    def count_windows(self, windows) -> list:
        """Exact counts of (src, dst) window batches of varying lengths
        (each ≤ edge_bucket), in chunked sharded dispatches."""
        if not windows:
            return []
        s, d, valid = seg_ops.stack_window_list(windows, self.eb, self.vb)
        with telemetry.span("sharded.stream", tier="sharded",
                            engine="triangles", mesh=self.n,
                            windows=len(windows),
                            edges=sum(len(w[0]) for w in windows)):
            return self._run_stack(
                len(windows), lambda at, hi: (s[at:hi], d[at:hi],
                                              valid[at:hi]),
                lambda w: windows[w])


# ----------------------------------------------------------------------
# the window engine
# ----------------------------------------------------------------------

class ShardedWindowEngine:
    """Per-window analytics over a mesh with carried state: running
    degrees, min-label CC, double-cover bipartiteness, the triangle
    count of a given neighbor table, and the sliding-window reduce. The
    state (`degree_state`, `labels` [vb+2]; `bip_labels` [2vb+2]) is
    replicated on every rank's device."""

    def __init__(self, mesh: Mesh = None,
                 num_vertices_bucket: int = 1 << 16):
        self.mesh = mesh if mesh is not None else make_mesh()
        _require_member(self.mesh)
        self.n = shard_count(self.mesh)
        self.vb = num_vertices_bucket
        self.device = self.mesh.device
        self.degree_fn = make_sharded_degree_fn(self.mesh, self.vb)
        self.cc_fn = make_sharded_cc_fn(self.mesh, self.vb)
        self.tri_fn = make_sharded_triangle_fn(self.mesh)
        # the double cover's fixpoint over 2·vb cover vertices, built at
        # the first bipartite call
        self._bip_fn = None
        # pane reduces, per (pane_bucket, wp, monoid or fn)
        self._pane_fns = {}
        self.reset()

    def reset(self) -> None:
        """Clear the carried state (the built fns are kept)."""
        self._degree_state = torch.zeros(self.vb + 2, dtype=torch.int32,
                                         device=self.device)
        self._labels = torch.arange(self.vb + 2, dtype=torch.int32,
                                    device=self.device)
        self._bip_labels = None

    def _prep(self, src, dst, sentinel: int = None):
        sent = self.vb + 1 if sentinel is None else sentinel
        src, dst = pad_edges_for_mesh(np.asarray(src, np.int32).ravel(),
                                      np.asarray(dst, np.int32).ravel(),
                                      self.mesh, sentinel=sent)
        src, dst = guard_wire((src, dst), self.n, sent)
        return _int32_local(self.mesh, src), _int32_local(self.mesh, dst)

    def _dispatch(self, analytic: str, edges: int, fn):
        """One sharded dispatch: its span, the shard_dispatch hook, and
        the stage guard's retry when armed (every fn here is pure: the
        state rebinds on success)."""
        def _call():
            fire_shard_dispatch(self.n)
            return fn()

        with telemetry.span("sharded.window", tier="sharded",
                            analytic=analytic, mesh=self.n, edges=edges):
            return _guarded_dispatch(("sharded", analytic), _call)

    def degrees(self, src, dst) -> np.ndarray:
        """Fold a window batch into the running degree vector."""
        s, d = self._prep(src, dst)
        state = self._degree_state
        self._degree_state = self._dispatch(
            "degrees", len(np.atleast_1d(src)),
            lambda: self.degree_fn(s, d, state))
        return self._degree_state[:self.vb].cpu().numpy()

    def cc_labels(self, src, dst, carry: bool = True) -> np.ndarray:
        """The labels after a window batch; carry=True keeps the labels
        across windows."""
        s, d = self._prep(src, dst)
        labels = self._labels if carry else torch.arange(
            self.vb + 2, dtype=torch.int32, device=self.device)
        self._labels = self._dispatch(
            "cc", len(np.atleast_1d(src)),
            lambda: self.cc_fn(s, d, labels))
        return self._labels[:self.vb].cpu().numpy()

    def bipartite(self, src, dst, carry: bool = True):
        """Bipartiteness through the double cover (ops/unionfind.py):
        (labels[vb], signs[vb], odd[vb]); carry=True folds the window
        into the running cover labels."""
        if self._bip_fn is None:
            self._bip_fn = make_sharded_cc_fn(self.mesh, 2 * self.vb)
        fresh = torch.arange(2 * self.vb + 2, dtype=torch.int32,
                             device=self.device)
        labels = self._bip_labels if (carry and self._bip_labels
                                      is not None) else fresh
        s2, d2 = unionfind.double_cover_edges(
            np.asarray(src).ravel(), np.asarray(dst).ravel(), self.vb)
        s2, d2 = self._prep(s2, d2, sentinel=2 * self.vb + 1)
        self._bip_labels = self._dispatch(
            "bipartite", len(np.atleast_1d(src)),
            lambda: self._bip_fn(s2, d2, labels))
        return unionfind.decode_double_cover(
            self._bip_labels.cpu().numpy(), self.vb)

    def state_dict(self) -> dict:
        """The carried state as host arrays. It is replicated, so one
        rank's copy is the layout of every mesh width: it loads on any
        mesh, or into the host twin (parallel/host_twin.py).
        `mesh_shape` records where it was taken; load ignores it."""
        fire_shard_gather(self.n)
        state = {
            "vb": self.vb,
            "mesh_shape": [self.n],
            "degree_state": self._degree_state.cpu().numpy(),
            "labels": self._labels.cpu().numpy(),
        }
        if self._bip_labels is not None:
            state["bip_labels"] = self._bip_labels.cpu().numpy()
        return state

    def load_state_dict(self, state: dict) -> None:
        if state["vb"] != self.vb:
            raise ValueError(
                f"vertex bucket mismatch: checkpoint has {state['vb']}, "
                f"engine built with {self.vb}")

        def put(a):
            return self.mesh.put(np.asarray(a, np.int32))

        self._degree_state = put(state["degree_state"])
        self._labels = put(state["labels"])
        # a state taken before any bipartite call clears the cover
        self._bip_labels = (put(state["bip_labels"])
                            if "bip_labels" in state else None)

    def triangles(self, nbr, ea, eb, emask) -> int:
        """The count of a [V+1, K] neighbor table (the same on every rank)
        over the oriented edges (ea, eb, emask), split over the mesh."""
        target = mesh_padded_len(len(ea), self.mesh)
        sentinel = nbr.shape[0] - 1
        ea = seg_ops.pad_to(np.asarray(ea, np.int32), target, fill=sentinel)
        eb = seg_ops.pad_to(np.asarray(eb, np.int32), target, fill=sentinel)
        emask = seg_ops.pad_to(np.asarray(emask, bool), target, fill=False)
        ea, eb = guard_wire((ea, eb), self.n, sentinel)
        nbr_t = self.mesh.put(np.asarray(nbr, np.int32))
        ea_t, eb_t = _int32_local(self.mesh, ea), _int32_local(self.mesh, eb)
        em_t = self.mesh.put(self.mesh.local(emask))
        return self._dispatch(
            "triangles", len(ea),
            lambda: int(self.tri_fn(nbr_t, ea_t, eb_t, em_t)))

    def sliding_reduce(self, src, pane, val, num_panes: int,
                       panes_per_window: int, name: str = "sum",
                       fn=None):
        """The sliding-window reduce over the mesh
        (`make_sharded_pane_reduce`): `pane` is each edge's dense slide
        index, a window covers panes_per_window consecutive panes. Pass
        `name` for a monoid, or `fn` (name then ignored) for a tensor fn
        declared associative. Returns numpy (win_vals, win_counts), both
        [pane_bucket + panes_per_window - 1, vb + 1]; a (w, v) cell is
        meaningful iff win_counts[w, v] > 0."""
        if fn is not None:
            name = None
        pb = seg_ops.bucket_size(num_panes)
        key = (pb, panes_per_window, name or fn)
        pane_fn = self._pane_fns.get(key)
        if pane_fn is None:
            pane_fn = make_sharded_pane_reduce(self.mesh, self.vb, pb,
                                               panes_per_window,
                                               name=name, fn=fn)
            self._pane_fns[key] = pane_fn
        src = np.asarray(src, np.int32)
        pane = np.asarray(pane, np.int32)
        val = seg_ops.x64_off_values(val)
        n = len(src)
        # a power-of-two edge bucket, then the mesh multiple; the padded
        # lanes are invalid (the trash cell)
        target = mesh_padded_len(seg_ops.bucket_size(n), self.mesh)
        src, pane, val = (seg_ops.pad_to(a, target, fill=0)
                          for a in (src, pane, val))
        valid = seg_ops.pad_to(np.ones(n, bool), target, fill=False)
        src, pane = guard_wire((src, pane), self.n, max(self.vb, pb))
        local = [self.mesh.local(a) for a in (src, pane, val, valid)]
        wv, wc = self._dispatch("sliding_reduce", n,
                                lambda: pane_fn(*local))
        return wv.cpu().numpy(), wc.cpu().numpy()


# ----------------------------------------------------------------------
# the summary engine
# ----------------------------------------------------------------------

def make_sharded_summary_scan(mesh: Mesh, eb: int, vb: int, kb: int,
                              cap: int, table: str = "replicated"):
    """run(carry, src_w, dst_w, valid_w) -> (carry', outs): the summary
    body of each window of a [W, eb/n] stack (this rank's columns,
    tensors on its device) folded into the replicated carry (deg[vb+1],
    labels[vb+1], cover[2(vb+1)]; the cover's (-) at vb+1+v, the shared
    sentinel vb), window by window. outs is int32 [6, W]: max_degree,
    num_components, odd_cycle, triangles, bucket_overflow, k_overflow.
    The degrees merge by SUM, both fixpoints by the MIN exchange, the
    triangles by the window counter's collectives."""
    sent = vb
    tri_body = build_sharded_window_counter(mesh, eb, vb, kb, cap, table)

    def exchange(lab):
        return mesh.all_reduce(lab, "min")

    def run(carry, src_w, dst_w, valid_w):
        deg, labels, cover = carry
        dev = deg.device
        vidx = torch.arange(vb, dtype=torch.int32, device=dev)
        rows = []
        for src, dst, valid in zip(src_w, dst_w, valid_w):
            s = torch.where(valid, src, sent)
            d = torch.where(valid, dst, sent)
            ones = valid.to(torch.int32)
            local = torch.zeros(vb + 1, dtype=torch.int32, device=dev)
            local.index_add_(0, s, ones).index_add_(0, d, ones)
            deg = deg + mesh.all_reduce(local, "sum")
            labels = unionfind.cc_fixpoint(labels, s, d, exchange=exchange)
            touched = deg[:vb] > 0
            ncomp = (touched & (labels[:vb] == vidx)).sum()
            cover = unionfind.cc_fixpoint(
                cover, torch.cat([s, s + (vb + 1)]),
                torch.cat([d + (vb + 1), d]), exchange=exchange)
            odd = (touched & (cover[:vb] == cover[vb + 1:2 * vb + 1])).any()
            rows.append(torch.cat([
                torch.stack([deg[:vb].max(), ncomp.to(torch.int32),
                             odd.to(torch.int32)]),
                tri_body(src, dst, valid)]))
        return (deg, labels, cover), torch.stack(rows, dim=1)

    return run


def make_sharded_snapshot_scan(mesh: Mesh, vb: int, analytics: tuple,
                               deltas: bool = False):
    """The driver's snapshot scan over the mesh (the JAX package's
    `make_sharded_snapshot_scan`, parallel/sharded.py:1172-1256 there):
    run(carry, s_w, d_w, valid_w) -> (carry', outs) over a [W, eb] stack
    of host arrays, the same on every rank, whose invalid slots are
    padding. Each rank stages its own slice of the edge axis (Mesh.local),
    the axis padded to a multiple of the mesh with invalid slots at the
    sentinel vb+1, so any eb splits.

    The carry keeps the engines' layouts on the rank's device, int32:
    degrees [vb+2] (sentinel vb+1), labels [vb+2], cover [2vb+2] ((+) at
    v, (-) at vb+v, sentinels 2vb and 2vb+1); it is replicated, and a
    run returns a new one. outs, on the device: "deg" and "labels"
    [W, vb] int32 and "odd" [W, vb] bool where the analytic runs; with
    `deltas` also "deg_chg", "labels_chg" and "cover_chg" [W, vb] bool,
    each slot's change against the previous window (row -1: the carry),
    the cover's of its odd flag.

    Degrees do not depend on the carry: the chunk's [W, vb+2] partials
    merge in one SUM, then a prefix sum over the windows (int32, wrapping
    as the per-window sums do). Each window's label and cover fixpoints
    run on row U (ops/unionfind.cc_fixpoint, carried) with the MIN
    exchange every round."""
    want_deg = "degrees" in analytics
    want_cc = "cc" in analytics
    want_bip = "bipartite" in analytics
    sent, sent2 = vb + 1, 2 * vb + 1

    def exchange(lab):
        return mesh.all_reduce(lab, "min")

    def stage(a, dtype, fill):
        a = np.asarray(a, dtype)
        pad = mesh_padded_len(a.shape[1], mesh) - a.shape[1]
        if pad:
            a = np.concatenate(
                [a, np.full((a.shape[0], pad), fill, dtype)], axis=1)
        return mesh.put(mesh.local(a))

    def run(carry, s_w, d_w, valid_w):
        deg, labels, cover = carry
        valid = stage(valid_w, np.bool_, False)
        src = torch.where(valid, stage(s_w, np.int32, sent), sent)
        dst = torch.where(valid, stage(d_w, np.int32, sent), sent)
        num_w = src.shape[0]
        dev = src.device
        outs = {}
        if want_deg:
            ones = valid.to(torch.int32).reshape(-1)
            base = (torch.arange(num_w, device=dev) * (vb + 2))[:, None]
            local = torch.zeros(num_w * (vb + 2), dtype=torch.int32,
                                device=dev)
            local.index_add_(0, (base + src).reshape(-1), ones)
            local.index_add_(0, (base + dst).reshape(-1), ones)
            mesh.all_reduce(local, "sum")
            rows = deg + torch.cumsum(local.reshape(num_w, vb + 2), 0,
                                      dtype=torch.int32)
            outs["deg"] = rows[:, :vb]
            if deltas:
                outs["deg_chg"] = rows[:, :vb] != torch.cat(
                    [deg[None, :vb], rows[:-1, :vb]])
            deg = rows[-1].clone()
        if want_cc:
            outs["labels"] = torch.empty((num_w, vb), dtype=torch.int32,
                                         device=dev)
            if deltas:
                outs["labels_chg"] = torch.empty((num_w, vb),
                                                 dtype=torch.bool, device=dev)
        if want_bip:
            outs["odd"] = torch.empty((num_w, vb), dtype=torch.bool,
                                      device=dev)
            if deltas:
                outs["cover_chg"] = torch.empty((num_w, vb),
                                                dtype=torch.bool, device=dev)
        for w in range(num_w):
            s, d, v = src[w], dst[w], valid[w]
            if want_cc:
                new = unionfind.cc_fixpoint(labels, s, d, exchange=exchange)
                outs["labels"][w] = new[:vb]
                if deltas:
                    outs["labels_chg"][w] = new[:vb] != labels[:vb]
                labels = new
            if want_bip:
                s2 = torch.cat([torch.where(v, s, sent2),
                                torch.where(v, s + vb, sent2)])
                d2 = torch.cat([torch.where(v, d + vb, sent2),
                                torch.where(v, d, sent2)])
                new = unionfind.cc_fixpoint(cover, s2, d2, exchange=exchange)
                odd = new[:vb] == new[vb:2 * vb]
                outs["odd"][w] = odd
                if deltas:
                    outs["cover_chg"][w] = odd != (cover[:vb]
                                                   == cover[vb:2 * vb])
                cover = new
        return (deg, labels, cover), outs

    return run


class ShardedSummaryEngine(SummaryEngineBase):
    """The summary engine over a mesh (ops/scan_analytics.py's
    `StreamSummaryEngine` with each window's edges split over the
    ranks): carried degrees, CC and bipartiteness and the triangles of
    every window, through the engines' pipelined chunk loop, one
    dispatch per MAX_WINDOWS windows. Windows whose triangles overflow K
    or the exchange capacity are recounted exactly by the sharded
    kernel's ladder. Its state is the single-chip engine's layout plus
    `mesh_shape`, so either loads the other's, and the host twin both."""

    METRICS_TIER = "sharded"

    def __init__(self, mesh: Mesh, edge_bucket: int, vertex_bucket: int,
                 k_bucket: int = 0, table: str = None):
        self.mesh = mesh
        self.n = shard_count(mesh)
        self._tri = ShardedTriangleWindowKernel(
            mesh, edge_bucket=edge_bucket, vertex_bucket=vertex_bucket,
            k_bucket=k_bucket, table=table)
        self.eb = self._tri.eb
        self.vb = self._tri.vb
        self.device = mesh.device
        self.stage_timers = ingress_pipeline.StageTimers()
        # summaries finalized before the last escaping process() error
        # (None: clean), the demoting caller's hand-off
        self.drained_partial = None
        self._partial_out = []
        self._run = make_sharded_summary_scan(
            mesh, self.eb, self.vb, self._tri.kb, self._tri.cap,
            table=self._tri.table)
        self._ring = ChunkStager(self.device, slots=self._ring_slots())
        self.reset()

    def _init_carry(self):
        return fresh_carry(self.vb, self.device)

    def _to_carry(self, a) -> torch.Tensor:
        return self.mesh.put(np.array(a, np.int32))

    def _check_carry(self, carry) -> None:
        check_summary_carry(carry, self.vb)

    def state(self):
        """(degrees[vb], cc_labels[vb], odd[vb]) snapshots."""
        deg, labels, cover = (x.cpu().numpy() for x in self._carry)
        odd = cover[:self.vb] == cover[self.vb + 1:2 * self.vb + 1]
        return deg[:self.vb], labels[:self.vb], odd

    def _h2d(self, args, ordinal: int):
        s, d = guard_wire(args[:2], self.n, self.vb)
        return self._ring.put([self.mesh.local(a) for a in (s, d, args[2])],
                              ordinal)

    def _dispatch_async(self, staged, wire: str):
        tensors = self._ring.take(staged)
        _guarded_dispatch(("sharded_summary", self.windows_done),
                          lambda: fire_shard_dispatch(self.n))
        telemetry.event("sharded.round", engine="summary",
                        window=self.windows_done,
                        windows=tensors[0].shape[0], mesh=self.n)
        self._carry, outs = self._run(self._carry, *tensors)
        self._ring.done(staged)
        return HostCopy(outs)

    def _materialize(self, raw) -> np.ndarray:
        fire_shard_gather(self.n)
        return raw.numpy()

    def _redo(self, src, dst, b_ovf: int, k_ovf: int) -> int:
        return self._tri.count(
            src, dst, failed_kb=self._tri.kb if k_ovf else 0,
            failed_cap=self._tri.cap if b_ovf else 0)

    def _finalize_summaries(self, at: int, res: np.ndarray, src, dst,
                            out: list) -> None:
        """One chunk's [6, real] outputs into summary dicts, each
        overflowing window's triangles recounted exactly. `out` is teed
        by alias for the error path's drain."""
        mdeg, ncomp, odd, tri, b_ovf, k_ovf = res
        tri = tri.astype(np.int64)
        for w in np.nonzero(b_ovf + k_ovf)[0]:
            lo = (at + int(w)) * self.eb
            tri[w] = self._redo(src[lo:lo + self.eb], dst[lo:lo + self.eb],
                                int(b_ovf[w]), int(k_ovf[w]))
        for w in range(res.shape[1]):
            out.append({"max_degree": int(mdeg[w]),
                        "num_components": int(ncomp[w]),
                        "odd_cycle": bool(odd[w]),
                        "triangles": int(tri[w])})
        self.windows_done += res.shape[1]
        self._partial_out = out

    def process(self, src: np.ndarray, dst: np.ndarray) -> list:
        """SummaryEngineBase.process over the mesh. When an error escapes
        (a dead shard, a corrupt wire), the in-flight chunk's finalize has
        drained first (ops/ingress_pipeline) and the summaries of every
        window finalized before the failure are on `drained_partial`;
        windows_done / resume_offset() sit just past them, so a caller
        hands them over and re-enters on a twin (parallel/host_twin.py)
        or another mesh from there."""
        self._partial_out = []
        self.drained_partial = None
        with telemetry.span("sharded.stream", tier="sharded",
                            engine="summary", mesh=self.n,
                            edges=len(np.atleast_1d(src))):
            try:
                return super().process(src, dst)
            except Exception:
                self.drained_partial = list(self._partial_out)
                raise
            finally:
                self._partial_out = []

    def state_dict(self) -> dict:
        fire_shard_gather(self.n)
        state = super().state_dict()
        # where it was taken; load ignores it (the carry is replicated)
        state["mesh_shape"] = [self.n]
        return state
