"""The typed `GS_*` knob registry: the one place the port's environment
knobs are declared, parsed and documented.

Port of the JAX package's `utils/knobs.py`: the registry API as it is
(`Knob`, `KnobError`, `register`, `get_int`, `get_float`, `get_bool`,
`get_str`, `get_path`, `render_table`; :46-180 and :631-649 there), with
the knobs the port reads registered under the JAX names, kinds, defaults
and bounds (:180-625 there): the ingress pipeline's width, look-ahead
and prefetch (`ops/ingress_pipeline.py`), the egress pin and cap
(`ops/delta_egress.py`), the stage guard's and the demotion
registry's (`utils/resilience.py`; the sharded engines' wire check,
`parallel/sharded.py`), the dispatch autotuner's
(`ops/autotune.py`), the resident tier's (`ops/resident_engine.py`), the
host hooks' (`utils/telemetry.py`, `metrics.py`, `healthz.py`,
`wal.py`, `latency.py`, `sanitize.py`, `costmodel.py`, `provenance.py`)
the GNN engine's width and activation (`ops/gnn_window.py`), the
driver's probation and slide (`core/driver.py`) and the cohort's
admission cap, queue depth, overflow policy, quarantine probation and
reorder bound (`core/tenancy.py`), and the serving front end's port,
deadlines, pump mode and subscriber queue (`core/serve.py`). The
cost model's peaks are not knobs here: they come from the card's row of
`utils/costmodel.PEAKS`; nor are the JAX package's `GS_*PALLAS*` knobs,
which pick between Pallas and XLA forms the port does not have.

- Reads are live: `os.environ` is consulted on every call, never
  cached, so a test or a tool can flip a knob mid-process. The engines
  read the hook knobs once a call, not once a window.
- A malformed value raises `KnobError` naming the knob, the text and the
  expected kind, at the read site.
- Unset and empty both mean the default.
- Numbers are clamped to `lo`/`hi`, not refused: the bounds say "2 is
  the smallest useful explore period", not that the user erred.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["Knob", "KnobError", "REGISTRY", "register", "get_int",
           "get_float", "get_bool", "get_str", "get_path", "render_table"]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


class KnobError(ValueError):
    """A `GS_*` environment value could not be parsed as its declared
    kind. Carries `.knob` (the Knob) and `.value` (the offending text)."""

    def __init__(self, knob: "Knob", value: str, problem: str):
        super().__init__(
            "%s=%r: %s (expected %s; default %r)"
            % (knob.name, value, problem, knob.kind, knob.default))
        self.knob = knob
        self.value = value


@dataclass(frozen=True)
class Knob:
    """One declared environment knob. `kind` is one of 'int', 'float',
    'bool', 'str', 'path'; `lo`/`hi` clamp parsed numbers; `choices`
    restricts str knobs; `default_text` says how the default reads
    where it is computed; `help` is the knob's meaning."""

    name: str
    kind: str
    default: object
    help: str
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Tuple[str, ...]] = None
    default_text: Optional[str] = None


REGISTRY: Dict[str, Knob] = {}


def register(name: str, kind: str, default, help: str, **kw) -> Knob:
    assert name.startswith("GS_"), name
    assert kind in ("int", "float", "bool", "str", "path"), kind
    assert name not in REGISTRY, "duplicate knob %s" % name
    knob = Knob(name, kind, default, help, **kw)
    REGISTRY[name] = knob
    return knob


def _raw(name: str) -> Optional[str]:
    """The live environment text; unset and empty are both None (the
    default)."""
    val = os.environ.get(name)
    return None if val is None or val == "" else val


def _clamp(knob: Knob, num):
    if knob.lo is not None and num < knob.lo:
        num = type(num)(knob.lo)
    if knob.hi is not None and num > knob.hi:
        num = type(num)(knob.hi)
    return num


def _knob(name: str, kind: str) -> Knob:
    knob = REGISTRY.get(name)
    assert knob is not None, "unregistered knob %s" % name
    assert knob.kind == kind, (name, knob.kind, kind)
    return knob


def get_int(name: str) -> Optional[int]:
    knob = _knob(name, "int")
    raw = _raw(name)
    if raw is None:
        return knob.default if knob.default is None \
            else _clamp(knob, int(knob.default))
    try:
        num = int(raw)
    except ValueError:
        raise KnobError(knob, raw, "not an integer") from None
    return _clamp(knob, num)


def get_float(name: str) -> Optional[float]:
    knob = _knob(name, "float")
    raw = _raw(name)
    if raw is None:
        return knob.default if knob.default is None \
            else _clamp(knob, float(knob.default))
    try:
        num = float(raw)
    except ValueError:
        raise KnobError(knob, raw, "not a number") from None
    return _clamp(knob, num)


def get_bool(name: str) -> bool:
    knob = _knob(name, "bool")
    raw = _raw(name)
    if raw is None:
        return bool(knob.default)
    low = raw.lower()
    if low in _TRUE:
        return True
    if low in _FALSE:
        return False
    raise KnobError(knob, raw, "not a boolean (%s / %s)"
                    % ("/".join(_TRUE), "/".join(_FALSE)))


def get_str(name: str) -> str:
    knob = _knob(name, "str")
    raw = _raw(name)
    if raw is None:
        return knob.default
    if knob.choices is not None and raw not in knob.choices:
        raise KnobError(knob, raw,
                        "not one of %s" % "/".join(knob.choices))
    return raw


def get_path(name: str) -> Optional[str]:
    """Path knobs: a filesystem location, or the conventional "0" for
    explicitly disabled, which callers test for. None = unset."""
    knob = _knob(name, "path")
    raw = _raw(name)
    return knob.default if raw is None else raw


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------

# ingress pipeline (ops/ingress_pipeline.py)
register("GS_PIPELINE_WORKERS", "int", None, lo=0,
         help="prep worker-pool width; unset = min(4, cpus-1), `0` "
              "pins the synchronous single-thread form",
         default_text="min(4, cpus-1)")
register("GS_PIPELINE_INFLIGHT", "int", 3, lo=1,
         help="max prepped+transferred chunks kept in flight ahead of "
              "dispatch; narrows an `inflight=` a caller gives (the "
              "engines pass their staging ring's depth, 3), as in JAX")
register("GS_STREAM_PREFETCH", "bool", True,
         help="`0` pins the synchronous ingress form everywhere (the "
              "A/B lever `ops/ingress_pipeline.forced_sync` scopes "
              "per-measurement)")

# egress (ops/delta_egress.py)
register("GS_EGRESS", "str", "", choices=("full", "delta", "auto"),
         help="pin the batched d2h egress: `full` (whole snapshot "
              "rows) or `delta` (per-window changed-slot wire, "
              "`ops/delta_egress.py`); unset/`auto` = adopt delta "
              "only on the device's parity+≥5% `egress_ab` rows",
         default_text="auto")
register("GS_EGRESS_CAP", "int", None, lo=1,
         help="per-window changed-slot capacity of the delta wire "
              "where no `egress_cap=` is given; a window that "
              "overflows it refolds its chunk on full rows, so any "
              "cap stays exact",
         default_text="min(2·eb, vb)")

# stage guard and tier demotion (utils/resilience.py)
register("GS_STAGE_TIMEOUT_S", "float", 0.0, lo=0.0,
         help="per-stage deadline of the ingress pipeline's host stages "
              "(prep, h2d): a hung stage surfaces as a typed "
              "`StageTimeout` naming the chunk; 0 = off",
         default_text="0 (off)")
register("GS_STAGE_RETRIES", "int", 0, lo=0,
         help="bounded retry of the host stages (prep, h2d); exhaustion "
              "raises `StageFailed` with per-attempt timings. A kernel "
              "or CUDA error is never retried")
register("GS_STAGE_BACKOFF_S", "float", 0.05, lo=0.0,
         help="deterministic (jitterless) exponential backoff base "
              "between attempts")
register("GS_TIER_RETRY_WINDOWS", "int", 0, lo=0,
         help="probation length before a demoted snapshot tier of the "
              "driver re-probes the faster one; 0 = never",
         default_text="0 (never)")
register("GS_TIER_DEMOTE", "bool", True,
         help="`0` pins the resolved tier: a persistent host-side "
              "failure raises a typed `StageFailed` instead of demoting "
              "the driver's snapshot tier (a kernel, CUDA or collective "
              "error never demotes)")
register("GS_MESH_DEMOTE", "bool", True,
         help="`0` pins a mesh driver to the mesh (the `sharded→scan` "
              "rung): a failure the rung would cure raises its typed "
              "`StageFailed`; subordinate to `GS_TIER_DEMOTE`")
register("GS_MESH_WIRE_CHECK", "bool", False,
         help="`1` arms the per-shard range check of every mesh-bound "
              "h2d stack (`parallel/sharded.guard_wire`): a corrupt "
              "shard wire raises an error naming the shard instead of "
              "scattering garbage ids into carried state",
         default_text="0 (off)")

# dispatch autotuner (ops/autotune.py)
register("GS_AUTOTUNE", "bool", True,
         help="`0` disables the online dispatch tuner "
              "(`ops/autotune.py`): windows-per-dispatch, K and the wire "
              "then run the static configuration; on, the tuner "
              "deterministically (with 1.05× hysteresis) finds the fast "
              "configuration on the live stream")
register("GS_AUTOTUNE_ROUND", "int", 4, lo=1,
         help="dispatch chunks per tuner measurement round; a 1-chunk "
              "round would measure the synchronous form")
register("GS_AUTOTUNE_EXPLORE", "int", 3, lo=2,
         help="every Nth measurement round explores the next "
              "single-knob move off the incumbent; the rest exploit")
register("GS_TUNE_CACHE", "path", None,
         help="directory of the per-backend tuning cache "
              "(`tuning_<backend>.json`, backend `cuda` or `cpu`) that "
              "seeds the next run with this run's optimum; `0` disables "
              "persistence",
         default_text="`~/.cache/gelly_streaming_tpu_torch`")

# resident-state tier (ops/resident_engine.py)
register("GS_RESIDENT", "str", "", choices=("on", "off", "auto"),
         help="pin the driver's resident snapshot tier "
              "(`ops/resident_engine.py`): `on` selects it, `off` never; "
              "unset/`auto` = adopt it only on the device's parity+≥5% "
              "`resident_ab`/`driver_resident` rows (none committed: "
              "the scan tier)",
         default_text="auto")
register("GS_RESIDENT_SPB", "int", 256, lo=1,
         help="windows per super-batch of the resident tier (one CUDA "
              "graph replay folds this many windows; rounded up to a "
              "power of two)")
register("GS_RESIDENT_SLOTS", "int", 2, lo=1,
         help="ingest-ring depth of the resident tier: super-batches "
              "prepped and copied ahead of dispatch (2 = slot N+1 fills "
              "while N computes)")

# flight recorder (utils/telemetry.py)
register("GS_TELEMETRY", "bool", False,
         help="arm the flight recorder (`utils/telemetry.py`): spans, "
              "events, counters and gauges with a per-run trace id and "
              "per-chunk correlation; off, every hook is a guarded "
              "no-op and results are bit-identical. The dispatching "
              "thread's spans (`engine.call`, `engine.admit`, "
              "`engine.chunks`, `ingress.wait`, `ingress.dispatch`, "
              "`ingress.finalize`) also enter any running "
              "`torch.profiler` capture, with this off too; the pool's "
              "prep and h2d reach the trace only through `ingress.wait` "
              "and `device_trace`'s clock anchor",
         default_text="0 (off)")
register("GS_TRACE_DIR", "path", None,
         help="directory of the crash-safe JSONL run ledger "
              "(`trace_<id>.jsonl`); durable events (faults, stage "
              "errors, checkpoints, resumes) are appended and fsync'd "
              "at once, buffered spans flush at exit, SIGTERM or a "
              "fatal fault",
         default_text="unset")
register("GS_TRACE_RING", "int", 4096, lo=16,
         help="in-memory ring-buffer capacity (records)")
register("GS_TRACE_DURABLE", "bool", True,
         help="`0` drops the per-durable-event fsync (the append "
              "still happens)")

# live health plane (utils/metrics.py + utils/healthz.py)
register("GS_METRICS", "bool", False,
         help="arm the streaming metrics registry (`utils/metrics.py`): "
              "stage latency histograms, window and edge throughput, "
              "retry, fault and checkpoint counters, fed from the "
              "flight-recorder hooks; off, every hook is a guarded no-op",
         default_text="0 (off)")
register("GS_METRICS_PORT", "int", 0, lo=0, hi=65535,
         help="serve `/metrics` (Prometheus text) and `/healthz` (JSON) "
              "from a daemon thread on this 127.0.0.1 port "
              "(`utils/healthz.py`); 0 = no server",
         default_text="0 (off)")
register("GS_METRICS_SERIES", "int", 64, lo=1,
         help="label-set cardinality bound per metric name: beyond it "
              "new label sets collapse into one `overflow` series")
register("GS_METRICS_COMPILE_BASE", "int", 8, lo=1,
         help="base allowance of new dispatch shapes per wrapped "
              "dispatch in the shape watch: `base + log2(max/min "
              "observed size) + 1` before a durable `recompile_storm` "
              "event fires")
register("GS_HEALTH_STALE_S", "float", 30.0, lo=0.0,
         help="staleness deadline: with the metrics plane armed, no "
              "window finalizing for this many seconds flips `/healthz` "
              "to `degraded`; 0 disables the watchdog",
         default_text="30")

# write-ahead edge journal (utils/wal.py)
register("GS_WAL", "bool", True,
         help="`0` is the journal kill switch: every `enable_wal()` "
              "call degrades to a no-op; 1 (default) lets callers that "
              "enable a journal get one")
register("GS_WAL_FSYNC_S", "float", 0.0, lo=0.0,
         help="fsync batching interval of the edge journal: 0 (default) "
              "fsyncs every append, >0 at most one fsync per interval",
         default_text="0 (every append)")
register("GS_WAL_RETAIN", "bool", False,
         help="`1` arms journal retention: every checkpoint flush "
              "truncates the segments the older of the two kept "
              "checkpoint generations covers",
         default_text="0 (off)")
register("GS_WAL_SEGMENT_BYTES", "int", 1 << 26, lo=4096,
         help="segment-rotation size of the journal (and of the "
              "dead-letter and provenance ledgers); records never split "
              "across segments",
         default_text="67108864 (64 MiB)")

# end-to-end latency plane (utils/latency.py)
register("GS_LATENCY", "bool", False,
         help="arm the ingest→deliver latency plane "
              "(`utils/latency.py`): admission stamps (carried through "
              "the journal's ts column), per-window stage waterfalls, "
              "per-lane percentiles, the oldest-unfinalized-edge age "
              "and the SLO burn; off, every hook is a guarded no-op",
         default_text="0 (off)")
register("GS_LAT_MARKS", "int", 4096, lo=16,
         help="per-lane admission-mark memory bound")
register("GS_LAT_PENDING", "int", 1024, lo=16,
         help="bounded finalized-but-undelivered window records")
register("GS_SLO_P99_S", "float", 0.0, lo=0.0,
         help="delivered-window end-to-end latency target (seconds); "
              "0 disables the SLO module",
         default_text="0 (off)")
register("GS_SLO_BUDGET", "float", 0.01, lo=1e-6, hi=1.0,
         help="error budget: the allowed fraction of windows over the "
              "GS_SLO_P99_S target")
register("GS_SLO_WINDOW_S", "float", 60.0, lo=1.0,
         help="sliding window (seconds) of the SLO burn rate")
register("GS_SLO_BURN", "float", 2.0, lo=0.1,
         help="burn rate at or above which `/healthz`'s `latency` "
              "section flips `degraded` (a durable `slo_burn` event)")

# admission sanitizer and dead-letter journal (utils/sanitize.py)
register("GS_SANITIZE", "str", "off", choices=("off", "on", "strict"),
         help="admission sanitizer (`utils/sanitize.py`) at every "
              "engine's admission, before the journal: `off` (default) "
              "bit-identical, `on` rejects structurally invalid records "
              "with typed reasons, `strict` adds the self-loop and "
              "duplicate-flood policies",
         default_text="off")
register("GS_DLQ_DIR", "path", None,
         help="dead-letter journal directory: rejected records are "
              "appended as CRC-framed segment records; unset/`0` = "
              "rejections are counted and dropped",
         default_text="unset")
register("GS_DLQ_RETAIN", "int", 0, lo=0,
         help="closed dead-letter segments kept after rotation; 0 "
              "keeps every segment",
         default_text="0 (keep all)")
register("GS_MAX_BATCH_EDGES", "int", 0, lo=0,
         help="admission batch-size bound: a longer process() batch is "
              "refused whole with a typed `BatchRejected`; 0 = "
              "unbounded",
         default_text="0 (unbounded)")

# per-launch cost observatory (utils/costmodel.py)
register("GS_COSTMODEL", "bool", False,
         help="arm the per-launch cost observatory "
              "(`utils/costmodel.py`): each kernel launch on the engine "
              "paths is timed with CUDA events (the host clock on the "
              "CPU) and joined with its bytes and operations against "
              "the card's peaks; off, every hook is a guarded no-op",
         default_text="0 (off)")

# windowed GNN workload (ops/gnn_window.py)
register("GS_GNN_F", "int", 16, lo=1, hi=256,
         help="feature width F of the GNN engines' per-vertex slab "
              "(`ops/gnn_window.py`), read at construction when "
              "feature_dim is not given")
register("GS_GNN_ACT", "str", "relu", choices=("relu", "abs",
                                               "identity"),
         help="activation of the GNN dense update (exact elementwise "
              "ops only), read at construction when activation is not "
              "given")

# per-window provenance ledger (utils/provenance.py)
register("GS_PROVENANCE", "bool", False,
         help="arm the per-window provenance ledger "
              "(`utils/provenance.py`): every finalize appends a "
              "CRC-framed record (tenant, window, journal span, tier, "
              "program, knob fingerprint, summary sha256); off, every "
              "emit() is a no-op")
register("GS_PROVENANCE_DIR", "path", None,
         help="directory of the ledger's `prov_<n>.seg` segments; "
              "unset disarms emit() even with GS_PROVENANCE=1")
register("GS_PROVENANCE_RETAIN", "int", 0, lo=0,
         help="closed ledger segments kept behind the open one; 0 = "
              "keep everything")

# the driver's sliding windows (core/driver.py)
register("GS_SLIDE", "int", 0, lo=0,
         help="the driver's `slide=` where it is None: an emission every "
              "this many edges, each edge folded into its pane once; a "
              "power of two dividing the window size; 0 = tumbling")

# the multi-tenant cohort (core/tenancy.py)
register("GS_TENANT_MAX", "int", 64, lo=1,
         help="admission cap of `TenantCohort` and `GnnTenantCohort` "
              "where `max_tenants` is None: tenants past it are refused "
              "with a typed `TenantRejected` and a durable "
              "`tenant_rejected` event")
register("GS_TENANT_QUEUE_WINDOWS", "int", 8, lo=1,
         help="per-tenant ingest-queue depth in windows where "
              "`queue_windows` is None (capacity = depth x edge_bucket "
              "edges)")
register("GS_TENANT_ADMISSION", "str", "reject",
         choices=("reject", "drop"),
         help="queue-overflow policy where `admission` is None: "
              "`reject` raises a typed `TenantBackpressure` accepting "
              "nothing, `drop` accepts what fits and sheds the rest "
              "with an event and a counter")
register("GS_TENANT_TPD", "int", 0, lo=0,
         help="tenants per cohort dispatch where `tenants_per_dispatch` "
              "is 0: a value above 0 pins it; 0 lets the dispatch "
              "autotuner's tenants-per-dispatch arm choose (every ready "
              "tenant of a group in one slab with GS_AUTOTUNE=0)",
         default_text="0 (auto)")
register("GS_COHORT_RESIDENT", "str", "", choices=("on", "off", "auto"),
         help="the resident cohort tier (`core/tenancy.py`): each (vertex "
              "bucket, K) group's carries stay stacked on the device "
              "between rounds, each dispatch one replayed CUDA graph, "
              "restacked only when the group's membership changes; `on` "
              "selects it, `off` runs the scan form; unset/`auto` = "
              "adopt it only on the device's parity+≥5% "
              "`tenancy_ab`/`cohort_resident` rows (none committed: the "
              "scan form)",
         default_text="auto")
register("GS_QUARANTINE_WINDOWS", "int", 4, lo=0,
         help="clean solo probation windows a quarantined tenant must "
              "finalize, on its own engine on the cohort's device, "
              "before it re-enters the cohort; 0 = quarantine is "
              "permanent for the process")
register("GS_OOO_BOUND", "int", 0, lo=0,
         help="bounded out-of-orderness (event-time ns) of the cohort's "
              "per-tenant reorder buffer: a `feed(ts=)` edge is held "
              "until the tenant's watermark (newest stamp − bound) "
              "passes it, then released in ts order; 0 = off")

# the serving front end (core/serve.py)
register("GS_SERVE_PORT", "int", 0, lo=0, hi=65535,
         help="TCP port of the serving front end "
              "(`core/serve.StreamServer`, 127.0.0.1); 0 = a port the "
              "OS assigns (the server's `.port` holds it)",
         default_text="0 (ephemeral)")
register("GS_SERVE_DRAIN_S", "float", 30.0, lo=0.0,
         help="graceful-drain deadline: on SIGTERM the server stops "
              "accepting, waits up to this long for in-flight requests, "
              "pumps every queue dry, checkpoints, seals the journal and "
              "exits 0; 0 = wait for in-flight requests without a "
              "deadline",
         default_text="30")
register("GS_SERVE_IDLE_S", "float", 60.0, lo=0.1,
         help="per-connection deadline of the serving front end: a "
              "connection idle this long is closed, and a client whose "
              "response send stalls this long is shed (durable "
              "`serve_client_shed` event), never stalling the pump",
         default_text="60")
register("GS_PUMP", "str", "sync", choices=("sync", "async"),
         help="the serving pump: `sync` (default) pumps inline under the "
              "request lock; `async` runs slab prep, h2d, the launches "
              "and finalize on a pump thread, so the accept loop and "
              "file tails only sanitize, journal and enqueue under the "
              "cohort's queue lock (same windows either way)",
         default_text="sync")
register("GS_SUB_QUEUE", "int", 256, lo=1,
         help="bounded per-connection queue (rows) of the `subscribe` "
              "op; a subscriber whose queue overflows is shed with the "
              "durable `serve_client_shed` event")


# ----------------------------------------------------------------------
# docs rendering (the README's port knob table)
# ----------------------------------------------------------------------
def _default_cell(knob: Knob) -> str:
    if knob.default_text is not None:
        return knob.default_text
    if knob.kind == "bool":
        return "1" if knob.default else "0"
    return str(knob.default)


def render_table() -> str:
    """The README's table of the port's `GS_*` knobs, one row per
    registered knob in registration order."""
    lines = ["| knob | default | meaning |", "|---|---|---|"]
    for knob in REGISTRY.values():
        lines.append("| `%s` | %s | %s |"
                     % (knob.name, _default_cell(knob),
                        " ".join(knob.help.split())))
    return "\n".join(lines)
