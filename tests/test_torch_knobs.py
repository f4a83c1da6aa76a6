"""The port's knob registry (gelly_streaming_tpu_torch/utils/knobs.py)
against the JAX package's: every knob the port reads (the stage guard
and demotion registry, the sharded engines' wire check, the dispatch
autotuner, the resident tier, the
host hooks, the GNN engines, the driver's probation and slide, the
cohort's admission, queue, tenants per dispatch, resident tier,
quarantine and reorder bound, the serving
front end's port, deadlines, pump mode and subscriber queue) with the
same kinds, defaults, bounds and choices, and the same parsing (live
reads, clamping, typed refusals)."""

import pytest
import torch

from gelly_streaming_tpu.utils import knobs as jax_knobs
from gelly_streaming_tpu_torch.utils import knobs

SLICE_KNOBS = (
    "GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES", "GS_STAGE_BACKOFF_S",
    "GS_TIER_RETRY_WINDOWS", "GS_TIER_DEMOTE", "GS_MESH_DEMOTE",
    "GS_MESH_WIRE_CHECK", "GS_AUTOTUNE", "GS_AUTOTUNE_ROUND", "GS_AUTOTUNE_EXPLORE",
    "GS_TUNE_CACHE", "GS_RESIDENT", "GS_RESIDENT_SPB", "GS_RESIDENT_SLOTS",
    "GS_TELEMETRY", "GS_TRACE_DIR", "GS_TRACE_RING", "GS_TRACE_DURABLE",
    "GS_METRICS", "GS_METRICS_PORT", "GS_METRICS_SERIES",
    "GS_METRICS_COMPILE_BASE", "GS_HEALTH_STALE_S",
    "GS_WAL", "GS_WAL_FSYNC_S", "GS_WAL_RETAIN", "GS_WAL_SEGMENT_BYTES",
    "GS_LATENCY", "GS_LAT_MARKS", "GS_LAT_PENDING", "GS_SLO_P99_S",
    "GS_SLO_BUDGET", "GS_SLO_WINDOW_S", "GS_SLO_BURN",
    "GS_SANITIZE", "GS_DLQ_DIR", "GS_DLQ_RETAIN", "GS_MAX_BATCH_EDGES",
    "GS_COSTMODEL", "GS_GNN_F", "GS_GNN_ACT",
    "GS_PROVENANCE", "GS_PROVENANCE_DIR", "GS_PROVENANCE_RETAIN",
    "GS_SLIDE", "GS_TENANT_MAX", "GS_TENANT_QUEUE_WINDOWS",
    "GS_TENANT_ADMISSION", "GS_TENANT_TPD", "GS_COHORT_RESIDENT",
    "GS_QUARANTINE_WINDOWS", "GS_OOO_BOUND",
    "GS_SERVE_PORT", "GS_SERVE_DRAIN_S", "GS_SERVE_IDLE_S", "GS_PUMP",
    "GS_SUB_QUEUE")


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in SLICE_KNOBS:
        monkeypatch.delenv(name, raising=False)
    yield
    torch.set_num_threads(threads)


def test_registry_is_the_slice_knobs():
    assert tuple(knobs.REGISTRY) == SLICE_KNOBS


@pytest.mark.parametrize("name", SLICE_KNOBS)
def test_knob_matches_jax(name):
    mine, theirs = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    for field in ("kind", "default", "lo", "hi", "choices"):
        assert getattr(mine, field) == getattr(theirs, field), field


@pytest.mark.parametrize("name,raw", [
    ("GS_AUTOTUNE", None), ("GS_AUTOTUNE", "0"), ("GS_AUTOTUNE", "yes"),
    ("GS_AUTOTUNE_ROUND", None), ("GS_AUTOTUNE_ROUND", "0"),
    ("GS_AUTOTUNE_ROUND", "7"), ("GS_AUTOTUNE_EXPLORE", "1"),
    ("GS_AUTOTUNE_EXPLORE", "5"), ("GS_TUNE_CACHE", None),
    ("GS_TUNE_CACHE", "0"), ("GS_TUNE_CACHE", "/some/dir"),
    ("GS_RESIDENT", None), ("GS_RESIDENT", "on"), ("GS_RESIDENT", "auto"),
    ("GS_RESIDENT_SPB", None), ("GS_RESIDENT_SPB", "100"),
    ("GS_RESIDENT_SPB", "-3"), ("GS_RESIDENT_SLOTS", "0"),
    ("GS_RESIDENT_SLOTS", ""), ("GS_RESIDENT_SLOTS", "4"),
    ("GS_TENANT_MAX", "0"), ("GS_TENANT_QUEUE_WINDOWS", "3"),
    ("GS_TENANT_ADMISSION", "drop"), ("GS_QUARANTINE_WINDOWS", "0"),
    ("GS_OOO_BOUND", "-5"), ("GS_SERVE_PORT", None),
    ("GS_SERVE_PORT", "70000"), ("GS_SERVE_DRAIN_S", "0"),
    ("GS_SERVE_DRAIN_S", "-1.5"), ("GS_SERVE_IDLE_S", "0.01"),
    ("GS_SERVE_IDLE_S", None), ("GS_PUMP", None), ("GS_PUMP", "async"),
    ("GS_SUB_QUEUE", "0"), ("GS_SUB_QUEUE", "16"), ("GS_TENANT_TPD", None),
    ("GS_TENANT_TPD", "16"), ("GS_TENANT_TPD", "-2"),
    ("GS_COHORT_RESIDENT", None), ("GS_COHORT_RESIDENT", "on"),
    ("GS_COHORT_RESIDENT", "off"), ("GS_COHORT_RESIDENT", "auto"),
    ("GS_MESH_WIRE_CHECK", None), ("GS_MESH_WIRE_CHECK", "1")])
def test_reads_match_jax(monkeypatch, name, raw):
    if raw is not None:
        monkeypatch.setenv(name, raw)
    get = {"int": "get_int", "float": "get_float", "bool": "get_bool",
           "str": "get_str", "path": "get_path"}[knobs.REGISTRY[name].kind]
    assert getattr(knobs, get)(name) == getattr(jax_knobs, get)(name)


@pytest.mark.parametrize("name,raw", [
    ("GS_AUTOTUNE", "maybe"), ("GS_AUTOTUNE_ROUND", "3O"),
    ("GS_RESIDENT", "always"), ("GS_RESIDENT_SLOTS", "two"),
    ("GS_TENANT_ADMISSION", "queue"), ("GS_OOO_BOUND", "1e3"),
    ("GS_PUMP", "threaded"), ("GS_SERVE_IDLE_S", "soon"),
    ("GS_TENANT_TPD", "all"), ("GS_COHORT_RESIDENT", "yes")])
def test_malformed_values_raise(monkeypatch, name, raw):
    monkeypatch.setenv(name, raw)
    get = {"int": knobs.get_int, "float": knobs.get_float,
           "bool": knobs.get_bool,
           "str": knobs.get_str}[knobs.REGISTRY[name].kind]
    with pytest.raises(knobs.KnobError, match=name) as err:
        get(name)
    assert err.value.knob.name == name and err.value.value == raw


def test_reads_are_live_and_unregistered_knobs_refused(monkeypatch):
    assert knobs.get_int("GS_RESIDENT_SPB") == 256
    monkeypatch.setenv("GS_RESIDENT_SPB", "64")
    assert knobs.get_int("GS_RESIDENT_SPB") == 64
    with pytest.raises(AssertionError, match="unregistered"):
        knobs.get_int("GS_PIPELINE_WORKERS")
    with pytest.raises(AssertionError):
        knobs.get_bool("GS_RESIDENT_SPB")       # the wrong kind
    with pytest.raises(AssertionError, match="duplicate"):
        knobs.register("GS_AUTOTUNE", "bool", True, help="again")


def test_render_table_is_in_the_readme():
    """The README's table of the port's knobs is `render_table()`'s."""
    import os

    readme = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "README.md")
    assert knobs.render_table() in open(readme).read()


def test_tenant_knobs_and_the_constructor_override(monkeypatch):
    """GS_TENANT_TPD (int, 0 = auto) and GS_COHORT_RESIDENT (on, off,
    auto; unset the scan form): their kinds, defaults and choices, and
    the cohort's `tenants_per_dispatch`, which pins above 0 and reads
    the knob at 0."""
    from gelly_streaming_tpu_torch import TenantCohort
    from gelly_streaming_tpu_torch.core import tenancy
    from gelly_streaming_tpu_torch.ops import resident_engine

    tpd, res = knobs.REGISTRY["GS_TENANT_TPD"], \
        knobs.REGISTRY["GS_COHORT_RESIDENT"]
    assert (tpd.kind, tpd.default, tpd.lo) == ("int", 0, 0)
    assert (res.kind, res.default, res.choices) == ("str", "",
                                                    ("on", "off", "auto"))
    assert tenancy.pinned_tpd() == 0
    assert not resident_engine.resolve_resident_cohort()
    co = TenantCohort(64, 128, device="cpu")
    pinned = TenantCohort(64, 128, device="cpu", tenants_per_dispatch=3)
    assert co._pinned_tpd() == 0 and pinned._pinned_tpd() == 3
    monkeypatch.setenv("GS_TENANT_TPD", "5")
    monkeypatch.setenv("GS_COHORT_RESIDENT", "on")
    assert tenancy.pinned_tpd() == 5 and co._pinned_tpd() == 5
    assert pinned._pinned_tpd() == 3
    assert resident_engine.resolve_resident_cohort()
    with pytest.raises(ValueError, match="tenants_per_dispatch"):
        TenantCohort(64, 128, device="cpu", tenants_per_dispatch=-1)
