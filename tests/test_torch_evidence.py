"""The port's measured-adoption routing (gelly_streaming_tpu_torch/utils/
evidence.py and the resolvers of ops/triangles.py, ops/resident_engine.py,
core/driver.py, ops/delta_egress.py, ops/windowed_reduce.py and
parallel/sharded.py) held to the JAX package's resolvers on the same
fabricated rows.

The rows go to a JAX-format file ({"backend": ..., <sections>}) and to a
port-format file ({"devices": {<label>: <sections>}}); both packages are
pointed at them by monkeypatch (the JAX `_PERF_PATH`, the port's
`evidence.PERF_PATH`) with every memo reset, as the JAX package's own
`selection_env` does (tests/library/test_kernel_selection.py:30-44).
On the CPU the JAX process backend is "cpu" and the port's device
label "cpu"; the card case labels the port's device with a card's name
and the JAX process "tpu". Cases are taken from
tests/library/test_kernel_selection.py, tests/operations/test_egress.py,
tests/operations/test_resident.py, tests/library/test_windowed_reduce.py,
tests/parallel/test_sharded.py and tests/test_native.py. Then: routed
engines give the results of their pinned defaults, and with no evidence
file every default is the one the port had before the routing.
"""

import json

import jax
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import driver as jax_driver
from gelly_streaming_tpu.ops import delta_egress as jax_egress
from gelly_streaming_tpu.ops import resident_engine as jax_res
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.ops import windowed_reduce as jax_wr
from gelly_streaming_tpu.parallel import sharded as jax_sharded
from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                       StreamSummaryEngine,
                                       TriangleWindowKernel,
                                       WindowedEdgeReduce)
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.core import driver
from gelly_streaming_tpu_torch.ops import delta_egress
from gelly_streaming_tpu_torch.ops import resident_engine
from gelly_streaming_tpu_torch.ops import triangles
from gelly_streaming_tpu_torch.ops import windowed_reduce
from gelly_streaming_tpu_torch.parallel import sharded
from gelly_streaming_tpu_torch.utils import evidence
from gelly_streaming_tpu_torch.utils.streams import make_stream

CARD = "NVIDIA H100 80GB HBM3"
PINS = ("GS_RESIDENT", "GS_COHORT_RESIDENT", "GS_EGRESS", "GS_EGRESS_CAP")


def reset_port() -> None:
    """Every resolver's memo, through `evidence.forget`."""
    evidence.forget()
    assert evidence._CHOSEN == {}


@pytest.fixture
def evidence_env(tmp_path, monkeypatch):
    """configure(sections, card=False, foreign=False): the same sections
    in both files, the JAX process backend "cpu" (card: "tpu") and the
    port's device label "cpu" (card: CARD); `foreign` files them under
    another device in both."""
    jax_path = tmp_path / "PERF.json"
    port_path = tmp_path / "PERF_torch.json"
    monkeypatch.setattr(jax_tri, "_PERF_PATH", str(jax_path))
    for name, value in (("_STREAM_IMPL", None), ("_STREAM_IMPL_EB", {}),
                        ("_INGRESS", None), ("_TUNED_KB", {}),
                        ("_TUNED_CHUNK", {}), ("_COMPILE_CAPS", {})):
        monkeypatch.setattr(jax_tri, name, value)
    monkeypatch.setattr(jax_res, "_RESIDENT", None)
    monkeypatch.setattr(jax_res, "_RESIDENT_COHORT", None)
    monkeypatch.setattr(jax_driver, "_SNAPSHOT_TIER", None)
    monkeypatch.setattr(jax_egress, "_EGRESS", None)
    monkeypatch.setattr(jax_wr, "_REDUCE_IMPL", {})
    monkeypatch.setattr(jax_sharded, "_TABLE_MODE", None)
    monkeypatch.setattr(evidence, "PERF_PATH", str(port_path))
    for name in PINS:
        monkeypatch.delenv(name, raising=False)
    reset_port()

    def configure(sections, card=False, foreign=False):
        backend = "tpu" if card else "cpu"
        label = CARD if card else "cpu"
        jax_file = {"backend": "gpu" if foreign else backend}
        port_label = "NVIDIA A100-SXM4-80GB" if foreign else label
        jax_file.update(sections(backend))
        jax_path.write_text(json.dumps(jax_file))
        port_path.write_text(json.dumps(
            {"devices": {port_label: sections(label)}}))
        monkeypatch.setattr(jax, "default_backend", lambda: backend)
        if card:
            monkeypatch.setattr(evidence, "device_label",
                                lambda device=None: CARD)

    yield configure
    reset_port()


def secs(**rates) -> dict:
    """Each arm's turns as utils/evidence_ab.py writes them, all equal:
    `<arm>_s_min` = `<arm>_s_max` = 1e6 / its rate (the card's gate
    reads the turns; the JAX rule reads the rates)."""
    return {"%s_%s" % (arm, end): 1e6 / rate for arm, rate in rates.items()
            for end in ("s_min", "s_max")}


def sections_at(r: float, parity: bool = True, resident: float = None,
                drop=(), buckets=(8192, 32768)):
    """Every section of the routing with its alternative at r times its
    baseline (`resident` overrides the resident row's ratio), `drop`
    naming rate keys left out (malformed rows). A function of the
    label the sharded row carries as its backend."""
    res = r if resident is None else resident

    def row(**kv):
        return {k: v for k, v in kv.items() if k not in drop}

    def make(label):
        return {
            "host_stream": [row(edge_bucket=eb, parity=parity,
                                device_edges_per_s=1e6,
                                host_edges_per_s=r * 1e6,
                                native_parity=parity,
                                native_edges_per_s=r * r * 1e6,
                                **secs(device=1e6, host=r * 1e6,
                                       native=r * r * 1e6))
                            for eb in buckets],
            "ingress_ab": [row(probe="stream_ab", parity=parity,
                               speedup=r, **secs(std=1e6, compact=r * 1e6))],
            "window": [{"edge_bucket": 8192,
                        "k_sweep": [{"k_bucket": 64, "per_window_ms": 2.0},
                                    {"k_bucket": 32, "per_window_ms": 1.0}],
                        "chunk_sweep": [
                            {"windows_per_dispatch": 32,
                             "per_window_ms": 1.5},
                            {"windows_per_dispatch": 16,
                             "per_window_ms": 1.2}]}],
            "resident_ab": [row(probe="driver_resident", parity=parity,
                                scan_edges_per_s=1e6,
                                native_edges_per_s=1e6,
                                resident_edges_per_s=res * 1e6,
                                **secs(scan=1e6, native=1e6,
                                       resident=res * 1e6))],
            "tenancy_ab": [row(probe="cohort_resident", parity=parity,
                               sequential_edges_per_s=1e6,
                               tenant_edges_per_s=r * 1e6,
                               **secs(sequential=1e6, tenant=r * 1e6))],
            "host_snapshot": [row(parity=parity, scan_edges_per_s=1e6,
                                  native_edges_per_s=r * 1e6)],
            "egress_ab": [row(probe="driver_ab", parity=parity, speedup=r,
                              **secs(full=1e6, delta=r * 1e6))],
            "host_reduce": [row(name="sum", edge_bucket=8192, parity=parity,
                                device_edges_per_s=1e6,
                                host_edges_per_s=r * 1e6,
                                native_parity=parity,
                                native_edges_per_s=r * r * 1e6,
                                **secs(device=1e6, host=r * 1e6,
                                       native=r * r * 1e6))],
            "sharded_table": row(backend=label, counts_match=parity,
                                 replicated_edges_per_s=1e6,
                                 owner_edges_per_s=r * 1e6,
                                 rows=[row(counts_match=parity,
                                           **secs(replicated=1e6,
                                                  owner=r * 1e6))]),
        }

    return make


def empty(_label):
    return {k: [] for k in ("host_stream", "ingress_ab", "window",
                            "resident_ab", "tenancy_ab", "host_snapshot",
                            "egress_ab", "host_reduce")} | {
        "sharded_table": {}}


def error_stubs(label):
    return {k: {"error": "RuntimeError: section failed"}
            for k in sections_at(1.3)(label)}


def ingress_only(label):
    return {"ingress_ab": sections_at(1.3)(label)["ingress_ab"]}


def per_bucket(label):
    s = sections_at(1.3)(label)
    lose = sections_at(1.0)(label)["host_stream"]
    s["host_stream"] = [s["host_stream"][0], lose[1]]   # 8192 wins only
    return s


def sweep_without_value(label):
    s = sections_at(1.3)(label)
    s["window"] = [
        {"edge_bucket": 8192,
         "k_sweep": [{"per_window_ms": 0.5},            # no k_bucket
                     {"k_bucket": 32, "per_window_ms": 1.0},
                     {"k_bucket": 16}],                 # no time
         "chunk_sweep": [{"per_window_ms": 0.1},
                         {"windows_per_dispatch": 8,
                          "per_window_ms": 3.0}]},
        {"edge_bucket": 32768, "k_sweep": []}]          # no sweep rows
    return s


CASES = {
    "clean_win": (sections_at(1.3), False, False),
    "native_snapshot": (sections_at(1.3, resident=1.0), False, False),
    "margin_1_04": (sections_at(1.04), False, False),
    "no_parity": (sections_at(1.3, parity=False), False, False),
    "malformed": (sections_at(1.3, drop=(
        "device_edges_per_s", "speedup", "scan_edges_per_s",
        "sequential_edges_per_s", "replicated_edges_per_s")),
        False, False),
    "empty_sections": (empty, False, False),
    "error_stubs": (error_stubs, False, False),
    "other_device": (sections_at(1.3), False, True),
    "vb_gate": (ingress_only, False, False),
    "per_bucket_card": (per_bucket, True, False),
    "sweep_without_value": (sweep_without_value, False, False),
}


def jax_choices(card: bool) -> dict:
    out = {
        "stream": [jax_tri._resolve_stream_impl(eb)
                   for eb in (None, 8192, 32768)],
        "ingress": [jax_tri.resolve_ingress(vb)
                    for vb in (65536, 1 << 17, 32768)],
        "kb": [jax_tri._tuned_kb(eb) for eb in (8192, 32768)],
        "resident": jax_res.resolve_resident(),
        "resident_cohort": jax_res.resolve_resident_cohort(),
        "snapshot": jax_driver.resolve_snapshot_tier(),
        "egress": jax_egress.resolve_egress(),
        "reduce": [jax_wr._resolve_reduce_impl("sum"),
                   jax_wr._resolve_reduce_impl("sum", allow_native=False),
                   jax_wr._resolve_reduce_impl("min")],
        "table": jax_sharded.resolve_table_mode(),
    }
    if not card:   # on a TPU the JAX chunk is capped by its compiler
        out["chunk"] = [jax_tri._tuned_chunk(eb) for eb in (8192, 32768)]
    return out


def port_choices(card: bool) -> dict:
    dev = "cpu"
    out = {
        "stream": [triangles._resolve_stream_impl(eb, dev)
                   for eb in (None, 8192, 32768)],
        "ingress": [triangles.resolve_ingress(None, vb, dev)
                    for vb in (65536, 1 << 17, 32768)],
        "kb": [triangles._tuned_kb(eb, dev) for eb in (8192, 32768)],
        "resident": resident_engine.resolve_resident(dev),
        "resident_cohort": resident_engine.resolve_resident_cohort(dev),
        "snapshot": driver.resolve_snapshot_tier(dev),
        "egress": delta_egress.resolve_egress(dev),
        "reduce": [windowed_reduce._resolve_reduce_impl("sum", device=dev),
                   windowed_reduce._resolve_reduce_impl(
                       "sum", allow_native=False, device=dev),
                   windowed_reduce._resolve_reduce_impl("min", device=dev)],
        "table": sharded.resolve_table_mode(dev),
    }
    if not card:
        out["chunk"] = [triangles._tuned_chunk(eb, dev)
                        for eb in (8192, 32768)]
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_resolver_chooses_as_jax(evidence_env, case):
    if not (native.available() and native.snapshot_available()
            and native.triangles_available()):
        pytest.skip("the native library cannot build here: %s"
                    % native.build_error())
    sections, card, foreign = CASES[case]
    evidence_env(sections, card=card, foreign=foreign)
    want, got = jax_choices(card), port_choices(card)
    assert got == want
    # the gate itself is the JAX rule
    for rows, args in ((sections("cpu").get("egress_ab"),
                        ("speedup", lambda r: 1.0)),
                       (sections("cpu").get("host_snapshot"),
                        ("native_edges_per_s", "scan_edges_per_s"))):
        assert evidence.rows_clear_bar(rows, *args) \
            == jax_tri.rows_clear_bar(rows, *args)
    if case == "clean_win":   # the win the cases are measured against
        assert got["stream"][1:] == ["native", "native"]
        assert got["ingress"] == ["compact", "standard", "compact"]
        assert got["kb"] == [32, triangles.default_kb(32768)]
        assert got["chunk"] == [16, 64]
        assert got["resident"] and got["resident_cohort"]
        assert (got["snapshot"], got["egress"], got["table"]) == (
            "resident", "delta", "owner")
        assert got["reduce"] == ["native", "host", "device"]
    if case == "per_bucket_card":
        assert got["stream"] == ["device", "native", "device"]
        assert got["snapshot"] == "resident"


def slow_turns(label):
    """sections_at(1.3), every arm's slowest turn as slow as the
    baseline's median: the medians clear the bar, the worst pairing
    (1.0x) does not."""
    sec = sections_at(1.3)(label)

    def slow(row):
        if isinstance(row, dict):
            for key in [k for k in row if k.endswith("_s_max")]:
                row[key] = 1.0
            for sub in row.get("rows", []):
                slow(sub)

    for rows in sec.values():
        for row in rows if isinstance(rows, list) else [rows]:
            slow(row)
    return sec


def test_card_adopts_only_on_the_worst_turns(evidence_env):
    """On a card every gate reads the worst pairing of the turns, so rows
    whose medians clear the bar inside their spread route nothing the
    JAX rule (medians) would move, and a row without the default arm's
    times keeps the default."""
    if not (native.available() and native.triangles_available()):
        pytest.skip("the native library cannot build here: %s"
                    % native.build_error())
    evidence_env(slow_turns, card=True)
    got, jax_got = port_choices(True), jax_choices(True)
    assert jax_got["stream"][1:] == ["native", "native"]
    assert got["stream"] == ["device"] * 3
    assert got["ingress"] == ["standard"] * 3
    assert (got["resident"], got["resident_cohort"], got["snapshot"],
            got["egress"], got["table"]) == (False, False, "scan", "full",
                                             "replicated")
    assert got["reduce"] == ["device"] * 3
    assert got["kb"] == jax_got["kb"]    # K is the fastest row, no bar
    reset_port()
    evidence_env(sections_at(1.3, drop=("device_s_min", "device_s_max")),
                 card=True)
    got = port_choices(True)
    assert got["reduce"] == ["device"] * 3
    assert got["stream"] == ["device"] * 3
    assert got["egress"] == "delta"      # its rows have both arms' turns


def test_unreadable_rows_fall_back_to_every_default(evidence_env,
                                                    monkeypatch):
    """Where the rows raise, each resolver returns its default, emits
    `selection.fallback` and memoizes nothing."""
    from gelly_streaming_tpu_torch.utils import telemetry

    def broken(label):
        raise RuntimeError("unreadable")

    seen = []
    monkeypatch.setattr(evidence, "load_label", broken)
    monkeypatch.setattr(telemetry, "event",
                        lambda name, **kw: seen.append((name, kw)))
    assert port_choices(False) == {
        "stream": ["device"] * 3, "ingress": ["standard"] * 3,
        "kb": [triangles.default_kb(8192), triangles.default_kb(32768)],
        "resident": False, "resident_cohort": False, "snapshot": "scan",
        "egress": "full", "reduce": ["device"] * 3,
        "table": "replicated", "chunk": [64, 64]}
    assert evidence._CHOSEN == {}
    assert {kw["component"] for name, kw in seen
            if name == "selection.fallback"} == {
        "stream_impl", "ingress", "tuned_kb", "tuned_chunk", "resident",
        "resident_cohort", "snapshot_tier", "egress", "windowed_reduce",
        "sharded_table"}


@pytest.mark.parametrize("rows, base, want", [
    ([{"parity": True, "a_s_max": 1.0, "b_s_min": 1.06}], "b", True),
    ([{"parity": True, "a_s_max": 1.0, "b_s_min": 1.04}], "b", False),
    ([{"parity": False, "a_s_max": 1.0, "b_s_min": 2.0}], "b", False),
    ([{"parity": True, "a_s_max": 1.0}], "b", False),
    ([{"parity": True, "b_s_min": 2.0}], "b", False),
    ([{"parity": True, "a_s_max": 0, "b_s_min": 2.0}], "b", False),
    ([{"parity": True, "a_s_max": 1.0, "b_s_min": 2.0, "c_s_min": 1.0}],
     ("b", "c"), False),
    ([{"parity": True, "a_s_max": 1.0, "b_s_min": 2.0}], ("b", "c"), True),
    ([{"parity": True, "a_s_max": 1.0, "c_s_min": 2.0}], ("b", "c"), False),
    ([], "b", False), (None, "b", False),
])
def test_worst_clears_bar(rows, base, want):
    assert evidence.worst_clears_bar(rows, "a", base) is want


def test_load_matching_drops_stubs_and_refuses_bad_files(evidence_env,
                                                         tmp_path):
    evidence_env(error_stubs)
    assert evidence.load_matching("cpu") == {}
    assert evidence.load_label(CARD) is None
    path = tmp_path / "PERF_torch.json"
    for text in ("{", "[]", json.dumps({"devices": {"cpu": [1]}}),
                 json.dumps({"backend": "cpu", "ingress_ab": []})):
        path.write_text(text)
        assert evidence.load_matching("cpu") is None
    path.unlink()
    assert evidence.load_matching("cpu") is None
    assert evidence.device_label("cpu") == "cpu"
    assert evidence.device_label(torch.device("cpu")) == "cpu"


def _edges(seed=3, n=2048, v=200):
    return make_stream(n, v, seed=seed)


WINDOW_FIELDS = ("window_start", "num_edges", "triangles")
WINDOW_ARRAYS = ("vertex_ids", "degrees", "cc_labels", "bipartite_odd")
WINDOW_DELTAS = ("delta_degrees", "delta_cc", "delta_bipartite")


def same_windows(want, got) -> None:
    assert len(want) == len(got) > 1
    for w, g in zip(want, got):
        for f in WINDOW_FIELDS:
            assert getattr(w, f) == getattr(g, f), f
        for f in WINDOW_ARRAYS:
            np.testing.assert_array_equal(getattr(w, f), getattr(g, f),
                                          err_msg=f)
        for f in WINDOW_DELTAS:
            for a, b in zip(getattr(w, f), getattr(g, f)):
                np.testing.assert_array_equal(a, b, err_msg=f)


def same_rows(want, got, exact=True) -> None:
    assert len(want) == len(got) > 1
    for (c1, n1), (c2, n2) in zip(want, got):
        np.testing.assert_array_equal(n1, n2)
        if exact:
            np.testing.assert_array_equal(c1[n1 > 0], c2[n2 > 0])
        else:
            np.testing.assert_allclose(c1[n1 > 0], c2[n2 > 0], rtol=1e-6)


def routed_rows(snapshot: float):
    """Rows at eb=128 that adopt every alternative but the resident
    tier, with the native snapshot fold at `snapshot` times the scan."""
    def make(label):
        s = sections_at(1.3, resident=1.0, buckets=(128,))(label)
        s["host_snapshot"][0]["native_edges_per_s"] = snapshot * 1e6
        s["window"] = [{"edge_bucket": 128,
                        "k_sweep": [{"k_bucket": 8, "per_window_ms": 0.5}],
                        "chunk_sweep": [{"windows_per_dispatch": 4,
                                         "per_window_ms": 0.5}]}]
        return s

    return make


def test_routed_engines_equal_their_pinned_defaults(evidence_env):
    """On rows that adopt every alternative, the engines given no pins
    take them, and their counts, summaries, driver windows and reduce
    rows equal those of the engines pinned to today's defaults."""
    if not (native.available() and native.snapshot_available()):
        pytest.skip("the native library cannot build here: %s"
                    % native.build_error())
    evidence_env(routed_rows(1.3))
    src, dst = _edges()
    dev, kb0 = "cpu", triangles.default_kb(128)

    routed = TriangleWindowKernel(128, 256, device=dev)
    pinned = TriangleWindowKernel(128, 256, k_bucket=kb0, device=dev,
                                  ingress="standard", stream_tier="device")
    assert (routed.stream_tier, routed.kb, routed.MAX_STREAM_WINDOWS,
            routed.ingress) == ("native", 8, 4, "compact")
    want = pinned.count_stream(src, dst)
    assert routed.count_stream(src, dst) == want
    on_device = TriangleWindowKernel(128, 256, device=dev,
                                     stream_tier="device")
    assert (on_device.kb, on_device.ingress) == (8, "compact")
    assert on_device.count_stream(src, dst) == want
    assert triangles.triangle_count(src[:128], dst[:128], 256, dev) \
        == want[0]

    eng = StreamSummaryEngine(128, 256, device=dev)
    twin = StreamSummaryEngine(128, 256, k_bucket=kb0, device=dev,
                               ingress="standard")
    assert (eng.kb, eng.ingress) == (8, "compact")
    assert eng.process(src, dst) == twin.process(src, dst)

    ids_s, ids_d = src * 7 + 3, dst * 7 + 3
    kw = dict(window_ms=1, edge_bucket=128, vertex_bucket=256, device=dev,
              emit_deltas=True)
    base = StreamingAnalyticsDriver(snapshot_tier="scan", egress="full",
                                    **kw).run_arrays(ids_s, ids_d)
    drv = StreamingAnalyticsDriver(**kw)
    assert (drv.snapshot_tier, drv.egress) == ("native", "delta")
    same_windows(base, drv.run_arrays(ids_s, ids_d))

    val = (1 + (src + 3 * dst) % 97).astype(np.int64)
    for name, tier in (("sum", "native"), ("min", "device")):
        red = WindowedEdgeReduce(256, 128, name, device=dev)
        plain = WindowedEdgeReduce(256, 128, name, device=dev,
                                   tier="device", egress="full",
                                   ingress="standard")
        assert (red.tier, red.egress, red.ingress) == (tier, "delta",
                                                       "compact")
        same_rows(plain.process_stream(src, dst, val),
                  red.process_stream(src, dst, val))
    # float values the native tier cannot fold go where the rows without
    # it point (host)
    fval = val.astype(np.float32) / 4
    red = WindowedEdgeReduce(256, 128, "sum", device=dev)
    plain = WindowedEdgeReduce(256, 128, "sum", device=dev, tier="device")
    same_rows(plain.process_stream(src, dst, fval),
              red.process_stream(src, dst, fval), exact=False)

    # the snapshot fold losing: the scan tier on the delta wire
    reset_port()
    evidence_env(routed_rows(1.0))
    drv = StreamingAnalyticsDriver(**kw)
    assert (drv.snapshot_tier, drv.egress) == ("scan", "delta")
    same_windows(base, drv.run_arrays(ids_s, ids_d))


def test_without_evidence_every_default_is_unchanged(evidence_env,
                                                     tmp_path):
    """No evidence file: each resolver returns the default the port had
    before the routing, and engines given no pins are those defaults."""
    assert not (tmp_path / "PERF_torch.json").exists()
    dev = "cpu"
    assert port_choices(False) == {
        "stream": ["device"] * 3,
        "ingress": ["standard"] * 3,
        "kb": [triangles.default_kb(8192), triangles.default_kb(32768)],
        "resident": False, "resident_cohort": False, "snapshot": "scan",
        "egress": "full", "reduce": ["device"] * 3,
        "table": "replicated", "chunk": [64, 64]}
    k = TriangleWindowKernel(128, 256, device=dev)
    kb0 = TriangleWindowKernel(128, 256, device=dev,
                               k_bucket=triangles.default_kb(128)).kb
    assert (k.stream_tier, k.ingress, k.kb, k.MAX_STREAM_WINDOWS) == (
        "device", "standard", kb0, 64)
    drv = StreamingAnalyticsDriver(window_ms=1, edge_bucket=128,
                                   vertex_bucket=256, device=dev)
    assert (drv.snapshot_tier, drv.egress, drv.egress_cap) == (
        "scan", "full", None)
    assert delta_egress.egress_cap(128, 256) == 256
    red = WindowedEdgeReduce(256, 128, "sum", device=dev)
    assert (red.tier, red.egress, red.ingress) == ("device", "full",
                                                   "standard")
    eng = StreamSummaryEngine(128, 256, device=dev)
    assert (eng.kb, eng.ingress) == (kb0, "standard")
    # the pins still win over an absent file, as over rows
    assert triangles.resolve_ingress("compact", 256) == "compact"
    with pytest.raises(ValueError, match="lossy"):
        triangles.resolve_ingress("compact", 1 << 17)
    with pytest.raises(ValueError, match="unknown tier"):
        WindowedEdgeReduce(256, 128, "sum", device=dev, tier="gpu")


def test_knob_pins_win_over_rows(evidence_env, monkeypatch):
    evidence_env(sections_at(1.3))
    for knob, value, call, want in (
            ("GS_RESIDENT", "off",
             lambda: resident_engine.resolve_resident("cpu"), False),
            ("GS_COHORT_RESIDENT", "off",
             lambda: resident_engine.resolve_resident_cohort("cpu"), False),
            ("GS_EGRESS", "full",
             lambda: delta_egress.resolve_egress("cpu"), "full")):
        monkeypatch.setenv(knob, value)
        assert call() == want
        monkeypatch.delenv(knob)
    monkeypatch.setenv("GS_EGRESS_CAP", "5")
    assert delta_egress.egress_cap(128, 256) == jax_egress.egress_cap(
        128, 256) == 5
    assert delta_egress.egress_cap(128, 256, cap=9) == 9
    monkeypatch.setenv("GS_RESIDENT", "on")
    assert driver.resolve_snapshot_tier("cpu") \
        == jax_driver.resolve_snapshot_tier() == "resident"


def expected_choices(sec: dict, label: str) -> dict:
    """What the resolvers must choose on the sections `sec` of device
    `label`, computed here from the rows and the gate."""
    gate = evidence.rows_clear_bar
    stream = [r for r in sec["host_stream"]]

    def tier(rows):
        impl = "device"
        if gate(rows, "host_edges_per_s", "device_edges_per_s"):
            impl = "host"
        if gate(rows, "native_edges_per_s",
                lambda r: max(r["device_edges_per_s"],
                              r["host_edges_per_s"]),
                parity_key="native_parity") and native.triangles_available():
            impl = "native"
        return impl

    def fastest(eb, sweep, key, default):
        rows = [s for row in sec["window"] if row["edge_bucket"] == eb
                for s in row[sweep]]
        return min(rows, key=lambda s: s["per_window_ms"])[key] \
            if rows else default

    red = sec["host_reduce"]
    host_red = all(r["host_edges_per_s"] >= 1.05 * r["device_edges_per_s"]
                   for r in red)
    nat_red = all(r["native_edges_per_s"] >= 1.05 * max(
        r["device_edges_per_s"], r["host_edges_per_s"]) for r in red)
    res = [r for r in sec["resident_ab"] if r["probe"] == "driver_resident"]
    table = sec.get("sharded_table", {})
    return {
        "stream": tier(stream),
        "ingress": "compact" if gate(sec["ingress_ab"], "speedup",
                                     lambda r: 1.0) else "standard",
        "kb": {eb: fastest(eb, "k_sweep", "k_bucket",
                           triangles.default_kb(eb))
               for eb in {r["edge_bucket"] for r in sec["window"]}},
        "chunk": {eb: fastest(eb, "chunk_sweep", "windows_per_dispatch", 64)
                  for eb in {r["edge_bucket"] for r in sec["window"]}},
        "resident": gate(res, "resident_edges_per_s", lambda r: max(
            r["scan_edges_per_s"], r.get("native_edges_per_s") or 0)),
        "cohort": gate(sec["tenancy_ab"], "tenant_edges_per_s",
                       "sequential_edges_per_s"),
        "egress": "delta" if gate(sec["egress_ab"], "speedup",
                                  lambda r: 1.0) else "full",
        "reduce": ("native" if nat_red and native.windowed_reduce_available()
                   else "host" if host_red else "device"),
        "table": "owner" if (table and table["backend"] == label
                             and table["counts_match"] is True
                             and table["owner_edges_per_s"] >= 1.05
                             * table["replicated_edges_per_s"])
        else "replicated",
    }


def test_evidence_ab_rows_route_the_resolvers(evidence_env, tmp_path,
                                              monkeypatch):
    """utils/evidence_ab.py at toy buckets on the CPU: every section's
    rows hold parity and the JAX keys, the file keeps another device's
    rows, and each resolver routes on the written rows as the gate
    computed from them says; the same rows filed under another name
    route nothing."""
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.utils import evidence_ab as ab

    if not native.available():
        pytest.skip("the native library cannot build here: %s"
                    % native.build_error())
    for name, value in (("EB", 128), ("VB", 256), ("BUCKETS", (64, 128)),
                        ("K_SWEEP", (8, 16, 32)), ("CHUNK_SWEEP", (2, 4, 8)),
                        ("CO_EB", 64), ("CO_VB", 128), ("CO_TENANTS", 2),
                        ("TURNS", 1)):
        monkeypatch.setattr(ab, name, value)
    sections = [s for s in ab.SECTIONS
                if s != "sharded_table" or not dist.is_initialized()]
    out = tmp_path / "PERF_torch.json"
    out.write_text(json.dumps({"devices": {CARD: {"egress_ab": []}}}))
    w = ab.run(str(out), device="cpu", windows=8, sections=sections,
               log=lambda _m: None)
    perf = json.loads(out.read_text())
    assert perf["devices"][CARD] == {"egress_ab": []}
    reset_port()     # the engines made above resolved on the old file
    sec = perf["devices"]["cpu"]
    assert set(sec) == set(sections) == set(w.seconds)
    for rows in (sec["host_stream"], sec["host_reduce"]):
        assert all(r["parity"] is True and r["native_parity"] is True
                   and r["host_edges_per_s"] > 0 for r in rows)
    for name in ("ingress_ab", "egress_ab", "resident_ab", "tenancy_ab"):
        assert all(r["parity"] is True and r["speedup"] > 0
                   and r["backend"] == "cpu" for r in sec[name])
    assert {r["probe"] for r in sec["resident_ab"]} == {
        "driver_resident", "engine_resident"}
    assert {"resident_edges_per_s", "scan_edges_per_s",
            "perwindow_edges_per_s", "native_edges_per_s"} <= set(
        sec["resident_ab"][0])
    for row in sec["window"]:
        assert [s["k_bucket"] for s in row["k_sweep"]] == [8, 16, 32]
        assert [s["windows_per_dispatch"] for s in row["chunk_sweep"]] == [
            2, 4, 8]
    if "sharded_table" in sec:
        assert sec["sharded_table"]["counts_match"] is True
    want = expected_choices(sec, "cpu")
    dev = "cpu"
    assert triangles._resolve_stream_impl(64, dev) == want["stream"]
    assert triangles.resolve_ingress(None, 256, dev) == want["ingress"]
    for eb, kb in want["kb"].items():
        assert triangles._tuned_kb(eb, dev) == kb
        assert triangles._tuned_chunk(eb, dev) == want["chunk"][eb]
    assert resident_engine.resolve_resident(dev) is want["resident"]
    assert resident_engine.resolve_resident_cohort(dev) is want["cohort"]
    assert delta_egress.resolve_egress(dev) == want["egress"]
    assert windowed_reduce._resolve_reduce_impl("sum", device=dev) \
        == want["reduce"]
    if "sharded_table" in sec:
        assert sharded.resolve_table_mode(dev) == want["table"]
    # the same rows under another device's name route nothing
    out.write_text(json.dumps({"devices": {CARD: sec}}))
    reset_port()
    assert port_choices(False) == {
        "stream": ["device"] * 3, "ingress": ["standard"] * 3,
        "kb": [triangles.default_kb(8192), triangles.default_kb(32768)],
        "resident": False, "resident_cohort": False, "snapshot": "scan",
        "egress": "full", "reduce": ["device"] * 3,
        "table": "replicated", "chunk": [64, 64]}
