"""The port's serving front end (gelly_streaming_tpu_torch/core/serve.py)
against the JAX package's (gelly_streaming_tpu/core/serve.py) on the CPU.

Each case of tests/test_serve.py runs here twice, once through each
package's `StreamServer` and `ServeClient` over loopback in this
process, on the same numpy-seeded streams: every wire reply (all fields;
a `message` may differ only where it names a module path, and `port`,
each server's own ephemeral port, is left out), every result row
(tenant, window, summary), the results JSONL byte for byte, the health
section and the drain summary must be equal, and the JAX test's own
checks hold on the port's. The JAX cohort runs its XLA form
(GS_COHORT_RESIDENT and GS_COHORT_PALLAS off, GS_AUTOTUNE=0); both get
the port's default K. The wire cases of tests/test_sanitize.py and
tests/test_latency.py, and the provenance delivery record, are held the
same way. Then: a journal and checkpoints written by one
package's server recover in the other's cohort, after a drain and after
a kill; and the standalone server (`python -m
gelly_streaming_tpu_torch.core.serve --device cpu`) drains on SIGTERM
and, killed in the middle of a window, recovers with `--recover` to the
uninterrupted JAX server's windows."""

import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import serve as jax_serve
from gelly_streaming_tpu.core import tenancy as jax_tenancy
from gelly_streaming_tpu.ops import pallas_window
from gelly_streaming_tpu.ops import resident_engine
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import latency as jax_latency
from gelly_streaming_tpu.utils import metrics as jax_metrics
from gelly_streaming_tpu.utils import provenance as jax_provenance
from gelly_streaming_tpu.utils import resilience as jax_resilience
from gelly_streaming_tpu.utils import sanitize as jax_sanitize
from gelly_streaming_tpu.utils import telemetry as jax_telemetry
from gelly_streaming_tpu.utils import wal as jax_wal
from gelly_streaming_tpu_torch.core import serve
from gelly_streaming_tpu_torch.core import tenancy
from gelly_streaming_tpu_torch.ops.triangles import default_kb
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import resilience
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry
from gelly_streaming_tpu_torch.utils import wal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EB, VB = 256, 512
KB = default_kb(EB)
PKGS = {
    "jax": SimpleNamespace(serve=jax_serve, tenancy=jax_tenancy,
                           faults=jax_faults, metrics=jax_metrics,
                           wal=jax_wal),
    "torch": SimpleNamespace(serve=serve, tenancy=tenancy, faults=faults,
                             metrics=metrics, wal=wal),
}
_KNOBS = ("GS_PUMP", "GS_SUB_QUEUE", "GS_SERVE_PORT", "GS_SERVE_DRAIN_S",
          "GS_SERVE_IDLE_S", "GS_TENANT_QUEUE_WINDOWS", "GS_TENANT_MAX",
          "GS_OOO_BOUND", "GS_METRICS", "GS_LATENCY", "GS_SANITIZE",
          "GS_PROVENANCE", "GS_TELEMETRY", "GS_STAGE_TIMEOUT_S",
          "GS_STAGE_RETRIES")
_RESETS = (telemetry, metrics, latency, provenance, sanitize,
           jax_telemetry, jax_metrics, jax_latency, jax_provenance,
           jax_sanitize)


def _reset():
    for m in _RESETS:
        m.reset()
    resilience.reset_demotions()
    jax_resilience.reset_demotions()
    resident_engine._reset_resident_cohort()
    pallas_window._reset_pallas_window()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in (("GS_AUTOTUNE", "0"), ("GS_COHORT_RESIDENT", "off"),
                 ("GS_COHORT_PALLAS", "off")):
        monkeypatch.setenv(k, v)
    _reset()
    yield
    _reset()
    torch.set_num_threads(threads)


def _stream(num_w, seed=0, extra=0):
    rng = np.random.default_rng(seed)
    n = num_w * EB + extra
    return (rng.integers(0, VB, n).astype(np.int32),
            rng.integers(0, VB, n).astype(np.int32))


def make(P):
    if P is PKGS["jax"]:
        return P.tenancy.TenantCohort(EB, VB, k_bucket=KB)
    return P.tenancy.TenantCohort(EB, VB, k_bucket=KB, device="cpu")


def _oracle(src, dst):
    """The port's cohort fed directly, one window a pump."""
    c = make(PKGS["torch"])
    c.admit("t")
    out = []
    for i in range(0, len(src), EB):
        c.feed("t", src[i:i + EB], dst[i:i + EB])
        out += c.pump().get("t", [])
    return out + c.close("t")


def norm(x):
    """A reply, section or row with `port` left out and module paths in
    `message` named as the JAX package names them."""
    if isinstance(x, dict):
        return {k: (v.replace("gelly_streaming_tpu_torch",
                              "gelly_streaming_tpu")
                    if k == "message" and isinstance(v, str) else norm(v))
                for k, v in x.items() if k != "port"}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    return x


def twin(run, tmp_path):
    """run(P, tmp) for each package, in its own directory; the two
    observations equal after `norm`. Returns the port's."""
    got = {}
    for pkg, P in PKGS.items():
        tmp = tmp_path / pkg
        tmp.mkdir()
        got[pkg] = run(P, tmp)
        _reset()
    assert norm(got["torch"]) == norm(got["jax"])
    return got["torch"]


def served(P, tmp, wal_ckpt=True, results=True, **kw):
    """The JAX tests' `server` fixture: a journal, checkpoints every two
    windows; here also a results file."""
    cohort = make(P)
    if wal_ckpt:
        cohort.enable_wal(str(tmp / "wal"))
        cohort.enable_auto_checkpoint(str(tmp / "ckpt"), every_n_windows=2)
    return P.serve.StreamServer(
        cohort, port=0,
        results_path=str(tmp / "out.jsonl") if results else None,
        **kw).start()


def results_bytes(tmp):
    path = tmp / "out.jsonl"
    return path.read_bytes() if path.exists() else None


def test_loopback_digest_equals_direct_feed(tmp_path):
    src, dst = _stream(4, seed=1)

    def run(P, tmp):
        srv = served(P, tmp)
        cli = P.serve.ServeClient(srv.port)
        try:
            replies = [cli.admit("t")]
            for i in range(0, len(src), EB):
                replies += [cli.feed("t", src[i:i + EB], dst[i:i + EB]),
                            cli.pump()]
            replies.append(cli.close_tenant("t"))
        finally:
            cli.close()
            srv.close()
        return {"replies": replies, "results": results_bytes(tmp)}

    got = twin(run, tmp_path)
    r = got["replies"]
    assert r[0] == {"ok": True, "tenant": "t"}
    assert all(x == {"ok": True, "accepted": EB} for x in r[1:-1:2])
    summaries = [row["summary"] for x in r[2:-1:2]
                 for row in x["results"].get("t", [])]
    summaries += [row["summary"] for row in r[-1]["results"]]
    assert summaries == _oracle(src, dst)
    assert [json.loads(line)["summary"]
            for line in got["results"].splitlines()] == summaries


def test_backpressure_wire_response_carries_retry_hint(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("GS_TENANT_QUEUE_WINDOWS", "1")
    src, dst = _stream(3, seed=2)

    def run(P, tmp):
        srv = served(P, tmp)
        cli = P.serve.ServeClient(srv.port)
        try:
            out = [cli.admit("t"), cli.feed("t", src[:EB], dst[:EB])]
            out.append(cli.feed("t", src[EB:3 * EB], dst[EB:3 * EB]))
            out.append(cli.feed("t", src[EB:3 * EB], dst[EB:3 * EB]))
            out.append(cli.pump())
            out.append(cli.feed("t", src[EB:2 * EB], dst[EB:2 * EB]))
            out.append(cli.feed("t", src[EB:3 * EB], dst[EB:3 * EB]))
        finally:
            cli.close()
            srv.close()
        return {"replies": out, "results": results_bytes(tmp)}

    r = twin(run, tmp_path)["replies"]
    assert r[1]["ok"]
    r1, r2, r3 = r[2], r[3], r[6]
    assert r1["ok"] is False and r1["error"] == "TenantBackpressure"
    assert r1["queued"] == EB and r1["capacity"] == EB
    assert r1["retry_after_s"] > 0
    # consecutive refusals double the hint, an accepted feed resets it
    assert r2["retry_after_s"] == 2 * r1["retry_after_s"]
    assert r[5]["ok"]
    assert r3["retry_after_s"] == r1["retry_after_s"]


def test_unknown_tenant_and_bad_request_are_typed(tmp_path):
    def run(P, tmp):
        srv = served(P, tmp)
        cli = P.serve.ServeClient(srv.port)
        try:
            return [cli.feed("ghost", [1], [2]),
                    cli.request(op="nonsense")]
        finally:
            cli.close()
            srv.close()

    r, bad = twin(run, tmp_path)
    assert r["ok"] is False and r["error"] == "TenantRejected"
    assert r["tenant"] == "ghost"
    assert bad["ok"] is False and bad["error"] == "BadRequest"


def test_connection_cap_answers_typed_busy(tmp_path):
    def run(P, tmp):
        srv = served(P, tmp, wal_ckpt=False, results=False,
                     max_connections=1)
        try:
            hold = P.serve.ServeClient(srv.port)
            held = hold.request(op="status")  # registered as active
            extra = P.serve.ServeClient(srv.port)
            r = extra.request(op="status")
            extra.close()
            hold.close()
        finally:
            srv.close()
        return {"held": held, "busy": r, "stats": srv._stats["busy"]}

    got = twin(run, tmp_path)
    assert got["held"]["ok"] and got["held"]["serve"]["pump"] == "sync"
    r = got["busy"]
    assert r["ok"] is False and r["error"] == "ServerBusy"
    assert r["retry_after_s"] > 0 and got["stats"] == 1


@pytest.mark.faults
def test_slow_client_is_shed_not_wedged(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_SERVE_IDLE_S", "0.3")
    src, dst = _stream(2, seed=3)

    def run(P, tmp):
        srv = served(P, tmp, wal_ckpt=False)
        try:
            slow = P.serve.ServeClient(srv.port, timeout=30)
            out = [slow.admit("t"), slow.feed("t", src[:EB], dst[:EB])]
            with P.faults.inject(P.faults.FaultSpec(
                    site="serve_send", on_call=1, action="hang",
                    seconds=1.0)):
                with pytest.raises((ConnectionError, OSError)):
                    slow.pump()
            # the pump still serves a fresh connection afterwards
            cli = P.serve.ServeClient(srv.port, timeout=30)
            out += [cli.feed("t", src[EB:], dst[EB:]), cli.pump()]
            cli.close()
            slow.close()
        finally:
            srv.close()
        return {"replies": out, "shed": srv._stats["shed"],
                "rows": srv.results, "results": results_bytes(tmp)}

    got = twin(run, tmp_path)
    r = got["replies"]
    assert r[2]["ok"] and len(r[3]["results"]["t"]) >= 1
    assert got["shed"] == 1
    assert [row["summary"] for row in got["rows"]["t"]] \
        == _oracle(src, dst)


def test_idle_connection_is_closed(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_SERVE_IDLE_S", "0.3")

    def run(P, tmp):
        srv = served(P, tmp, wal_ckpt=False, results=False)
        try:
            cli = P.serve.ServeClient(srv.port, timeout=30)
            first = cli.request(op="status")
            time.sleep(0.8)  # idle past the deadline
            with pytest.raises((ConnectionError, OSError)):
                cli.request(op="status")
            cli.close()
        finally:
            srv.close()
        return first

    first = twin(run, tmp_path)
    assert first["ok"] and first["serve"]["requests"] == 1


def test_drain_finalizes_queued_windows_and_seals(tmp_path):
    """Graceful drain loses nothing: windows still queued at drain time
    come out finalized, the journal is sealed, a checkpoint a tenant is
    written."""
    src, dst = _stream(4, seed=4)

    def run(P, tmp):
        srv = served(P, tmp)
        cli = P.serve.ServeClient(srv.port)
        replies = [cli.admit("t")]
        for i in range(0, len(src), EB):
            replies.append(cli.feed("t", src[i:i + EB], dst[i:i + EB]))
        cli.close()
        summary = srv.drain(deadline_s=5)
        srv.close()
        return {"replies": replies, "summary": summary,
                "rows": srv.results, "results": results_bytes(tmp),
                "sealed": P.wal.scan(str(tmp / "wal"))["sealed"],
                "ckpt": os.path.exists(str(tmp / "ckpt" / "tenant_t.npz"))}

    got = twin(run, tmp_path)
    assert got["summary"] == {"drained_windows": 4, "forced_connections": 0,
                              "windows_total": 4, "sealed": True}
    assert [row["summary"] for row in got["rows"]["t"]] \
        == _oracle(src, dst)
    assert got["sealed"] is True and got["ckpt"] is True


def test_file_tail_source_end_to_end(tmp_path):
    src, dst = _stream(2, seed=5)

    def run(P, tmp):
        path = str(tmp / "feed.txt")
        open(path, "w").close()
        srv = served(P, tmp, wal_ckpt=False)
        srv.cohort.enable_wal(str(tmp / "wal"))
        try:
            srv.attach_file_tail(path, "t", poll_s=0.02)
            with open(path, "a") as f:
                for s, d in zip(src.tolist(), dst.tolist()):
                    f.write("%d %d\n" % (s, d))
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                srv.pump_once()
                if sum(len(v) for v in srv.results.values()) >= 2:
                    break
                time.sleep(0.05)
        finally:
            summary = srv.drain(deadline_s=5)
            srv.close()
        return {"rows": srv.results, "summary": summary,
                "results": results_bytes(tmp),
                "offsets": P.wal.scan(str(tmp / "wal"))["offsets"]}

    got = twin(run, tmp_path)
    assert [row["summary"] for row in got["rows"]["t"]] \
        == _oracle(src, dst)
    # the tailed edges went through the journal too
    assert got["offsets"]["t"] == 2 * EB


def test_healthz_serve_section(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_METRICS", "1")

    def run(P, tmp):
        P.metrics.reset()
        srv = served(P, tmp)
        try:
            cli = P.serve.ServeClient(srv.port)
            cli.admit("t")
            src, dst = _stream(1, seed=6)
            cli.feed("t", src, dst)
            cli.pump()
            sec = P.metrics.health_snapshot()["serve"]
            status = cli.status()
            cli.close()
            port = sec["port"] == srv.port == status["serve"]["port"]
        finally:
            srv.close()
            P.metrics.reset()
        return {"section": sec, "status": status, "port": port}

    got = twin(run, tmp_path)
    sec = got["section"]
    assert got["port"] is True
    assert sec["windows"] >= 1 and sec["requests"] >= 3
    assert sec["wal"]["edges"] == EB
    assert sec["draining"] is False


def test_results_sink_jsonl(tmp_path):
    src, dst = _stream(2, seed=7)

    def run(P, tmp):
        srv = served(P, tmp, wal_ckpt=False)
        try:
            cli = P.serve.ServeClient(srv.port)
            cli.admit("t")
            cli.feed("t", src, dst)
            cli.pump()
            cli.close()
        finally:
            summary = srv.drain(deadline_s=5)
            srv.close()
        return {"summary": summary, "results": results_bytes(tmp)}

    got = twin(run, tmp_path)
    rows = [json.loads(line) for line in got["results"].splitlines()]
    assert [r["window"] for r in rows] == [0, 1]
    assert all(r["tenant"] == "t" for r in rows)
    assert [r["summary"] for r in rows] == _oracle(src, dst)


def test_missing_fields_come_back_as_bad_request(tmp_path):
    """A request missing required fields is the typed BadRequest, and the
    connection lives on."""
    def run(P, tmp):
        srv = served(P, tmp)
        cli = P.serve.ServeClient(srv.port)
        try:
            return [cli.request(op="feed"), cli.request(op="admit"),
                    cli.request(op="status")]
        finally:
            cli.close()
            srv.close()

    feed, admit, status = twin(run, tmp_path)
    assert feed["ok"] is False and feed["error"] == "BadRequest"
    assert "KeyError" in feed["message"]
    assert admit["ok"] is False and admit["error"] == "BadRequest"
    assert status["ok"] is True


# ----------------------------------------------------------------------
# the armed hooks at the wire (tests/test_sanitize.py :532-646,
# tests/test_latency.py :331-378, and the provenance delivery record)
# ----------------------------------------------------------------------
def test_disarmed_feed_never_wraps_huge_ids(tmp_path):
    """GS_SANITIZE off keeps the int32 cast in _op_feed: an id past
    int32 raises there and nothing is admitted."""
    def run(P, tmp):
        srv = P.serve.StreamServer(make(P), port=0)
        try:
            srv.cohort.admit("t")
            with pytest.raises((OverflowError, ValueError)) as err:
                srv._op_feed({"tenant": "t", "src": [2 ** 40], "dst": [1]})
            return {"error": type(err.value).__name__,
                    "queued": srv.cohort.tenants["t"].queued}
        finally:
            srv.close()

    assert twin(run, tmp_path)["queued"] == 0


def test_armed_feed_surfaces_rejections_and_status_dlq(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("GS_SANITIZE", "on")

    def run(P, tmp):
        monkeypatch.setenv("GS_DLQ_DIR", str(tmp / "dlq"))
        monkeypatch.delenv("GS_MAX_BATCH_EDGES", raising=False)
        srv = served(P, tmp, wal_ckpt=False, results=False)
        cli = P.serve.ServeClient(srv.port)
        try:
            out = [cli.admit("t"),
                   cli.feed("t", [1, 600, 2 ** 40, -2], [2, 3, 4, 5])]
            status = cli.status()["serve"]
            status["dlq"]["dir"] = os.path.basename(status["dlq"]["dir"])
            out += [status, cli.feed("t", [1], [2])]
            monkeypatch.setenv("GS_MAX_BATCH_EDGES", "4")
            out.append(cli.feed("t", [1] * 5, [2] * 5))
        finally:
            cli.close()
            srv.close()
        return out

    _admit, r, st, r2, r3 = twin(run, tmp_path)
    assert r["ok"] and r["accepted"] == 1 and r["rejected"] == 3
    assert r["reasons"] == {"id_negative": 1, "id_overflow": 1,
                            "id_out_of_range": 1}
    assert st["dlq"]["records"] == 3 and st["sanitize"] == "on"
    assert "rejected" not in r2 and "reasons" not in r2
    assert r3 == {"ok": False, "error": "BatchRejected", "tenant": "t",
                  "reason": "batch_overflow", "size": 5, "limit": 4,
                  "message": r3["message"]}


def test_quarantined_tenant_is_refused_by_its_own_name(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("GS_QUARANTINE_WINDOWS", "0")

    def run(P, tmp):
        srv = served(P, tmp, wal_ckpt=False, results=False)
        cli = P.serve.ServeClient(srv.port)
        try:
            out = [cli.admit("t")]
            srv.cohort.quarantine("t", "test")
            out += [cli.feed("t", [1], [2]), cli.status()["serve"]]
        finally:
            cli.close()
            srv.close()
        return out

    _admit, r, st = twin(run, tmp_path)
    assert r["ok"] is False and r["error"] == "TenantQuarantined"
    assert r["probation_left"] == -1 and st["quarantined"] == ["t"]


@pytest.mark.parametrize("demote", [False, True])
def test_armed_rows_carry_latency_and_a_serve_provenance_record(
        tmp_path, monkeypatch, demote):
    """GS_LATENCY and GS_PROVENANCE armed: each delivered row carries
    `latency_s` and `queue_edges`, and each window has a `tier="serve"`
    delivery record whose fields (all but each package's own `knobs` and
    `sig`) equal the JAX server's; a demoted tenant's rows too; the
    server's close hands the cohort back to finalize-time records."""
    monkeypatch.setenv("GS_LATENCY", "1")
    monkeypatch.setenv("GS_PROVENANCE", "1")
    src, dst = _stream(2, seed=8)

    def run(P, tmp):
        monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp / "prov"))
        srv = served(P, tmp, wal_ckpt=False, results=False)
        cli = P.serve.ServeClient(srv.port)
        try:
            cli.admit("t")
            if demote:
                srv.cohort.demote("t", reason="test")
            assert cli.feed("t", src.tolist(), dst.tolist())["ok"]
            rows = cli.pump()["results"]["t"]
            status = cli.status()["serve"]
        finally:
            cli.close()
            srv.close()
        PROV = provenance if P is PKGS["torch"] else jax_provenance
        PROV.reset()
        recs = [{k: v for k, v in r.items() if k not in ("knobs", "sig")}
                for r in PROV.scan(str(tmp / "prov"))["records"]]
        fields = all("latency_s" in r and "queue_edges" in r
                     and r["latency_s"] > 0 for r in rows)
        return {"rows": [{k: v for k, v in r.items() if k != "latency_s"}
                         for r in rows],
                "fields": fields, "serve_records": [
                    r for r in recs if r["tier"] == "serve"],
                "queues": status["queues"],
                "lat_tenants": sorted(status["latency"]["tenants"]),
                "deferred": srv.cohort.defer_delivery}

    got = twin(run, tmp_path)
    assert got["fields"] is True and len(got["rows"]) == 2
    assert [r["window"] for r in got["serve_records"]] == [0, 1]
    assert got["queues"]["t"]["edges"] == 0 and got["lat_tenants"] == ["t"]
    assert got["deferred"] is False


# ----------------------------------------------------------------------
# durable state across the packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("how", ["drain", "kill"])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_journal_and_checkpoints_recover_across_packages(tmp_path, writer,
                                                         reader, how):
    """A server of one package takes 3.5 windows in half-window feeds and
    pumps, then drains (a checkpoint at window 3, the journal sealed) or
    is killed (the last checkpoint at window 2, the journal open); the
    other package's cohort recovers from its journal and checkpoints and
    takes the rest: every window equals the uninterrupted stream's."""
    src, dst = _stream(6, seed=11, extra=EB // 3)
    want = _oracle(src, dst)
    W, R = PKGS[writer], PKGS[reader]
    wal_dir, ck = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    co = make(W)
    co.enable_wal(wal_dir)
    co.enable_auto_checkpoint(ck, every_n_windows=2)
    srv = W.serve.StreamServer(co, port=0).start()
    cli = W.serve.ServeClient(srv.port)
    cli.admit("t")
    head = 3 * EB + EB // 2
    for i in range(0, head, EB // 2):
        assert cli.feed("t", src[i:i + EB // 2], dst[i:i + EB // 2])["ok"]
        cli.pump()
    cli.close()
    if how == "drain":
        assert srv.drain(deadline_s=5)["sealed"] is True
        srv.close()
    else:
        srv.close()
        co._wal.close()
    before = [row["summary"] for row in srv.results["t"]]
    assert before == want[:3]

    rec = make(R)
    rec.admit("t")
    rec.enable_auto_checkpoint(ck, every_n_windows=2)
    rec.enable_wal(wal_dir)
    info = rec.recover()
    done = rec.windows_done("t")
    assert info["resumed"] == {"t": True}
    assert info["sealed"] is (how == "drain")
    assert done == (3 if how == "drain" else 2)
    assert info["replayed_edges"] == {"t": head - done * EB}
    out = rec.pump().get("t", [])
    for i in range(head, len(src), EB):
        rec.feed("t", src[i:i + EB], dst[i:i + EB])
        out += rec.pump().get("t", [])
    out += rec.close("t")
    assert before[:done] + out == want


# ----------------------------------------------------------------------
# the standalone server
# ----------------------------------------------------------------------
CLI_BUDGET_S = 120        # each subprocess test's own deadline


def _left(end) -> float:
    left = end - time.monotonic()
    assert left > 0, "the test ran past its %d s deadline" % CLI_BUDGET_S
    return left


def _cli_server(tmp, end, *extra):
    """Start `python -m gelly_streaming_tpu_torch.core.serve --device
    cpu` with a journal, checkpoints every 2 windows, a results file and
    a port file; returns (process, port)."""
    port_file = tmp / "port.txt"
    if port_file.exists():
        port_file.unlink()
    cmd = [sys.executable, "-m", "gelly_streaming_tpu_torch.core.serve",
           "--device", "cpu", "--edge-bucket", str(EB),
           "--vertex-bucket", str(VB), "--wal", str(tmp / "wal"),
           "--ckpt", str(tmp / "ckpt"), "--ckpt-every", "2",
           "--results", str(tmp / "out.jsonl"),
           "--port-file", str(port_file), *extra]
    env = dict(os.environ, GS_AUTOTUNE="0", PYTHONPATH=REPO)
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        while True:
            _left(end)
            text = port_file.read_text() if port_file.exists() else ""
            if text.strip():
                return proc, int(text)
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.05)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise


def _rows(tmp):
    return [json.loads(line)
            for line in (tmp / "out.jsonl").read_text().splitlines()]


def _wait_rows(tmp, n, proc, end):
    while not ((tmp / "out.jsonl").exists() and len(_rows(tmp)) >= n):
        _left(end)
        assert proc.poll() is None
        time.sleep(0.05)


def _stop(proc, sig, end):
    proc.send_signal(sig)
    return proc.communicate(timeout=_left(end))


def _reap(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_cli_sigterm_drains_and_seals(tmp_path):
    """SIGTERM after the feeds: exit 0, a `drained:` line with a sealed
    journal, and every accepted window in the results file."""
    end = time.monotonic() + CLI_BUDGET_S
    src, dst = _stream(4, seed=12)
    proc, port = _cli_server(tmp_path, end)
    try:
        cli = serve.ServeClient(port, timeout=_left(end))
        assert cli.admit("t")["ok"]
        for i in range(0, len(src), EB):
            assert cli.feed("t", src[i:i + EB], dst[i:i + EB]) \
                == {"ok": True, "accepted": EB}
        cli.close()
        out, err = _stop(proc, signal.SIGTERM, end)
    finally:
        _reap(proc)
    assert proc.returncode == 0, err
    drained = [line for line in out.splitlines()
               if line.startswith("drained: ")]
    assert len(drained) == 1
    summary = json.loads(drained[0][len("drained: "):])
    assert summary["sealed"] is True and summary["windows_total"] == 4
    assert wal.scan(str(tmp_path / "wal"))["sealed"] is True
    rows = _rows(tmp_path)
    assert [(r["tenant"], r["window"]) for r in rows] \
        == [("t", w) for w in range(4)]
    assert [r["summary"] for r in rows] == _oracle(src, dst)


def test_cli_sigkill_mid_window_recovers(tmp_path):
    """Two tenants; SIGKILL with half a window queued after windows were
    delivered, a restart with `--recover`, the rest of the streams, the
    closes and a SIGTERM drain: the last record per (tenant, window)
    equals the uninterrupted JAX server's rows."""
    end = time.monotonic() + CLI_BUDGET_S
    streams = {"a": _stream(6, seed=13, extra=EB // 4),
               "b": _stream(5, seed=14, extra=EB // 2)}
    head = 3 * EB + EB // 2
    proc, port = _cli_server(tmp_path, end)
    try:
        cli = serve.ServeClient(port, timeout=_left(end))
        for tid, (s, d) in streams.items():
            assert cli.admit(tid)["ok"]
            for i in range(0, head, EB // 2):
                assert cli.feed(tid, s[i:i + EB // 2],
                                d[i:i + EB // 2])["ok"]
        _wait_rows(tmp_path, 6, proc, end)
        cli.close()
        proc.kill()
        proc.communicate(timeout=_left(end))
    finally:
        _reap(proc)
    proc, port = _cli_server(tmp_path, end, "--recover")
    try:
        cli = serve.ServeClient(port, timeout=_left(end))
        for tid, (s, d) in streams.items():
            for i in range(head, len(s), EB):
                assert cli.feed(tid, s[i:i + EB], d[i:i + EB])["ok"]
            assert cli.close_tenant(tid)["ok"]
        cli.close()
        out, err = _stop(proc, signal.SIGTERM, end)
    finally:
        _reap(proc)
    assert proc.returncode == 0, err
    assert any(line.startswith("recovered: ") for line in out.splitlines())
    last = {}
    for r in _rows(tmp_path):
        last[(r["tenant"], r["window"])] = r["summary"]

    # the uninterrupted JAX server over the same streams
    jsrv = jax_serve.StreamServer(make(PKGS["jax"]), port=0).start()
    try:
        jcli = jax_serve.ServeClient(jsrv.port, timeout=_left(end))
        for tid, (s, d) in streams.items():
            jcli.admit(tid)
            for i in range(0, len(s), EB):
                jcli.feed(tid, s[i:i + EB], d[i:i + EB])
                jcli.pump()
            jcli.close_tenant(tid)
        jcli.close()
    finally:
        jsrv.close()
    want = {(r["tenant"], r["window"]): r["summary"]
            for rows in jsrv.results.values() for r in rows}
    assert last == want
