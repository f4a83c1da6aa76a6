"""The port's async serving pump (GS_PUMP=async), `subscribe` and the
cohort's GS_OOO_BOUND reorder buffer against the JAX package's, on the
CPU: each case of tests/test_serve_pump.py runs through both packages on
the same numpy-seeded streams.

Where the timing of the pump thread decides a reply (a feed refused by
backpressure and retried, the windows a drain still had to pump), the
cases compare what does not depend on it: every delivered row (tenant,
window, summary), each line of the results JSONL byte for byte (the
lines sorted: the rounds decide how tenants interleave), the accepted
feeds' replies, the drain's window total and seal, the demotion records. The
overlap case asserts that feeds were admitted while a dispatch was in
flight and that the windows are equal; it times nothing. Then the one
departure from the JAX server: a device error (a `KernelError` of the
cohort's launch) on the async pump thread marks the server fatal and
`serve_until_drained` raises it unwrapped, nothing quarantined or
demoted."""

import threading
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
from gelly_streaming_tpu_torch import kernels
from gelly_streaming_tpu_torch.core import serve
from gelly_streaming_tpu_torch.core import tenancy
from gelly_streaming_tpu_torch.ops import cohort_summary
from gelly_streaming_tpu_torch.ops.triangles import default_kb
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import resilience
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry

EB, VB = 256, 512
KB = default_kb(EB)
PKGS = {
    "jax": SimpleNamespace(serve=jax_serve, tenancy=jax_tenancy,
                           faults=jax_faults, latency=jax_latency,
                           resilience=jax_resilience),
    "torch": SimpleNamespace(serve=serve, tenancy=tenancy, faults=faults,
                             latency=latency, resilience=resilience),
}
_KNOBS = ("GS_PUMP", "GS_SUB_QUEUE", "GS_OOO_BOUND", "GS_SERVE_IDLE_S",
          "GS_TENANT_QUEUE_WINDOWS", "GS_LATENCY", "GS_METRICS",
          "GS_SANITIZE", "GS_PROVENANCE", "GS_TELEMETRY",
          "GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES")
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


def _stream(num_w, seed=0):
    rng = np.random.default_rng(seed)
    n = num_w * EB
    return (rng.integers(0, VB, n).astype(np.int32),
            rng.integers(0, VB, n).astype(np.int32))


def make(P):
    if P is PKGS["jax"]:
        return P.tenancy.TenantCohort(EB, VB, k_bucket=KB)
    return P.tenancy.TenantCohort(EB, VB, k_bucket=KB, device="cpu")


def _oracle(streams):
    """The port's cohort, one thread, windows in order."""
    c = make(PKGS["torch"])
    out = {}
    for tid in streams:
        c.admit(tid)
        out[tid] = []
    for tid, (s, d) in streams.items():
        for i in range(0, len(s), EB):
            c.feed(tid, s[i:i + EB], d[i:i + EB])
            out[tid] += c.pump().get(tid, [])
    for tid in streams:
        out[tid] += c.close(tid)
    return out


def twin(run, tmp_path):
    """run(P, tmp) for each package, in its own directory; the two
    observations equal. Returns the port's."""
    got = {}
    for pkg, P in PKGS.items():
        tmp = tmp_path / pkg
        tmp.mkdir()
        got[pkg] = run(P, tmp)
        _reset()
    assert got["torch"] == got["jax"]
    return got["torch"]


def _feed_all(cli, tid, src, dst, chunk=EB):
    """Feed riding the typed backpressure's retry hint; the accepted
    replies."""
    accepted = []
    for i in range(0, len(src), chunk):
        deadline = time.monotonic() + 60
        while True:
            r = cli.feed(tid, src[i:i + chunk], dst[i:i + chunk])
            if r.get("ok"):
                accepted.append(r)
                break
            assert r["error"] == "TenantBackpressure", r
            assert time.monotonic() < deadline, "backpressure wedged"
            time.sleep(r.get("retry_after_s", 0.05))
    return accepted


def _async_server(P, tmp, monkeypatch, **kw):
    monkeypatch.setenv("GS_PUMP", "async")
    srv = P.serve.StreamServer(make(P), port=0,
                               results_path=str(tmp / "out.jsonl"),
                               **kw).start()
    assert srv.pump_mode == "async"
    assert srv._pump_thread is not None and srv._pump_thread.is_alive()
    return srv


def _delivered(srv, tmp):
    """The rows the server delivered and its results file's lines (each
    byte for byte; sorted, since the pump thread's rounds decide how
    tenants interleave)."""
    return {"rows": srv.results,
            "results": sorted((tmp / "out.jsonl").read_bytes().splitlines())}


def _summaries(rows):
    return {tid: [r["summary"] for r in trows] for tid, trows in rows.items()}


def test_async_pump_digest_equals_sync_oracle(tmp_path, monkeypatch):
    streams = {"a": _stream(3, seed=1), "b": _stream(2, seed=2)}

    def run(P, tmp):
        srv = _async_server(P, tmp, monkeypatch)
        try:
            cli = P.serve.ServeClient(srv.port, timeout=60)
            replies = []
            for tid, (s, d) in streams.items():
                replies.append(cli.admit(tid))
                replies += _feed_all(cli, tid, s, d)
            cli.close()
            summary = srv.drain(deadline_s=60)
        finally:
            srv.close()
        return {"replies": replies, "sealed": summary["sealed"],
                "windows_total": summary["windows_total"],
                **_delivered(srv, tmp)}

    got = twin(run, tmp_path)
    assert _summaries(got["rows"]) == _oracle(streams)
    assert got["windows_total"] == 5


def test_async_pump_overlaps_ingest_with_dispatch(tmp_path, monkeypatch):
    """Hang one slab prep on the pump thread and feed through it: the
    accept loop keeps admitting (overlap_feeds counts those feeds) and
    the windows are the oracle's. Unlike the JAX case, the last feed
    waits until the pump has a dispatch in flight, so whether a feed
    overlaps does not hang on the machine's load."""
    src, dst = _stream(3, seed=3)

    def run(P, tmp):
        srv = _async_server(P, tmp, monkeypatch)
        try:
            cli = P.serve.ServeClient(srv.port, timeout=60)
            cli.admit("t")
            _feed_all(cli, "t", src[:EB], dst[:EB])
            with P.faults.inject(P.faults.FaultSpec(
                    site="tenant_prep", on_call=1, action="hang",
                    seconds=0.6)):
                _feed_all(cli, "t", src[EB:2 * EB], dst[EB:2 * EB])
                # the pump thread has a dispatch in flight (its prep hung
                # inside the plan): the next feed lands while it holds
                # the pump
                deadline = time.monotonic() + 30
                while not srv._pump_busy.is_set():
                    assert time.monotonic() < deadline, "the pump is idle"
                    time.sleep(0.001)
                _feed_all(cli, "t", src[2 * EB:], dst[2 * EB:])
            cli.close()
            srv.drain(deadline_s=60)
        finally:
            srv.close()
        return {"overlap": srv._stats["overlap_feeds"] >= 1,
                **_delivered(srv, tmp)}

    got = twin(run, tmp_path)
    assert got["overlap"] is True
    assert _summaries(got["rows"]) == _oracle({"t": (src, dst)})


def test_async_pump_races_feed_close_drain(tmp_path, monkeypatch):
    """Concurrent feeder threads against the live pump thread, then the
    drain: every tenant's windows equal the sequential oracle's, nothing
    lost, nothing doubled."""
    streams = {f"t{i}": _stream(2, seed=10 + i) for i in range(3)}

    def run(P, tmp):
        srv = _async_server(P, tmp, monkeypatch)
        try:
            errs = []

            def feeder(tid, s, d):
                try:
                    cli = P.serve.ServeClient(srv.port, timeout=60)
                    cli.admit(tid)
                    _feed_all(cli, tid, s, d)
                    cli.close()
                except Exception as e:  # raised after the join
                    errs.append((tid, e))

            threads = [threading.Thread(target=feeder, args=(tid, s, d))
                       for tid, (s, d) in streams.items()]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not errs, errs
            summary = srv.drain(deadline_s=60)
        finally:
            srv.close()
        return {"rows": srv.results, "sealed": summary["sealed"],
                "windows_total": summary["windows_total"]}

    got = twin(run, tmp_path)
    assert _summaries(got["rows"]) == _oracle(streams)
    assert got["windows_total"] == 6


def test_async_pump_survives_mid_pump_fault(tmp_path, monkeypatch):
    """A non-fatal injected fault in the pump thread's slab prep demotes
    that tenant onto its own engine, not the pump: the next rounds
    finalize every window, equal to the oracle's."""
    src, dst = _stream(2, seed=4)

    def run(P, tmp):
        srv = _async_server(P, tmp, monkeypatch)
        try:
            cli = P.serve.ServeClient(srv.port, timeout=60)
            cli.admit("t")
            with P.faults.inject(P.faults.FaultSpec(site="tenant_prep",
                                                    on_call=1)):
                _feed_all(cli, "t", src, dst)
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    if len(srv.results.get("t", ())) >= 2:
                        break
                    time.sleep(0.05)
            cli.close()
            srv.drain(deadline_s=60)
        finally:
            srv.close()
        return {"demotions": [(e["component"], e["from"], e["to"])
                              for e in P.resilience.demotion_events()],
                **_delivered(srv, tmp)}

    got = twin(run, tmp_path)
    assert _summaries(got["rows"]) == _oracle({"t": (src, dst)})
    assert got["demotions"] == [("tenant:t", "cohort", "single")]


def test_pump_default_sync_is_single_lock_legacy(tmp_path):
    """GS_PUMP unset: no pump thread, both serve locks are the one
    request lock, every reply equal and the windows the oracle's."""
    src, dst = _stream(2, seed=5)

    def run(P, tmp):
        srv = P.serve.StreamServer(make(P), port=0).start()
        try:
            locks = (srv.pump_mode, srv._pump_thread is None,
                     srv._ingest_lock is srv._lock,
                     srv._pump_mutex is srv._lock)
            cli = P.serve.ServeClient(srv.port, timeout=60)
            replies = [cli.admit("t")]
            for i in range(0, len(src), EB):
                replies += [cli.feed("t", src[i:i + EB], dst[i:i + EB]),
                            cli.pump()]
            replies.append(cli.close_tenant("t"))
            cli.close()
        finally:
            srv.close()
        return {"locks": locks, "replies": replies}

    got = twin(run, tmp_path)
    assert got["locks"] == ("sync", True, True, True)
    r = got["replies"]
    summaries = [row["summary"] for x in r[2:-1:2]
                 for row in x["results"].get("t", [])]
    summaries += [row["summary"] for row in r[-1]["results"]]
    assert summaries == _oracle({"t": (src, dst)})["t"]


def test_async_pump_stress_more_feeders_than_cores(tmp_path, monkeypatch):
    """More feeder threads than cores against the port's pump thread,
    with a short switch interval: every tenant's windows are delivered
    once each, equal to the sequential oracle's (a lost or doubled
    update of a queue, a cursor or the results would break it)."""
    import os
    import sys

    n = min(len(os.sched_getaffinity(0)) + 2, 32)
    streams = {f"s{i}": _stream(2, seed=40 + i) for i in range(n)}
    P = PKGS["torch"]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        srv = _async_server(P, tmp_path, monkeypatch)
        errs = []

        def feeder(tid, s, d):
            try:
                cli = P.serve.ServeClient(srv.port, timeout=60)
                cli.admit(tid)
                _feed_all(cli, tid, s, d, chunk=EB // 2)
                cli.close()
            except Exception as e:  # raised after the join
                errs.append((tid, e))

        threads = [threading.Thread(target=feeder, args=(tid, s, d))
                   for tid, (s, d) in streams.items()]
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)
            assert not errs, errs
            summary = srv.drain(deadline_s=60)
        finally:
            srv.close()
    finally:
        sys.setswitchinterval(switch)
    assert summary["windows_total"] == 2 * n
    assert _summaries(srv.results) == _oracle(streams)
    assert all([r["window"] for r in rows] == [0, 1]
               for rows in srv.results.values())


# ----------------------------------------------------------------------
# subscribe
# ----------------------------------------------------------------------
def test_subscribe_pushes_rows_in_order(tmp_path):
    src, dst = _stream(3, seed=6)

    def run(P, tmp):
        srv = P.serve.StreamServer(make(P), port=0).start()
        try:
            sub = P.serve.ServeClient(srv.port, timeout=60)
            replies = [sub.subscribe("t")]
            cli = P.serve.ServeClient(srv.port, timeout=60)
            replies.append(cli.admit("t"))
            for i in range(0, len(src), EB):
                replies += [cli.feed("t", src[i:i + EB], dst[i:i + EB]),
                            cli.pump()]
            replies.append(cli.close_tenant("t"))
            pushed = [sub.next_window(timeout=30) for _ in range(3)]
            stats = dict(srv._stats)
            cli.close()
            sub.close()
        finally:
            srv.close()
        return {"replies": replies, "pushed": pushed,
                "pushed_n": stats["pushed"],
                "subscribers": stats["subscribers"]}

    got = twin(run, tmp_path)
    assert got["replies"][0] == {"ok": True, "subscribed": ["t"]}
    pushed = got["pushed"]
    assert [p["tenant"] for p in pushed] == ["t"] * 3
    assert [p["event"] for p in pushed] == ["window"] * 3
    assert [p["summary"] for p in pushed] == _oracle({"t": (src, dst)})["t"]
    assert [p["window"] for p in pushed] == [0, 1, 2]
    assert got["pushed_n"] == 3 and got["subscribers"] == 1


def test_subscribe_slow_consumer_is_shed(tmp_path, monkeypatch):
    """GS_SUB_QUEUE=1 and a sender held by a hung socket write: the
    fan-out's put overflows, the subscriber is shed, and the pump's reply
    comes back whole."""
    monkeypatch.setenv("GS_SUB_QUEUE", "1")
    src, dst = _stream(3, seed=7)

    def run(P, tmp):
        srv = P.serve.StreamServer(make(P), port=0).start()
        try:
            sub = P.serve.ServeClient(srv.port, timeout=60)
            replies = [sub.subscribe("*")]
            subscribers = srv._stats["subscribers"]
            cli = P.serve.ServeClient(srv.port, timeout=60)
            replies.append(cli.admit("t"))
            for i in range(0, len(src), EB):
                replies.append(cli.feed("t", src[i:i + EB], dst[i:i + EB]))
            with P.faults.inject(P.faults.FaultSpec(
                    site="serve_send", on_call=1, action="hang",
                    seconds=1.5)):
                # one pump emits 3 rows: the hung sender holds row 1, the
                # 1-deep mailbox row 2, row 3 overflows: shed
                replies.append(cli.pump())
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and srv._subs:
                time.sleep(0.05)
            shed = (not srv._subs, srv._stats["shed"] >= 1)
            cli.close()
            sub.close()
        finally:
            srv.close()
        return {"replies": replies, "subscribers": subscribers,
                "shed": shed}

    got = twin(run, tmp_path)
    assert got["subscribers"] == 1
    assert len(got["replies"][-1]["results"]["t"]) == 3
    assert got["shed"] == (True, True), "slow subscriber not shed"


# ----------------------------------------------------------------------
# GS_OOO_BOUND reorder buffer
# ----------------------------------------------------------------------
def _ts_cohort(P):
    c = make(P)
    c.admit("t")
    return c


def test_ooo_within_bound_reorders_to_the_sorted_stream(tmp_path,
                                                        monkeypatch):
    """A bounded out-of-order feed equals the ts-sorted stream through an
    unbuffered cohort, in both packages."""
    rng = np.random.default_rng(8)
    n = 2 * EB
    src = rng.integers(0, VB, n).astype(np.int32)
    dst = rng.integers(0, VB, n).astype(np.int32)
    ts = np.arange(n, dtype=np.int64) * 1_000 \
        + rng.integers(-40, 40, n) * 1_000
    order = np.argsort(ts, kind="stable")

    def run(P, tmp):
        monkeypatch.delenv("GS_OOO_BOUND", raising=False)
        want_c = _ts_cohort(P)
        want_c.feed("t", src[order], dst[order], ts=ts[order])
        want = want_c.pump().get("t", []) + want_c.close("t")
        monkeypatch.setenv("GS_OOO_BOUND", str(100 * 1_000))
        c = _ts_cohort(P)
        accepted = [c.feed("t", src[i:i + 64], dst[i:i + 64],
                           ts=ts[i:i + 64]) for i in range(0, n, 64)]
        got = c.pump().get("t", []) + c.close("t")
        return {"want": want, "got": got, "accepted": accepted}

    got = twin(run, tmp_path)
    assert got["got"] == got["want"]


def test_ooo_beyond_bound_refused_atomically(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", "100")

    def run(P, tmp):
        c = _ts_cohort(P)
        c.feed("t", [1, 2], [2, 3], ts=[1000, 2000])
        held = c.tenants["t"].ooo_ts.copy()
        # 1500 is within the hold, but 500 reaches back past the released
        # frontier (watermark 2000 - 100 = 1900 released ts <= 1900)
        with pytest.raises(ValueError, match="regression past") as err:
            c.feed("t", [3, 4], [4, 5], ts=[1500, 500])
        # atomic: the refused batch left the hold untouched
        return {"untouched": np.array_equal(c.tenants["t"].ooo_ts, held),
                "held": held.tolist(), "message": str(err.value)}

    got = twin(run, tmp_path)
    assert got["untouched"] is True and got["held"] == [2000]


def test_ooo_close_flushes_the_hold(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", str(10 ** 12))
    src, dst = _stream(1, seed=9)

    def run(P, tmp):
        c = _ts_cohort(P)
        c.feed("t", src, dst, ts=np.arange(EB, dtype=np.int64))
        # a bound this wide holds everything until close
        held = (c.tenants["t"].ooo_ts.size, c.tenants["t"].queued)
        return {"held": held, "closed": c.close("t")}

    got = twin(run, tmp_path)
    assert got["held"] == (EB, 0)
    assert len(got["closed"]) == 1  # the full window came out at close


def test_ooo_watermark_lag_reaches_the_latency_plane(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_OOO_BOUND", str(10 ** 12))
    monkeypatch.setenv("GS_LATENCY", "1")

    def run(P, tmp):
        P.latency.reset()
        try:
            c = _ts_cohort(P)
            # stamps 2 s apart in ns: the held lag is 2 s exactly
            c.feed("t", [1, 2], [2, 3], ts=[0, 2_000_000_000])
            row = P.latency.health_section()["tenants"]["t"]
            got = {"held": row["watermark_held"],
                   "lag_s": row["watermark_lag_s"],
                   "oldest": P.latency.oldest_age()}
            c.close("t")
        finally:
            P.latency.reset()
        return got

    got = twin(run, tmp_path)
    assert got["held"] == 2
    assert got["lag_s"] == pytest.approx(2.0)
    assert got["oldest"] == pytest.approx(2.0)


# ----------------------------------------------------------------------
# the departure: a device error on the pump thread
# ----------------------------------------------------------------------
def test_pump_thread_device_error_is_fatal_and_raised_unwrapped(
        monkeypatch):
    """A KernelError of the cohort's launch on the async pump thread: the
    server is fatal, its listener closed, serve_until_drained raises the
    error itself (no wrapper, no cause), and nothing is quarantined,
    demoted or retried."""
    calls = []

    def broken(*args, **kw):
        calls.append(1)
        raise kernels.KernelError("injected: the cohort_summary library "
                                  "failed")

    monkeypatch.setattr(cohort_summary, "summarize_cohort_plain", broken)
    monkeypatch.setenv("GS_PUMP", "async")
    src, dst = _stream(2, seed=15)
    srv = serve.StreamServer(make(PKGS["torch"]), port=0).start()
    try:
        cli = serve.ServeClient(srv.port, timeout=60)
        assert cli.admit("t")["ok"]
        assert cli.feed("t", src, dst) == {"ok": True, "accepted": 2 * EB}
        deadline = time.monotonic() + 30
        while not srv.fatal and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.fatal
        srv._pump_thread.join(30)
        assert not srv._pump_thread.is_alive()
        with pytest.raises(kernels.KernelError) as err:
            srv.serve_until_drained()
        assert err.value is srv.pump_error
        assert type(err.value) is kernels.KernelError
        assert err.value.__cause__ is None and err.value.__context__ is None
        assert len(calls) == 1
        assert srv._listener.fileno() == -1     # the listener is closed
        co = srv.cohort
        assert co.quarantined() == [] and co.tenant_tier("t") == "cohort"
        assert resilience.demotion_events() == []
        assert co.queued_edges("t") == 2 * EB and srv.results == {}
        cli.close()
    finally:
        srv.close()
