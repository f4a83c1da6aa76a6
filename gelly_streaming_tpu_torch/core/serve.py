"""The serving front end: live traffic in, windows out, and a server
that survives a kill in the middle of a window.

Port of the JAX package's `core/serve.py`, with its names and its wire
protocol. `StreamServer` wraps one multi-tenant cohort
(core/tenancy.TenantCohort) on the device the cohort was built for:

- **Sources.** A 127.0.0.1 TCP accept loop speaking newline-delimited
  JSON requests (admit / feed / pump / close / status / subscribe, see
  _OPS), and `attach_file_tail()` threads that follow growing edge files
  (io/sources.tail_edge_file). Both go through the same `cohort.feed()`
  admission path, so every accepted edge is in the write-ahead journal
  (utils/wal.py) before any queue.
- **Typed wire responses.** `TenantRejected` (`TenantQuarantined` under
  its own name, with `probation_left`) and `TenantBackpressure` come
  back as `{"ok": false, "error": <type>, ...}`; backpressure carries a
  deterministic `retry_after_s` hint (utils/resilience.backoff_s, the
  GS_STAGE_BACKOFF_S ladder), doubling per consecutive refusal of the
  tenant and reset by its first accepted feed. With the sanitizer armed
  (GS_SANITIZE) feed replies carry the counts of the edges sent to the
  dead-letter journal by reason, an oversized batch comes back as
  `BatchRejected` with its reason code, and status adds the journal's
  depth and the quarantined tenants. A malformed request is a
  `BadRequest`.
- **Deadlines.** GS_SERVE_IDLE_S bounds a connection's idle receive and
  every response send (`resilience.call_guarded`, retries=0): a client
  that stops reading is shed (durable `serve_client_shed` event,
  connection closed) and never stalls the pump. Connections past
  `max_connections` are answered with a typed `ServerBusy`.
- **The pump.** GS_PUMP=sync (the default) pumps inline under one
  re-entrant lock; GS_PUMP=async runs slab prep, the staging copy, the
  launches and the copy back on a pump thread woken by each feed, so
  ingest (sanitize, journal, enqueue under the cohort's queue lock)
  overlaps the card's work. Same windows either way.
- **Graceful drain.** SIGTERM (or `request_drain()`): stop accepting,
  finish in-flight requests within GS_SERVE_DRAIN_S, stop the tails,
  pump every queue dry, write a checkpoint per tenant, seal the journal
  (durable `wal_sealed` and `serve_drain` events) and exit 0.
- **Recovery.** A killed server restarts with `--recover`: tenants are
  admitted from the journal, each resumes its newest checkpoint, and the
  journal's suffix past it replays into the queues, so the next pumps
  give again the windows the crash swallowed.
- **Observation.** `gs_serve_*` counters and gauges, a `serve` section
  on `/healthz`, durable events for drain, seal, replay and shed. With
  GS_LATENCY armed each delivered row carries `latency_s`
  (ingest to delivery, the sink write stamped as the `deliver` stage)
  and `queue_edges`, and each row's deferred latency record closes at
  the sink write; with GS_PROVENANCE armed each row gets a `tier="serve"`
  delivery record.

The device rules of the port: the server runs where its cohort runs
(`TenantCohort(device=None)` is the card and raises without one), and
nothing falls back to the CPU. One departure from the JAX server: a
device error on the async pump thread (`resilience.is_device_error`, a
kernel's `KernelError` among them) marks the server fatal and closes the
listener, the error is kept, and `serve_until_drained` raises it
unwrapped, nothing quarantined, demoted or retried. The JAX pump thread
dies silently on such an error while the server goes on accepting
feeds.

Run one standalone (the card; `--device cpu` for the plain versions):

    python -m gelly_streaming_tpu_torch.core.serve --edge-bucket 512 \\
        --vertex-bucket 1024 --wal wal/ --ckpt ckpt/ \\
        --results results.jsonl [--recover] [--port-file port.txt]

The process prints its bound port, pumps continuously, appends every
finalized window summary to the results file as one JSON line (tenant,
window ordinal, summary; at least once across a kill and recovery:
readers keep the last record per (tenant, window)) and exits 0 on
SIGTERM after a clean drain.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..ops.resident_engine import Mailbox
from ..utils import faults
from ..utils import knobs
from ..utils import latency
from ..utils import metrics
from ..utils import provenance
from ..utils import resilience
from ..utils import sanitize as sanitize_mod
from ..utils import telemetry
from ..utils.faults import InjectedFault
from .tenancy import TenantBackpressure, TenantCohort, TenantRejected

__all__ = ["ServeClient", "StreamServer", "drain_deadline_s",
           "idle_timeout_s", "main", "pump_mode", "serve_port",
           "sub_queue_cap"]

_OPS = ("admit", "feed", "pump", "close", "status", "subscribe")


def serve_port() -> int:
    """GS_SERVE_PORT (0: a port the OS assigns; `.port` holds the bound
    one)."""
    return knobs.get_int("GS_SERVE_PORT")


def pump_mode() -> str:
    """GS_PUMP: `sync` (default) pumps inline under the request lock;
    `async` runs slab prep, h2d, dispatch and finalize on a pump thread
    so ingest overlaps the card's work. Same windows either way."""
    return knobs.get_str("GS_PUMP")


def sub_queue_cap() -> int:
    """GS_SUB_QUEUE: the bounded per-connection queue of the `subscribe`
    op; a subscriber whose queue overflows is shed, never allowed to
    stall the pump."""
    return knobs.get_int("GS_SUB_QUEUE")


def drain_deadline_s() -> float:
    """GS_SERVE_DRAIN_S: how long drain waits for in-flight requests
    before it closes their connections (0: forever)."""
    return knobs.get_float("GS_SERVE_DRAIN_S")


def idle_timeout_s() -> float:
    """GS_SERVE_IDLE_S: the per-connection idle receive and response
    send deadline."""
    return knobs.get_float("GS_SERVE_IDLE_S")


class StreamServer:
    """One cohort behind one accept loop. Response sends happen outside
    the locks, so a slow client can stall only its own connection
    thread, never the pump."""

    def __init__(self, cohort: TenantCohort,
                 host: str = "127.0.0.1",
                 port: Optional[int] = None,
                 backlog: int = 16,
                 max_connections: int = 32,
                 results_path: Optional[str] = None):
        self.cohort = cohort
        # the cohort defers each finalized window's latency record to
        # _emit, which stamps the delivery boundary (the sink write)
        cohort.defer_delivery = True
        self._lock = threading.RLock()
        # lock discipline:
        # sync:  _ingest_lock and _pump_mutex are both _lock, one
        #        re-entrant lock for every request.
        # async: admit and feed (socket and tails) take _ingest_lock
        #        only; the pump thread holds _pump_mutex for prep, h2d,
        #        dispatch, finalize and _emit. The two meet only at the
        #        cohort's queue lock (TenantCohort._qlock), so enqueue
        #        overlaps dispatch. close and drain take _pump_mutex
        #        before _ingest_lock, the one place both are held.
        self.pump_mode = pump_mode()
        if self.pump_mode == "async":
            self._ingest_lock = threading.RLock()
            self._pump_mutex = threading.RLock()
        else:
            self._ingest_lock = self._lock
            self._pump_mutex = self._lock
        self._pump_thread: Optional[threading.Thread] = None
        self._pump_stop = threading.Event()
        # bounded wake channel: a feed drops a token; a full mailbox
        # means the pump is awake already
        self._pump_wake = Mailbox(capacity=64)
        self._pump_busy = threading.Event()  # a dispatch in flight
        # a device error the pump thread met, raised by
        # serve_until_drained
        self.pump_error: Optional[BaseException] = None
        # subscriptions: cid -> (conn, mailbox, tenant filter); each
        # subscribed connection has a sender thread draining its bounded
        # mailbox, so a slow subscriber is shed, never waited for
        self._subs: Dict[int, tuple] = {}
        self._send_locks: Dict[int, threading.Lock] = {}
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, serve_port() if port is None else port))
        self._listener.listen(backlog)
        self.host = host
        self.port = self._listener.getsockname()[1]
        self.max_connections = max_connections
        self._accept_thread = None
        self._conns: Dict[int, socket.socket] = {}
        self._conn_threads: List[threading.Thread] = []
        self._conn_seq = 0
        self._draining = threading.Event()
        self._drain_req = threading.Event()
        self._drained = None          # drain()'s summary, once run
        self._drain_lock = threading.Lock()
        self.fatal = False            # a fatal fault or a device error
        self._bp_attempts: Dict[str, int] = {}  # consecutive refusals
        self._tails: List[tuple] = []  # (thread, stop event)
        self._results_path = results_path
        self._results_file = (open(results_path, "a")
                              if results_path else None)
        self.results: Dict[str, list] = {}  # tenant -> rows
        self._stats = {"connections": 0, "requests": 0, "shed": 0,
                       "rejections": 0, "busy": 0, "windows": 0,
                       # feeds accepted while the async pump had a
                       # dispatch in flight: the overlap's evidence
                       "overlap_feeds": 0,
                       "subscribers": 0, "pushed": 0}
        metrics.register_health_section("serve", self._health_section)
        telemetry.event("serve_started", port=self.port)

    # ------------------------------------------------------------------
    # accept loop
    # ------------------------------------------------------------------
    def start(self) -> "StreamServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="gs-serve")
        self._accept_thread.start()
        if self.pump_mode == "async" and self._pump_thread is None:
            self._pump_thread = threading.Thread(
                target=self._pump_loop, daemon=True, name="gs-serve-pump")
            self._pump_thread.start()
        return self

    def _die(self) -> None:
        """The server is dead: no further accept succeeds, the shape a
        real kill leaves behind."""
        self.fatal = True
        try:
            self._listener.close()
        except OSError:
            pass

    def _pump_loop(self, interval_s: float = 0.02) -> None:
        """The pump thread (GS_PUMP=async): wake on a feed token or the
        interval, dispatch every ready window under _pump_mutex, never
        under _ingest_lock, so the accept loop and the tails keep
        admitting while slabs prep, copy and fold. One cohort round a
        call (max_rounds=1), so rows are delivered as each round
        finalizes. A fatal injected fault leaves the shape of a kill; a
        device error also marks the server fatal, and is kept for
        serve_until_drained to raise."""
        while not self._pump_stop.is_set():
            self._pump_wake.get(timeout=interval_s)
            if self._pump_stop.is_set():
                return
            if not self._any_ready():
                continue
            try:
                self.pump_once(max_rounds=1)
            except InjectedFault as e:
                if e.fatal:
                    self._die()
                    return
                telemetry.event("serve_pump_failed", error=repr(e)[:200])
            except (TenantRejected, TenantBackpressure):
                pass  # a racing close or admission: plan again next wake
            except Exception as e:
                if not resilience.is_device_error(e):
                    raise
                self.pump_error = e
                telemetry.event("serve_pump_device_error", durable=True,
                                error=repr(e)[:200])
                self._die()
                return

    def _join_pump(self) -> None:
        """Stop and join the async pump thread; idempotent, a no-op in
        sync mode."""
        self._pump_stop.set()
        self._pump_wake.close()
        t = self._pump_thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join()

    def _accept_loop(self) -> None:
        while not self._draining.is_set():
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # the listener closed: drain began
            with self._lock:
                self._stats["connections"] += 1
                active = len(self._conns)
            metrics.counter_inc("gs_serve_connections_total")
            if active >= self.max_connections:
                # a typed busy with the retry hint, never an unbounded
                # queue of connections
                self._stats["busy"] += 1
                metrics.counter_inc("gs_serve_rejections_total",
                                    kind="ServerBusy")
                try:
                    conn.sendall((json.dumps({
                        "ok": False, "error": "ServerBusy",
                        "retry_after_s": resilience.backoff_s(0),
                    }) + "\n").encode())
                except OSError:
                    pass
                conn.close()
                continue
            with self._lock:
                self._conn_seq += 1
                cid = self._conn_seq
                self._conns[cid] = conn
            t = threading.Thread(target=self._handle_conn, args=(cid, conn),
                                 daemon=True, name="gs-serve-conn-%d" % cid)
            # only this thread touches the list: keep the live ones, so
            # drain() joins no finished connection
            self._conn_threads = [x for x in self._conn_threads
                                  if x.is_alive()]
            self._conn_threads.append(t)
            t.start()

    def _handle_conn(self, cid: int, conn: socket.socket) -> None:
        metrics.gauge_set("gs_serve_active_connections", len(self._conns))
        conn.settimeout(idle_timeout_s())
        buf = b""
        try:
            while not self._draining.is_set():
                nl = buf.find(b"\n")
                if nl < 0:
                    try:
                        chunk = conn.recv(1 << 20)
                    except socket.timeout:
                        telemetry.event("serve_idle_closed", conn=cid)
                        metrics.counter_inc("gs_serve_idle_closed_total")
                        return
                    if not chunk:
                        return  # the client hung up
                    buf += chunk
                    continue
                line, buf = buf[:nl], buf[nl + 1:]
                if not line.strip():
                    continue
                resp = self._handle_request(cid, line)
                if not self._send(cid, conn, resp):
                    return
        except InjectedFault as e:
            if e.fatal:
                # the simulated kill: the whole server is dead
                self._die()
                raise
            telemetry.event("serve_request_failed", conn=cid,
                            error=repr(e)[:200])
        except OSError:
            return  # the connection was reset
        finally:
            self._drop_sub(cid)
            with self._lock:
                self._conns.pop(cid, None)
                self._send_locks.pop(cid, None)
            metrics.gauge_set("gs_serve_active_connections",
                              len(self._conns))
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, cid: int, conn: socket.socket, resp: dict) -> bool:
        """Send one response under the connection's deadline; a client
        that stalls the send is shed (durable event, connection closed).
        The pump's lock is not held here."""
        data = (json.dumps(resp) + "\n").encode()
        # a subscribed connection has two writers (its request thread
        # and its sender): one lock a connection keeps lines whole
        with self._lock:
            slock = self._send_locks.setdefault(cid, threading.Lock())

        def _do_send():
            faults.fire("serve_send", cid)
            with slock:
                conn.sendall(data)

        try:
            resilience.call_guarded("serve_send", cid, _do_send, retries=0,
                                    timeout=idle_timeout_s())
            return True
        except (resilience.StageError, OSError):
            self._stats["shed"] += 1
            telemetry.event("serve_client_shed", durable=True, conn=cid,
                            bytes=len(data))
            metrics.counter_inc("gs_serve_shed_total")
            try:
                conn.close()
            except OSError:
                pass
            return False

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------
    def _handle_request(self, cid: int, line: bytes) -> dict:
        try:
            req = json.loads(line)
            op = req.get("op")
            if op not in _OPS:
                raise ValueError("unknown op %r (one of %s)"
                                 % (op, "/".join(_OPS)))
        except ValueError as e:
            return {"ok": False, "error": "BadRequest",
                    "message": str(e)[:500]}
        self._stats["requests"] += 1
        metrics.counter_inc("gs_serve_requests_total", op=op)
        req["_cid"] = cid  # subscribe binds to the connection
        try:
            return getattr(self, "_op_" + op)(req)
        except TenantBackpressure as e:
            # the hint doubles per consecutive refusal of this tenant and
            # resets on its first accepted feed
            with self._lock:
                n = self._bp_attempts.get(e.tenant, 0)
                self._bp_attempts[e.tenant] = n + 1
            self._stats["rejections"] += 1
            metrics.counter_inc("gs_serve_rejections_total",
                                kind="TenantBackpressure")
            return {"ok": False, "error": "TenantBackpressure",
                    "tenant": e.tenant, "queued": e.queued,
                    "capacity": e.capacity,
                    "retry_after_s": resilience.backoff_s(n)}
        except TenantRejected as e:
            # the class's own name: a client tells a quarantined tenant
            # (TenantQuarantined) from a refused admission
            self._stats["rejections"] += 1
            metrics.counter_inc("gs_serve_rejections_total",
                                kind=type(e).__name__)
            resp = {"ok": False, "error": type(e).__name__,
                    "tenant": e.tenant, "message": str(e)[:500]}
            left = getattr(e, "probation_left", None)
            if left is not None:
                resp["probation_left"] = left
            return resp
        except sanitize_mod.BatchRejected as e:
            # the sanitizer's refusal of a whole batch, with its reason
            self._stats["rejections"] += 1
            metrics.counter_inc("gs_serve_rejections_total",
                                kind="BatchRejected")
            return {"ok": False, "error": "BatchRejected",
                    "tenant": e.tenant, "reason": e.reason,
                    "size": e.size, "limit": e.limit,
                    "message": str(e)[:500]}
        except InjectedFault:
            raise  # an injected kill must look like a kill
        except (ValueError, KeyError, TypeError) as e:
            # a malformed payload (missing fields, wrong shapes) is a
            # typed BadRequest; the connection lives on
            return {"ok": False, "error": "BadRequest",
                    "message": "%s: %s" % (type(e).__name__, str(e)[:500])}

    def _op_admit(self, req: dict) -> dict:
        with self._ingest_lock:
            self.cohort.admit(req["tenant"],
                              vertex_bucket=req.get("vertex_bucket"))
        return {"ok": True, "tenant": str(req["tenant"])}

    def _op_feed(self, req: dict) -> dict:
        if sanitize_mod.enabled():
            # armed: the raw arrays reach the cohort, so the sanitizer
            # sees a 2^40 id, not its int32-wrapped ghost
            src = np.asarray(req["src"])
            dst = np.asarray(req["dst"])
        else:
            # disarmed: the int32 cast here, so a Python int out of the
            # int32 range raises (OverflowError) and never wraps into a
            # plausible id
            src = np.asarray(req["src"], np.int32)
            dst = np.asarray(req["dst"], np.int32)
        ts = req.get("ts")
        if ts is not None:
            ts = np.asarray(ts, np.int64)
        with self._ingest_lock:
            if self._pump_busy.is_set():
                # this batch is admitted while a dispatch is in flight
                self._stats["overlap_feeds"] += 1
            accepted = self.cohort.feed(req["tenant"], src, dst, ts=ts)
            self._bp_attempts.pop(str(req["tenant"]), None)
            t = self.cohort.tenants.get(str(req["tenant"]))
            rep = t.last_report if t is not None else None
            quarantined = t is not None and t.tier == "quarantined"
        self._wake_pump()
        resp = {"ok": True, "accepted": int(accepted)}
        if rep is not None:
            # the sanitizer's counts by reason ({} on a clean batch)
            resp.update(rep.wire_fields())
        if quarantined:
            resp["quarantined"] = True
        return resp

    def _op_pump(self, req: dict) -> dict:
        return {"ok": True, "results": self.pump_once()}

    def _op_close(self, req: dict) -> dict:
        # close() flushes ingest-side state (the reorder buffer) and
        # pumps the final windows: it excludes both sides, pump lock
        # first (in sync mode both are the same re-entrant lock)
        with self._pump_mutex:
            with self._ingest_lock:
                summaries = self.cohort.close(req["tenant"])
            out = self._emit({str(req["tenant"]): summaries}) \
                if summaries else {}
        return {"ok": True, "results": out.get(str(req["tenant"]), [])}

    def _op_status(self, req: dict) -> dict:
        return {"ok": True, "serve": self._health_section()}

    def _op_subscribe(self, req: dict) -> dict:
        """Register this connection for a tenant's rows (`tenant` "*":
        every tenant). Rows are pushed as `{"ok": true, "event":
        "window", ...}` lines by a sender thread draining a bounded
        mailbox (GS_SUB_QUEUE); an overflow or a stalled send sheds the
        subscriber."""
        cid = int(req["_cid"])
        tenant = str(req.get("tenant", "*"))
        with self._lock:
            conn = self._conns.get(cid)
            if conn is None:
                raise ValueError("subscribe on a vanished connection")
            ent = self._subs.get(cid)
            if ent is not None:
                ent[2].add(tenant)
                return {"ok": True, "subscribed": sorted(ent[2])}
            mb = Mailbox(capacity=sub_queue_cap())
            self._subs[cid] = (conn, mb, {tenant})
            self._stats["subscribers"] += 1
        threading.Thread(target=self._sub_sender_loop, args=(cid, conn, mb),
                         daemon=True, name="gs-serve-sub-%d" % cid).start()
        metrics.counter_inc("gs_serve_subscribes_total")
        return {"ok": True, "subscribed": [tenant]}

    def _sub_sender_loop(self, cid: int, conn, mb: Mailbox) -> None:
        while True:
            row = mb.get(timeout=0.5)
            if row is None:
                if mb.closed and not len(mb):
                    return
                continue
            if not self._send(cid, conn, row):
                self._drop_sub(cid)
                return

    def _drop_sub(self, cid: int) -> None:
        with self._lock:
            ent = self._subs.pop(cid, None)
        if ent is not None:
            ent[1].close()

    def _fanout(self, rows: Dict[str, list]) -> None:
        """Put freshly emitted rows into every matching subscriber's
        mailbox. put() never blocks: a full mailbox means the subscriber
        fell behind its GS_SUB_QUEUE budget, and it is shed."""
        with self._lock:
            subs = list(self._subs.items())
        for cid, (conn, mb, tenants) in subs:
            if self._push(mb, tenants, rows):
                continue
            self._stats["shed"] += 1
            telemetry.event("serve_client_shed", durable=True, conn=cid,
                            reason="sub_overflow", depth=len(mb))
            metrics.counter_inc("gs_serve_shed_total")
            self._drop_sub(cid)
            try:
                conn.close()
            except OSError:
                pass

    def _push(self, mb: Mailbox, tenants, rows: Dict[str, list]) -> bool:
        """Queue the rows `tenants` asked for; False at the first that
        does not fit."""
        for tid, trows in rows.items():
            if "*" not in tenants and tid not in tenants:
                continue
            for row in trows:
                if not mb.put({"ok": True, "event": "window", **row}):
                    return False
                self._stats["pushed"] += 1
        return True

    # ------------------------------------------------------------------
    # pumping and results
    # ------------------------------------------------------------------
    def _wake_pump(self) -> None:
        """Nudge the async pump thread (a no-op in sync mode; a full
        wake mailbox means it is awake already)."""
        if self.pump_mode == "async" and not self._pump_stop.is_set():
            self._pump_wake.put(1)

    def pump_once(self, max_rounds: Optional[int] = None) -> Dict[str, list]:
        """One cohort pump under the pump mutex (the request lock in sync
        mode); the summaries go to the results sink with per-tenant
        window ordinals and come back keyed by tenant. `max_rounds`
        bounds the cohort rounds of the call (the async pump's); None
        drains every ready window."""
        with self._pump_mutex:
            self._pump_busy.set()
            try:
                results = self.cohort.pump(max_rounds=max_rounds)
            finally:
                self._pump_busy.clear()
            return self._emit(results)

    def _emit(self, results: Dict[str, list]) -> Dict[str, list]:
        out = {}
        for tid, summaries in results.items():
            if not summaries:
                continue
            base = self.cohort.windows_done(tid) - len(summaries)
            rows = [{"tenant": tid, "window": base + i, "summary": s}
                    for i, s in enumerate(summaries)]
            # the delivery boundary of the latency plane: each window's
            # deferred record closes here; the keys appear only armed
            if latency.enabled():
                queued = self.cohort.queued_edges(tid)
                for row in rows:
                    rec = latency.delivered(tid, row["window"])
                    if rec is not None:
                        row["latency_s"] = round(rec["e2e_s"], 6)
                        row["queue_edges"] = int(queued)
            if provenance.armed():
                # the delivery record: its digest covers the summary
                # alone, so it matches the compute tier's record of the
                # window; its span is the nominal eb-aligned window
                eb = self.cohort.eb
                for row in rows:
                    provenance.emit(
                        tenant=tid, window=row["window"],
                        wal_lo=row["window"] * eb,
                        wal_hi=(row["window"] + 1) * eb,
                        tier="serve", program="serve",
                        summary=row["summary"])
            out[tid] = rows
            self.results.setdefault(tid, []).extend(rows)
            self._stats["windows"] += len(rows)
            if self._results_file is not None:
                for row in rows:
                    self._results_file.write(json.dumps(row) + "\n")
                self._results_file.flush()
        if out:
            self._fanout(out)
        return out

    def _any_ready(self) -> bool:
        # quarantined tenants never count as ready: their queues wait for
        # probation, and drain() must end with a poisoned stream's
        # backlog still queued (its edges are in the journal)
        with self._lock:
            return any(t.queued >= self.cohort.eb or (t.closing and t.queued)
                       for t in self.cohort.tenants.values()
                       if not t.closed and t.tier != "quarantined")

    # ------------------------------------------------------------------
    # file-tail sources
    # ------------------------------------------------------------------
    def attach_file_tail(self, path: str, tenant,
                         poll_s: float = 0.2) -> None:
        """Follow a growing edge file into one tenant's queue through the
        journaled feed path the socket uses. Backpressure is ridden by
        sleeping the hint and retrying; the tail stops at drain, its
        final partial line first."""
        from ..io import sources

        with self._ingest_lock:
            if str(tenant) not in self.cohort.tenants:
                self.cohort.admit(tenant)
        stop = threading.Event()

        def _tail():
            attempt = 0
            for s, d, _ts in sources.tail_edge_file(path, stop,
                                                    poll_s=poll_s):
                s = np.asarray(s, np.int32)
                d = np.asarray(d, np.int32)
                while True:
                    try:
                        with self._ingest_lock:
                            if self._pump_busy.is_set():
                                self._stats["overlap_feeds"] += 1
                            self.cohort.feed(tenant, s, d)
                        self._wake_pump()
                        attempt = 0
                        break
                    except TenantBackpressure:
                        time.sleep(resilience.backoff_s(attempt))
                        attempt += 1
                        if stop.is_set():
                            telemetry.event(
                                "serve_tail_dropped", durable=True,
                                tenant=str(tenant), path=path,
                                edges=int(len(s)))
                            return

        t = threading.Thread(target=_tail, daemon=True, name="gs-serve-tail")
        t.start()
        self._tails.append((t, stop))

    # ------------------------------------------------------------------
    # drain and shutdown
    # ------------------------------------------------------------------
    def request_drain(self) -> None:
        """Ask for a drain (the SIGTERM handler's body);
        serve_until_drained() runs it."""
        self._drain_req.set()

    def drain(self, deadline_s: Optional[float] = None) -> dict:
        """Graceful shutdown: stop accepting, let in-flight requests
        finish (close their connections past the deadline), stop the
        tails, pump every queue dry, write a checkpoint per tenant, seal
        the journal. Idempotent; returns a summary dict."""
        with self._drain_lock:
            if self._drained is not None:
                return self._drained
            deadline = drain_deadline_s() if deadline_s is None \
                else deadline_s
            telemetry.event("serve_drain", durable=True, phase="begin",
                            port=self.port)
            self._draining.set()
            try:
                self._listener.close()
            except OSError:
                pass
            t0 = time.monotonic()
            for t in list(self._conn_threads):
                left = (None if deadline <= 0
                        else max(0.0, deadline - (time.monotonic() - t0)))
                t.join(left)
            forced = 0
            with self._lock:
                for conn in self._conns.values():
                    forced += 1
                    try:
                        conn.close()
                    except OSError:
                        pass
                self._conns.clear()
            for _t, stop in self._tails:
                stop.set()
            for t, _stop in self._tails:
                t.join()
            # every source is quiet: stop the async pump before the dry
            # loop, so this thread alone pumps the tail of the streams
            self._join_pump()
            drained_windows = 0
            while self._any_ready():
                drained_windows += sum(
                    len(v) for v in self.pump_once().values())
            # subscribers saw every drained row (_emit fans out): close
            # their mailboxes so the sender threads end
            for cid in list(self._subs):
                self._drop_sub(cid)
            with self._pump_mutex:
                with self._ingest_lock:
                    self.cohort.checkpoint_all()
                    self.cohort.seal_wal()
                # a cohort that outlives its server records latency at
                # finalize again; settle only this cohort's lanes
                self.cohort.defer_delivery = False
                lanes = list(self.cohort.tenants)
            for tid in lanes:
                latency.settle(tid)
            if self._results_file is not None:
                self._results_file.flush()
                os.fsync(self._results_file.fileno())
            summary = {
                "drained_windows": drained_windows,
                "forced_connections": forced,
                "windows_total": self._stats["windows"],
                "sealed": True,
            }
            telemetry.event("serve_drain", durable=True, phase="sealed",
                            **summary)
            metrics.counter_inc("gs_serve_drains_total")
            self._drained = summary
            return summary

    def serve_until_drained(self, pump_interval_s: float = 0.02) -> dict:
        """The standalone main loop: install the SIGTERM hook, pump
        whenever a tenant has a window ready, drain when asked, and
        return drain()'s summary. A device error of the async pump
        thread is raised here, unwrapped, with no drain."""
        import signal

        def _on_term(signum, frame):
            # a flag only: drain runs on this (main) thread below, and the
            # earlier handler is not chained, so the process exits 0
            self.request_drain()

        try:
            signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread: the caller owns the signals
        if self._accept_thread is None:
            self.start()
        while not self._drain_req.is_set() and not self.fatal:
            if self.pump_mode != "async" and self._any_ready():
                # sync: this loop is the pump; async: the pump thread is
                self.pump_once()
            else:
                time.sleep(pump_interval_s)
        if self.pump_error is not None:
            raise self.pump_error
        return self.drain()

    def close(self) -> None:
        """Hard teardown (no drain)."""
        self._draining.set()
        self._join_pump()
        for cid in list(self._subs):
            self._drop_sub(cid)
        try:
            self._listener.close()
        except OSError:
            pass
        for _t, stop in self._tails:
            stop.set()
        with self._lock:
            for conn in self._conns.values():
                try:
                    conn.close()
                except OSError:
                    pass
            self._conns.clear()
        if self._results_file is not None:
            try:
                self._results_file.close()
            except OSError:
                pass
        # as in drain(): the cohort records at finalize again, and only
        # its own lanes settle
        self.cohort.defer_delivery = False
        for tid in list(self.cohort.tenants):
            latency.settle(tid)
        metrics.unregister_health_section("serve")

    # ------------------------------------------------------------------
    # observation
    # ------------------------------------------------------------------
    def _health_section(self) -> dict:
        with self._lock:
            stats = dict(self._stats)
            active = len(self._conns)
            wal = self.cohort._wal
            # per-tenant queue depth and the age of its oldest edge
            queues = {
                tid: {"edges": int(t.queued),
                      "age_s": (None if t.queued == 0
                                else latency.queue_age(tid))}
                for tid, t in self.cohort.tenants.items() if not t.closed}
        sec = {
            "port": self.port,
            "pump": self.pump_mode,
            "draining": self._draining.is_set(),
            "active_connections": active,
            "tails": len(self._tails),
            "queues": queues,
            "latency": latency.health_section(),
            **stats,
        }
        with self._lock:
            quarantined = self.cohort.quarantined()
        if quarantined:
            sec["quarantined"] = quarantined
        dlq = sanitize_mod.dlq_status()
        if dlq is not None:
            sec["dlq"] = dlq
        if sanitize_mod.enabled():
            sec["sanitize"] = sanitize_mod.mode()
        if wal is not None:
            offs = wal.offsets()
            sec["wal"] = {"tenants": len(offs),
                          "edges": sum(offs.values()),
                          "sealed": wal.sealed}
        return sec


class ServeClient:
    """A loopback client of the wire protocol."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""
        self._events = collections.deque()  # queued pushed rows

    def _line(self) -> Optional[dict]:
        """The next whole line of the buffer, decoded; None without
        one."""
        nl = self._buf.find(b"\n")
        if nl < 0:
            return None
        line, self._buf = self._buf[:nl], self._buf[nl + 1:]
        return json.loads(line)

    def _recv(self, what: str) -> None:
        chunk = self.sock.recv(1 << 20)
        if not chunk:
            raise ConnectionError(what)
        self._buf += chunk

    def request(self, **req) -> dict:
        self.sock.sendall((json.dumps(req) + "\n").encode())
        while True:
            resp = self._line()
            if resp is None:
                self._recv("server closed the connection mid-request "
                           "(killed, shed, or draining)")
            elif resp.get("event") == "window":
                # a push raced this request's reply: keep it for
                # next_window() and read on
                self._events.append(resp)
            else:
                return resp

    def admit(self, tenant, **kw) -> dict:
        return self.request(op="admit", tenant=tenant, **kw)

    def feed(self, tenant, src, dst, ts=None) -> dict:
        req = dict(op="feed", tenant=tenant, src=np.asarray(src).tolist(),
                   dst=np.asarray(dst).tolist())
        if ts is not None:
            req["ts"] = np.asarray(ts).tolist()
        return self.request(**req)

    def pump(self) -> dict:
        return self.request(op="pump")

    def subscribe(self, tenant="*") -> dict:
        """Arm this connection for pushed rows; pushes that interleave
        with later replies are queued for next_window()."""
        return self.request(op="subscribe", tenant=tenant)

    def next_window(self, timeout: Optional[float] = None) -> dict:
        """Block for the next pushed `event: window` row (queued pushes
        first). Raises socket.timeout past `timeout`."""
        if self._events:
            return self._events.popleft()
        old = self.sock.gettimeout()
        if timeout is not None:
            self.sock.settimeout(timeout)
        try:
            while True:
                resp = self._line()
                if resp is None:
                    self._recv("server closed the subscription")
                elif resp.get("event") == "window":
                    return resp
                # else a stale reply: not ours to keep
        finally:
            self.sock.settimeout(old)

    def close_tenant(self, tenant) -> dict:
        return self.request(op="close", tenant=tenant)

    def status(self) -> dict:
        return self.request(op="status")

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# ----------------------------------------------------------------------
# the standalone server
# ----------------------------------------------------------------------
def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--edge-bucket", type=int, default=512)
    ap.add_argument("--vertex-bucket", type=int, default=1024)
    ap.add_argument("--port", type=int, default=None,
                    help="TCP port (default GS_SERVE_PORT; 0 = ephemeral)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound port here")
    ap.add_argument("--wal", default=None,
                    help="write-ahead journal directory (arms durable "
                         "ingest)")
    ap.add_argument("--ckpt", default=None,
                    help="per-tenant checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=4,
                    help="checkpoint cadence in windows")
    ap.add_argument("--results", default=None,
                    help="append finalized window summaries here (JSONL; "
                         "at least once across recovery)")
    ap.add_argument("--recover", action="store_true",
                    help="resume checkpoints and replay the journal's "
                         "suffix before serving")
    ap.add_argument("--tail", action="append", default=[],
                    metavar="PATH:TENANT",
                    help="file-tail source (repeatable)")
    ap.add_argument("--device", default=None,
                    help="the cohort's device (default: the CUDA card, "
                         "an error without one; `cpu`: the plain "
                         "versions)")
    args = ap.parse_args(argv)

    cohort = TenantCohort(edge_bucket=args.edge_bucket,
                          vertex_bucket=args.vertex_bucket,
                          device=args.device)
    if args.wal:
        cohort.enable_wal(args.wal)
    if args.ckpt:
        cohort.enable_auto_checkpoint(args.ckpt,
                                      every_n_windows=args.ckpt_every)
    if args.recover:
        if not args.wal:
            ap.error("--recover needs --wal")
        info = cohort.recover()
        print("recovered: %s" % json.dumps(
            {k: v for k, v in info.items() if k != "resumed"}), flush=True)
    server = StreamServer(cohort, port=args.port,
                          results_path=args.results).start()
    print("serving on %s:%d" % (server.host, server.port), flush=True)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(server.port))
    for spec in args.tail:
        path, _, tenant = spec.rpartition(":")
        server.attach_file_tail(path, tenant)
    summary = server.serve_until_drained()
    print("drained: %s" % json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
