"""Deterministic fault injection.

Port of the JAX package's `utils/faults.py`: a process-global,
context-scoped fault plan that the runtime's hook points consult:

    with faults.inject(
            faults.FaultSpec(site="prep", on_call=3),          # raise
            faults.FaultSpec(site="h2d", on_call=2,
                             action="hang", seconds=5.0),      # stall
            faults.FaultSpec(site="ckpt_save",
                             action="truncate_file")):         # damage
        engine.process(src, dst)

Sites are plain strings fired by the runtime (`fire(site)`); the active
plan counts calls per site and triggers each spec on its 1-based
`on_call`-th firing, `times` times. Nothing is random: the same plan
against the same stream injects the same faults.

Sites the port fires (each a no-op without a plan: one list test):

    prep          ops/ingress_pipeline, a worker's prep of a chunk
    h2d           ops/ingress_pipeline, a worker's h2d of a chunk
    admit         the engines' and the driver's admission,
                  before the sanitizer and the journal see the batch;
                  payload=(tenant, src, dst), so a `call` spec can
                  poison the arrays
    wal_enqueue   between the journal append and the fold
    ckpt_save     utils/checkpoint.save, after the atomic replace,
                  payload=the final path
    ckpt_restore  utils/checkpoint.restore, before the load
    dispatch      core/driver.py, before a chunk's snapshot launch (or
                  inside its native / host fold), on the caller's thread
    finalize      core/driver.py, before a chunk's finalize reads its
                  outs
    tenant_prep   core/tenancy.py, one tenant's slab prep (payload=the
                  tenant id): a failure demotes that tenant alone
    cohort_dispatch
                  core/tenancy.py, before a cohort dispatch's staging
                  copy and launch, on the caller's thread
                  (payload=the batch's tenant ids): a non-fatal fault
                  bisects the batch to the tenants it follows
    h2d           core/tenancy.py too, before a cohort slab's staging
                  copy (payload=("cohort", ordinal))

The mesh sites come with their owner (ROADMAP step 1.10).

Actions:
    raise          raise InjectedFault (or `exc` if given). fatal=True
                   marks it non-retryable: the stage guard re-raises it
                   at once (the deterministic kill of crash drills).
    hang           time.sleep(seconds) inside the stage; the deadline
                   (GS_STAGE_TIMEOUT_S) is what must cut it.
    truncate_file  payload is a path: cut the file to half its bytes.
    corrupt_bytes  payload is bytes: garble the first line.
    call           return `fn(payload)`: bespoke corruption.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, List, Optional

from . import telemetry


class InjectedFault(RuntimeError):
    """A fault raised by the active plan. `site` names the hook that
    fired; `fatal` marks it exempt from stage-guard retries (the
    simulated hard kill); `shard` names the shard a mesh site's fault
    implicates (None elsewhere)."""

    def __init__(self, message: str, site: str, fatal: bool = False,
                 shard: Optional[int] = None):
        super().__init__(message)
        self.site = site
        self.fatal = fatal
        self.shard = shard


@dataclasses.dataclass
class FaultSpec:
    """One planned fault: fire at the `on_call`-th firing of `site`
    (1-based, counted per plan), `times` consecutive firings."""

    site: str
    on_call: int = 1
    times: int = 1
    action: str = "raise"
    seconds: float = 0.0          # hang duration
    exc: Optional[type] = None    # raise: exception class to use
    fatal: bool = False           # raise: exempt from guard retries
    fn: Optional[Callable] = None  # call: bespoke payload transform
    shard: Optional[int] = None   # mesh sites: the implicated shard

    def _matches(self, call_no: int) -> bool:
        return self.on_call <= call_no < self.on_call + self.times


class FaultPlan:
    """An ordered set of FaultSpecs plus per-site call counters.
    Thread-safe: stages fire from pool workers and watchdog threads."""

    def __init__(self, specs):
        self.specs: List[FaultSpec] = list(specs)
        self.calls = {}   # site -> firings so far
        self.fired = []   # (site, call_no, action) log, for assertions
        self._lock = threading.Lock()

    def fire(self, site: str, payload=None):
        with self._lock:
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            hits = [s for s in self.specs
                    if s.site == site and s._matches(n)]
            for s in hits:
                self.fired.append((site, n, s.action))
        # injected faults are part of the run's timeline: the flight
        # recorder (utils/telemetry) stamps each firing, so the ledger
        # interleaves faults with the spans they poisoned
        for s in hits:
            telemetry.event("fault_injected", durable=s.fatal,
                            site=site, call=n, action=s.action,
                            fatal=s.fatal, shard=s.shard)
        # act OUTSIDE the lock: a hang must not serialize other sites
        for s in hits:
            payload = _act(s, site, n, payload)
        return payload


def _act(spec: FaultSpec, site: str, call_no: int, payload):
    if spec.action == "raise":
        if spec.fatal:
            # the simulated hard kill: flush the telemetry ring first,
            # so the ledger left behind holds the spans before it
            telemetry.on_fatal(site)
        exc = spec.exc
        where = ("site %r (call %d)" % (site, call_no)
                 if spec.shard is None else
                 "site %r (call %d, shard %d)"
                 % (site, call_no, spec.shard))
        if exc is None:
            raise InjectedFault("injected fault at " + where, site,
                                fatal=spec.fatal, shard=spec.shard)
        raise exc("injected fault at " + where)
    if spec.action == "hang":
        time.sleep(spec.seconds)
        return payload
    if spec.action == "truncate_file":
        path = payload
        with open(path, "r+b") as f:
            f.seek(0, 2)
            f.truncate(f.tell() // 2)
        return payload
    if spec.action == "corrupt_bytes":
        data = bytearray(payload)
        # garble the first line: digits -> 'x' makes the parser drop
        # it (a torn write), never silently misread it
        end = data.find(b"\n")
        end = len(data) if end < 0 else end
        for i in range(end):
            data[i] = ord("x")
        return bytes(data)
    if spec.action == "call":
        return spec.fn(payload)
    raise ValueError("unknown fault action %r" % spec.action)


_ACTIVE: List[FaultPlan] = []  # stack; innermost plan wins
_ACTIVE_LOCK = threading.Lock()


@contextlib.contextmanager
def inject(*specs):
    """Activate a fault plan for the dynamic extent of the context.
    Nestable (innermost plan fires); process-global, so concurrent
    runs in one process must not overlap an injection."""
    plan = FaultPlan(specs)
    with _ACTIVE_LOCK:
        _ACTIVE.append(plan)
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE.remove(plan)


def active() -> Optional[FaultPlan]:
    return _ACTIVE[-1] if _ACTIVE else None


def fire(site: str, payload=None):
    """Runtime hook: consult the active plan (no-op without one). May
    raise, sleep, or transform `payload`; returns the (possibly
    transformed) payload."""
    plan = active()
    if plan is None:
        return payload
    return plan.fire(site, payload)
