"""The stage guard (deadline, bounded retry, typed errors), the rule that
keeps kernel and CUDA errors out of it, and the tier-demotion registry.

Port of the JAX package's `utils/resilience.py`:

- Typed stage errors. `StageTimeout` / `StageFailed` carry the chunk,
  the stage and the per-attempt timings; construction stamps a durable
  flight-recorder event (`stage_timeout` / `stage_failed`).
- `call_guarded` runs one host stage under a deadline
  (`GS_STAGE_TIMEOUT_S`) with bounded retry and deterministic
  (jitterless) exponential backoff (`GS_STAGE_RETRIES`,
  `GS_STAGE_BACKOFF_S`). With both knobs at their defaults the guard is
  inert and callers run their inline path: no thread, no overhead.
  The ingress pipeline guards its host stages, prep and h2d, with its
  own cell-aware twin (ops/ingress_pipeline._guarded_prep_h2d); the
  device stages (dispatch, finalize) are not guarded in the port: the
  driver fires its `dispatch` and `finalize` fault sites inline
  (timeout=0) on the caller's thread before the launch, never around
  it.
- The demotion registry (`record_demotion`, `demotion_events`,
  `tier_demotion_enabled`, `mesh_demotion_enabled`): a process-global
  log of tier demotions, served on `/healthz`, and the probation knob
  (`tier_retry_windows`). Its owner is the driver's demotion ladder
  (core/driver.py `_maybe_demote`), which never demotes on a device
  error.

The rule of the port (`is_device_error`): an error raised by a kernel's
build or launch (`kernels.KernelError`) or by a CUDA call (PyTorch's
accelerator and out-of-memory errors, or a RuntimeError naming CUDA) is
never retried and never wrapped: it propagates as it was raised. A
device fault such as an illegal address is sticky, so a retry would only
launch again into a dead context, and a wrapped one could read to a
later demotion as a host-stage failure. The JAX package's kernels log a
`selection.fallback` and drop to XLA; the port has no such fallback.

Deadline mechanics: the guarded callable runs on a helper thread and the
caller waits `timeout` seconds. On expiry the helper is abandoned
(daemon; Python cannot interrupt a thread blocked in a C call) and the
attempt is retried or surfaces as `StageTimeout`. A guarded stage must
be safe to run again: prep is pure, and the pipeline's h2d writes its
chunk's own staging slot (ops/staging.ChunkStager.put) on the stager's
copy stream, whichever thread runs it.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from . import faults
from . import knobs
from . import telemetry


class StageError(RuntimeError):
    """Base of the typed stage failures. `stage` is the pipeline stage
    name ('prep' / 'h2d'), `chunk` the chunk descriptor the caller
    passed, `attempts` one dict per attempt: {"outcome": "timeout" |
    exception class name, "elapsed_s": float}.

    Construction stamps a durable flight-recorder event, which covers
    both guard implementations (call_guarded and
    ingress_pipeline._guarded_prep_h2d)."""

    def __init__(self, message: str, stage: str, chunk,
                 attempts: Optional[List[dict]] = None):
        super().__init__(message)
        self.stage = stage
        self.chunk = chunk
        self.attempts = attempts or []
        telemetry.event(
            {"StageTimeout": "stage_timeout",
             "StageFailed": "stage_failed"}.get(type(self).__name__,
                                                "stage_error"),
            durable=True, stage=stage,
            chunk=telemetry.chunk_key(chunk),
            attempts=len(self.attempts))


class StageTimeout(StageError):
    """A stage exceeded its GS_STAGE_TIMEOUT_S deadline on every
    allowed attempt."""


class StageFailed(StageError):
    """A stage raised on every allowed attempt; the last exception
    rides as __cause__."""


def is_device_error(exc: BaseException) -> bool:
    """True when `exc`, or an exception it was raised from, is an error
    of a kernel's build or launch or of a CUDA call: such an error is
    never retried, wrapped or demoted on (module docstring)."""
    import torch

    from .. import kernels

    accel = getattr(torch, "AcceleratorError", None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (kernels.KernelError,
                            torch.cuda.OutOfMemoryError)):
            return True
        if accel is not None and isinstance(exc, accel):
            return True
        if type(exc) is RuntimeError and "cuda" in str(exc).lower():
            return True
        exc = exc.__cause__
    return False


# ----------------------------------------------------------------------
# env knobs (read per call through the utils/knobs registry)
# ----------------------------------------------------------------------
def stage_timeout_s() -> float:
    """Per-stage deadline in seconds (GS_STAGE_TIMEOUT_S); 0 (default)
    disables it."""
    return knobs.get_float("GS_STAGE_TIMEOUT_S")


def stage_retries() -> int:
    """Extra attempts after the first failure or timeout
    (GS_STAGE_RETRIES, default 0)."""
    return knobs.get_int("GS_STAGE_RETRIES")


def stage_backoff_s() -> float:
    """Base of the deterministic exponential backoff between attempts:
    sleep base·2^attempt, no jitter (GS_STAGE_BACKOFF_S, default
    0.05)."""
    return knobs.get_float("GS_STAGE_BACKOFF_S")


def backoff_s(attempt: int) -> float:
    """The backoff ladder: base·2^attempt seconds."""
    return stage_backoff_s() * (2 ** max(0, attempt))


def guard_active() -> bool:
    """True when either knob arms the guard; callers keep their inline
    path (and exception types) otherwise."""
    return stage_timeout_s() > 0 or stage_retries() > 0


_TIMEOUT = object()  # sentinel: deadline expired


def _run_with_deadline(fn: Callable, timeout: float):
    """Run fn() on a daemon helper thread, waiting at most `timeout`
    seconds. Returns fn's value, re-raises its exception, or returns the
    _TIMEOUT sentinel (the helper is abandoned)."""
    box = {}
    done = threading.Event()

    def runner():
        try:
            box["value"] = fn()
        except BaseException as e:  # captured: re-raised on the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=runner, daemon=True,
                         name="gs-stage-watchdog")
    t.start()
    if not done.wait(timeout):
        return _TIMEOUT
    if "error" in box:
        raise box["error"]
    return box["value"]


def call_guarded(stage: str, chunk, fn: Callable, *,
                 retries: Optional[int] = None,
                 timeout: Optional[float] = None):
    """Run `fn()` (one host stage of one chunk) under the deadline and
    retry policy; retries/timeout default to the knobs.

    Raises StageTimeout/StageFailed with per-attempt timings once the
    attempt budget is spent. Interrupts, fatal injected faults
    (faults.InjectedFault(fatal=True)) and device errors
    (`is_device_error`) pass through unwrapped and unretried."""
    if retries is None:
        retries = stage_retries()
    if timeout is None:
        timeout = stage_timeout_s()
    attempts: List[dict] = []
    for attempt in range(retries + 1):
        t0 = time.perf_counter()
        try:
            if timeout > 0:
                out = _run_with_deadline(fn, timeout)
            else:
                out = fn()
        except Exception as e:
            if (isinstance(e, faults.InjectedFault) and e.fatal) \
                    or is_device_error(e):
                raise
            attempts.append({"outcome": type(e).__name__,
                             "elapsed_s": time.perf_counter() - t0})
            if attempt >= retries:
                raise StageFailed(
                    "%s stage failed for chunk %r after %d attempt(s): %s"
                    % (stage, chunk, len(attempts), e),
                    stage, chunk, attempts) from e
        else:
            if out is not _TIMEOUT:
                return out
            attempts.append({"outcome": "timeout",
                             "elapsed_s": time.perf_counter() - t0})
            if attempt >= retries:
                raise StageTimeout(
                    "%s stage of chunk %r exceeded its %.3gs deadline "
                    "on %d attempt(s) (GS_STAGE_TIMEOUT_S; per-attempt "
                    "timings on .attempts)"
                    % (stage, chunk, timeout, len(attempts)),
                    stage, chunk, attempts)
        telemetry.event("stage_retry", stage=stage,
                        chunk=telemetry.chunk_key(chunk),
                        attempt=attempt + 1,
                        outcome=attempts[-1]["outcome"])
        time.sleep(backoff_s(attempt))


# ----------------------------------------------------------------------
# tier-demotion registry
# ----------------------------------------------------------------------
_DEMOTIONS: List[dict] = []
_DEMOTIONS_LOCK = threading.Lock()


def record_demotion(component: str, from_tier: str, to_tier: str,
                    window: int, reason: str,
                    mesh_shape: Optional[list] = None,
                    shard_id: Optional[int] = None,
                    tenant: Optional[str] = None) -> dict:
    """Log one tier demotion in the process-global log (and a durable
    `tier_demotion` event), in the JAX package's record layout:
    component, from, to, window, reason (≤ 500 chars), mesh_shape,
    shard_id, tenant. The caller must not demote on a device error
    (`is_device_error`)."""
    event = {
        "component": component,
        "from": from_tier,
        "to": to_tier,
        "window": int(window),
        "reason": reason[:500],
        "mesh_shape": (None if mesh_shape is None
                       else [int(x) for x in mesh_shape]),
        "shard_id": None if shard_id is None else int(shard_id),
        "tenant": None if tenant is None else str(tenant),
    }
    with _DEMOTIONS_LOCK:
        _DEMOTIONS.append(event)
    telemetry.event("tier_demotion", durable=True, **event)
    return event


def demotion_events() -> List[dict]:
    with _DEMOTIONS_LOCK:
        return list(_DEMOTIONS)


def reset_demotions() -> None:
    """Test hook: clear the process-global demotion log."""
    with _DEMOTIONS_LOCK:
        _DEMOTIONS.clear()


def tier_retry_windows() -> int:
    """Probation before re-promotion after a tier demotion
    (GS_TIER_RETRY_WINDOWS): once this many windows have finalized on
    the demoted tier, the driver runs the higher tier again; a repeat
    failure demotes again and restarts probation. 0 (the default): a
    demotion lasts for the driver's life."""
    return knobs.get_int("GS_TIER_RETRY_WINDOWS")


def tier_demotion_enabled() -> bool:
    """GS_TIER_DEMOTE=0 pins the resolved tier: failures raise instead
    of demoting."""
    return knobs.get_bool("GS_TIER_DEMOTE")


def mesh_demotion_enabled() -> bool:
    """GS_MESH_DEMOTE=0 pins a sharded session to the mesh
    (subordinate to GS_TIER_DEMOTE)."""
    return knobs.get_bool("GS_MESH_DEMOTE")
