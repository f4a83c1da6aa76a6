"""The system under test of the GNN configurations: the port's
`GnnSummaryEngine` (gelly_streaming_tpu_torch/ops/gnn_window.py), driven
through its public entry `process()` at the program's defaults.

Set-up (`System(...)`) makes the configuration's edge pool on the card
from the seed (portbench/streams.py: the law that the configuration's
`assumed.degree_law` states), copies it to the host once as a ring of
the pool and its first call's worth again (so call k is a view of it,
never a copy), makes the weights on the card from the seed, builds the
engine with the configuration's buckets, width and activation, hands it
the weights through `set_weights`, and feeds it call 0, the warm-up,
from the zero slab the engine starts with. The device's peak is counted
from the engine's build on, less what the harness still holds on the
card then (`memory_base`).

The stream is the pool repeated without end; call k takes the edges
[k C, (k + 1) C) of it, C = windows_per_call * edge_bucket, so the
state is carried across the pool's wraps.

The check of `correct` (`check()`, after the window has closed and the
program's state is freed) runs the configuration's plain reference:
  - the start: the warm-up call's first START_WINDOWS windows from the
    reference's own zero slab;
  - one call of the window, drawn from the seed by the loop: from the
    program's slab as it stood before that call (the reference cannot
    follow a whole window's windows in less time than the window), each
    of its windows' summaries and the whole slab after it; and the
    program's reported checksum of the window before it against the
    slab it was handed. The slab before and after is read through the
    engine's public `state()`, a host copy that the loop keeps off the
    window's clock; the sentinel row, zero by the round's semantics, is
    not in it and is put back as zeros;
  - every window of the run: delivered, and its msg_edges equal to the
    edges it held (no reference needed: the harness cut the windows).
Every comparison is exact (limit 0).

`program="control"` puts the reference itself, computed at the control
precision (`reference.GcnRound(precision="fp8")`), in the program's
place: the check must then come out false.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import streams

START_WINDOWS = 64
# the round's kernels in a device trace (csrc/gnn_round.cu), matched as
# parts of the names the profiler gives; the round's memsets are added
ROUND_KERNELS = ("scatter_kernel", "update_kernel", "init_sums_kernel")
WEIGHT_BIAS_UNITS = 32      # bias units drawn from [0, 32]


def make_weights(F: int, gen: torch.Generator):
    """Real-valued W [F, F] and b [F] on the lattice of 2^-5: in each
    column one entry +1 unit and one -1 unit, in two rows drawn from the
    seed, and a bias of 0 to 32 units. A layer of gain about one, so the
    slab stays between 0 and the cap instead of saturating, and a
    changed message shows in the summaries."""
    dev = gen.device
    cols = torch.arange(F, device=dev)
    plus = torch.randint(0, F, (F,), generator=gen, device=dev)
    minus = (plus + 1 + torch.randint(0, F - 1, (F,), generator=gen,
                                      device=dev)) % F
    W = torch.zeros(F, F, dtype=torch.float32, device=dev)
    W[plus, cols] = 1.0
    W[minus, cols] = -1.0
    b = torch.randint(0, WEIGHT_BIAS_UNITS + 1, (F,), generator=gen,
                      device=dev).float()
    return W / 32.0, b / 32.0


class Clock:
    """Laps of set-up on the host's clock, the device waited for."""

    def __init__(self, device, laps: list):
        self.device, self.laps = device, laps
        self.t = time.perf_counter()

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps.append((name, now - self.t))
        self.t = now


class ControlEngine:
    """The reference at the control precision in the engine's place:
    `process` returns the engine's summary dicts."""

    def __init__(self, ref, device):
        self.ref = ref
        self._carry = (ref.fresh_slab(device),)
        self.rows = ref.rows
        self.device = device

    def state(self) -> np.ndarray:
        return self._carry[0][:self.rows].cpu().numpy()

    def process(self, src: np.ndarray, dst: np.ndarray) -> list:
        h, table = self.ref.run(
            self._carry[0], torch.from_numpy(src).to(self.device),
            torch.from_numpy(dst).to(self.device))
        self._carry = (h,)
        return [dict(zip(("max_feat", "active_vertices", "feat_checksum",
                          "msg_edges"), map(int, row)))
                for row in table.tolist()]


class System:
    """One configuration's engine under one mix, set up from the seed:
    `call(k)` feeds call k, `check(calls)` compares after the window."""

    def __init__(self, cfg: dict, seed: int, traffic: dict, reference,
                 device=None, program: str = "engine"):
        self.cfg = cfg
        self.reference = reference
        self.device = torch.device("cuda" if device is None else device)
        self.eb = int(cfg["edge_bucket"])
        self.F = int(cfg["feature_dim"])
        self.num_edges = int(cfg["num_edges"])
        self.call_edges = int(traffic["windows_per_call"]) * self.eb
        self.setup_steps = []
        clock = Clock(self.device, self.setup_steps)
        gen = streams.generator(seed, self.device)
        clock.lap("device context")
        src, dst = streams.make_pool(self.num_edges,
                                     int(cfg["num_vertices"]), gen)
        self.W, self.b = make_weights(self.F, gen)
        clock.lap("pool and weights on the device")
        reps = -(-(self.num_edges + self.call_edges) // self.num_edges)
        ring = self.num_edges + self.call_edges
        self.src = src.repeat(reps)[:ring].cpu().numpy()
        self.dst = dst.repeat(reps)[:ring].cpu().numpy()
        del src, dst
        clock.lap("pool to the host")
        self.rows = reference.bucket(cfg["vertex_bucket"])
        self.memory_base = 0
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self.memory_base = torch.cuda.memory_allocated(self.device)
        if program == "engine":
            from gelly_streaming_tpu_torch.ops.gnn_window import \
                GnnSummaryEngine
            self.engine = GnnSummaryEngine(
                cfg["edge_bucket"], cfg["vertex_bucket"],
                feature_dim=self.F, activation=cfg["activation"],
                device=device)
            self.engine.set_weights(self.W.cpu().numpy(),
                                    self.b.cpu().numpy())
        elif program == "control":
            self.engine = ControlEngine(self._reference("fp8"), self.device)
        else:
            raise ValueError("program must be engine or control, got %r"
                             % program)
        clock.lap("engine built, weights set")
        # the sampled call's slab before and after it, as the engine's
        # state() gives it ([rows, F] on the host)
        self.before = self.after = None
        self.sample = self._pending = None
        self.outputs = {}            # call -> [windows, 4] int64
        self.call(0)                 # the warm-up, from the zero slab
        clock.lap("warm-up call")
        self.reset_stages()

    # -- the program ---------------------------------------------------
    def _edges(self, k: int):
        lo = (k * self.call_edges) % self.num_edges
        return (self.src[lo:lo + self.call_edges],
                self.dst[lo:lo + self.call_edges])

    def keep(self, k: int, after: bool) -> None:
        """Keep the engine's state before call k (`after` false) or
        after it, for the check; call k becomes the sample once both are
        kept."""
        state = self.engine.state()
        if not after:
            self._pending = (k, state)
        elif self._pending is not None and self._pending[0] == k:
            self.sample, self.before, self.after = k, self._pending[1], state
            self._pending = None

    def call(self, k: int) -> int:
        """Feed call k; returns its edges."""
        src, dst = self._edges(k)
        out = self.engine.process(src, dst)
        self.outputs[k] = np.array(
            [(o["max_feat"], o["active_vertices"], o["feat_checksum"],
              o["msg_edges"]) for o in out], np.int64).reshape(-1, 4)
        return len(src)

    def stage_ms(self) -> dict:
        """The ingress pipeline's stage totals since reset_stages, in ms
        (prep summed over the workers: CPU time, not critical path)."""
        t = getattr(self.engine, "stage_timers", None)
        if t is None:
            return {}
        return {"prep": t.prep_ms, "h2d": t.h2d_ms,
                "compute": t.compute_ms, "chunks": t.chunks}

    def reset_stages(self) -> None:
        t = getattr(self.engine, "stage_timers", None)
        if t is not None:
            t.reset()

    def release(self) -> None:
        """Free the program's state (after the window, before the
        reference runs)."""
        self.engine = self._pending = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    # -- the yardstick -------------------------------------------------
    def work(self, windows: int, calls: int, valid_edges: int):
        """(operations, bytes) that `windows` windows in `calls` calls
        with `valid_edges` edges need at the least: the update's product
        2 (rows + 1) F^2 a window and the scatter's F a valid edge; the
        slab read once and written once a call, the edges in (two int32
        ids and a valid byte a slot), the summaries out (four int32 a
        window)."""
        rows1, F = self.rows + 1, self.F
        ops = windows * 2 * rows1 * F * F + valid_edges * F
        nbytes = (calls * 2 * rows1 * F * 4 + windows * self.eb * 9
                  + windows * 16)
        return ops, nbytes

    def _reference(self, precision: str = "float32"):
        cfg = self.cfg
        return self.reference.GcnRound(
            cfg["vertex_bucket"], cfg["edge_bucket"], self.F,
            cfg["activation"], self.W, self.b, precision=precision)

    def expected_msgs(self, k: int) -> np.ndarray:
        n = len(self._edges(k)[0])
        full, tail = divmod(n, self.eb)
        return np.array([self.eb] * full + ([tail] if tail else []),
                        np.int64)

    def check(self, calls):
        """(checks, windows missing): checks the (name, value, limit) of
        every number compared, `calls` the window's calls in order."""
        ref = self._reference()
        dev = self.device
        src, dst = self._edges(0)
        n0 = min(START_WINDOWS * self.eb, len(src))
        _, want = ref.run(ref.fresh_slab(dev),
                          torch.from_numpy(src[:n0]).to(dev),
                          torch.from_numpy(dst[:n0]).to(dev))
        checks = [("start_windows_off",
                   _rows_off(self.outputs[0][:len(want)], want), 0)]
        k = self.sample
        if k is None:
            checks += [("sample_windows_off", 1, 0), ("sample_slab_off", 1, 0)]
        else:
            src, dst = self._edges(k)
            before = _with_sentinel(self.before, dev)
            # the window before the call reported the checksum of the
            # slab the call was handed
            handed = int(self.reference.slab_checksum(before)
                         != self.outputs[k - 1][-1, 2])
            h, want = ref.run(before, torch.from_numpy(src).to(dev),
                              torch.from_numpy(dst).to(dev))
            del before
            checks.append(("sample_windows_off",
                           _rows_off(self.outputs[k], want) + handed, 0))
            after = torch.from_numpy(self.after).to(dev)
            checks.append(("sample_slab_off",
                           int((h[:self.rows] != after).sum().item()), 0))
            del h, after
        off = missing = 0
        for c in [0] + list(calls):
            want = self.expected_msgs(c)
            got = self.outputs.get(c, np.zeros((0, 4), np.int64))
            n = min(len(want), len(got))
            missing += len(want) - n
            off += int((got[:n, 3] != want[:n]).sum())
        checks.append(("run_windows_off", off + missing, 0))
        return checks, missing


def _with_sentinel(state: np.ndarray, device) -> torch.Tensor:
    """A [rows, F] state as the [rows + 1, F] slab, the sentinel row
    zero."""
    slab = torch.zeros(state.shape[0] + 1, state.shape[1],
                       dtype=torch.float32, device=device)
    slab[:-1] = torch.from_numpy(state)
    return slab


def _rows_off(got: np.ndarray, want) -> int:
    want = np.asarray(want, np.int64)
    n = min(len(got), len(want))
    return int((got[:n] != want[:n]).any(axis=1).sum()) + abs(
        len(got) - len(want))
