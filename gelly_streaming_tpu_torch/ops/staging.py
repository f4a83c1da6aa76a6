"""Host-to-device staging of a chunk's window stacks, and the enqueued
copy back of its outputs: the two copies each chunk of a stream costs.

A `ChunkStager` takes either wire (ops/compact_ingress.py): the
standard [W, eb] int32 src, int32 dst, bool valid (9 bytes per slot) or
the compact [W, eb] uint16 src, uint16 dst and [W] int32 valid counts (4
bytes per slot plus 4 per window). The stream engines stage through a
ring of slots from the ingress pipeline's workers
(ops/ingress_pipeline.py); the cohorts and the one-window counts stage
on the caller's thread.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint16): torch.uint16,
                 np.dtype(np.bool_): torch.bool,
                 np.dtype(np.float32): torch.float32}
_ALIGN = 16


class _Slot:
    """One pinned host buffer and one device buffer (allocated at first
    use, grown only when a larger chunk comes), the "copied" event of its
    h2d and the "consumed" event recorded after the kernels that read
    it."""

    def __init__(self):
        self.host = None
        self.dev = None
        self.copied = None
        self.consumed = None
        self.busy = False


class Staged:
    """A chunk staged into one slot: `tensors` are its arrays on the
    device (views into the slot's device buffer), valid once the compute
    stream waits for `slot.copied` (`ChunkStager.take`)."""

    __slots__ = ("slot", "tensors")

    def __init__(self, slot, tensors):
        self.slot = slot
        self.tensors = tensors


class ChunkStager:
    """A ring of `slots` staging slots on `device`.

    `put(arrays, ordinal)` (any thread) writes the host arrays back to
    back into the pinned buffer of slot `ordinal % slots` and copies them
    in one non-blocking h2d on the stager's own copy stream, recording the
    slot's "copied" event. `take(staged)` (the dispatching thread) makes
    the current stream wait for that event and returns the device
    tensors; `done(staged)`, called after the kernels that read them are
    enqueued, records the slot's "consumed" event on the current stream.
    A slot is written again only after its previous chunk is done and its
    "copied" and "consumed" events have passed, so neither the pinned
    buffer under an unfinished copy nor the device buffer under
    unfinished kernels is overwritten. A pipelined caller whose
    look-ahead is `inflight` holds `inflight + 1` slots: chunk
    i + inflight + 1 is staged only after chunk i was dispatched.

    `stager(*arrays)` stages, takes and returns the tensors in one call
    for callers that stage and launch on one thread: the slot's
    "consumed" event is recorded at that caller's next call, on its
    current stream, after whatever it launched in between.

    On the CPU every call hands out zero-copy views of the host arrays.
    """

    def __init__(self, device: torch.device, slots: int = 1):
        self.device = torch.device(device)
        self._slots = [_Slot() for _ in range(max(1, int(slots)))]
        self._cond = threading.Condition()
        self._next = 0
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    def put(self, arrays, ordinal: int) -> Staged:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self.device.type == "cpu":
            return Staged(None, tuple(torch.from_numpy(a) for a in arrays))
        slot = self._slots[ordinal % len(self._slots)]
        with self._cond:
            while slot.busy:        # the previous chunk not dispatched yet
                self._cond.wait()
            slot.busy = True
        if slot.consumed is not None:     # its copy and kernels are over
            slot.copied.synchronize()
            slot.consumed.synchronize()
        offsets, total = [], 0
        for a in arrays:
            offsets.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        with torch.cuda.device(self.device), torch.cuda.stream(self._copy):
            if slot.host is None or slot.host.numel() < total:
                slot.host = torch.empty(total, dtype=torch.uint8,
                                        pin_memory=True)
                slot.dev = torch.empty(total, dtype=torch.uint8,
                                       device=self.device)
                slot.copied = torch.cuda.Event()
                slot.consumed = torch.cuda.Event()
            host = slot.host.numpy()
            for a, off in zip(arrays, offsets):
                host[off:off + a.nbytes].view(a.dtype)[:] = a.reshape(-1)
            slot.dev[:total].copy_(slot.host[:total], non_blocking=True)
            slot.copied.record(self._copy)
        tensors = tuple(
            slot.dev[off:off + a.nbytes].view(_TORCH_DTYPES[a.dtype])
            .view(a.shape) for a, off in zip(arrays, offsets))
        return Staged(slot, tensors)

    def take(self, staged: Staged) -> tuple:
        if staged.slot is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.slot.copied)
            # the buffer was allocated on the copy stream: tell the
            # caching allocator the compute stream uses it too
            staged.slot.dev.record_stream(stream)
        return staged.tensors

    def done(self, staged: Staged) -> None:
        slot = staged.slot
        if slot is None:
            return
        slot.consumed.record(torch.cuda.current_stream(self.device))
        with self._cond:
            slot.busy = False
            self._cond.notify_all()

    def release_all(self) -> None:
        """Free every slot after a run that failed between put and done
        (its workers finished): a staged chunk that was never dispatched
        no longer holds its slot."""
        with self._cond:
            for slot in self._slots:
                slot.busy = False
            self._cond.notify_all()

    def __call__(self, *arrays) -> tuple:
        if self.device.type == "cuda":
            slot = self._slots[self._next % len(self._slots)]
            if slot.busy:   # handed out by an earlier call of this thread
                self.done(Staged(slot, ()))
        staged = self.put(arrays, self._next)
        self._next += 1
        return self.take(staged)


class HostCopy:
    """A tensor's copy to host memory, enqueued on the current stream:
    `numpy()` waits for it (on the CPU it is the tensor itself)."""

    __slots__ = ("_host", "_event")

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cpu":
            self._host, self._event = t, None
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
