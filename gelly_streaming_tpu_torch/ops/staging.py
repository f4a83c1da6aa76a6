"""Host-to-device staging of a [W, eb] window stack: the one copy each
chunk of a stream costs on its way to the kernels.

Both stream engines (ops/triangles.TriangleWindowKernel and
ops/scan_analytics.StreamSummaryEngine) stage through a `ChunkStager`.
"""

from __future__ import annotations

import numpy as np
import torch


class ChunkStager:
    """stager(s, d, valid) -> the [W, eb] host stacks (int32, int32,
    bool) as tensors on `device`.

    On the CPU they are zero-copy views. On a card the three stacks go
    back to back (9 bytes per slot) into one pinned host buffer, which
    is copied in one non-blocking h2d. The buffer is reused, so a caller
    reads the results of one staged chunk (which synchronises) before
    staging the next."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf = None

    def __call__(self, s: np.ndarray, d: np.ndarray, valid: np.ndarray):
        if self.device.type == "cpu":
            return tuple(torch.from_numpy(np.ascontiguousarray(x))
                         for x in (s, d, valid))
        w, eb = s.shape
        n = w * eb
        if self._buf is None or self._buf.numel() < 9 * n:
            self._buf = torch.empty(9 * n, dtype=torch.uint8,
                                    pin_memory=True)
        host = self._buf[:9 * n].numpy()
        host[:4 * n].view(np.int32)[:] = s.reshape(-1)
        host[4 * n:8 * n].view(np.int32)[:] = d.reshape(-1)
        host[8 * n:].view(np.bool_)[:] = valid.reshape(-1)
        dev = self._buf[:9 * n].to(self.device, non_blocking=True)
        return (dev[:4 * n].view(torch.int32).view(w, eb),
                dev[4 * n:8 * n].view(torch.int32).view(w, eb),
                dev[8 * n:].view(torch.bool).view(w, eb))
