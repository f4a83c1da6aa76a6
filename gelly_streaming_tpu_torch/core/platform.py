"""Device selection for the PyTorch port.

Every entry point of the port takes `device=None`, which means the CUDA
card. There is no silent fallback to the CPU: the plain PyTorch path
runs on the CPU only when the caller passes `device="cpu"` (the tests
do), so a measurement can never be taken on the wrong device by
accident.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` → the current CUDA device, raising when there is none; an
    explicit device is taken as given, and a CUDA device is checked to
    exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device %s requested but no CUDA device "
                               "is available" % dev)
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
