"""The card's published peaks and its power limit.

Rates from NVIDIA's H100 SXM data sheet, dense, at the full power limit
of 700 W: fp16/bf16 tensor cores 989 TFLOP/s, float32 without tensor
cores 67 TFLOP/s, HBM3 3.35 TB/s. A card set below 700 W runs slower
under load; every result line names the limit it ran at.
"""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp16_tensor_flops": 989e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "rated_watts": 700.0,
    },
}


def peaks_of(kind: str) -> dict:
    """The peaks of the card named `kind`; none for a card the table
    does not know (the readers that need them then read nothing)."""
    return PEAKS.get(kind, {})


def power_limit(index: int = 0) -> str:
    """The card's power limit as nvidia-smi reads it ("700.00 W"), or
    "unknown"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip() or "unknown"
