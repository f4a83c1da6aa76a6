"""gelly_streaming_tpu_torch — the PyTorch/CUDA port of
gelly_streaming_tpu for one NVIDIA H100.

It runs the exact per-window triangle count over an edge stream
(`TriangleWindowKernel.count_stream`) through hand-written CUDA kernels
(`csrc/`, built by `kernels.py` at first use). It imports torch and
numpy, never JAX and nothing of the JAX package. Entry points run on the
card unless the caller passes `device="cpu"`, which runs each kernel's
plain PyTorch version.

Layers: core/ (device selection), ops/ (window layout, the intersect
and window-counter kernels' wrappers, the triangle stream, the numpy
oracle), utils/ (synthetic streams), kernels.py + csrc/ (CUDA build and
binding).
"""

from .core.platform import resolve_device
from .ops.triangles import TriangleWindowKernel
from .utils.streams import make_stream

__all__ = ["TriangleWindowKernel", "make_stream", "resolve_device"]
