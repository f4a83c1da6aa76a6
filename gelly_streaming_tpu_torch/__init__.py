"""gelly_streaming_tpu_torch — the PyTorch/CUDA port of
gelly_streaming_tpu for one NVIDIA H100.

It runs the exact per-window triangle count over an edge stream
(`TriangleWindowKernel.count_stream`) and the fused summary engine
(`StreamSummaryEngine.process`: carried degrees, connected components,
bipartiteness and triangles per window, and its sliding form) through
hand-written CUDA kernels (`csrc/`, built by `kernels.py` at first
use). It imports torch and numpy, never JAX and nothing of the JAX
package. Entry points run on the card unless the caller passes
`device="cpu"`, which runs each kernel's plain PyTorch version.

Layers: core/ (device selection), ops/ (window layout and staging, the
intersect, window-counter and window-summary kernels' wrappers, the
union-find, the triangle stream, the summary engines, the numpy
oracles), utils/ (synthetic streams), kernels.py + csrc/ (CUDA build and
binding).
"""

from .core.platform import resolve_device
from .ops.scan_analytics import SlidingSummaryEngine, StreamSummaryEngine
from .ops.triangles import TriangleWindowKernel
from .utils.streams import make_stream

__all__ = ["SlidingSummaryEngine", "StreamSummaryEngine",
           "TriangleWindowKernel", "make_stream", "resolve_device"]
