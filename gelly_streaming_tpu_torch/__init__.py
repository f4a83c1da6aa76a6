"""gelly_streaming_tpu_torch — the PyTorch/CUDA port of
gelly_streaming_tpu for one NVIDIA H100.

It runs the exact per-window triangle count over an edge stream
(`TriangleWindowKernel.count_stream`), the fused summary engine
(`StreamSummaryEngine.process`: carried degrees, connected components,
bipartiteness and triangles per window, and its sliding form), the
windowed GNN engine (`GnnSummaryEngine.process`: one exact GCN round per
window, with `GnnHostEngine` its numpy twin), the one-window count
`triangle_count` (a dense contraction up to 4096 vertices) and the
multi-tenant cohorts (`TenantCohort`: N summary streams, one cohort
dispatch per window round; `GnnTenantCohort`: N GNN streams) through
hand-written CUDA kernels (`csrc/`, built by `kernels.py` at first
use). The stream paths build their chunks through a three-stage ingress
pipeline (prep and h2d on a worker pool, dispatch in chunk order;
`forced_sync()` pins the synchronous form) and take the standard wire
or, with `ingress="compact"`, the compact one (uint16 ids, one valid
count per window), which the counter and summary kernels decode as they
load it. It imports torch and numpy, never JAX and nothing of the JAX
package. Entry points run on the card unless the caller passes
`device="cpu"`, which runs each kernel's plain PyTorch version.

Layers: core/ (device selection, the tenant cohorts), ops/ (window
layout, the compact wire, the ingress pipeline and staging, the
intersect, window-counter, window-summary, cohort-summary, GNN-round and
dense-triangle kernels' wrappers, the union-find, the triangle stream
and dispatcher, the summary and GNN engines, the numpy oracles), utils/
(synthetic streams), kernels.py + csrc/ (CUDA build and binding).
"""

from .core.driver import StreamingAnalyticsDriver, WindowResult
from .core.platform import resolve_device
from .core.tenancy import (GnnTenantCohort, TenantBackpressure,
                           TenantCohort, TenantError, TenantRejected)
from .ops.gnn_window import GnnHostEngine, GnnSummaryEngine
from .ops.ingress_pipeline import forced_sync
from .ops.scan_analytics import SlidingSummaryEngine, StreamSummaryEngine
from .ops.triangles import (TriangleWindowKernel, triangle_count,
                            triangle_count_dense)
from .utils.streams import make_stream

__all__ = ["GnnHostEngine", "GnnSummaryEngine", "GnnTenantCohort",
           "SlidingSummaryEngine", "StreamSummaryEngine",
           "StreamingAnalyticsDriver", "WindowResult",
           "TenantBackpressure", "TenantCohort", "TenantError",
           "TenantRejected", "TriangleWindowKernel", "forced_sync",
           "make_stream", "resolve_device", "triangle_count",
           "triangle_count_dense"]
