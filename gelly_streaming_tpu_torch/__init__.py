"""gelly_streaming_tpu_torch — the PyTorch/CUDA port of
gelly_streaming_tpu for one NVIDIA H100.

It carries the graph-streaming API (`StreamEnvironment`,
`SimpleEdgeStream`, `slice()` and the neighborhood fold/reduce/apply on
`Torch*` or host UDFs, `models.triangles.WindowTriangleCount`), the
summary-aggregation models of `models/` (connected components and the
bipartiteness check as host folds and as `Torch*` device folds on the
union-find kernel, iterative CC, weighted matching, the sampling
triangle estimators) and the columnar windowed reduce
(`WindowedEdgeReduce`, over the cell-reduce kernel). It runs the exact per-window triangle count over an edge stream
(`TriangleWindowKernel.count_stream`), the fused summary engine
(`StreamSummaryEngine.process`: carried degrees, connected components,
bipartiteness and triangles per window, and its sliding form), the
windowed GNN engine (`GnnSummaryEngine.process`: one exact GCN round per
window, with `GnnHostEngine` its numpy twin), the one-window count
`triangle_count` (a dense contraction up to 4096 vertices) and the
multi-tenant cohorts (`TenantCohort`: N summary streams, one cohort
dispatch per window round; `GnnTenantCohort`: N GNN streams), served
over loopback TCP by `StreamServer` (`ServeClient` its client), through
hand-written CUDA kernels (`csrc/`, built by `kernels.py` at first
use). The stream paths build their chunks through a three-stage ingress
pipeline (prep and h2d on a worker pool, dispatch in chunk order;
`forced_sync()` pins the synchronous form) and take the standard wire
or, with `ingress="compact"`, the compact one (uint16 ids, one valid
count per window), which the counter and summary kernels decode as they
load it. It imports torch and numpy, never JAX and nothing of the JAX
package. Entry points run on the card unless the caller passes
`device="cpu"`, which runs each kernel's plain PyTorch version.

Layers: core/ (the graph-stream API and its runtime, device selection,
the tenant cohorts and their serving front end, the columnar driver
with tumbling or sliding windows), models/ (the window triangle count and its workloads,
connected components, bipartiteness, iterative CC, matching, the
sampling estimators), ops/ (the neighborhood kernels, the windowed
reduce and cell reduce, window
layout, the compact wire, the ingress pipeline and staging, the
intersect, window-counter, window-summary, cohort-summary, GNN-round and
dense-triangle kernels' wrappers, the union-find, the triangle stream
and dispatcher, the summary and GNN engines, the numpy oracles), utils/
(synthetic streams, the synthetic cit-HepPh stream, the models' summary
states and event records), kernels.py + csrc/ (CUDA build and binding).
"""

from .core.datastream import DataStream
from .core.driver import StreamingAnalyticsDriver, WindowResult
from .core.env import StreamEnvironment
from .core.functions import (EdgesApply, EdgesFold, EdgesReduce,
                             TorchEdgesApply, TorchEdgesFold,
                             TorchEdgesReduce)
from .core.graphstream import GraphStream, GraphWindowStream, SimpleEdgeStream
from .core.gtime import (AscendingTimestampExtractor, ManualClock, SystemClock,
                         Time, TimeCharacteristic)
from .core.platform import resolve_device
from .core.serve import ServeClient, StreamServer, serve_port
from .core.types import NULL, Edge, EdgeDirection, NullValue, Vertex
from .core.tenancy import (GnnTenantCohort, TenantBackpressure,
                           TenantCohort, TenantError, TenantQuarantined,
                           TenantRejected)
from .ops.gnn_window import (GnnHostEngine, GnnResidentEngine,
                             GnnSummaryEngine)
from .ops.ingress_pipeline import forced_sync
from .ops.scan_analytics import SlidingSummaryEngine, StreamSummaryEngine
from .ops.triangles import (TriangleWindowKernel, triangle_count,
                            triangle_count_dense)
from .ops.windowed_reduce import WindowedEdgeReduce
from .utils.streams import make_stream

__all__ = ["DataStream", "StreamEnvironment", "EdgesApply", "EdgesFold",
           "EdgesReduce", "TorchEdgesApply", "TorchEdgesFold",
           "TorchEdgesReduce", "GraphStream", "GraphWindowStream",
           "SimpleEdgeStream", "AscendingTimestampExtractor",
           "ManualClock", "SystemClock", "Time", "TimeCharacteristic",
           "NULL", "Edge", "EdgeDirection", "NullValue", "Vertex",
           "GnnHostEngine", "GnnResidentEngine", "GnnSummaryEngine",
           "GnnTenantCohort", "ServeClient",
           "SlidingSummaryEngine", "StreamServer", "StreamSummaryEngine",
           "StreamingAnalyticsDriver", "WindowResult",
           "TenantBackpressure", "TenantCohort", "TenantError",
           "TenantQuarantined", "TenantRejected", "TriangleWindowKernel",
           "WindowedEdgeReduce",
           "forced_sync", "make_stream", "resolve_device", "serve_port",
           "triangle_count", "triangle_count_dense"]
