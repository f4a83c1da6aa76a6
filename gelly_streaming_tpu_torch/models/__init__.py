"""Algorithm library and workloads (the reference's L4 `library/`): the
window triangle count and its workload pipelines, connected components
and the bipartiteness check (host folds and `Torch*` device folds),
iterative CC, weighted matching and the sampling triangle estimators."""

from .bipartiteness import BipartitenessCheck, TorchBipartitenessCheck
from .connected_components import (ConnectedComponents,
                                   TorchConnectedComponents)
from .iterative_cc import TorchIterativeConnectedComponents

__all__ = [
    "BipartitenessCheck", "TorchBipartitenessCheck",
    "ConnectedComponents", "TorchConnectedComponents",
    "TorchIterativeConnectedComponents",
]
