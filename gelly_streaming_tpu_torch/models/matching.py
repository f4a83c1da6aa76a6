"""Centralized preemptive greedy weighted matching.

A copy of the JAX package's `models/matching.py`, the counterpart of the reference's CentralizedWeightedMatching
(example/CentralizedWeightedMatching.java:56-108): a parallelism-1
sequential stage (parallelism strategy P4, SURVEY.md §2.4) that keeps a
local matching; an arriving edge replaces its colliding matched edges
iff its weight exceeds TWICE their summed weight, emitting ADD/REMOVE
events. This 2x-threshold preemptive greedy (Feigenbaum et al.'s
streaming matching) guarantees a 1/6-approximation in the worst case —
NOT the folklore 1/2 of offline greedy: a kept edge flanked by two
just-under-threshold rivals shows the gap (pinned with an executed
counterexample in the JAX package's tests/library/test_workloads.py and
the port's tests/test_torch_matching_sampling.py). Inherently sequential —
this stays a host stage by design, as in the JAX package; the endpoint-collision lookup uses
a dict index instead of the reference's full-set scan.
"""

from __future__ import annotations

from typing import Dict, Set

from ..core.datastream import DataStream
from ..core.types import Edge
from ..utils.events import MatchingEvent, MatchingEventType


class WeightedMatchingMapper:
    """Stateful flat-mapper holding the current matching."""

    def __init__(self):
        self._matching: Set[Edge] = set()
        self._by_vertex: Dict[object, Set[Edge]] = {}

    def __call__(self, edge: Edge, collect) -> None:
        collisions = set()
        for endpoint in (edge.source, edge.target):
            collisions |= self._by_vertex.get(endpoint, set())
        total = sum(e.value for e in collisions)
        if edge.value > 2 * total:
            for colliding in collisions:
                self._remove(colliding)
                collect(MatchingEvent(MatchingEventType.REMOVE, colliding))
            self._add(edge)
            collect(MatchingEvent(MatchingEventType.ADD, edge))

    def _add(self, edge: Edge) -> None:
        self._matching.add(edge)
        for endpoint in (edge.source, edge.target):
            self._by_vertex.setdefault(endpoint, set()).add(edge)

    def _remove(self, edge: Edge) -> None:
        self._matching.discard(edge)
        for endpoint in (edge.source, edge.target):
            self._by_vertex.get(endpoint, set()).discard(edge)


def centralized_weighted_matching(edges: DataStream) -> DataStream:
    """edges: DataStream of weighted Edge records → MatchingEvent stream."""
    return edges.flat_map(WeightedMatchingMapper()).set_parallelism(1)
