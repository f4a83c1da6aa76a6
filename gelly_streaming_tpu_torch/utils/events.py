"""Event/record types used by the workload library (a copy of the JAX
package's `utils/events.py`).

Counterparts of the reference's example/util records:
MatchingEvent (MatchingEvent.java:26-41), SampledEdge
(SampledEdge.java:26-55), TriangleEstimate (TriangleEstimate.java:24-43).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

from ..core.types import Edge


class MatchingEventType(enum.Enum):
    ADD = "ADD"
    REMOVE = "REMOVE"


class MatchingEvent:
    """Output event of streaming weighted matching: an edge entering or
    leaving the matching. A plain class (not a tuple) so sinks print it
    via its own formatting."""

    __slots__ = ("type", "edge")

    def __init__(self, type: MatchingEventType, edge: Edge):
        self.type = type
        self.edge = edge

    def __repr__(self) -> str:
        return (f"{self.type.value} "
                f"{self.edge.source},{self.edge.target},{self.edge.value}")

    def __eq__(self, other) -> bool:
        return (isinstance(other, MatchingEvent)
                and self.type == other.type and self.edge == other.edge)


class SampledEdge(NamedTuple):
    """Routing record for incidence sampling: which subtask/instance an
    (edge, edge_count) observation belongs to, and whether the instance
    resampled on this edge."""

    subtask: int
    instance: int
    edge: Edge
    edge_count: int
    resample: bool


class TriangleEstimate(NamedTuple):
    """Partial estimate from one sampler subtask."""

    source_subtask: int
    edge_count: int
    beta: int
