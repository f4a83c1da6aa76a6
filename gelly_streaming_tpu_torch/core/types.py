"""Graph data model: edges, vertices, directions, and Java-parity formatting.

Mirrors the data model the reference borrows from Flink Gelly:
`Edge<K,EV>` is a (source, target, value) triple, `Vertex<K,VV>` is an
(id, value) pair, `EdgeDirection` selects neighborhood orientation
(reference: SimpleEdgeStream.java:59, GraphStream.java:38).

Formatting helpers reproduce the exact text output of the reference's
CSV/text sinks so golden-output tests transfer verbatim
(e.g. `NullValue` prints as "(null)", tuples as "(a,b)"). Copy of the
JAX package's `core/types.py`.
"""

from __future__ import annotations

import enum
from typing import Any, NamedTuple


class NullValue:
    """Singleton placeholder value (Flink `NullValue`); prints as "(null)"."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @staticmethod
    def get_instance() -> "NullValue":
        return NullValue()

    def __repr__(self) -> str:
        return "(null)"

    def __eq__(self, other) -> bool:
        return isinstance(other, NullValue)

    def __hash__(self) -> int:
        return hash(NullValue)


NULL = NullValue.get_instance()


class EdgeDirection(enum.Enum):
    """Neighborhood orientation (reference: Gelly `EdgeDirection`)."""

    IN = "in"
    OUT = "out"
    ALL = "all"


class Edge(NamedTuple):
    """Directed edge (source, target, value) — reference: Gelly `Edge<K,EV>`."""

    source: Any
    target: Any
    value: Any = NULL

    def reverse(self) -> "Edge":
        return Edge(self.target, self.source, self.value)

    def get_source(self):
        return self.source

    def get_target(self):
        return self.target

    def get_value(self):
        return self.value


class Vertex(NamedTuple):
    """Vertex (id, value) — reference: Gelly `Vertex<K,VV>`."""

    id: Any
    value: Any = NULL

    def get_id(self):
        return self.id

    def get_value(self):
        return self.value


def java_str(value: Any) -> str:
    """Render a value the way Java's `toString` would in the reference's sinks.

    - tuples → "(a,b)"  (Flink Tuple.toString)
    - NullValue → "(null)"
    - booleans → "true"/"false"
    - dict → "{k1=v1, k2=v2}" (java.util Map.toString)
    - list → "[a, b]"
    """
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, tuple):
        return "(" + ",".join(java_str(f) for f in value) + ")"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{java_str(k)}={java_str(v)}" for k, v in value.items()) + "}"
    if isinstance(value, list):
        return "[" + ", ".join(java_str(v) for v in value) + "]"
    return str(value)


def csv_line(value: Any) -> str:
    """Render one record as the reference's `writeAsCsv` would (top-level
    tuple fields comma-joined, nested values via `java_str`)."""
    if isinstance(value, tuple):
        return ",".join(java_str(f) for f in value)
    return java_str(value)


def text_line(value: Any) -> str:
    """Render one record as the reference's `writeAsText` would (toString)."""
    return java_str(value)
