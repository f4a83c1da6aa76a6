"""Time primitives for the streaming runtime.

Covers the slice of Flink time semantics the reference uses
(reference: SimpleEdgeStream.java:74,90-94 — IngestionTime default,
EventTime with an ascending timestamp extractor; windowing via
`timeWindow(Time.of(...))`). Copy of the JAX package's `core/gtime.py`.
"""

from __future__ import annotations

import dataclasses
import enum
import time as _pytime


class TimeCharacteristic(enum.Enum):
    """How records acquire timestamps (reference: SimpleEdgeStream.java:74,91)."""

    INGESTION_TIME = "ingestion"
    EVENT_TIME = "event"


@dataclasses.dataclass(frozen=True)
class Time:
    """A duration in milliseconds (reference: Flink `Time.of(n, unit)`)."""

    milliseconds: int

    @staticmethod
    def of(value: int, unit: str = "ms") -> "Time":
        factor = {
            "ms": 1,
            "milliseconds": 1,
            "s": 1000,
            "seconds": 1000,
            "min": 60_000,
            "minutes": 60_000,
            "h": 3_600_000,
            "hours": 3_600_000,
            "d": 86_400_000,
            "days": 86_400_000,
        }[unit]
        return Time(int(value) * factor)

    @staticmethod
    def milliseconds_of(value: int) -> "Time":
        return Time(int(value))

    @staticmethod
    def seconds(value: int) -> "Time":
        return Time(int(value) * 1000)

    @staticmethod
    def minutes(value: int) -> "Time":
        return Time(int(value) * 60_000)

    @staticmethod
    def hours(value: int) -> "Time":
        return Time(int(value) * 3_600_000)

    @staticmethod
    def days(value: int) -> "Time":
        return Time(int(value) * 86_400_000)


class Clock:
    """Source of ingestion timestamps (ms)."""

    def now_ms(self) -> int:
        raise NotImplementedError


class SystemClock(Clock):
    def now_ms(self) -> int:
        return int(_pytime.time() * 1000)


class ManualClock(Clock):
    """Deterministic clock for tests: fixed time, advanced explicitly."""

    def __init__(self, start_ms: int = 0):
        self._now = start_ms

    def now_ms(self) -> int:
        return self._now

    def advance(self, delta_ms: int) -> None:
        self._now += delta_ms


def window_start(timestamp_ms: int, size_ms: int) -> int:
    """Tumbling-window start for a timestamp (Flink TimeWindow semantics)."""
    return timestamp_ms - (timestamp_ms % size_ms)


def window_end(timestamp_ms: int, size_ms: int) -> int:
    return window_start(timestamp_ms, size_ms) + size_ms


def window_max_timestamp(timestamp_ms: int, size_ms: int) -> int:
    """Flink `TimeWindow.maxTimestamp()` = end - 1 (WindowTriangles.java:137)."""
    return window_end(timestamp_ms, size_ms) - 1


class AscendingTimestampExtractor:
    """Event-time extractor base (reference: SimpleEdgeStream.java:90-94).

    Subclasses (or instances constructed with `fn`) return the event-time
    timestamp in ms for each element; timestamps are assumed ascending.
    """

    def __init__(self, fn=None):
        self._fn = fn

    def extract_ascending_timestamp(self, element) -> int:
        if self._fn is None:
            raise NotImplementedError
        return self._fn(element)
