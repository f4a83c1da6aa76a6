"""Stream execution environment.

Port of the JAX package's `core/env.py`: the counterpart of the
reference's `StreamExecutionEnvironment` (SimpleEdgeStream.java:74,91;
WindowTriangles.java:175,188; GraphStreamTestUtils.java:32-37): program
context, sources, time characteristic, parallelism, execute(). The
environment also names the device its neighborhood and triangle kernels
run on: `device=None` means the CUDA card, resolved at the first device
kernel a job builds (a job of host UDFs needs none); `device="cpu"` runs
the kernels' plain versions. `enable_tracing` and `trace_report` raise
NotImplementedError until the port's tracing (ROADMAP step 1.8).
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

from .datastream import DataStream
from .gtime import Clock, SystemClock, TimeCharacteristic
from .plan import OpNode
from .platform import resolve_device


class StreamEnvironment:
    def __init__(self, clock: Optional[Clock] = None, device=None):
        self.clock: Clock = clock or SystemClock()
        self.time_characteristic = TimeCharacteristic.INGESTION_TIME
        self.parallelism = 1
        self._device_arg = device
        self._device = None
        self._sinks: List[OpNode] = []
        self._results: dict = {}
        self._last_runtime_ms: Optional[float] = None

    @property
    def device(self):
        """The device of the job's kernels, resolved at first use."""
        if self._device is None:
            self._device = resolve_device(self._device_arg)
        return self._device

    # ------------------------------------------------------------------
    @staticmethod
    def get_execution_environment(clock: Optional[Clock] = None,
                                  device=None) -> "StreamEnvironment":
        return StreamEnvironment(clock=clock, device=device)

    def set_parallelism(self, parallelism: int) -> "StreamEnvironment":
        self.parallelism = parallelism
        return self

    def set_stream_time_characteristic(self, tc: TimeCharacteristic) -> "StreamEnvironment":
        self.time_characteristic = tc
        return self

    # ------------------------------------------------------------------
    # sources (reference: fromCollection / readTextFile / generateSequence)
    # ------------------------------------------------------------------
    def from_collection(self, items: Iterable[Any]) -> DataStream:
        return DataStream(self, OpNode("source", (), items=list(items)))

    def read_text_file(self, path: str) -> DataStream:
        def _read():
            with open(path) as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield line

        return DataStream(self, OpNode("source", (), items_fn=_read))

    def generate_sequence(self, start: int, end: int) -> DataStream:
        return DataStream(self, OpNode("source", (), items=list(range(start, end + 1))))

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _register_sink(self, node: OpNode) -> None:
        self._sinks.append(node)

    def execute(self, job_name: str = "job") -> "JobExecutionResult":
        import time as _t

        from . import runtime

        if self._last_runtime_ms is not None:
            # Operator closures hold state for the life of the plan (like a
            # Flink program instance); re-running would silently reuse it.
            raise RuntimeError(
                "this environment was already executed; build a new "
                "StreamEnvironment per job"
            )
        start = _t.time()
        self._results = runtime.execute(self)
        self._last_runtime_ms = (_t.time() - start) * 1000
        return JobExecutionResult(self._last_runtime_ms)

    def results_of(self, stream: DataStream) -> List[Any]:
        """Records collected by a `.collect()` sink (values only)."""
        return [v for (v, _ts) in self._results.get(stream.node.id, [])]

    def enable_tracing(self) -> "StreamEnvironment":
        raise NotImplementedError("per-operator tracing is not ported yet "
                                  "(ROADMAP step 1.8)")

    def trace_report(self) -> List[dict]:
        raise NotImplementedError("per-operator tracing is not ported yet "
                                  "(ROADMAP step 1.8)")


class JobExecutionResult:
    """Mirror of the reference's use of `JobExecutionResult.getNetRuntime()`
    (CentralizedWeightedMatching.java:62-64)."""

    def __init__(self, runtime_ms: float):
        self._runtime_ms = runtime_ms

    def get_net_runtime(self) -> float:
        return self._runtime_ms
