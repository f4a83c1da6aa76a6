"""Edge sources: 'src dst [ts]' text files parsed by the native parser
(native/ingest.cpp) straight into int64 COO arrays, whole or in
bounded-memory chunks, for the columnar driver; and `read_edge_file`,
the same data as a record-level SimpleEdgeStream for the graph API.

Port of the JAX package's `io/sources.py` (:27-186).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native
from ..core.datastream import DataStream
from ..core.graphstream import SimpleEdgeStream
from ..core.gtime import AscendingTimestampExtractor
from ..core.plan import OpNode
from ..core.types import NULL, Edge


def load_edge_arrays(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, ts) int64 arrays; ts = -1 where a line has no third
    column."""
    return native.parse_edge_file(path)


def _iter_edge_chunks_sync(path: str, chunk_bytes: int):
    remainder = b""
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk_bytes)
            if not buf:
                break
            data = remainder + buf
            cut = data.rfind(b"\n")
            if cut < 0:
                remainder = data
                continue
            remainder = data[cut + 1:]
            arrays = native.parse_edge_bytes(data[:cut + 1])
            if len(arrays[0]):
                yield arrays
    if remainder:
        arrays = native.parse_edge_bytes(remainder)
        if len(arrays[0]):
            yield arrays


def tail_edge_file(path: str, stop, chunk_bytes: int = 1 << 20,
                   poll_s: float = 0.2):
    """Follow a growing 'src dst [ts]' file: yield parsed COO chunks of
    every complete appended line, polling every `poll_s` seconds, until
    the threading.Event `stop` is set; then the last line, with or
    without its newline, goes through the parser too."""
    remainder = b""
    with open(path, "rb") as f:
        while not stop.is_set():
            buf = f.read(chunk_bytes)
            if not buf:
                stop.wait(poll_s)
                continue
            data = remainder + buf
            cut = data.rfind(b"\n")
            if cut < 0:
                remainder = data
                continue
            remainder = data[cut + 1:]
            arrays = native.parse_edge_bytes(data[:cut + 1])
            if len(arrays[0]):
                yield arrays
        remainder += f.read()
    if remainder:
        arrays = native.parse_edge_bytes(remainder)
        if len(arrays[0]):
            yield arrays


def iter_edge_chunks(path: str, chunk_bytes: int = 1 << 24,
                     prefetch: int = 2):
    """Stream a 'src dst [ts]' file as COO chunks of about `chunk_bytes`
    each, cut at the last newline, without reading the whole file.
    `prefetch` > 0 reads and parses up to that many chunks ahead on a
    producer thread (the ctypes parse drops the GIL); 0 parses
    inline."""
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    if prefetch < 1:
        yield from _iter_edge_chunks_sync(path, chunk_bytes)
        return

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    DONE, ERROR = object(), object()
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for arrays in _iter_edge_chunks_sync(path, chunk_bytes):
                if stop.is_set() or not _put(arrays):
                    return        # the consumer is gone: stop reading
            _put(DONE)
        except BaseException as e:   # re-raised by the consumer
            _put((ERROR, e))

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and item[0] is ERROR:
                raise item[1]
            yield item
    finally:
        # finished or abandoned: stop the producer, which checks `stop`
        # between chunks, so at most one more chunk is parsed
        stop.set()
        while t.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)


def read_edge_file(env, path: str,
                   event_time: bool = False) -> SimpleEdgeStream:
    """A SimpleEdgeStream over a 'src dst [ts]' file. With event_time,
    the third column drives event-time windows (and edge values become
    NullValue, matching the reference's RemoveEdgeValue pattern)."""
    src, dst, ts = load_edge_arrays(path)

    def _records():
        if event_time:
            for s, d, t in zip(src.tolist(), dst.tolist(), ts.tolist()):
                yield Edge(s, d, t)
        else:
            for s, d in zip(src.tolist(), dst.tolist()):
                yield Edge(s, d, NULL)

    edges = DataStream(env, OpNode("source", (), items_fn=_records))
    if event_time:
        stream = SimpleEdgeStream(
            edges, env,
            timestamp_extractor=AscendingTimestampExtractor(lambda e: e.value),
        )
        return stream.map_edges(lambda e: NULL)
    return SimpleEdgeStream(edges, env)
