"""Checkpoint files: every stateful object's `state_dict()` (nested
dicts, lists and tuples of numpy arrays and scalars) in one .npz, the
tree's structure as JSON inside it.

Port of the JAX package's `utils/checkpoint.py` (:48-254), in the same
file format, so a checkpoint written by either package restores in the
other. The contract:
- `save` is atomic (a tmp file named by the process, fsynced, then
  renamed; unlinked on any failure) and keeps the previous generation
  as `prev_path(path)`;
- `restore` of a damaged file raises `CheckpointCorrupt` naming it, and
  lets operational failures (missing file, permissions, EIO) raise as
  they are;
- `load_latest` tries the newest generation, then the previous one, and
  returns None where neither exists.
A completed save stamps a durable `checkpoint_saved` flight-recorder
event and fires the `ckpt_save` fault site (utils/faults.py) after the
rename; a restore fires `ckpt_restore` first and stamps
`checkpoint_restored` or a durable `checkpoint_corrupt`.
`CheckpointPolicy` is the cadence (every N windows and/or every T
seconds, with an injectable clock) the driver asks at its window and
chunk boundaries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from . import faults
from . import telemetry

_ARRAY_KEY = "__arrays__"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file exists but cannot be decoded (truncation,
    bit-flips, torn writes). `path` names the damaged file."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(f"checkpoint {path!r} is corrupt "
                         f"({type(cause).__name__}: {cause})")
        self.path = path


def _key(k):
    """A dict key with its type kept across the JSON spec."""
    if isinstance(k, bool) or not isinstance(k, (int, str)):
        raise TypeError(f"unsupported checkpoint dict key: {k!r}")
    return ["i", k] if isinstance(k, int) else ["s", k]


def _unkey(pair):
    kind, k = pair
    return int(k) if kind == "i" else k


def _flatten(tree: Any, arrays: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        return {"t": "dict",
                "items": [[_key(k), _flatten(v, arrays)]
                          for k, v in tree.items()]}
    if isinstance(tree, np.ndarray):
        # sequential keys: keys built from paths could collide
        key = f"a{len(arrays)}"
        arrays[key] = tree
        return {"t": "array", "key": key}
    if isinstance(tree, (list, tuple)):
        return {"t": "list" if isinstance(tree, list) else "tuple",
                "items": [_flatten(v, arrays) for v in tree]}
    if isinstance(tree, (int, float, str, bool)) or tree is None:
        return {"t": "scalar", "v": tree}
    raise TypeError(f"unsupported checkpoint leaf: {type(tree)}")


def _unflatten(node: dict, arrays) -> Any:
    kind = node["t"]
    if kind == "dict":
        return {_unkey(k): _unflatten(v, arrays) for k, v in node["items"]}
    if kind == "array":
        return arrays[node["key"]]
    if kind == "list":
        return [_unflatten(v, arrays) for v in node["items"]]
    if kind == "tuple":
        return tuple(_unflatten(v, arrays) for v in node["items"])
    if kind == "scalar":
        return node["v"]
    raise TypeError(kind)


def prev_path(path: str) -> str:
    """The previous generation `save` keeps beside `path`."""
    return path + ".prev"


def save(path: str, tree: Any) -> None:
    """Atomically write `tree` to `path`, moving the file already there
    to `prev_path(path)` first."""
    arrays: Dict[str, np.ndarray] = {}
    spec = _flatten(tree, arrays)
    arrays[_ARRAY_KEY + "spec"] = np.frombuffer(json.dumps(spec).encode(),
                                                dtype=np.uint8)
    tmp = "%s.tmp.%d" % (path, os.getpid())
    written = tmp + ".npz"          # np.savez appends .npz
    try:
        np.savez_compressed(tmp, **arrays)
        # on disk before the rename, so a crash never installs a file
        # whose bytes were still in the page cache
        fd = os.open(written, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if os.path.exists(path):
            os.replace(path, prev_path(path))
        os.replace(written, path)
    finally:
        if os.path.exists(written):
            try:
                os.unlink(written)
            except OSError:
                pass
    telemetry.event("checkpoint_saved", durable=True, path=path)
    # damage to a completed checkpoint, injected after the rename
    faults.fire("ckpt_save", path)


def restore(path: str) -> Any:
    """Decode one checkpoint file; damage raises CheckpointCorrupt."""
    import zipfile
    import zlib

    faults.fire("ckpt_restore", path)
    try:
        with np.load(path, allow_pickle=False) as data:
            spec = json.loads(bytes(data[_ARRAY_KEY + "spec"]).decode())
            arrays = {k: data[k] for k in data.files
                      if k != _ARRAY_KEY + "spec"}
        tree = _unflatten(spec, arrays)
    except (zipfile.BadZipFile, zlib.error, ValueError, KeyError,
            EOFError, json.JSONDecodeError, TypeError, IndexError) as e:
        # what np.load and the spec decode raise on damaged archives
        telemetry.event("checkpoint_corrupt", durable=True, path=path,
                        cause=type(e).__name__)
        raise CheckpointCorrupt(path, e) from e
    telemetry.event("checkpoint_restored", path=path)
    return tree


def load_latest(path: str):
    """(tree, path used): `path`, else `prev_path(path)` when `path` is
    corrupt or absent; None when neither exists; CheckpointCorrupt when
    every existing generation is damaged."""
    corrupt = None
    for cand in (path, prev_path(path)):
        if not os.path.exists(cand):
            continue
        try:
            return restore(cand), cand
        except CheckpointCorrupt as e:
            corrupt = e
    if corrupt is not None:
        raise corrupt
    return None


@dataclasses.dataclass
class CheckpointPolicy:
    """When to snapshot: every `every_n_windows` processed windows and/or
    every `every_seconds` of wall time, whichever comes first (0
    disables a trigger). Callers ask `due(windows_done)` at their
    boundaries and call `mark(windows_done)` after taking a snapshot."""

    every_n_windows: int = 0
    every_seconds: float = 0.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.every_n_windows < 0 or self.every_seconds < 0:
            raise ValueError("checkpoint cadences must be >= 0")
        self._last_w = 0
        self._last_t: Optional[float] = None

    def enabled(self) -> bool:
        return self.every_n_windows > 0 or self.every_seconds > 0

    def due(self, windows_done: int) -> bool:
        if self.every_n_windows > 0 and (
                windows_done // self.every_n_windows
                > self._last_w // self.every_n_windows):
            return True
        if self.every_seconds > 0:
            now = self.clock()
            if self._last_t is None:
                self._last_t = now      # the first call anchors the clock
            elif now - self._last_t >= self.every_seconds:
                return True
        return False

    def mark(self, windows_done: int) -> None:
        self._last_w = windows_done
        if self.every_seconds > 0:
            self._last_t = self.clock()
