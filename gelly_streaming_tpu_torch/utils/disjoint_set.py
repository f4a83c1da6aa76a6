"""Union-find summary state for streaming connected components.

Copy of the JAX package's `utils/disjoint_set.py`: the host-side
counterpart of the reference's `DisjointSet`
(example/util/DisjointSet.java:30-154): parent map with path
compression, union by rank, and a merge that unions in the entries of
another instance ("naive symmetric hash join", DisjointSet.java:126-136).
The device-side equivalent is ops/unionfind.py (the union-find kernel);
this class is the exact-parity state used by the merge-tree and tests.

`__repr__` prints components as `{root=[members...]}` matching the
reference's toString (DisjointSet.java:139-153), which its tests parse
(ConnectedComponentsTest.java:45-57); members are emitted in sorted
order for determinism. The port adds a `__deepcopy__` of the two maps.
"""

from __future__ import annotations

from typing import Dict, Generic, Iterable, TypeVar

R = TypeVar("R")


class DisjointSet(Generic[R]):
    def __init__(self, elements: Iterable[R] = ()):
        self._parent: Dict[R, R] = {}
        self._rank: Dict[R, int] = {}
        for e in elements:
            self.make_set(e)

    def get_matches(self) -> Dict[R, R]:
        return self._parent

    def make_set(self, e: R) -> None:
        self._parent[e] = e
        self._rank[e] = 0

    def find(self, e: R):
        """Root of e's set, with full path compression
        (reference: DisjointSet.java:71-85)."""
        if e not in self._parent:
            return None
        root = e
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[e] != root:
            self._parent[e], e = root, self._parent[e]
        return root

    def union(self, e1: R, e2: R) -> None:
        """Union by rank; absent elements are created
        (reference: DisjointSet.java:97-123)."""
        if e1 not in self._parent:
            self.make_set(e1)
        if e2 not in self._parent:
            self.make_set(e2)
        r1, r2 = self.find(e1), self.find(e2)
        if r1 == r2:
            return
        if self._rank[r1] > self._rank[r2]:
            self._parent[r2] = r1
        elif self._rank[r1] < self._rank[r2]:
            self._parent[r1] = r2
        else:
            self._parent[r2] = r1
            self._rank[r1] += 1

    def merge(self, other: "DisjointSet[R]") -> None:
        """Union in every (element, parent) entry of `other`
        (reference: DisjointSet.java:132-136)."""
        for e, p in other.get_matches().items():
            self.union(e, p)

    def size(self) -> int:
        return len(self._parent)

    def components(self) -> Dict[R, list]:
        comps: Dict[R, list] = {}
        for v in self._parent:
            comps.setdefault(self.find(v), []).append(v)
        return comps

    def __deepcopy__(self, memo) -> "DisjointSet[R]":
        """A copy of the two maps (elements are hashable ids, never
        changed in place): the merger copies the whole state at each
        emission, which copy.deepcopy's generic walk makes slow."""
        out = type(self)()
        out._parent = dict(self._parent)
        out._rank = dict(self._rank)
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "elements": list(self._parent.keys()),
            "parents": list(self._parent.values()),
            "ranks": [self._rank[e] for e in self._parent],
        }

    def load_state_dict(self, state: dict) -> None:
        self._parent = dict(zip(state["elements"], state["parents"]))
        self._rank = dict(zip(state["elements"], state["ranks"]))

    def __repr__(self) -> str:
        comps = self.components()
        try:
            keys = sorted(comps)
        except TypeError:
            keys = list(comps)
        return "{" + ", ".join(
            f"{k}=[{', '.join(str(m) for m in sorted(comps[k]))}]" for k in keys
        ) + "}"
