"""Bipartiteness-check summary state: signed two-coloring candidates.

Copy of the JAX package's `utils/candidates.py`: the result-parity
re-implementation of the reference's `Candidates` /
`SignedVertex` (example/util/Candidates.java:26-196,
example/util/SignedVertex.java:23-41): a success flag plus an ordered
map component-id → {vertex-id → (vertex-id, sign)}. `merge` compares
each incoming component against existing ones, merges along shared
vertices with sign reversal, and collapses to `(false,{})` on any odd
cycle (Candidates.java:76-138). The reference notes its own O(C²·V)
merge needs cleanup (Candidates.java:75); the vectorizable device
equivalent is the parity union-find in ops/unionfind.py — this class
exists for exact golden-string parity
(BipartitenessCheckTest.java:18-20). The port adds a `__deepcopy__`
that shares the immutable SignedVertex records.

`__repr__` matches Java's `Tuple2(Boolean, TreeMap).toString`:
``(true,{1={1=(1,true), 2=(2,false)}})``.
"""

from __future__ import annotations

from typing import Dict


class SignedVertex:
    """(vertex id, sign) pair (reference: SignedVertex.java:23-41)."""

    __slots__ = ("vertex", "sign")

    def __init__(self, vertex: int, sign: bool):
        self.vertex = vertex
        self.sign = sign

    def reverse(self) -> "SignedVertex":
        return SignedVertex(self.vertex, not self.sign)

    def __repr__(self) -> str:
        return f"({self.vertex},{'true' if self.sign else 'false'})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, SignedVertex)
                and self.vertex == other.vertex and self.sign == other.sign)


Component = Dict[int, SignedVertex]  # vertex id -> signed vertex


class Candidates:
    def __init__(self, success: bool = True):
        self.success = success
        # component id -> {vertex id -> SignedVertex}; kept key-sorted on
        # iteration (the reference uses TreeMaps).
        self.map: Dict[int, Component] = {}

    # ------------------------------------------------------------------
    def add(self, component: int, vertex: SignedVertex) -> bool:
        """Add a signed vertex; False on sign conflict within the component
        (reference: Candidates.java:60-73)."""
        comp = self.map.setdefault(component, {})
        stored = comp.get(vertex.vertex)
        if stored is not None and stored.sign != vertex.sign:
            return False
        comp[vertex.vertex] = vertex
        return True

    def _add_component(self, component: int, vertices: Component) -> bool:
        for v in vertices.values():
            if not self.add(component, v):
                return False
        return True

    # ------------------------------------------------------------------
    def merge(self, other: "Candidates") -> "Candidates":
        """Merge another candidate set into this one
        (reference: Candidates.java:76-138). Mutates and returns self,
        or a fresh failed instance on an odd cycle."""
        if not other.success or not self.success:
            return Candidates(False)

        for in_key in sorted(other.map):
            in_comp = other.map[in_key]
            # Components of self sharing a vertex (identical-set ones skipped)
            merge_with = []
            for self_key in sorted(self.map):
                self_comp = self.map[self_key]
                if set(in_comp) == set(self_comp):
                    continue
                if any(v in self_comp for v in in_comp):
                    merge_with.append(self_key)

            if not merge_with:
                # Disjoint from everything: adopt the component as-is
                # (the reference ignores add's return here too,
                # Candidates.java:110).
                self._add_component(in_key, in_comp)
                continue

            first_key = merge_with[0]
            if not self._merge_components(other, in_key, first_key):
                return Candidates(False)
            first_key = min(in_key, first_key)
            for self_key in merge_with[1:]:
                if not self._merge_components(self, self_key, first_key):
                    # Deliberate divergence: the reference ignores this
                    # failure (Candidates.java:127-130 calls fail() and
                    # drops the result, staying success=true) — an odd
                    # cycle detected while collapsing bridged components
                    # is a genuine non-bipartiteness witness, so we fail.
                    return Candidates(False)
                self.map.pop(self_key, None)

        return self

    def _merge_components(self, source: "Candidates", source_key: int,
                          self_key: int) -> bool:
        """Merge source's component into self's, under key
        min(source_key, self_key), reversing signs if the first shared
        vertex disagrees; False if shared vertices are inconsistent
        (reference: Candidates.java:141-191)."""
        src_comp = source.map[source_key]
        self_comp = self.map[self_key]
        shared = [v for v in src_comp if v in self_comp]
        reversed_ = src_comp[shared[0]].sign != self_comp[shared[0]].sign
        for v in shared:
            agree = src_comp[v].sign == self_comp[v].sign
            if agree == reversed_:
                return False
        common_key = min(source_key, self_key)
        for sv in list(src_comp.values()):
            if not self.add(common_key, sv.reverse() if reversed_ else sv):
                return False
        return True

    def __deepcopy__(self, memo) -> "Candidates":
        """A copy that shares the SignedVertex records: none is changed
        once made (`reverse` makes a new one). The merger copies the
        whole state at each emission, which copy.deepcopy's generic walk
        makes the slowest step of a large stream."""
        out = Candidates(self.success)
        out.map = {k: dict(comp) for k, comp in self.map.items()}
        return out

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "success": self.success,
            "components": {
                str(k): {str(v): sv.sign for v, sv in comp.items()}
                for k, comp in self.map.items()
            },
        }

    def load_state_dict(self, state: dict) -> None:
        self.success = state["success"]
        self.map = {
            int(k): {
                int(v): SignedVertex(int(v), bool(sign))
                for v, sign in comp.items()
            }
            for k, comp in state["components"].items()
        }

    # ------------------------------------------------------------------
    def __repr__(self) -> str:
        inner = ", ".join(
            "{}={{{}}}".format(
                k, ", ".join(f"{v}={self.map[k][v]}" for v in sorted(self.map[k]))
            )
            for k in sorted(self.map)
        )
        return f"({'true' if self.success else 'false'},{{{inner}}})"


def edge_to_candidate(v1: int, v2: int) -> Candidates:
    """An edge as a two-vertex signed component keyed by the smaller
    endpoint (reference: BipartitenessCheck.java:57-64)."""
    src, trg = min(v1, v2), max(v1, v2)
    cand = Candidates(True)
    cand.add(src, SignedVertex(src, True))
    cand.add(src, SignedVertex(trg, False))
    return cand
