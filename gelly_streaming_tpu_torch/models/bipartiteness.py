"""Streaming bipartiteness check via summary aggregation.

Port of the JAX package's `models/bipartiteness.py`, the counterpart of
the reference's `BipartitenessCheck`
(library/BipartitenessCheck.java:40-136): per-window fold merges each
edge as a two-vertex signed component (edgeToCandidate, :57-64) into a
`Candidates` summary; the combiner merges window summaries, collapsing
to (false,{}) on any odd cycle.

Two execution modes:
- `BipartitenessCheck` — host fold, exact reference string parity.
- `TorchBipartitenessCheck` — the window fold runs on the environment's
  device (the JAX package's `TpuBipartitenessCheck`) as a signed
  (parity) union-find via the bipartite double cover
  (ops/unionfind.bipartite_labels): one union-find call over 2·V cover
  vertices replaces the reference's O(C²·V) Candidates merge hot loop
  (Candidates.java:75 TODO). The per-window summary is converted to a
  canonical `Candidates` (component key = min vertex, root sign
  positive).

Deliberate divergences from the host/reference path, kept from the JAX
package (both are cases where the reference's merge is buggy and the
device result is the mathematically correct one):
- self-loops: the device form reports the odd cycle (false,{});
  the reference's edgeToCandidate silently drops the sign conflict
  (Candidates.java:110 ignores add's return) and stays bipartite.
- components the reference's merge leaves split/duplicated (a min
  vertex arriving via a later bridging edge, Candidates.java:107-133)
  are emitted fully canonicalized here — same bipartiteness verdicts,
  possibly different component grouping in the printed state.
"""

from __future__ import annotations

from ..core.aggregation import WindowGraphAggregation
from ..ops import segment as seg_ops
from ..ops import unionfind
from ..utils.candidates import Candidates, SignedVertex, edge_to_candidate
from .connected_components import window_arrays


def _update(cand: Candidates, v1, v2, _value) -> Candidates:
    return cand.merge(edge_to_candidate(v1, v2))


def _combine(c1: Candidates, c2: Candidates) -> Candidates:
    return c1.merge(c2)


class BipartitenessCheck(WindowGraphAggregation):
    def __init__(self, merge_window_millis: int):
        super().__init__(
            update_fun=_update,
            combine_fun=_combine,
            initial_value=Candidates(True),
            time_millis=merge_window_millis,
            transient_state=False,
        )


class TorchBipartitenessCheck(WindowGraphAggregation):
    def __init__(self, merge_window_millis: int):
        super().__init__(
            update_fun=_update,  # unused: fold_kernel takes the window
            combine_fun=_combine,
            initial_value=Candidates(True),
            time_millis=merge_window_millis,
            transient_state=False,
            fold_kernel=self._window_candidates,
        )

    @staticmethod
    def _window_candidates(edges, _wmax, device) -> Candidates:
        uniq, (s_dense, d_dense) = seg_ops.intern(*window_arrays(edges))
        labels, signs, odd = unionfind.bipartite_labels(
            s_dense, d_dense, len(uniq), device)
        if bool(odd.any()):
            return Candidates(False)
        cand = Candidates(True)
        roots = uniq[labels]
        for v, root, sign in zip(uniq.tolist(), roots.tolist(), signs.tolist()):
            cand.add(int(root), SignedVertex(int(v), bool(sign)))
        return cand
