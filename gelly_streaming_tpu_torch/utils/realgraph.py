"""Real-shaped graph streams: a citation-stream generator calibrated
against the published SNAP cit-HepPh summary statistics, for bench legs
and workload runs whose input should have a real graph's degree and
timestamp shape rather than the synthetic power law of
utils/streams.make_stream. A copy of the JAX package's
`utils/realgraph.py`: the same seed gives the same stream, element for
element. (The SNAP file itself is not downloaded: the generator is held
to the dataset's published numbers instead, in the JAX package's
tests/library/test_realgraph.py.)

Published anchors (SNAP cit-HepPh summary page; also the dataset named
by BASELINE.json's Continuous Degree Aggregate config):
    nodes 34,546 · edges 421,578 · average clustering coefficient
    0.2848 · triangles 1,276,868
The generated graph hits the node/edge counts exactly and lands within
a few percent of the clustering/triangle figures. SNAP publishes no
max-degree figure, so the degree tail is anchored instead by the
in-degree power-law exponent, inside the α ≈ 2-3.5 band reported for
citation networks.

Model: time-ordered preferential attachment with triadic closure and a
bimodal paper population — ordinary papers cite ~11 references, a
survey stratum (1 in 12) cites 60, mostly by copying reference pairs
from already-chosen papers (co-citation bursts). The copying is what
concentrates triangles in hub neighborhoods, which is exactly how the
real dataset combines a high global triangle count with a moderate
average clustering coefficient: hub triangles barely move the local
coefficient of a high-degree vertex. Citations always point backwards
in time, so the stream is a DAG with strictly increasing timestamps
and no self-loops — the shape every ingest path downstream assumes.
"""

from __future__ import annotations

import random

import numpy as np

# SNAP cit-HepPh published summary statistics (the calibration anchors)
CIT_HEPPH_NODES = 34_546
CIT_HEPPH_EDGES = 421_578
CIT_HEPPH_AVG_CLUSTERING = 0.2848
CIT_HEPPH_TRIANGLES = 1_276_868

# Calibrated model parameters (tests assert the resulting statistics;
# re-tune these only against the published anchors above)
_SURVEY_EVERY = 12       # 1-in-12 papers is a survey
_SURVEY_M = 60           # survey reference-list length
_SURVEY_CLOSURE = 0.48   # survey triadic-closure probability
_BASE_CLOSURE = 0.57     # ordinary-paper closure probability
_UNIFORM = 0.46          # uniform (non-preferential) citation share
_BURST = 2               # co-citation copy length for surveys


def citation_stream(num_papers: int = CIT_HEPPH_NODES,
                    num_edges: int = CIT_HEPPH_EDGES,
                    seed: int = 17):
    """Deterministic cit-HepPh-shaped edge stream.

    Returns (src, dst, ts): src strictly newer than dst (a DAG, no
    self-loops), ts = arrival index (strictly increasing, the
    event-time contract of SimpleEdgeStream's extractors). Exactly
    `num_edges` edges over exactly `num_papers` vertices.
    """
    rng = random.Random(seed)
    out_adj: list = [()] * num_papers
    repeated: list = []        # PA urn: one entry per received citation
    src_l: list = []
    dst_l: list = []

    # exact edge quotas: surveys take _SURVEY_M, the remainder spreads
    # over ordinary papers; early papers (t < quota) push their
    # shortfall onto later ones
    n_cite = num_papers - 1
    surveys = sum(1 for t in range(1, num_papers)
                  if t % _SURVEY_EVERY == 0)
    base_total = num_edges - surveys * _SURVEY_M
    base_n = n_cite - surveys
    base_m, rem = divmod(base_total, base_n)
    deficit = 0
    base_seen = 0
    for t in range(1, num_papers):
        if t % _SURVEY_EVERY == 0:
            m = _SURVEY_M
            closure, burst = _SURVEY_CLOSURE, _BURST
        else:
            base_seen += 1
            m = base_m + (1 if base_seen <= rem else 0)
            closure, burst = _BASE_CLOSURE, 1
        m += deficit
        take = min(m, t)
        deficit = m - take
        m = take

        targets: list = []
        tset: set = set()
        guard = 0
        while len(targets) < m and guard < 60 * m:
            guard += 1
            if targets and rng.random() < closure:
                u = targets[rng.randrange(len(targets))]
                refs = out_adj[u]
                if refs:
                    start = rng.randrange(len(refs))
                    for j in range(burst):
                        if len(targets) >= m:
                            break
                        w = refs[(start + j) % len(refs)]
                        if w not in tset:
                            tset.add(w)
                            targets.append(w)
                            repeated.append(w)
                    continue
            if rng.random() < _UNIFORM or not repeated:
                w = rng.randrange(t)
            else:
                w = repeated[rng.randrange(len(repeated))]
            if w not in tset:
                tset.add(w)
                targets.append(w)
                repeated.append(w)
        deficit += m - len(targets)   # guard exhaustion (tiny graphs)
        out_adj[t] = tuple(targets)
        src_l.extend([t] * len(targets))
        dst_l.extend(targets)

    src = np.array(src_l, np.int32)
    dst = np.array(dst_l, np.int32)
    ts = np.arange(len(src), dtype=np.int64)
    return src, dst, ts


def undirected_stats(src: np.ndarray, dst: np.ndarray, n: int):
    """Exact (triangles, average local clustering coefficient, degree
    vector) of the undirected simple graph underlying a COO stream —
    the quantities the SNAP summary pages publish. Set-intersection
    edge iterator: each edge (u,v) contributes |N(u) ∩ N(v)| shared
    neighbors; every triangle is counted once per edge (÷3 globally)
    and twice per incident vertex (÷2 locally)."""
    adj = [set() for _ in range(n)]
    for u, v in zip(src.tolist(), dst.tolist()):
        if u != v:
            adj[u].add(v)
            adj[v].add(u)
    acc = np.zeros(n, np.int64)
    tri3 = 0
    for u in range(n):
        au = adj[u]
        for v in au:
            if v > u:
                c = len(au & adj[v])
                tri3 += c
                acc[u] += c
                acc[v] += c
    deg = np.array([len(a) for a in adj], np.int64)
    tv = acc / 2
    with_deg = deg >= 2
    local = np.zeros(n)
    local[with_deg] = tv[with_deg] / (deg[with_deg]
                                      * (deg[with_deg] - 1) / 2)
    avg_cc = float(local[deg > 0].mean()) if (deg > 0).any() else 0.0
    return tri3 // 3, avg_cc, deg


def indegree_powerlaw_alpha(dst: np.ndarray, n: int,
                            dmin: int = 20) -> float:
    """Discrete-MLE power-law exponent of the in-degree tail (Clauset
    et al.'s continuous approximation, adequate for a band assert):
    α = 1 + k / Σ ln(d_i / (dmin - ½)) over degrees ≥ dmin."""
    ind = np.bincount(dst, minlength=n)
    tail = ind[ind >= dmin].astype(float)
    if len(tail) == 0:
        return float("nan")
    return float(1.0 + len(tail) / np.log(tail / (dmin - 0.5)).sum())
