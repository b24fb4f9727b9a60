"""Baselines and oracles — the port of ``repro.core.exhaustive``, numpy and
plain Python over the port's :class:`~repro_torch.core.graph.GraphStore`.

* :func:`brute_force_max_clique` / :func:`brute_force_cliques` — exact host
  oracles for tests.
* :class:`ArabesqueStyleClique` — the paper's comparison system, reproduced
  algorithmically: level-synchronous **exhaustive expansion** of connected
  subgraphs followed by **post-filtering** of non-cliques, no prioritization,
  no pruning (paper §2.2 / Fig. 2: creates s10, s11, s12 then discards them).
  Reports the paper's machine-independent cost metric — the number of
  candidate subgraphs created.
* :func:`nuri_np_clique_candidates` — "Nuri-NP": targeted expansion only
  (never creates non-cliques) but FIFO order and no pruning.
* :func:`brute_force_iso` / :func:`pattern_support_oracle` — oracles for
  subgraph isomorphism and min-image pattern support.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .graph import GraphStore


# --------------------------------------------------------------------- clique
def brute_force_max_clique(graph: GraphStore) -> Tuple[int, List[int]]:
    """Exact maximum clique by recursive candidate intersection (host)."""
    neigh = [set(map(int, graph.neighbors(v))) for v in range(graph.n)]
    best_size, best = 0, []

    def rec(cur: List[int], cand: Set[int]):
        nonlocal best_size, best
        if len(cur) > best_size:
            best_size, best = len(cur), list(cur)
        if len(cur) + len(cand) <= best_size:
            return
        for v in sorted(cand):
            rec(cur + [v], {u for u in cand if u > v and u in neigh[v]})

    rec([], set(range(graph.n)))
    return best_size, sorted(best)


def brute_force_cliques(graph: GraphStore, max_size: int) -> List[Tuple[int, ...]]:
    """All cliques up to ``max_size`` (host, for small test graphs)."""
    neigh = [set(map(int, graph.neighbors(v))) for v in range(graph.n)]
    out = []

    def rec(cur: List[int], cand: Set[int]):
        out.append(tuple(cur))
        if len(cur) == max_size:
            return
        for v in sorted(cand):
            rec(cur + [v], {u for u in cand if u > v and u in neigh[v]})

    for v in range(graph.n):
        rec([v], {u for u in neigh[v] if u > v})
    return out


class ArabesqueStyleClique:
    """Arabesque-style exhaustive expansion + post-filter for clique discovery.

    Level-synchronous: all size-ℓ subgraphs are produced before any size-ℓ+1
    subgraph (no prioritized expansion), every connected expansion is created
    then filtered (no targeted expansion), nothing is pruned (no top-k bound).
    """

    def __init__(self, graph: GraphStore, max_candidates: int = 2_000_000):
        self.g = graph
        self.neigh = [set(map(int, graph.neighbors(v)))
                      for v in range(graph.n)]
        self.max_candidates = max_candidates

    def run(self) -> dict:
        candidates = 0
        level: Set[Tuple[int, ...]] = {(v,) for v in range(self.g.n)}
        candidates += len(level)
        best_size, best = 1, next(iter(level)) if level else ()
        completed = True
        while level:
            nxt: Set[Tuple[int, ...]] = set()
            for sub in level:
                members = set(sub)
                frontier = set().union(*(self.neigh[v] for v in sub)) - members
                for u in frontier:
                    cand = tuple(sorted(members | {u}))
                    if cand in nxt:
                        continue
                    candidates += 1           # created BEFORE filtering
                    if candidates > self.max_candidates:
                        completed = False
                        break
                    # post-filter: keep only cliques
                    if all(b in self.neigh[a]
                           for a, b in itertools.combinations(cand, 2)):
                        nxt.add(cand)
                if not completed:
                    break
            if not completed:
                break
            if nxt:
                best_size = len(next(iter(nxt)))
                best = max(nxt)
            level = nxt
        return dict(candidates=candidates, max_clique_size=best_size,
                    clique=sorted(best), completed=completed)


def nuri_np_clique_candidates(graph: GraphStore,
                              max_candidates: int = 5_000_000) -> dict:
    """Nuri-NP: targeted expansion (cliques only), FIFO order, no pruning."""
    neigh = [set(map(int, graph.neighbors(v))) for v in range(graph.n)]
    q = deque()
    for v in range(graph.n):
        q.append((frozenset([v]), frozenset(u for u in neigh[v] if u > v)))
    candidates = len(q)
    best_size = 1
    completed = True
    while q:
        members, cand = q.popleft()
        best_size = max(best_size, len(members))
        for v in sorted(cand):
            child_cand = frozenset(
                u for u in cand if u > v and u in neigh[v])
            candidates += 1
            if candidates > max_candidates:
                completed = False
                q.clear()
                break
            q.append((members | {v}, child_cand))
    return dict(candidates=candidates, max_clique_size=best_size,
                completed=completed)


# ------------------------------------------------------------------------ iso
def brute_force_iso(graph: GraphStore, q_edges: List[Tuple[int, int]],
                    q_labels: List[int], induced: bool = True,
                    k: int = 1,
                    predicate=None) -> List[Tuple[int, Tuple[int, ...]]]:
    """Top-k induced subgraph isomorphisms by total degree (host oracle).

    ``predicate`` (a :class:`repro_torch.core.labels.LabelPredicate`) applies
    the label-constrained semantics of DESIGN.md §12: per-query-vertex
    label classes (``q_any_of``), a global allowed-vertex set
    (``vertex_any_of``), and adjacency restricted to allowed edge types
    (``edge_any_of``) — scores remain full-graph degree sums.
    """
    nq = len(q_labels)
    q_adj = [[False] * nq for _ in range(nq)]
    for a, b in q_edges:
        q_adj[a][b] = q_adj[b][a] = True
    deg = graph.degrees
    labels = graph.labels
    if predicate is not None and labels is None and (
            predicate.vertex_any_of is not None
            or predicate.q_any_of is not None):
        raise ValueError(
            "label predicate requires a vertex-labeled graph")
    classes = [
        set(predicate.q_any_of[j]) if predicate is not None
        and predicate.q_any_of is not None else {q_labels[j]}
        for j in range(nq)]
    allowed = (set(predicate.vertex_any_of)
               if predicate is not None
               and predicate.vertex_any_of is not None else None)
    if predicate is not None and predicate.edge_any_of is not None:
        eadj = predicate.adjacency(graph)

        def has_edge(u, v):
            return bool((int(eadj[u, v // 32]) >> (v % 32)) & 1)
    else:
        has_edge = graph.has_edge
    results = []

    def rec(mapping: List[int]):
        d = len(mapping)
        if d == nq:
            score = int(sum(deg[v] for v in mapping))
            results.append((score, tuple(mapping)))
            return
        for v in range(graph.n):
            if v in mapping:
                continue
            if labels is not None and int(labels[v]) not in classes[d]:
                continue
            if allowed is not None and int(labels[v]) not in allowed:
                continue
            ok = True
            for i in range(d):
                has = has_edge(mapping[i], v)
                if q_adj[i][d] != has and (induced or q_adj[i][d]):
                    ok = False
                    break
            if ok:
                rec(mapping + [v])

    rec([])
    results.sort(key=lambda t: (-t[0], t[1]))
    return results[:k]


# -------------------------------------------------------------------- pattern
def pattern_support_oracle(graph: GraphStore,
                           p_edges: List[Tuple[int, int]],
                           p_labels: List[int]) -> int:
    """Minimum image-based support [5] of a pattern (non-induced embeddings)."""
    nq = len(p_labels)
    embeddings = _all_embeddings(graph, p_edges, p_labels)
    if not embeddings:
        return 0
    images = [set() for _ in range(nq)]
    for emb in embeddings:
        for j, v in enumerate(emb):
            images[j].add(v)
    return min(len(s) for s in images)


def _all_embeddings(graph: GraphStore, p_edges, p_labels):
    nq = len(p_labels)
    q_adj = [[False] * nq for _ in range(nq)]
    for a, b in p_edges:
        q_adj[a][b] = q_adj[b][a] = True
    labels = graph.labels
    out = []

    def rec(mapping: List[int]):
        d = len(mapping)
        if d == nq:
            out.append(tuple(mapping))
            return
        for v in range(graph.n):
            if v in mapping:
                continue
            if labels is not None and int(labels[v]) != p_labels[d]:
                continue
            ok = all(not q_adj[i][d] or graph.has_edge(mapping[i], v)
                     for i in range(d))
            if ok:
                rec(mapping + [v])

    rec([])
    return out
