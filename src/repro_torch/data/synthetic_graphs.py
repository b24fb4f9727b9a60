"""Synthetic data graphs for benchmarks and tests.

The paper evaluates on Email/CiteSeer/MiCo/YouTube/Patents; those files are
not available offline, so benchmarks use synthetic stand-ins with the same
relevant structure:

* :func:`densifying_graph` — the paper's densification protocol (§6.2):
  "created increasingly denser data graphs ... by repeatedly adding batches
  of randomly chosen edges to an empty graph".
* :func:`planted_clique_graph` — ER background + planted clique (lets tests
  assert the known maximum clique).
* :func:`powerlaw_graph` — preferential-attachment for skew-degree behavior.
* :func:`skewed_graph` — large Zipf-endpoint graphs with a skew knob (and
  optional planted clique) sized for the distributed benchmarks, where
  degree skew makes per-shard workloads unequal (DESIGN.md §14).
* :func:`decoy_trap_graph` — skewed background plus dense *decoy* clusters
  and a planted clique on one round-robin residue class: the workload
  where diversified sharded search + bound exchange beats single-device
  priority order outright (DESIGN.md §14).
* :func:`labeled_graph` — ER with vertex labels (CiteSeer-like) for pattern
  mining / isomorphism.
* :func:`attributed_graph` — ER with *skewed* vertex labels plus edge
  types (RDF/protein-interaction-like), for the label-constrained
  workloads: the geometric label frequencies give every selectivity
  regime a label set to sweep (``benchmarks/bench_labeled.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import GraphStore


def densifying_graph(n: int, m: int, seed: int = 0) -> GraphStore:
    """n vertices, m random distinct undirected edges (paper §6.2 protocol)."""
    rng = np.random.default_rng(seed)
    seen = set()
    edges = []
    while len(edges) < m:
        need = m - len(edges)
        cand = rng.integers(0, n, size=(need * 2 + 16, 2))
        for u, v in cand:
            if u == v:
                continue
            key = (min(u, v), max(u, v))
            if key in seen:
                continue
            seen.add(key)
            edges.append(key)
            if len(edges) == m:
                break
    return GraphStore.from_edges(n, np.array(edges))


def planted_clique_graph(n: int, m: int, clique_size: int,
                         seed: int = 0) -> GraphStore:
    """ER(n, m) plus a planted clique on ``clique_size`` random vertices."""
    rng = np.random.default_rng(seed)
    g = densifying_graph(n, m, seed)
    members = rng.choice(n, size=clique_size, replace=False)
    extra = [(u, v) for i, u in enumerate(members) for v in members[i + 1:]]
    edges = np.concatenate([g.edge_array, np.array(extra, np.int32)])
    return GraphStore.from_edges(n, edges)


def powerlaw_graph(n: int, m_per_node: int, seed: int = 0) -> GraphStore:
    """Barabási–Albert preferential attachment."""
    rng = np.random.default_rng(seed)
    edges = []
    targets = list(range(m_per_node))
    repeated = []
    for v in range(m_per_node, n):
        for t in targets:
            edges.append((v, t))
        repeated.extend(targets)
        repeated.extend([v] * m_per_node)
        targets = [repeated[i] for i in
                   rng.integers(0, len(repeated), size=m_per_node)]
    return GraphStore.from_edges(n, np.array(edges))


def labeled_graph(n: int, m: int, n_labels: int, seed: int = 0) -> GraphStore:
    """ER(n, m) with uniform random vertex labels."""
    rng = np.random.default_rng(seed + 1)
    g = densifying_graph(n, m, seed)
    labels = rng.integers(0, n_labels, size=n).astype(np.int32)
    return GraphStore.from_edges(n, g.edge_array, labels=labels)


def _skewed_edges(n: int, m: int, skew: float,
                  rng: np.random.Generator) -> np.ndarray:
    """``m`` distinct undirected edges with Zipf-weighted endpoints
    (vectorized rejection sampling; shared by the large-graph builders)."""
    p = (np.arange(n) + 1.0) ** -float(skew)
    p /= p.sum()
    keys: set = set()
    edges = np.empty((0, 2), np.int64)
    while len(edges) < m:
        need = m - len(edges)
        cand = rng.choice(n, size=(2 * need + 64, 2), p=p)
        cand = cand[cand[:, 0] != cand[:, 1]]
        cand.sort(axis=1)
        fresh = [
            (u, v) for u, v in cand
            if (u, v) not in keys and not keys.add((u, v))][:need]
        if fresh:
            edges = np.concatenate([edges, np.asarray(fresh, np.int64)])
    return edges


def skewed_graph(n: int, m: int, skew: float = 0.0, clique_size: int = 0,
                 seed: int = 0) -> GraphStore:
    """Degree-skewed random graph, sized for the distributed benchmarks.

    Endpoints of the ``m`` distinct undirected edges are drawn with
    probability proportional to ``(v + 1) ** -skew`` — ``skew = 0`` is the
    uniform densifying protocol, larger values concentrate edges on
    low-index vertices (Zipf-like hubs).  Skew is the knob that makes
    shard workloads *unequal* under round-robin seed partitioning: the
    dense hub neighborhoods all hash to a few shards' subtrees, so the
    rebalancer and the stale-bound exchange are both exercised under
    realistic imbalance (DESIGN.md §14).  ``clique_size > 0`` additionally
    plants a clique on random vertices so top-k clique instances have a
    known dominant answer.

    Vectorized rejection sampling (not the edge-at-a-time loop of
    :func:`densifying_graph`): benchmark graphs are 10-100x larger than
    the test graphs, and Python-loop generation would dominate bench
    setup time.
    """
    assert 0 < m <= n * (n - 1) // 2
    rng = np.random.default_rng(seed)
    edges = _skewed_edges(n, m, skew, rng)
    if clique_size > 0:
        members = rng.choice(n, size=clique_size, replace=False)
        extra = [(u, v) for i, u in enumerate(members)
                 for v in members[i + 1:]]
        edges = np.concatenate([edges, np.asarray(extra, np.int64)])
    return GraphStore.from_edges(n, edges)


def decoy_trap_graph(n: int, m: int, skew: float = 0.0, clusters: int = 7,
                     cluster_size: int = 100, cluster_p: float = 0.19,
                     clique_size: int = 7, stride: int = 8,
                     seed: int = 0) -> GraphStore:
    """Skewed background + dense decoy clusters + a clique planted on one
    round-robin residue class (DESIGN.md §14).

    The engine's priority is lexicographic ``(|V|, |P|)``: any size-2 state
    outranks every seed, so a single device must exhaust the decoy
    clusters' size-2 tier — thousands of states whose upper bound sits just
    *below* the planted answer's k-th key — before its dominance threshold
    can rise enough to prune them.  Under round-robin seed partitioning
    into ``stride`` shards, residue class ``stride - 1`` holds the planted
    clique and **no** decoy vertices: that shard reaches the answer within
    a few super-steps, and the bound exchange broadcasts a threshold that
    lets every other shard drop its decoy frontier at dequeue / VPQ refill
    instead of expanding it.  Total work is order-dependent (branch-and-
    bound diversification), which is what lets the sharded engine beat the
    single device on wall clock even when all forced host devices share
    one CPU core.

    Tuning contract (defaults satisfy it): with ``c = cluster_size`` and
    ``p = cluster_p``, a decoy size-2 state has upper bound
    ``~2 + c*p**2``; it must stay >= the best decoy clique size (so the
    single device cannot prune it from its own discoveries, ``c*p**3``
    small keeps decoy cliques at ~4-5) but < ``clique_size - 1`` (the
    planted run's threshold, so the exchanged bound kills it).
    """
    assert clique_size >= 3 and stride >= 2
    rng = np.random.default_rng(seed)
    edges = _skewed_edges(n, m, skew, rng)
    # decoy clusters: disjoint vertex sets drawn off the planted residue
    decoy_pool = np.array([v for v in range(n) if v % stride != stride - 1])
    picks = rng.choice(len(decoy_pool), size=(clusters, cluster_size),
                       replace=False)
    extra = [edges]
    for row in picks:
        mem = np.sort(decoy_pool[row])
        iu, iv = np.triu_indices(cluster_size, k=1)
        keep = rng.random(len(iu)) < cluster_p
        extra.append(np.stack([mem[iu[keep]], mem[iv[keep]]], axis=1))
    # planted clique on the decoy-free residue class, high-index half only:
    # low indices carry the Zipf mass, and a member that doubles as a skew
    # hub would be dequeued with the hubs and hand the single device the
    # answer (and the pruning threshold) without grinding the decoy tier
    lo = n // (2 * stride)
    members = (stride - 1) + stride * (lo + rng.choice(
        n // stride - lo, size=clique_size, replace=False))
    extra.append(np.array([(u, v) for i, u in enumerate(members)
                           for v in members[i + 1:]], np.int64))
    all_e = np.concatenate(extra)
    all_e.sort(axis=1)
    return GraphStore.from_edges(n, np.unique(all_e, axis=0))


def attributed_graph(n: int, m: int, n_labels: int, n_edge_labels: int = 0,
                     skew: float = 0.6, seed: int = 0) -> GraphStore:
    """ER(n, m) with skewed vertex labels and (optionally) edge types.

    Vertex labels follow a geometric distribution: label ``l`` has
    relative frequency ``skew**l`` (normalized), so low-index labels are
    common and high-index labels rare — a label predicate allowing only
    the tail labels is *low-selectivity* (few allowed vertices), which is
    the regime where predicate pushdown pays (DESIGN.md §12).  Every
    label is guaranteed at least one vertex.  Edge types are uniform over
    ``n_edge_labels`` (0 = untyped graph).
    """
    assert n_labels >= 1 and n >= n_labels
    rng = np.random.default_rng(seed + 1)
    g = densifying_graph(n, m, seed)
    freq = skew ** np.arange(n_labels)
    labels = rng.choice(n_labels, size=n, p=freq / freq.sum())
    # guarantee every label occurs so predicates over any label are
    # non-degenerate (deterministic: first n_labels vertices)
    labels[:n_labels] = np.arange(n_labels)
    ea = g.edge_array
    edge_labels = (rng.integers(0, n_edge_labels, size=len(ea))
                   if n_edge_labels > 0 else None)
    return GraphStore.from_edges(n, ea, labels=labels.astype(np.int32),
                                 edge_labels=edge_labels)
