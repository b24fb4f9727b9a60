"""Top-k maximum-weight cliques: the reference's answer and its judgement
of a response.

The program answers a ``weighted-clique`` request with the ``k`` heaviest
cliques of the graph under the request's vertex ``weights``, every clique
counted and not only the maximal ones: summed weight descending, and among
cliques of one weight the canonical order of their states (the vertex
bitset's words from word 0, as signed 32-bit integers; ``clique.py`` has
the detail).  A response has to equal that list, key by key and clique by
clique.

The search is checked as in ``clique.py``: each clique is one node of the
program's search tree, whose candidates are the common neighbours above
its last vertex and whose bound is its weight plus theirs.  A bound never
grows from a node to its children, and the program expands every node
whose bound reaches its threshold, which never passes the answer's k-th
key; so a complete run's ``expanded`` may not fall below the number of
cliques whose bound reaches that key.

The reference lists every clique by levels with ``clique.py``'s numpy
``extend``, weighs each, takes the ``k`` heaviest by weight and then the
canonical order, and counts the cliques whose bound reaches the k-th key.
It imports nothing of the program.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Dict, List, Optional

import numpy as np

from .clique import _canonical, extend
from .graph import NEG, Graph


class WeightedCliques:
    """Every clique of a graph with its weight and bound under ``weights``:
    ``levels[j]`` the cliques of ``j + 1`` vertices (ascending rows),
    ``weights[j]`` each one's weight, ``bounds[j]`` its weight plus its
    candidates'."""

    def __init__(self, levels: List[np.ndarray], parents: List[np.ndarray],
                 weights: np.ndarray):
        w = np.asarray(weights, np.int64)
        self.levels = levels
        self.weights = [w[level].sum(axis=1) for level in levels]
        self.bounds = []
        for j, level in enumerate(levels):
            cand = np.zeros(len(level), np.int64)
            if j + 1 < len(levels):
                nxt = levels[j + 1]
                cand = np.bincount(parents[j + 1], weights=w[nxt[:, -1]],
                                   minlength=len(level)).astype(np.int64)
            self.bounds.append(self.weights[j] + cand)

    def top(self, k: int) -> List[List[int]]:
        """The ``k`` heaviest cliques (fewer where the graph has fewer),
        each as its ascending vertex list, in the program's order."""
        if k <= 0:
            return []
        every = np.concatenate(self.weights)
        if len(every) <= k:
            floor = int(every.min())
        else:
            floor = int(np.partition(every, len(every) - k)[len(every) - k])
        rows = [(int(wt), list(map(int, r)))
                for level, wts in zip(self.levels, self.weights)
                for r, wt in zip(level[wts >= floor], wts[wts >= floor])]

        def order(a, b):
            if a[0] != b[0]:
                return -1 if a[0] > b[0] else 1
            return _canonical(a[1], b[1])
        rows.sort(key=functools.cmp_to_key(order))
        return [r for _, r in rows[:k]]

    def must_expand(self, key: int) -> int:
        """The cliques whose bound reaches ``key``: those a run whose
        answer's k-th key is ``key`` expands, whatever its order."""
        return int(sum((b >= key).sum() for b in self.bounds))


def clique_levels(g: Graph):
    """Every clique of ``g`` by size, and for each level past the first
    the row of the level before that each clique extends."""
    levels = [np.arange(g.n, dtype=np.int64)[:, None]]
    parents = [np.empty(0, np.int64)]
    while True:
        nxt, parent = extend(g, levels[-1])
        if not len(nxt):
            return levels, parents
        levels.append(nxt)
        parents.append(parent)


#: the numbers :meth:`Reference.judge` counts, with their limits: exact
LIMITS = {"wrong_keys": 0, "wrong_results": 0, "unexpanded": 0}


class Reference:
    """Judges ``weighted-clique`` responses on one data graph, under each
    request's ``weights``.  ``labels`` are taken and not read."""

    def __init__(self, n: int, edges: np.ndarray,
                 labels: Optional[np.ndarray] = None):
        self.levels, self.parents = clique_levels(Graph(n, edges))
        self._by_weights: Dict[str, WeightedCliques] = {}
        self._top: Dict[tuple, List[List[int]]] = {}

    def cliques(self, weights: np.ndarray) -> WeightedCliques:
        key = hashlib.sha256(np.ascontiguousarray(
            weights, np.int64).tobytes()).hexdigest()
        if key not in self._by_weights:
            self._by_weights[key] = WeightedCliques(self.levels,
                                                    self.parents, weights)
        return self._by_weights[key]

    def judge(self, request: dict, response: dict) -> Dict[str, int]:
        """``wrong_keys`` (1 when the keys differ from the reference's),
        ``wrong_results`` (the places of the reference's list that the
        response's results do not hold, or holds something else at, and
        results past its end) and ``unexpanded`` (how far the response's
        ``expanded`` count falls below the cliques a complete run
        expands)."""
        k = int(request["k"])
        weights = np.asarray(request["weights"], np.int64)
        cliques = self.cliques(weights)
        tkey = (id(cliques), k)
        if tkey not in self._top:
            self._top[tkey] = cliques.top(k)
        want = self._top[tkey]
        want_keys = [int(weights[c].sum()) for c in want] + \
            [NEG] * (k - len(want))
        got = [sorted(int(v) for v in r) for r in response["results"]]
        wrong = sum(i >= len(got) or got[i] != c for i, c in enumerate(want))
        wrong += max(0, len(got) - len(want))
        need = cliques.must_expand(want_keys[-1])
        done = int(response.get("stats", {}).get("expanded", 0))
        return dict(wrong_keys=int([int(x) for x in response["result_keys"]]
                                   != want_keys),
                    wrong_results=wrong, unexpanded=max(0, need - done))
