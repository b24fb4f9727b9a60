"""Top-k cliques: the reference's answer and its judgement of a response.

The program answers a ``clique`` request with the ``k`` best cliques of
the graph, every clique counted and not only the maximal ones: clique
size descending, and among cliques of one size the canonical order of
its states, whose first words are the clique's vertex bitset (vertex
``v`` is bit ``v % 32`` of word ``v // 32``), compared word by word from
word 0 as signed 32-bit integers.  The answer is one list, so the
reference works out that list and a response has to equal it, key by key
and clique by clique.

The canonical order favours cliques of low vertex ids, which the
program's priority (a seed's candidates: its neighbours above it) also
reaches first, so the answer alone does not show a run that leaves out
part of the search.  The search itself is checked too: each clique is one
node of the program's search tree, whose candidates are the common
neighbours above its last vertex, and whose bound is its size plus their
number.  A bound never grows from a node to its children, and the
program expands every node whose bound reaches its threshold, which never
passes the answer's k-th key.  So a run that completes expands at least
every clique whose bound reaches that key, whatever its order: the
response's ``expanded`` count may not fall below their number.  A run
that drops a batch's rows or the spilled entries expands fewer.

The reference lists every clique by levels with numpy: the vertices, then
each level's cliques extended by the common neighbours above their last
vertex, until a level is empty; then it takes the ``k`` best from the top
level down, and counts the cliques whose bound reaches the k-th key.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import numpy as np

from .graph import NEG, Graph

#: candidate pairs tested at once while a level is extended
CHUNK = 1 << 23


def extend(g: Graph, level: np.ndarray):
    """The cliques one vertex larger than those of ``level`` (``[c, j]``,
    each row ascending): each row with every common neighbour above its
    last vertex, as rows ascending, in the order of ``level``; and for each
    new row, the row of ``level`` it extends."""
    c, j = level.shape
    if c == 0:
        return np.empty((0, j + 1), np.int64), np.empty(0, np.int64)
    last = level[:, -1]
    up_start = _up_start(g)
    counts = (g.indptr[1:] - up_start)[last]
    ends = np.cumsum(counts)
    out, parents = [], []
    lo = 0
    while lo < c:
        done = int(ends[lo - 1]) if lo else 0
        hi = max(int(np.searchsorted(ends, done + CHUNK, side="right")),
                 lo + 1)
        rows = np.repeat(np.arange(lo, hi), counts[lo:hi])
        # the t-th candidate of the chunk is the (t - row's first)-th
        # neighbour above the row's last vertex
        first = np.repeat(ends[lo:hi] - counts[lo:hi] - done, counts[lo:hi])
        cand = g.indices[up_start[last[rows]] + np.arange(len(rows)) - first]
        ok = np.ones(len(rows), bool)
        for i in range(j - 1):
            ok &= g.has_edges(level[rows, i], cand)
        out.append(np.concatenate([level[rows[ok]], cand[ok, None]],
                                  axis=1))
        parents.append(rows[ok])
        lo = hi
    return np.concatenate(out), np.concatenate(parents)


def _up_start(g: Graph) -> np.ndarray:
    """Where each vertex's neighbours above it start in ``g.indices`` (its
    sorted list holds those below it first)."""
    v = np.repeat(np.arange(g.n), g.degrees)
    below = np.bincount(v[g.indices < v], minlength=g.n)
    return g.indptr[:-1] + below


def _words(clique: Sequence[int]) -> Dict[int, int]:
    """The clique's nonzero bitset words, as signed 32-bit values."""
    out: Dict[int, int] = {}
    for v in clique:
        out[v // 32] = out.get(v // 32, 0) | (1 << (v % 32))
    return {i: w - (1 << 32) if w >= 1 << 31 else w for i, w in out.items()}


def _canonical(a: Sequence[int], b: Sequence[int]) -> int:
    """The states' order of two cliques of one size: their bitset words
    compared from word 0 as signed integers (absent words are 0)."""
    wa, wb = _words(a), _words(b)
    for i in sorted(set(wa) | set(wb)):
        x, y = wa.get(i, 0), wb.get(i, 0)
        if x != y:
            return -1 if x < y else 1
    return 0


class Cliques:
    """Every clique of a graph, by size: ``levels[j]`` holds the cliques
    of ``j + 1`` vertices as ascending rows, and ``bounds[j]`` each one's
    bound in the program's search (its size plus its candidates)."""

    def __init__(self, g: Graph):
        self.levels = [np.arange(g.n, dtype=np.int64)[:, None]]
        self.bounds = []
        while len(self.levels[-1]):
            level = self.levels[-1]
            nxt, parent = extend(g, level)
            self.bounds.append(level.shape[1] + np.bincount(
                parent, minlength=len(level)))
            self.levels.append(nxt)
        self.levels.pop()

    def top(self, k: int) -> List[List[int]]:
        """The ``k`` best cliques (fewer where the graph has fewer), each
        as its ascending vertex list, in the program's order."""
        return top(self.levels, k)

    def must_expand(self, key: int) -> int:
        """The cliques whose bound reaches ``key``: those a run whose
        answer's k-th key is ``key`` expands, whatever its order."""
        return int(sum((b >= key).sum() for b in self.bounds))


def top(levels: List[np.ndarray], k: int) -> List[List[int]]:
    """The ``k`` best of the cliques ``levels`` holds by size."""
    best: List[List[int]] = []
    for level in reversed(levels):
        rows = sorted((list(map(int, r)) for r in level),
                      key=functools.cmp_to_key(_canonical))
        best.extend(rows[:k - len(best)])
        if len(best) == k:
            break
    return best


#: the numbers :meth:`Reference.judge` counts, with their limits: exact
LIMITS = {"wrong_keys": 0, "wrong_results": 0, "unexpanded": 0}


class Reference:
    """Judges ``clique`` responses on one data graph.  ``labels`` are taken
    and not read: a clique is the same whatever its vertices' labels."""

    def __init__(self, n: int, edges: np.ndarray,
                 labels: Optional[np.ndarray] = None):
        self.cliques = Cliques(Graph(n, edges))
        self._top: Dict[int, List[List[int]]] = {}

    def top(self, k: int) -> List[List[int]]:
        if k not in self._top:
            self._top[k] = self.cliques.top(k)
        return self._top[k]

    def judge(self, request: dict, response: dict) -> Dict[str, int]:
        """``wrong_keys`` (1 when the keys differ from the reference's),
        ``wrong_results`` (the places of the reference's list that the
        response's results do not hold, or holds something else at, and
        results past its end) and ``unexpanded`` (how far the response's
        ``expanded`` count falls below the cliques a complete run
        expands)."""
        k = int(request["k"])
        want = self.top(k)
        want_keys = [len(c) for c in want] + [NEG] * (k - len(want))
        got = [sorted(int(v) for v in r) for r in response["results"]]
        wrong = sum(i >= len(got) or got[i] != c for i, c in enumerate(want))
        wrong += max(0, len(got) - len(want))
        need = self.cliques.must_expand(want_keys[-1])
        done = int(response.get("stats", {}).get("expanded", 0))
        return dict(wrong_keys=int([int(x) for x in response["result_keys"]]
                                   != want_keys),
                    wrong_results=wrong, unexpanded=max(0, need - done))
