"""The data graph as the reference holds it: sorted adjacency lists,
degrees and a sorted array of edge keys, built with numpy from the edge
list the benchmark generated."""
from __future__ import annotations

import numpy as np

#: an empty result slot's key: int32's least value, as the program's
NEG = -2 ** 31


class Graph:
    """An undirected graph on ``n`` vertices (loops and repeated pairs in
    ``edges`` are dropped)."""

    def __init__(self, n: int, edges: np.ndarray):
        e = np.asarray(edges, np.int64).reshape(-1, 2)
        e = e[e[:, 0] != e[:, 1]]
        self.n = int(n)
        #: sorted keys ``lo * n + hi`` of the distinct edges
        self.keys = np.unique(np.minimum(e[:, 0], e[:, 1]) * n
                              + np.maximum(e[:, 0], e[:, 1]))
        lo, hi = self.keys // n, self.keys % n
        src = np.concatenate([lo, hi])
        dst = np.concatenate([hi, lo])
        order = np.lexsort((dst, src))
        self.indices = dst[order]
        self.indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(src, minlength=n))]).astype(np.int64)
        self.degrees = np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def has_edges(self, u: np.ndarray, v: np.ndarray) -> np.ndarray:
        """Elementwise: is ``(u[i], v[i])`` an edge?"""
        u = np.asarray(u, np.int64)
        v = np.asarray(v, np.int64)
        key = np.minimum(u, v) * self.n + np.maximum(u, v)
        at = np.searchsorted(self.keys, key)
        hit = at < len(self.keys)
        hit[hit] = self.keys[at[hit]] == key[hit]
        return hit & (u != v)
