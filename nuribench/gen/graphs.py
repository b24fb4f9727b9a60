"""The data graphs' frozen functions, as edge lists made from a seed.  A
configuration reaches them through its generator file in this folder
(``<generator>.py``, whose ``make(config, seed)`` reads the sizes).

``densifying_edges`` is a frozen copy of
``src/repro_torch/data/synthetic_graphs.py``'s ``densifying_graph`` (the
port's copy of ``repro.data.synthetic_graphs``), the paper's densification
protocol: random distinct edges added in batches to a fixed vertex set.
The original returns a ``GraphStore``; this returns the edge list, and
draws every random number in the same order, so that
``GraphStore.from_edges`` of its output equals the original's graph byte
for byte (``tests/test_nuribench_gen.py`` holds them to each other).  It
takes each batch of candidate edges with numpy instead of a Python loop:
the first occurrence of each new pair, in the order drawn, as the loop
takes them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def densifying_edges(n: int, m: int, seed: int) -> np.ndarray:
    """``m`` distinct undirected edges ``(lo, hi)`` on ``n`` vertices, drawn
    in batches of ``2 * need + 16`` random pairs, as int64 ``[m, 2]``."""
    if not 0 <= m <= n * (n - 1) // 2:
        raise ValueError(f"{m} edges do not fit on {n} vertices")
    rng = np.random.default_rng(seed)
    taken = np.empty(0, np.int64)          # sorted keys lo * n + hi so far
    parts = []
    count = 0
    while count < m:
        need = m - count
        cand = rng.integers(0, n, size=(need * 2 + 16, 2))
        lo = np.minimum(cand[:, 0], cand[:, 1])
        hi = np.maximum(cand[:, 0], cand[:, 1])
        key = lo * n + hi
        rows = np.nonzero(lo != hi)[0]
        _, first = np.unique(key[rows], return_index=True)
        rows = np.sort(rows[first])        # first draw of each pair, in order
        rows = rows[~np.isin(key[rows], taken)][:need]
        parts.append(np.stack([lo[rows], hi[rows]], axis=1))
        taken = np.union1d(taken, key[rows])
        count += len(rows)
    return np.concatenate(parts) if parts else np.empty((0, 2), np.int64)


def densifying_graph(n: int, m: int, seed: int) -> Dict[str, object]:
    """The densification protocol's graph: ``{"n", "edges"}``."""
    return dict(n=n, edges=densifying_edges(n, m, seed))

