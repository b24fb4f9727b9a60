"""Aggregate computational model — paper Algorithm 2 (top-k pattern mining),
the port of ``repro.core.aggregate``.

Groups subgraphs by their grouping key (the pattern's minimal DFS code),
keeps a priority queue of *groups*, and applies the paper's user functions
at group granularity:

* ``key(s)``        — the minimal DFS code (pattern-oriented expansion),
* ``relevant(S)``   — pattern has exactly ``M`` edges,
* ``priority(S)``   — lexicographic ``(m(S), f(S))`` (edge count, support):
  larger patterns first, then more frequent ones (paper §3.3),
* ``dominated(S,S')`` — ``f(S) < f(S')`` — sound because minimum
  image-based support is anti-monotone [5].

This module is the reference's host code, copied: the heap of groups (with
its ``itertools.count()`` tiebreak), the budget stop and the pruning.  It
passes ``use_pallas`` and ``device`` to every
:func:`~repro_torch.core.patterns.expand_group`, whose edge probes run on
the device (``cuda`` unless the caller names another).

Also implements the paper's comparison baseline
(:func:`arabesque_style_mining`): level-synchronous edge-oriented expansion
with an a-priori support threshold ``T`` — the Abq-µ / Abq-µ/3 runs of
Figures 12-14 — which cannot prioritize and must finish every level.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from .api import resolve_device
from .graph import GraphStore
from .labels import LABEL_FILTERS, LabelPredicate
from .patterns import (Code, PatternGroup, _check_interpret, expand_group,
                       seed_groups)


@dataclasses.dataclass
class MiningResult:
    patterns: List[Tuple[Code, int]]      # [(code, support)] best-first
    candidates: int                       # embeddings materialized (metric 1)
    groups_expanded: int
    groups_pruned: int
    completed: bool = True


class TopKPatternMiner:
    """Steppable form of Algorithm 2: :meth:`step` pops and processes one
    group from the priority heap.

    :func:`topk_frequent_patterns` is the run-to-completion loop; a
    scheduler can interleave `step` calls of many queries instead — both
    drive this single implementation, so the prioritize/prune semantics
    cannot diverge between them.

    ``device`` is where the edge probes run (default ``cuda``; raises when
    no CUDA device is present and ``device`` is not given); ``interpret``
    is accepted for the reference's signature and must be None.
    """

    def __init__(self, g: GraphStore, m_edges: int, k: int = 1,
                 max_candidates: int = 50_000_000,
                 use_pallas: bool = False,
                 interpret: Optional[bool] = None,
                 predicate: Optional[LabelPredicate] = None,
                 label_filter: str = "pushdown",
                 device=None):
        assert label_filter in LABEL_FILTERS, label_filter
        _check_interpret(interpret)
        self.g = g
        self.m_edges = m_edges
        self.k = k
        self.max_candidates = max_candidates
        # kernel-path knob for embedding extension (byte-identical
        # results) and the probes' device — forwarded to every
        # expand_group call
        self.use_pallas = use_pallas
        self.device = resolve_device(device)
        # label-constrained mining (DESIGN.md §12): the predicate filters
        # seeds here and rides every expand_group call; label_filter picks
        # pushdown (filter before materialization) vs post (the host-side
        # baseline) — identical patterns/supports, different candidates
        self.predicate = predicate
        self.label_filter = label_filter
        groups = seed_groups(g, predicate=predicate)
        self.candidates = sum(len(gr.embeddings) for gr in groups.values())
        self._counter = itertools.count()
        self._pq: List[tuple] = []
        for code, gr in groups.items():
            sup = gr.support()
            # max-heap via negated lexicographic (m, f)
            heapq.heappush(self._pq,
                           ((-len(code), -sup), next(self._counter), gr, sup))
        self._results: List[Tuple[int, Code]] = []  # (support, code), sorted
        self.steps = 0
        self.expanded = 0
        self.pruned = 0
        self.completed = True     # False once the candidate budget is hit
        self.done = not self._pq

    def _kth_support(self) -> Optional[int]:
        return (self._results[self.k - 1][0]
                if len(self._results) >= self.k else None)

    def step(self) -> None:
        if self.done:
            return
        self.steps += 1
        _, _, gr, sup = heapq.heappop(self._pq)
        thr = self._kth_support()
        # relevant(S): pattern of exactly M edges → result candidate
        if gr.num_edges == self.m_edges:
            if thr is None or sup >= thr:
                self._results.append((sup, gr.code))
                self._results.sort(key=lambda t: (-t[0], t[1]))
                del self._results[self.k:]
        # dominated(S, kth): anti-monotone support bound
        elif thr is not None and sup < thr:
            self.pruned += 1
        else:
            children, created = expand_group(
                self.g, gr, use_pallas=self.use_pallas,
                predicate=self.predicate, label_filter=self.label_filter,
                device=self.device)
            self.candidates += created
            self.expanded += 1
            if self.candidates > self.max_candidates:
                self.completed = False
                self.done = True
                return
            thr = self._kth_support()
            for code, child in children.items():
                csup = child.support()
                if thr is not None and csup < thr:    # line 26 pruning
                    self.pruned += 1
                    continue
                heapq.heappush(self._pq, ((-len(code), -csup),
                                          next(self._counter), child, csup))
        if not self._pq:
            self.done = True

    def result(self) -> MiningResult:
        return MiningResult([(s, c) for s, c in self._results],
                            self.candidates, self.expanded, self.pruned,
                            completed=self.completed)


def topk_frequent_patterns(g: GraphStore, m_edges: int, k: int = 1,
                           max_candidates: int = 50_000_000,
                           use_pallas: bool = False,
                           interpret: Optional[bool] = None,
                           predicate: Optional[LabelPredicate] = None,
                           label_filter: str = "pushdown",
                           device=None) -> MiningResult:
    """Nuri: prioritized + pruned top-k mining of M-edge patterns (Alg. 2),
    with the edge probes on ``device`` (default ``cuda``)."""
    miner = TopKPatternMiner(g, m_edges, k, max_candidates,
                             use_pallas=use_pallas, interpret=interpret,
                             predicate=predicate, label_filter=label_filter,
                             device=device)
    while not miner.done:
        miner.step()
    return miner.result()


def arabesque_style_mining(g: GraphStore, m_edges: int, threshold: int,
                           max_candidates: int = 50_000_000,
                           use_pallas: bool = False,
                           interpret: Optional[bool] = None,
                           device=None) -> MiningResult:
    """Arabesque-style baseline: level-synchronous frequent-pattern mining
    with a user-supplied threshold ``T`` (paper §6.3).

    All patterns of size m are expanded before any of size m+1 (no
    prioritization); the only pruning is the a-priori ``support >= T``
    filter.  Top-k is selected a posteriori among the M-edge patterns.
    The edge probes run on ``device`` (default ``cuda``).
    """
    _check_interpret(interpret)
    device = resolve_device(device)
    groups = seed_groups(g)
    candidates = sum(len(gr.embeddings) for gr in groups.values())
    expanded = pruned = 0
    level = {c: gr for c, gr in groups.items()
             if gr.support() >= threshold}
    finals: List[Tuple[int, Code]] = []
    for _ in range(m_edges - 1):
        nxt: Dict[Code, PatternGroup] = {}
        for gr in level.values():
            children, created = expand_group(g, gr, use_pallas=use_pallas,
                                             device=device)
            candidates += created
            expanded += 1
            if candidates > max_candidates:
                return MiningResult(finals, candidates, expanded, pruned,
                                    completed=False)
            for code, child in children.items():
                if child.support() >= threshold:
                    if code not in nxt:
                        nxt[code] = child
                else:
                    pruned += 1
        level = nxt
    finals = sorted(((gr.support(), c) for c, gr in level.items()),
                    key=lambda t: (-t[0], t[1]))
    return MiningResult(finals, candidates, expanded, pruned)


def max_support_of_size(g: GraphStore, m_edges: int, device=None) -> int:
    """µ — the maximum support over M-edge patterns (used to position the
    baseline's threshold at µ and µ/3 as in Figures 12-14)."""
    res = topk_frequent_patterns(g, m_edges, k=1, device=device)
    return res.patterns[0][0] if res.patterns else 0
