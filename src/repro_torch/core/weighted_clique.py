"""Maximum-WEIGHT clique discovery; the port of
``repro.core.weighted_clique``, in two forms with the same numbers:

* the served one, fused over the batch as :mod:`repro_torch.core.clique`
  is, and built there (``make_clique_computation(..., weights=...)``): the
  children scored by the weighted AND-popcount on the card's 1-bit kernel
  and built by one launch of the weighted child rows;
* the pointwise one (:func:`make_pointwise_weighted_clique_computation`),
  written against the paper's succinct per-subgraph API
  (:func:`repro_torch.core.api.from_pointwise`), the Python analog of the
  paper's Listing 1, as the reference writes it:
  the plain path the CPU tests hold the fused one to.  It demonstrates the
  Table-1 generality claim: a new top-k computation is four scalar
  functions (expandable / priority / relevant+result / dominated); the
  engine, batching, pruning, and VPQ come for free.  It has no kernel and
  cannot serve a large graph (every score is a weighted sum over N bits).

State layout (``S = 2W + 2``): V bitset, P bitset, weight(V), weight(P) —
the dominance bound ``w(V) + w(P)`` generalizes the CP cardinality bound.
Weights are positive integers.  Words, weights and keys are ``int32``, as
in the reference's states.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from . import bitset, clique
from .api import chunk_size, from_pointwise, resolve_device
from .graph import GraphStore


def make_weighted_clique_computation(graph: GraphStore, weights: np.ndarray,
                                     device=None):
    """The weighted-clique computation on ``device`` (default ``cuda``;
    raises when no CUDA device is present and ``device`` is not given),
    fused as clique's is."""
    return clique.make_clique_computation(graph, device=device,
                                          weights=weights)


def make_pointwise_weighted_clique_computation(graph: GraphStore,
                                               weights: np.ndarray,
                                               device=None):
    """The same computation in the pointwise API, the plain form the fused
    one is held to."""
    device = resolve_device(device)
    n = graph.n
    w = bitset.num_words(n)
    weights = np.asarray(weights, np.int32)
    assert (weights > 0).all()
    total = int(weights.sum())
    assert total < 2 ** 30, "int32 priority keys"
    S = 2 * w + 2

    adj = bitset.to_tensor(graph.adj_bits, device)
    gt = bitset.to_tensor(bitset.lt_mask_table(n), device)
    ext_mask = adj & gt
    del adj, gt
    wts = torch.from_numpy(weights).to(device)
    word_ids = torch.arange(w, device=device)
    one = torch.ones((), dtype=torch.int32, device=device)

    def _set_weight(bits):
        return torch.where(bitset.to_bool(bits, n), wts, 0).sum(
            dtype=torch.int32)

    def _has(bits, a):
        return ((bits[a // bitset.WORD_BITS] >> (a % bitset.WORD_BITS))
                & 1) > 0

    def _with(bits, a):
        return bits | torch.where(word_ids == a // bitset.WORD_BITS,
                                  one << (a % bitset.WORD_BITS).int(), 0)

    def init_frontier():
        v_bits = bitset.to_tensor(bitset.eye_table(n), device)
        p_bits = ext_mask
        wv = wts
        wp = vmap(_set_weight, chunk_size=chunk_size(
            n, bitset.WORD_BITS * w))(p_bits)
        states = torch.cat([v_bits, p_bits, wv[:, None], wp[:, None]],
                           dim=-1)
        return states, wv + wp, wv + wp

    # ----- the paper's five user functions, scalar over one state --------
    def _unpack(s):
        return s[:w], s[w:2 * w], s[2 * w], s[2 * w + 1]

    def expandable(s, a):
        _, p, _, _ = _unpack(s)
        return _has(p, a)

    def child_priority(s, a):
        _, p, wv, _ = _unpack(s)
        new_p = p & ext_mask[a]
        return wv + wts[a] + _set_weight(new_p)

    def child_ub(s, a):          # same space: weight is the result metric
        return child_priority(s, a)

    def materialize_one(s, a):
        v, p, wv, _ = _unpack(s)
        new_p = p & ext_mask[a]
        return torch.cat([_with(v, a), new_p, (wv + wts[a])[None],
                          _set_weight(new_p)[None]])

    def relevant(s):
        return torch.ones((), dtype=torch.bool, device=s.device)

    def result_key_one(s):
        return s[2 * w]          # w(V)

    def upper_bound_one(s):
        return s[2 * w] + s[2 * w + 1]   # w(V) + w(P): dominated() bound

    def describe(row):
        v_bits = torch.as_tensor(np.asarray(row[:w], np.int32))
        return sorted(int(i) for i in
                      torch.nonzero(bitset.to_bool(v_bits, n))[:, 0])

    return from_pointwise(
        name="weighted-clique", state_width=S, num_actions=n,
        init_frontier=init_frontier, expandable=expandable,
        child_priority=child_priority, child_ub=child_ub,
        materialize_one=materialize_one, relevant=relevant,
        result_key_one=result_key_one, upper_bound_one=upper_bound_one,
        describe=describe, device=device)


def brute_force_max_weight_clique(graph: GraphStore, weights: np.ndarray):
    neigh = [set(map(int, graph.neighbors(v))) for v in range(graph.n)]
    best = [0, []]

    def rec(cur, cand, wsum):
        if wsum > best[0]:
            best[0], best[1] = wsum, list(cur)
        if wsum + sum(weights[u] for u in cand) <= best[0]:
            return
        for v in sorted(cand):
            rec(cur + [v], {u for u in cand if u > v and u in neigh[v]},
                wsum + int(weights[v]))

    rec([], set(range(graph.n)), 0)
    return best[0], sorted(best[1])
