"""Maximum-clique discovery on the engine (paper §3.2 / §4.1, CP bound [7]).

The port of ``repro.core.clique``, with the same state layout
(``S = 2W + 2`` int32 words, W = bitset words):

* ``[0:W)``      — V bitset (clique members),
* ``[W:2W)``     — P bitset (candidate vertices that keep it a clique,
  restricted to ids greater than the last added vertex),
* ``[2W]``       — ``|V|`` (clique size),
* ``[2W+1]``     — ``|P|``.

and the same user functions: ``priority(s) = |V|·(N+1) + |P|``, result key
``|V|``, upper bound ``|V| + |P|``.  Child scoring — ``popcount(P ∩ N(v) ∩
{u > v})`` for the whole ``[B, N]`` grid — goes through
:func:`repro_torch.kernels.ops.frontier_expand`: the Hopper kernel for a
computation on ``cuda``, its plain version on the CPU.  The engine builds a
step's child rows through ``materialize_selected``,
:func:`repro_torch.kernels.ops.clique_children`, the same way: one kernel
writes the ``[M, S]`` block, where gathering, ``materialize`` and zeroing
the invalid rows take some twenty passes over it.

Given vertex ``weights``, the same module builds the maximum-weight
clique computation (``repro.core.weighted_clique``'s, which
:mod:`repro_torch.core.weighted_clique` also writes in the pointwise API):
the same states with ``w(V)`` and ``w(P)`` in place of ``|V|`` and
``|P|``, priority and bound ``w(V) + w(P)``; its children scored by
:func:`repro_torch.kernels.ops.weighted_intersect` (the same kernel over
the weights' bit planes) and built by
:func:`repro_torch.kernels.ops.weighted_clique_children`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitset
from .api import NEG, SubgraphComputation, resolve_device
from .graph import GraphStore
from ..kernels import ops as kops
from ..kernels.clique_children import child_rows, weighted_child_rows
from ..kernels.weighted_intersect import weight_planes, weighted_popcount


def _ext_mask(graph: GraphStore, device) -> torch.Tensor:
    """``N(v) ∩ {u > v}`` for every vertex, int32 ``[N, W]``, contiguous:
    a kernel operand."""
    adj = bitset.to_tensor(graph.adj_bits, device)
    gt = bitset.to_tensor(bitset.lt_mask_table(graph.n), device)
    return (adj & gt).contiguous()


def _describe(n: int, w: int):
    def describe(state_row) -> list:
        v_bits = torch.as_tensor(np.asarray(state_row[:w], np.int32))
        return sorted(int(i) for i in
                      torch.nonzero(bitset.to_bool(v_bits, n))[:, 0])
    return describe


def make_clique_computation(graph: GraphStore, device=None,
                            weights=None) -> SubgraphComputation:
    """The clique computation on ``device`` (default ``cuda``; raises when
    no CUDA device is present and ``device`` is not given); with
    ``weights`` (positive ints, one a vertex, summing below ``2^30``) the
    maximum-weight clique computation."""
    device = resolve_device(device)
    if weights is not None:
        return _weighted(graph, np.asarray(weights, np.int32), device)
    n = graph.n
    w = bitset.num_words(n)
    if (n + 1) ** 2 >= 2 ** 31:
        raise ValueError(f"int32 priority keys require N <= 46339, got {n}")
    S = 2 * w + 2
    ext_mask = _ext_mask(graph, device)

    def _unpack(states):
        v_bits = states[..., :w]
        p_bits = states[..., w:2 * w]
        size = states[..., 2 * w]
        pcount = states[..., 2 * w + 1]
        return v_bits, p_bits, size, pcount

    def _pack(v_bits, p_bits, size):
        pcount = bitset.popcount(p_bits)
        return torch.cat([v_bits, p_bits, size[..., None], pcount[..., None]],
                         dim=-1)

    # ------------------------------------------------------------ callbacks
    def init_frontier():
        # unit cliques {v} with P = N(v) ∩ {u > v}  (canonical seeds)
        v_bits = bitset.to_tensor(bitset.eye_table(n), device)
        size = torch.ones((n,), dtype=torch.int32, device=device)
        states = _pack(v_bits, ext_mask, size)
        pcount = states[:, 2 * w + 1]
        prio = size * (n + 1) + pcount
        ub = size + pcount
        return states, prio, ub

    def score_children(states):
        _, p_bits, size, _ = _unpack(states)
        p_bits = p_bits.contiguous()
        counts = kops.frontier_expand(p_bits, ext_mask)        # [B, N]
        in_p = bitset.to_bool(p_bits, n)                       # expandable
        child_prio = torch.where(in_p, (size[:, None] + 1) * (n + 1) + counts,
                                 NEG)
        child_ub = torch.where(in_p, size[:, None] + 1 + counts, NEG)
        return child_prio, child_ub

    def materialize(states, actions):
        return child_rows(states, actions, ext_mask)

    def materialize_selected(states_b, parent, action, valid):
        return kops.clique_children(states_b, parent, action, valid,
                                    ext_mask)

    def result_key(states):
        return states[:, 2 * w]          # clique size; always relevant

    def upper_bound(states):
        return states[:, 2 * w] + states[:, 2 * w + 1]

    return SubgraphComputation(
        name="clique", state_width=S, num_actions=n,
        init_frontier=init_frontier, score_children=score_children,
        materialize=materialize, result_key=result_key,
        upper_bound=upper_bound, describe=_describe(n, w), device=device,
        materialize_selected=materialize_selected)


def _weighted(graph: GraphStore, weights: np.ndarray,
              device: torch.device) -> SubgraphComputation:
    """The maximum-weight clique computation, fused: states ``[V, P, w(V),
    w(P)]``; a child of vertex ``a`` (a bit of P) has priority and bound
    ``w(V) + w(a) + w(P ∩ ext[a])``."""
    if weights.shape != (graph.n,) or not (weights > 0).all() or \
            int(weights.astype(np.int64).sum()) >= 2 ** 30:
        raise ValueError("weights must be one positive int a vertex, "
                         "summing below 2^30 (int32 priority keys)")
    n = graph.n
    w = bitset.num_words(n)
    S = 2 * w + 2
    ext_mask = _ext_mask(graph, device)
    wts = torch.from_numpy(weights).to(device)
    planes = weight_planes(weights, device)                      # [K, W]

    def init_frontier():
        # unit cliques {v} with P = N(v) ∩ {u > v}  (canonical seeds)
        v_bits = bitset.to_tensor(bitset.eye_table(n), device)
        wp = weighted_popcount(ext_mask, planes)
        states = torch.cat([v_bits, ext_mask, wts[:, None], wp[:, None]],
                           dim=-1)
        return states, wts + wp, wts + wp

    def score_children(states):
        p_bits = states[:, w:2 * w].contiguous()
        wsum = kops.weighted_intersect(p_bits, ext_mask, planes)   # [B, N]
        in_p = bitset.to_bool(p_bits, n)                          # expandable
        child = torch.where(in_p, states[:, 2 * w, None] + wts + wsum, NEG)
        return child, child         # the bound is the priority

    def materialize(states, actions):
        return weighted_child_rows(states, actions, ext_mask, wts, planes)

    def materialize_selected(states_b, parent, action, valid):
        return kops.weighted_clique_children(states_b, parent, action, valid,
                                             ext_mask, wts)

    def result_key(states):
        return states[:, 2 * w]          # w(V); always relevant

    def upper_bound(states):
        return states[:, 2 * w] + states[:, 2 * w + 1]

    return SubgraphComputation(
        name="weighted-clique", state_width=S, num_actions=n,
        init_frontier=init_frontier, score_children=score_children,
        materialize=materialize, result_key=result_key,
        upper_bound=upper_bound, describe=_describe(n, w), device=device,
        materialize_selected=materialize_selected)
