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
computation on ``cuda``, its plain version on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitset
from .api import NEG, SubgraphComputation, resolve_device
from .graph import GraphStore
from ..kernels import ops as kops


def make_clique_computation(graph: GraphStore,
                            device=None) -> SubgraphComputation:
    """The clique computation on ``device`` (default ``cuda``; raises when
    no CUDA device is present and ``device`` is not given)."""
    device = resolve_device(device)
    n = graph.n
    w = bitset.num_words(n)
    if (n + 1) ** 2 >= 2 ** 31:
        raise ValueError(f"int32 priority keys require N <= 46339, got {n}")
    S = 2 * w + 2

    adj = bitset.to_tensor(graph.adj_bits, device)                # [N, W]
    gt = bitset.to_tensor(bitset.lt_mask_table(n), device)        # [N, W]
    ext_mask = (adj & gt).contiguous()       # N(v) ∩ {u > v}; kernel operand
    del adj, gt

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
        v_bits, p_bits, size, _ = _unpack(states)
        new_v = bitset.set_bit(v_bits, actions)
        new_p = p_bits & ext_mask[actions]
        return _pack(new_v, new_p, size + 1)

    def result_key(states):
        return states[:, 2 * w]          # clique size; always relevant

    def upper_bound(states):
        return states[:, 2 * w] + states[:, 2 * w + 1]

    def describe(state_row) -> list:
        v_bits = torch.as_tensor(np.asarray(state_row[:w], np.int32))
        return sorted(int(i) for i in
                      torch.nonzero(bitset.to_bool(v_bits, n))[:, 0])

    return SubgraphComputation(
        name="clique", state_width=S, num_actions=n,
        init_frontier=init_frontier, score_children=score_children,
        materialize=materialize, result_key=result_key,
        upper_bound=upper_bound, describe=describe, device=device)
