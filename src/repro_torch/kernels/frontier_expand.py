"""Batched clique-frontier expansion (the paper's hot loop, DESIGN.md §2.1).

For B dequeued cliques with candidate bitsets ``P [B, W]`` and the
per-vertex extension masks ``ext = N(v) ∩ {u > v}`` packed as ``[N, W]``
(int32 words), computes ``counts[b, v] = popcount(P[b] & ext[v])`` — the
|P| of every possible child clique.  It is the mask-free call of
:mod:`repro_torch.kernels.masked_intersect`, kept as a named entry point
because it *is* the paper's clique kernel.
"""
from __future__ import annotations

import torch

from .masked_intersect import masked_intersect

__all__ = ["frontier_expand"]


def frontier_expand(p_bits: torch.Tensor,
                    ext_bits: torch.Tensor) -> torch.Tensor:
    """counts[b, v] = popcount(p_bits[b] & ext_bits[v]); int32 [B, N]."""
    return masked_intersect(p_bits, ext_bits, None)
