"""Plain PyTorch versions of the ported kernels, under the reference's
names (``repro.kernels.ref``): each ``<name>_ref`` has the kernel's
signature and semantics and runs on any device.  The co-workload kernels'
references arrive with their ports (ROADMAP Queue 2).
"""
from __future__ import annotations

import torch

from .masked_intersect import masked_intersect_plain as masked_intersect_ref

__all__ = ["masked_intersect_ref", "frontier_expand_ref"]


def frontier_expand_ref(p_bits: torch.Tensor,
                        ext_bits: torch.Tensor) -> torch.Tensor:
    """counts[b, v] = popcount(p_bits[b] & ext_bits[v]); int32 [B, N]."""
    return masked_intersect_ref(p_bits, ext_bits)
