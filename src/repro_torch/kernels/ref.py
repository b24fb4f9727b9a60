"""Plain PyTorch versions of the ported kernels, under the reference's
names (``repro.kernels.ref``): each ``<name>_ref`` has the kernel's
signature and semantics and runs on any device.  Each lives beside its
kernel, in the kernel's module; this module only names them.
"""
from __future__ import annotations

import torch

from .embedding_bag import embedding_bag_plain as embedding_bag_ref
from .flash_attention import flash_attention_plain as flash_attention_ref
from .masked_intersect import masked_intersect_plain as masked_intersect_ref
from .segment_matmul import segment_matmul_plain as segment_matmul_ref

__all__ = ["masked_intersect_ref", "frontier_expand_ref",
           "segment_matmul_ref", "embedding_bag_ref", "flash_attention_ref"]


def frontier_expand_ref(p_bits: torch.Tensor,
                        ext_bits: torch.Tensor) -> torch.Tensor:
    """counts[b, v] = popcount(p_bits[b] & ext_bits[v]); int32 [B, N]."""
    return masked_intersect_ref(p_bits, ext_bits)
