"""Public entry points of the ported kernels (``repro.kernels.ops``), with
the reference's signatures less its Pallas tiling knobs (``block_*``,
``interpret``).

Each picks its path from the device of its tensors: CUDA tensors launch
the Hopper kernel (or raise), CPU tensors run the plain PyTorch version.
There is no mode switch.
"""
from __future__ import annotations

from .clique_children import clique_children, weighted_clique_children
from .embedding_bag import embedding_bag
from .flash_attention import flash_attention
from .frontier_expand import frontier_expand
from .masked_intersect import masked_intersect
from .segment_matmul import segment_matmul
from .weighted_intersect import weighted_intersect

__all__ = ["masked_intersect", "frontier_expand", "segment_matmul",
           "embedding_bag", "flash_attention", "clique_children",
           "weighted_clique_children", "weighted_intersect"]
