"""Public entry points of the ported kernels (``repro.kernels.ops``).

Each picks its path from the device of its tensors: CUDA tensors launch
the Hopper kernel (or raise), CPU tensors run the plain PyTorch version.
There is no mode switch.
"""
from __future__ import annotations

from .frontier_expand import frontier_expand
from .masked_intersect import masked_intersect

__all__ = ["masked_intersect", "frontier_expand"]
