"""Published peaks of the card and the least time of a kernel's work.

``HBM_BYTES_PER_S`` is NVIDIA's data-sheet rate of the H100 SXM's HBM3
(3.35 TB/s, at the full power limit of 700 W).  ``scoring_bound_s`` is a
frozen copy of ``chip_smoke.py::masked_intersect_bound_ms``: one call's
operands read once and its counts written once, over that rate.  The
operations set no larger figure: NVIDIA publishes no rate for the 1-bit
tensor-core product the kernel runs on.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)


def words(n: int) -> int:
    """32-bit words of an ``n``-bit set."""
    return (int(n) + 31) // 32


def scoring_bytes(b: int, n: int, masked: bool) -> int:
    """Bytes one scoring call must move: ``[b, W]`` rows (and as many
    mask words when ``masked``) and ``[n, W]`` columns read once, the
    ``[b, n]`` int32 counts written once."""
    w = words(n)
    return 4 * (b * w * (2 if masked else 1) + n * w + b * n)


def scoring_bound_s(b: int, n: int, masked: bool) -> float:
    """The least time of one scoring call at the HBM rate."""
    return scoring_bytes(b, n, masked) / HBM_BYTES_PER_S
