"""The least time of the maximum-weight clique's two kernels' work in one
engine step, at the card's HBM rate (``roofline.HBM_BYTES_PER_S``, 3.35
TB/s): what ``metrics/kernel.wscoring_roofline.py`` and
``metrics/kernel.wchildren_roofline.py`` divide by the kernels' device
time.

- Scoring: for each of the ``b`` parents and ``n`` vertices the weight of
  ``P_b & ext[v]``: the ``[b, W]`` rows and ``[n, W]`` columns read once,
  the ``n`` int32 weights read once, the ``[b, n]`` int32 sums written
  once.  The program computes it over the weights' bit planes (8 planes at
  weights below 256), which this count does not charge: it is the work,
  not the way.
- Child rows: the ``[m, S]`` int32 block (``S = 2W + 2``) written once and
  its ``m`` valid flags read, and for each valid row (a child) its vertex's
  ``W``-word ext row and its two int64 indices read; the parents are the
  step's ``[b, S]`` batch, read from L2, and not charged.
"""
from __future__ import annotations

from nuribench.roofline import HBM_BYTES_PER_S, words


def wscoring_bytes(b: int, n: int) -> int:
    w = words(n)
    return 4 * (b * w + n * w + b * n) + 4 * n


def wscoring_bound_s(b: int, n: int) -> float:
    """The least time of one step's weighted scoring."""
    return wscoring_bytes(b, n) / HBM_BYTES_PER_S


def wchildren_bound_s(steps: int, m: int, n: int, children: int) -> float:
    """The least time of ``steps`` launches of ``m`` rows that hold
    ``children`` valid rows in all."""
    w = words(n)
    return (steps * (4 * m * (2 * w + 2) + m)
            + children * (4 * w + 16)) / HBM_BYTES_PER_S
