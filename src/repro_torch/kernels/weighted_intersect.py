"""Weighted AND-popcount over packed bitsets — the maximum-weight clique
computation's child scoring::

    counts[r, c] = sum of weights[j] over the bits j of a[r] & b[c]
                                                        # int32 [B, N]

``a`` is ``[B, W]`` and ``b`` ``[N, W]`` int32 words
(:mod:`repro_torch.core.bitset`), ``weights`` one positive int32 a bit.
With every weight below ``2^K``, the sum splits by the weights' bit
planes: ``plane_k`` is the bitset of the bits whose weight has bit ``k``
set (:func:`weight_planes`), and

    counts[r, c] = sum_k 2^k popcount(a[r] & plane_k & b[c]),

exact in int32 while the weights sum below ``2^31``.  That is
:func:`repro_torch.kernels.masked_intersect.masked_intersect` over the
``K B`` rows ``a[r] & plane_k`` (plane-major), one launch, then a shift
and a sum over the planes.  At the benchmark's shape (B 64, N = 46,336,
K 8) the kernel's grid runs the column tiles fastest
(``csrc/masked_intersect.cu``), so each of the 8 row tiles streams all of
``b``; whether running a column tile's row tiles side by side would share
its read through L2 is an open question of the kernel's grid order.

On the CPU the same call runs the plain version of ``masked_intersect``,
because the tensors lie there; for a CUDA tensor the kernel launches or
the call raises.  :func:`weighted_intersect_plain` is the sum written out
over unpacked bits, which the CPU tests and the card's smoke run compare
it with.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import bitset
from .masked_intersect import masked_intersect

#: kernel launches so far (a call on the CPU does not count)
launches = 0
#: weighed bits the plain version holds at once (256 MiB of int32)
PLAIN_MAX_ELEMENTS = 1 << 26


def reset_launches() -> None:
    global launches
    launches = 0


def weight_planes(weights: np.ndarray, device) -> torch.Tensor:
    """The bit planes of positive int ``weights`` (one a bit), on
    ``device``: int32 ``[K, W]``, plane ``k`` the bits whose weight has bit
    ``k`` set, ``K`` the bit length of the largest weight."""
    weights = np.asarray(weights, np.int64)
    k = max(1, int(weights.max()).bit_length())
    bits = (weights[None, :] >> np.arange(k)[:, None]) & 1
    return bitset.to_tensor(bitset.from_bool(bits > 0), device)


def _shift_sum(counts: torch.Tensor) -> torch.Tensor:
    """``sum_k counts[k] << k`` over the leading axis, int32."""
    shift = torch.arange(counts.shape[0], dtype=torch.int32,
                         device=counts.device)
    return (counts << shift.view(-1, *([1] * (counts.dim() - 1)))).sum(
        0, dtype=torch.int32)


def weighted_popcount(bits: torch.Tensor, planes: torch.Tensor
                      ) -> torch.Tensor:
    """The weight of each set ``bits[..., W]``: ``sum_k 2^k popcount(bits &
    plane_k)``, int32 ``[...]``."""
    return _shift_sum(torch.stack([bitset.popcount(bits & p)
                                   for p in planes]))


def weighted_intersect_plain(a_bits: torch.Tensor, b_bits: torch.Tensor,
                             weights: torch.Tensor,
                             max_elements: int = PLAIN_MAX_ELEMENTS
                             ) -> torch.Tensor:
    """Plain PyTorch ``counts[r, c]``: the bits of each ``a[r] & b[c]``
    unpacked, each weighed, summed; over chunks of ``b``'s rows that hold
    at most ``max_elements`` weighed bits, a row of ``a`` at a time."""
    n = weights.shape[0]
    a_set = bitset.to_bool(a_bits, n)
    out = torch.empty((a_bits.shape[0], b_bits.shape[0]), dtype=torch.int32,
                      device=a_bits.device)
    chunk = max(1, max_elements // max(1, n))
    for c in range(0, b_bits.shape[0], chunk):
        b_set = bitset.to_bool(b_bits[c:c + chunk], n).to(torch.int32) * \
            weights
        for r in range(a_bits.shape[0]):
            out[r, c:c + chunk] = torch.where(a_set[r], b_set, 0).sum(
                -1, dtype=torch.int32)
    return out


def weighted_intersect(a_bits: torch.Tensor, b_bits: torch.Tensor,
                       planes: torch.Tensor) -> torch.Tensor:
    """``counts[r, c]`` by the weights' bit ``planes`` (:func:`weight_planes`):
    one ``masked_intersect`` call over the ``[K B, W]`` rows ``a & plane_k``,
    then the planes' counts shifted and summed; int32 ``[B, N]``."""
    global launches
    k, (b, w) = planes.shape[0], a_bits.shape
    if planes.shape[1] != w:
        raise ValueError(f"planes of {planes.shape[1]} words for rows of "
                         f"{w}")
    rows = (planes[:, None, :] & a_bits[None, :, :]).reshape(k * b, w)
    counts = masked_intersect(rows, b_bits)
    if rows.device.type == "cuda":
        launches += 1
    return _shift_sum(counts.view(k, b, -1))
