"""Packed-bitset algebra in PyTorch, on ``int32`` words.

Subgraph states are fixed-width bitsets packed 32 bits to a word
(``W = ceil(N / 32)`` words for an N-vertex graph), in the same bit layout
as ``repro.core.bitset``: bit ``i`` of the set is bit ``i % 32`` of word
``i // 32``.  The reference keeps ``uint32`` words and bit-casts to
``int32`` at the engine boundary; here the words are ``int32`` everywhere,
because PyTorch's ``uint32`` lacks ``bitwise_not``, the shifts and
``topk`` on the CPU.  Two consequences shape this module:

* ``>>`` on ``int32`` is an arithmetic shift, so every shift is followed by
  a mask before the shifted-in sign bits can matter;
* bit 31 is the sign bit, so its word value (``-2**31``) comes from a
  ``uint32`` table viewed as ``int32`` rather than from ``1 << 31``.

PyTorch has no popcount op: :func:`popcount` is SWAR arithmetic on
``int32``, exact modulo ``2**32`` like the ``uint32`` original.

The host-side table builders (:func:`from_indices`, :func:`from_bool`,
:func:`lt_mask_table`, :func:`eye_table`) return numpy ``uint32`` arrays
with the reference's bytes; :func:`to_tensor` moves one to a device as
``int32`` words.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

WORD_BITS = 32


@functools.lru_cache(maxsize=None)
def _bit_values(device: torch.device) -> torch.Tensor:
    """Word value of each bit position, bit 31 included, as int32."""
    bits = np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32)
    return torch.from_numpy(bits.view(np.int32)).to(device)


def num_words(n_bits: int) -> int:
    """Number of 32-bit words needed for ``n_bits`` bits."""
    return (int(n_bits) + WORD_BITS - 1) // WORD_BITS


def to_i32(x: np.ndarray) -> np.ndarray:
    """Host-side: view ``uint32`` words as ``int32`` (same bytes)."""
    return np.ascontiguousarray(x, np.uint32).view(np.int32)


def to_u32(x: np.ndarray) -> np.ndarray:
    """Host-side: view ``int32`` words as ``uint32`` (same bytes)."""
    return np.ascontiguousarray(x, np.int32).view(np.uint32)


def to_tensor(x: np.ndarray, device) -> torch.Tensor:
    """Host ``uint32`` (or ``int32``) words -> contiguous ``int32`` tensor on
    ``device``, bit for bit."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)


def zeros(shape_prefix, n_bits: int, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape_prefix) + (num_words(n_bits),),
                       dtype=torch.int32, device=device)


def from_indices(indices, n_bits: int) -> np.ndarray:
    """Host-side: build a packed bitset (numpy) from an index list."""
    w = num_words(n_bits)
    out = np.zeros((w,), np.uint32)
    idx = np.asarray(indices, np.int64)
    if idx.size:
        np.bitwise_or.at(out, idx // WORD_BITS,
                         (np.uint32(1) << (idx % WORD_BITS).astype(np.uint32)))
    return out


def from_bool(mask: np.ndarray) -> np.ndarray:
    """Host-side: pack a boolean vector [..., N] into [..., W] uint32."""
    mask = np.asarray(mask, bool)
    n = mask.shape[-1]
    w = num_words(n)
    pad = w * WORD_BITS - n
    if pad:
        mask = np.concatenate(
            [mask, np.zeros(mask.shape[:-1] + (pad,), bool)], axis=-1)
    bits = mask.reshape(mask.shape[:-1] + (w, WORD_BITS)).astype(np.uint32)
    shifts = (np.uint32(1) << np.arange(WORD_BITS, dtype=np.uint32))
    return (bits * shifts).sum(axis=-1).astype(np.uint32)


def to_bool(bitset: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Unpack [..., W] int32 words into a boolean [..., n_bits] tensor."""
    w = bitset.shape[-1]
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=bitset.device)
    bits = (bitset[..., :, None] >> shifts) & 1
    flat = bits.reshape(bitset.shape[:-1] + (w * WORD_BITS,))
    return flat[..., :n_bits].bool()


def popcount_words(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word (SWAR; every shift masked, so the
    arithmetic shift's sign fill never reaches the result)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333).add_((x >> 2) & 0x33333333)
    x = x.add_(x >> 4).bitwise_and_(0x0F0F0F0F)
    x = x.add_(x >> 8)      # bytes are <= 8 now, so x is non-negative
    x = x.add_(x >> 16)
    return x.bitwise_and_(0x3F)


def popcount(bitset: torch.Tensor, axis=-1) -> torch.Tensor:
    """Total number of set bits along ``axis`` (int32)."""
    return popcount_words(bitset).sum(dim=axis, dtype=torch.int32)


def get_bit(bitset: torch.Tensor, idx) -> torch.Tensor:
    """Test bit ``idx`` (int tensor broadcastable to batch) -> bool."""
    idx = torch.as_tensor(idx, device=bitset.device)
    word = torch.take_along_dim(
        bitset, (idx // WORD_BITS)[..., None].long(), dim=-1)[..., 0]
    return ((word >> (idx % WORD_BITS).int()) & 1).bool()


def set_bit(bitset: torch.Tensor, idx) -> torch.Tensor:
    """Return a copy of ``bitset`` with bit ``idx`` set (batched)."""
    idx = torch.as_tensor(idx, device=bitset.device).long()
    word_idx = idx // WORD_BITS
    bit = _bit_values(bitset.device)[idx % WORD_BITS]
    w = bitset.shape[-1]
    onehot = (torch.arange(w, device=bitset.device) == word_idx[..., None])
    return bitset | torch.where(onehot, bit[..., None], 0)


def lt_mask_table(n: int) -> np.ndarray:
    """Host-side table ``gt[v]`` = bitset of {u : u > v}, shape [n, W].

    Used for canonical (duplicate-free) clique expansion: the candidate set
    of ``s ∪ {v}`` is ``P_s ∩ N(v) ∩ gt[v]``.  Built word by word rather
    than through an ``[n, 32W]`` boolean matrix (4 GiB of temporaries at
    n = 32768); the bytes equal the reference's.
    """
    w = num_words(n)
    lo = WORD_BITS * np.arange(w, dtype=np.int64)[None, :]   # first bit of word
    v = np.arange(n, dtype=np.int64)[:, None]
    full = np.uint64(0xFFFFFFFF)
    cleared = np.clip(v - lo + 1, 0, WORD_BITS).astype(np.uint64)  # bits <= v
    kept = np.clip(n - lo, 0, WORD_BITS).astype(np.uint64)         # bits < n
    above = (full << cleared) & full
    below = (np.uint64(1) << kept) - np.uint64(1)
    return (above & below).astype(np.uint32)


def eye_table(n: int) -> np.ndarray:
    """Host-side identity table ``eye[v]`` = bitset containing only ``v``,
    shape [n, W].

    Used as the column operand of the masked-intersection kernel to turn
    popcounts into membership probes: ``popcount(m & eye[v])`` is bit ``v``
    of ``m`` (docs/KERNELS.md).
    """
    w = num_words(n)
    out = np.zeros((n, w), np.uint32)
    v = np.arange(n)
    out[v, v // WORD_BITS] = np.uint32(1) << (v % WORD_BITS).astype(np.uint32)
    return out


def first_set_bit(bitset: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit, or -1 if empty.  Batched over leading dims."""
    # lowest set bit per word (x & -x, wrapping at -2**31 as uint32 does)
    low = bitset & (~bitset + 1)
    # log2 of an exact power of two via popcount(x - 1)
    bit_in_word = popcount_words(low - 1)
    has = bitset != 0
    word_idx = torch.argmax(has.int(), dim=-1)
    any_set = has.any(dim=-1)
    sel = torch.take_along_dim(bit_in_word, word_idx[..., None],
                               dim=-1)[..., 0]
    return torch.where(any_set, word_idx.int() * WORD_BITS + sel, -1)
