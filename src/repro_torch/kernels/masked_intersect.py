"""Batched masked popcount-intersection over packed bitsets — the one
kernel behind every discovery workload's hot set check::

    counts[r, c] = popcount(a[r] & mask[r] & b[c])        # int32 [B, N]

``a``/``mask`` are ``[B, W]`` and ``b`` is ``[N, W]`` int32 words
(:mod:`repro_torch.core.bitset`); ``mask=None`` means no row mask.  The
call shapes of the workloads are those of ``repro.kernels.masked_intersect``
(clique cross counts, iso membership against ``eye_table`` columns, pattern
pair probes).

On the card, :func:`masked_intersect` launches one of three hand-written
Hopper kernels in ``csrc/masked_intersect.cu``, which together replace the
TPU kernel ``repro/kernels/masked_intersect.py::_kernel`` /
``::_kernel_masked``.  :func:`_plan` picks one per call from its shape and
its pointers, here in Python, so that the CPU tests pin the choice:

- the **mma** kernel for calls wider than :data:`ROWS_MAX_COLS` columns
  (clique and iso: B=64, N=32768, W=1024).  The count is a product of 0/1
  vectors over the K = 32 W bits, which Hopper's ``wgmma`` computes
  exactly in its 1-bit form (``m64n64k256.s32.b1.b1.and.popc``: a
  popcount of the AND over 256 bits a step, summed in int32) from the
  packed words as they are.  At the clique shape its 143 MB bound it:
  0.0426 ms at 3.35 TB/s.  The 2 B N K = 1.374e11 operations would take
  0.0694 ms at the H100's 1,979 TOP/s of dense int8 (the narrowest type
  NVIDIA gives a rate for), but the 1-bit form runs about 8x faster.
  b's columns are the A operand, each thread's fragment read from shared
  memory as words; (a & mask)'s 64 rows the B operand, ANDed once a
  block by a producer warpgroup while two consumer warpgroups multiply.
  Raw words stream in by ``cp.async`` (16 bytes a copy where
  ``vector``), and a block owns 64 rows by :data:`MMA_COLS` columns.
- the **tile**, the first port's 64 x 64 tile of ``__popc`` sums on the
  CUDA cores (bound there by the popcount rate: 0.51 ms at the clique
  shape), only for ``plan=TILE`` (the smoke run's yardstick).
- the **row-streaming** kernel for at most :data:`ROWS_MAX_COLS` columns
  (the pattern probe: Ep <= 1,024 rows, one column, W words, masked).
  That call is bound by bytes (8.4 MB at W=1024), and a 64-column tile
  would use Ep / 64 SMs and leave 63 of its 64 columns empty.  Here
  ``lanes`` threads of a warp stream one row, 16 bytes a load where W and
  the pointers allow it (``vector``), one word a load otherwise, over a
  one-dimensional grid of rows that fills the card; each lane keeps one
  sum per column (``cols`` of them a pass) and the row's lanes reduce them
  by shuffles.

Ragged edges are masked in the kernels, not padded.  The source note has
the detail.

On the CPU, :func:`masked_intersect` runs :func:`masked_intersect_plain`,
the plain PyTorch version that the CPU tests use and that the card's smoke
run compares the kernels with.  It does so only because the tensors lie on
the CPU: for a CUDA tensor the wrapper launches a kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..core.bitset import popcount
from . import build

# elements of the [rows, N, W] intersection the plain version materializes
# at once (256 MiB of int32 plus the popcount temporaries)
PLAIN_MAX_ELEMENTS = 1 << 26

#: kernel launches so far (the plain version does not count), and of them
#: those of each kernel (:class:`Plan`'s ``variant``)
launches = 0
launches_by_variant = {"mma": 0, "tile": 0, "rows": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_variant.update(mma=0, tile=0, rows=0)


def masked_intersect_plain(a_bits: torch.Tensor, b_bits: torch.Tensor,
                           mask_bits: Optional[torch.Tensor] = None,
                           max_elements: int = PLAIN_MAX_ELEMENTS
                           ) -> torch.Tensor:
    """Plain PyTorch ``counts[r, c] = popcount(a[r] & mask[r] & b[c])``.

    Works in row chunks so that the ``[chunk, N, W]`` intersection stays
    under ``max_elements`` (the unchunked form would need 8.6 GB at the
    main-path shape)."""
    rows = a_bits if mask_bits is None else a_bits & mask_bits
    n_rows, w = rows.shape
    n_cols = b_bits.shape[0]
    out = torch.empty((n_rows, n_cols), dtype=torch.int32,
                      device=rows.device)
    chunk = max(1, max_elements // max(1, n_cols * w))
    for s in range(0, n_rows, chunk):
        inter = rows[s:s + chunk, None, :] & b_bits[None, :, :]
        out[s:s + chunk] = popcount(inter, axis=-1)
    return out


def _check(a_bits, b_bits, mask_bits) -> None:
    operands = [("a_bits", a_bits), ("b_bits", b_bits)]
    if mask_bits is not None:
        operands.append(("mask_bits", mask_bits))
    for name, t in operands:
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{name} must be a 2-D int32 tensor of packed "
                            f"words, got {t.dtype} {tuple(t.shape)}")
        if t.device != a_bits.device:
            raise ValueError(f"{name} is on {t.device}, a_bits on "
                             f"{a_bits.device}")
    if a_bits.shape[1] != b_bits.shape[1]:
        raise ValueError(f"word-width mismatch: rows W={a_bits.shape[1]}, "
                         f"columns W={b_bits.shape[1]}")
    if mask_bits is not None and mask_bits.shape != a_bits.shape:
        raise ValueError(f"mask shape {tuple(mask_bits.shape)} != rows "
                         f"shape {tuple(a_bits.shape)}")


#: the most columns a call may have to take the row-streaming kernel: the
#: largest N at which it beat the mma kernel in chip_smoke.py's phase 2
#: sweep (N = 1 to 64 at 1,024 rows x 1,024 words, masked; PERF.md)
ROWS_MAX_COLS = 32
#: the most column sums a lane of the row kernel keeps in registers (its
#: templates: powers of two up to this), and the most threads on one row
ROW_MAX_SUMS = 32
ROW_MAX_LANES = 32          # a warp
#: columns of b a block of the mma kernel owns (two consumer warpgroups
#: of two tiles of 64), the only value its C entry takes
MMA_COLS = 256


class Plan(NamedTuple):
    """Which kernel a call launches, and how."""
    variant: str        # "mma", "tile" or "rows"
    lanes: int          # rows: threads a row; 0 otherwise
    vector: bool        # rows, mma: 16-byte loads (else one word a load)
    cols: int           # rows: column sums a lane keeps a pass; mma:
                        # columns a block; 0 for the tile


TILE = Plan("tile", 0, False, 0)


def _next_pow2(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def rows_plan(n_cols: int, w: int, aligned: bool) -> Plan:
    """The row-streaming kernel for ``n_cols`` columns of ``w`` words:
    16-byte loads when ``w % 4 == 0`` and every operand's base pointer is
    16-byte aligned (``aligned``); as many lanes a row as there are loads
    in it, a power of two up to a warp; as many column sums a lane as
    there are columns, a power of two up to 32 (more columns take more
    passes)."""
    vector = aligned and w % 4 == 0
    loads = w // 4 if vector else w
    return Plan("rows", min(ROW_MAX_LANES, _next_pow2(loads)), vector,
                min(ROW_MAX_SUMS, _next_pow2(n_cols)))


def mma_plan(w: int, aligned: bool) -> Plan:
    """The mma kernel for rows of ``w`` words: 16-byte copies when ``w %
    4 == 0`` and every operand's base pointer is 16-byte aligned
    (``aligned``), one word a copy otherwise."""
    return Plan("mma", 0, aligned and w % 4 == 0, MMA_COLS)


def _plan(n_cols: int, w: int, aligned: bool) -> Plan:
    """The kernel for a call of ``n_cols`` columns of ``w`` words: the row
    kernel up to :data:`ROWS_MAX_COLS` columns, the mma kernel above."""
    if n_cols <= ROWS_MAX_COLS:
        return rows_plan(n_cols, w, aligned)
    return mma_plan(w, aligned)


def _aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor's data starts on a 16-byte boundary."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# pointers and the stream as c_void_p; shapes and the plan (variant,
# lanes, vector, cols) as C ints
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)
_VARIANTS = {"tile": 0, "rows": 1, "mma": 2}


def masked_intersect(a_bits: torch.Tensor, b_bits: torch.Tensor,
                     mask_bits: Optional[torch.Tensor] = None,
                     plan: Optional[Plan] = None) -> torch.Tensor:
    """``counts[r, c] = popcount(a[r] & mask[r] & b[c])``; int32 [B, N].

    CUDA tensors go to a Hopper kernel (contiguous, 1 <= B, N, W < 2^31),
    the one :func:`_plan` picks unless ``plan`` names another (the smoke
    run times the kernels at one shape so); CPU tensors go to
    :func:`masked_intersect_plain`; anything else raises."""
    global launches
    _check(a_bits, b_bits, mask_bits)
    device = a_bits.device
    if device.type == "cpu":
        return masked_intersect_plain(a_bits, b_bits, mask_bits)
    if device.type != "cuda":
        raise ValueError(f"masked_intersect runs on cuda or cpu, not "
                         f"{device}")
    operands = (a_bits, b_bits) if mask_bits is None else \
        (a_bits, b_bits, mask_bits)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("masked_intersect kernel needs contiguous operands")
    (n_rows, w), n_cols = a_bits.shape, b_bits.shape[0]
    if min(n_rows, n_cols, w) < 1 or max(n_rows, n_cols, w) >= 2 ** 31:
        raise ValueError(f"masked_intersect kernel needs 1 <= B, N, W < "
                         f"2^31, got B={n_rows} N={n_cols} W={w}")
    if plan is None:
        plan = _plan(n_cols, w, _aligned(*operands))
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=device)
    build.launch_on(
        device, "masked_intersect", _ARGTYPES, a_bits.data_ptr(),
        None if mask_bits is None else mask_bits.data_ptr(),
        b_bits.data_ptr(), out.data_ptr(), n_rows, n_cols, w,
        _VARIANTS[plan.variant], plan.lanes, int(plan.vector), plan.cols)
    launches += 1
    launches_by_variant[plan.variant] += 1
    return out
