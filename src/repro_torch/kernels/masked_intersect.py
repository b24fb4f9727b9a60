"""Batched masked popcount-intersection over packed bitsets — the one
kernel behind every discovery workload's hot set check::

    counts[r, c] = popcount(a[r] & mask[r] & b[c])        # int32 [B, N]

``a``/``mask`` are ``[B, W]`` and ``b`` is ``[N, W]`` int32 words
(:mod:`repro_torch.core.bitset`); ``mask=None`` means no row mask.  The
call shapes of the workloads are those of ``repro.kernels.masked_intersect``
(clique cross counts, iso membership against ``eye_table`` columns, pattern
pair probes).

On the card, :func:`masked_intersect` launches the hand-written Hopper
kernel ``csrc/masked_intersect.cu``, which replaces the TPU kernel
``repro/kernels/masked_intersect.py::_kernel`` / ``::_kernel_masked``.  At
the main-path shape (B=64, N=32768, W=1024) it does 2.15e9 AND+popcount
word operations on 143 MB of compulsory traffic, so ``__popc`` throughput
bounds it (0.51 ms at 16 popcounts per clock per SM, 132 SMs, 1.98 GHz;
the bytes alone take 0.04 ms).  The design is a simple tile: each block
owns 64 rows x 64 columns, loops over W in 32-word chunks staged in shared
memory, and each thread accumulates a 4 x 4 register tile of ``__popc``
sums; ragged edges are masked in the kernel, not padded.  The source note
has the detail.

On the CPU, :func:`masked_intersect` runs :func:`masked_intersect_plain`,
the plain PyTorch version that the CPU tests use and that the card's smoke
run compares the kernel with.  It does so only because the tensors lie on
the CPU: for a CUDA tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.bitset import popcount
from . import build

# elements of the [rows, N, W] intersection the plain version materializes
# at once (256 MiB of int32 plus the popcount temporaries)
PLAIN_MAX_ELEMENTS = 1 << 26

#: kernel launches so far (the plain version does not count)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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


def _library() -> ctypes.CDLL:
    lib = build.load("masked_intersect")
    if lib.masked_intersect_launch.argtypes is None:
        # without argtypes ctypes passes every int as a C int and cuts the
        # 64-bit pointers
        lib.masked_intersect_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.masked_intersect_launch.restype = ctypes.c_int
        lib.masked_intersect_error_string.argtypes = [ctypes.c_int]
        lib.masked_intersect_error_string.restype = ctypes.c_char_p
    return lib


def masked_intersect(a_bits: torch.Tensor, b_bits: torch.Tensor,
                     mask_bits: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``counts[r, c] = popcount(a[r] & mask[r] & b[c])``; int32 [B, N].

    CUDA tensors go to the Hopper kernel (contiguous, B, N, W >= 1), CPU
    tensors to :func:`masked_intersect_plain`; anything else raises."""
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
    if min(n_rows, n_cols, w) < 1:
        raise ValueError(f"masked_intersect kernel needs B, N, W >= 1, got "
                         f"B={n_rows} N={n_cols} W={w}")
    lib = _library()
    out = torch.empty((n_rows, n_cols), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.masked_intersect_launch(
            a_bits.data_ptr(),
            None if mask_bits is None else mask_bits.data_ptr(),
            b_bits.data_ptr(), out.data_ptr(), n_rows, n_cols, w,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(
            f"masked_intersect launch failed: CUDA error {err} "
            f"({lib.masked_intersect_error_string(err).decode()})")
    launches += 1
    return out
