"""Recsys embedding lookup, the gather half of an EmbeddingBag::

    out[b, f*D:(f+1)*D] = table[f, ids[b, f]]            # fp32 [B, F*D]

``table`` is ``[F, V, D]`` fp32 or bf16 (one table per sparse field) and
``ids`` ``[B, F]`` int32.  The contract is ids in ``[0, V)``; any other id
is read as the reference's gather reads it (a negative id counts from the
end of the table, then the id is clamped into ``[0, V)``), so no id reads
outside the table.  The multi-hot bag reduction composes with
:mod:`repro_torch.kernels.segment_matmul`.

On the card, :func:`embedding_bag` launches the hand-written Hopper kernel
``csrc/embedding_bag.cu``, which replaces
``repro/kernels/embedding_bag.py::_kernel`` (a scalar-prefetched BlockSpec
row copy): one thread per (bag row, 16-byte chunk) loads its id and copies
its chunk, bound by memory.  The source note has the detail.

On the CPU it runs :func:`embedding_bag_plain`, the plain PyTorch version
that the CPU tests use and that the card's smoke run compares the kernel
with.  It does so only because the tensors lie on the CPU: for a CUDA
tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches so far (the plain version does not count)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# pointers and the stream as c_void_p, sizes and the dtype as C ints, V as
# int64
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def reset_launches() -> None:
    global launches
    launches = 0


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor
                        ) -> torch.Tensor:
    """Plain PyTorch per-field gather, ids read as the reference reads
    them (negative from the end, then clamped into ``[0, V)``)."""
    f, v, _ = table.shape
    b = ids.shape[0]
    rows = torch.where(ids < 0, ids + v, ids).clamp(0, v - 1).long()
    fields = torch.arange(f, device=ids.device)[None, :]
    return table[fields, rows].reshape(b, -1).float()


def _check(table: torch.Tensor, ids: torch.Tensor) -> None:
    if table.dtype not in DTYPES or table.dim() != 3:
        raise TypeError(f"table must be a 3-D [F, V, D] float32 or bfloat16 "
                        f"tensor, got {table.dtype} {tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise TypeError(f"ids must be a 2-D [B, F] int32 tensor, got "
                        f"{ids.dtype} {tuple(ids.shape)}")
    if ids.shape[1] != table.shape[0]:
        raise ValueError(f"ids name {ids.shape[1]} fields, the table holds "
                         f"{table.shape[0]}")
    if ids.device != table.device:
        raise ValueError(f"ids are on {ids.device}, the table on "
                         f"{table.device}")
    if min(table.shape) < 1 or ids.shape[0] < 1:
        raise ValueError(f"embedding_bag needs B, F, V, D >= 1, got "
                         f"B={ids.shape[0]} table {tuple(table.shape)}")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[b, f*D:(f+1)*D] = table[f, ids[b, f]]``; fp32 ``[B, F*D]``.

    CUDA tensors go to the Hopper kernel, CPU tensors to
    :func:`embedding_bag_plain`; anything else raises."""
    global launches
    _check(table, ids)
    device = table.device
    if device.type == "cpu":
        return embedding_bag_plain(table, ids)
    if device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu, not {device}")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag kernel needs contiguous operands")
    f, v, d = table.shape
    b = ids.shape[0]
    out = torch.empty((b, f * d), dtype=torch.float32, device=device)
    build.launch_on(device, "embedding_bag", _ARGTYPES, table.data_ptr(),
                    ids.data_ptr(), out.data_ptr(), b, f, v, d,
                    DTYPES[table.dtype])
    launches += 1
    return out
