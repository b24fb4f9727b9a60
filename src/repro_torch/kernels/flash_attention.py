"""Softmax attention with an online softmax (the LM training and prefill
hot spot)::

    out[h] = softmax(q[h] @ k[h].T / sqrt(D) [causal]) @ v[h]  # fp32 [H,S,D]

``q``, ``k``, ``v`` are ``[H, S, D]`` fp32 or bf16 (batch and grouped
key/value heads folded into ``H`` by the caller, as in the reference).

On the card, :func:`flash_attention` launches the hand-written Hopper
kernel ``csrc/flash_attention.cu``, which replaces
``repro/kernels/flash_attention.py::_kernel``: one block per (head, q-tile)
walks the k/v tiles with the running max and denominator in registers,
skips the tiles above the diagonal under ``causal``, and never writes the
``[S, S]`` scores to device memory.  Its bound is operations: at the
Llama-3-8B shape (H=32, S=8192, D=128, causal) 5.5e11 flops, 0.5559 ms at
the H100's 989 TFLOP/s of bf16 tensor-core products (8.2 ms at 67 TFLOP/s
of fp32 FMA).

- fp32 inputs run on fp32 FMA (TF32 would break the reference's 2e-4
  tolerance): 64-row q tiles, 64-key tiles.
- bf16 inputs run both products on ``wgmma`` (fp32 accumulation): 128-row
  q tiles over two warpgroups, the q tile kept in shared memory, k/v tiles
  of 128 keys (64 at D > 128) streamed by TMA through a 2-stage mbarrier
  ring, all in the 128-byte swizzled layout; p rounded to bf16 for the
  P·V product as the TPU kernel rounds it.  The kernel's rows are 64, 128
  or 256 wide (:func:`_bf16_plan`): a narrower D is zero-padded here, the
  true D still sets the scale and the stored columns.

Any S and any D up to 256 run.  The source note has the detail.

On the CPU it runs :func:`flash_attention_plain`, the plain PyTorch version
that the CPU tests use and that the card's smoke run compares the kernel
with.  It does so only because the tensors lie on the CPU: for a CUDA
tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: kernel launches so far (the plain version does not count)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256          # the kernel's widest shared-memory layout
MAX_HEADS = 65535           # the grid's y extent

BF16_WIDTHS = (64, 128, 256)   # the bf16 kernel's row widths (templates)

# pointers and the stream as c_void_p, sizes and flags as C ints
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def reset_launches() -> None:
    global launches
    launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain PyTorch softmax attention in fp32, one head at a time, so that
    only one ``[S, S]`` score matrix exists at once (268 MB at S = 8192).
    On the card its fp32 products run in full fp32 only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (the default)."""
    h, s, d = q.shape
    out = torch.empty((h, s, d), dtype=torch.float32, device=q.device)
    above = torch.ones((s, s), dtype=torch.bool,
                       device=q.device).triu_(1) if causal else None
    for i in range(h):
        scores = (q[i].float() @ k[i].float().T) / math.sqrt(d)
        if causal:
            scores.masked_fill_(above, float("-inf"))
        out[i] = torch.softmax(scores, dim=-1) @ v[i].float()
    return out


def _bf16_plan(d: int) -> tuple:
    """``(dp, pad)`` for bf16 rows of ``d`` columns: the bf16 kernel's row
    width (its template: the narrowest of 64, 128, 256 that holds ``d``)
    and the zero columns the wrapper appends to reach it."""
    dp = next(w for w in BF16_WIDTHS if d <= w)
    return dp, dp - d


def _tma_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` as the bf16 kernel's TMA loads read it: ``pad`` zero columns
    appended, on a 16-byte aligned base."""
    if pad:
        return torch.nn.functional.pad(t, (0, pad))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in DTYPES or q.dim() != 3:
        raise TypeError(f"q must be a 3-D [H, S, D] float32 or bfloat16 "
                        f"tensor, got {q.dtype} {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.shape != q.shape:
            raise TypeError(f"{name} is {t.dtype} {tuple(t.shape)}, q is "
                            f"{q.dtype} {tuple(q.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if min(q.shape) < 1:
        raise ValueError(f"flash_attention needs H, S, D >= 1, got "
                         f"{tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention with scale ``1/sqrt(D)``; fp32 ``[H, S, D]``.

    CUDA tensors go to the Hopper kernel (contiguous, D <= 256), CPU
    tensors to :func:`flash_attention_plain`; anything else raises."""
    global launches
    _check(q, k, v)
    device = q.device
    if device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {device}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    h, s, d = q.shape
    if d > MAX_HEAD_DIM or h > MAX_HEADS:
        raise ValueError(f"flash_attention kernel takes D <= {MAX_HEAD_DIM} "
                         f"and H <= {MAX_HEADS}, got H={h} D={d}")
    width = d
    if q.dtype == torch.bfloat16:
        width, pad = _bf16_plan(d)
        q, k, v = (_tma_rows(t, pad) for t in (q, k, v))
    out = torch.empty((h, s, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        build.launch("flash_attention", _ARGTYPES, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), h, s, d, width,
                     int(causal), DTYPES[q.dtype],
                     torch.cuda.current_stream(device).cuda_stream)
    launches += 1
    return out
