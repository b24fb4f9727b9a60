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
Llama-3-8B shape (H=32, S=8192, D=128, causal) 5.498e11 flops, 0.5559 ms
at the H100's 989 TFLOP/s of bf16 tensor-core products, and 3.332 ms for
fp32 inputs, whose products run as three tf32 tensor-core products each
(8.206 ms at 67 TFLOP/s of fp32 FMA).

- fp32 inputs run both products on ``wgmma`` as split 3xTF32: each
  operand x is split into hi = tf32(x) and lo = tf32(x - hi), each
  product is hi·hi + hi·lo + lo·hi in fp32 (about 7e-7 relative error a
  product; one tf32 product's 5e-4 would miss the 1e-4 per-head limit).
  tf32 ``wgmma`` reads both operands K-major, so a split pass in the same
  library first writes q, k hi/lo and vᵀ hi/lo (keys in :data:`KEY_ORDER`
  within each 8, so that p's split stays in registers) into a work buffer
  this wrapper allocates (:func:`_fp32_work_elems`); 64-row q tiles per
  warpgroup stay in shared memory, k/v chunks stream in by TMA through an
  mbarrier ring.  Rows are 32, 64, 128 or 256 wide (:func:`_fp32_plan`);
  the split pass zero-fills the columns past D.
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
FP32_WIDTHS = (32, 64, 128, 256)   # the fp32 (tf32) kernel's row widths

# pointers and the stream as c_void_p, sizes and flags as C ints
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


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


def _fp32_plan(d: int) -> tuple:
    """``(dp, pad)`` for fp32 rows of ``d`` columns: the fp32 kernel's row
    width (its template: the narrowest of 32, 64, 128, 256 that holds
    ``d``) and the zero columns its split pass appends to reach it."""
    dp = next(w for w in FP32_WIDTHS if d <= w)
    return dp, dp - d


def _fp32_work_elems(h: int, s: int, dp: int) -> int:
    """Floats of the fp32 kernel's split operands: q hi, q lo, k hi, k lo
    ``[H, S, dp]`` and v^T hi, v^T lo ``[H, dp, S8]`` (S8: S rounded up
    to 8)."""
    return 4 * h * s * dp + 2 * h * dp * (-(-s // 8) * 8)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds it: the low
    13 mantissa bits dropped, to nearest with ties away from zero (adding
    half of the dropped range to the bit pattern carries into the kept
    bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor) -> tuple:
    """``(hi, lo)``: hi = tf32(x), lo = tf32(x - hi); x - hi is exact in
    fp32, so ``|x - hi - lo| <= 2^-22 |x|``."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


#: position p of each 8 keys of the fp32 kernel's v^T rows holds key
#: KEY_ORDER[p]: the tf32 A fragment's k-indices t, t + 4 are then the
#: score accumulator's keys 2t, 2t + 1
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _key_order(n: int) -> torch.Tensor:
    """The key at each position of a v^T row of ``n`` (a multiple of 8)
    keys."""
    return torch.arange(n) // 8 * 8 + torch.tensor(KEY_ORDER).repeat(n // 8)


def _split_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dp: int) -> tuple:
    """What the fp32 kernel's split pass writes, in plain PyTorch: q hi,
    q lo, k hi, k lo ``[H, S, dp]`` (columns d.. zero) and v^T hi, v^T lo
    ``[H, dp, S8]``, keys in :data:`KEY_ORDER` within each 8, keys >= S
    zero."""
    h, s, d = q.shape
    s8 = -(-s // 8) * 8
    pad = torch.nn.functional.pad
    qk = [part for t in (q, k) for part in _split(pad(t.float(),
                                                      (0, dp - d)))]
    vt = pad(v.float(), (0, dp - d, 0, s8 - s)).transpose(1, 2)
    order = _key_order(s8).to(v.device)
    return (*qk, *_split(vt[..., order].contiguous()))


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
    work = None
    if q.dtype == torch.bfloat16:
        width, pad = _bf16_plan(d)
        q, k, v = (_tma_rows(t, pad) for t in (q, k, v))
    else:
        width, _ = _fp32_plan(d)
        work = torch.empty(_fp32_work_elems(h, s, width),
                           dtype=torch.float32, device=device)
    out = torch.empty((h, s, d), dtype=torch.float32, device=device)
    build.launch_on(device, "flash_attention", _ARGTYPES, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    None if work is None else work.data_ptr(), h, s, d, width,
                    int(causal), DTYPES[q.dtype])
    launches += 1
    return out
