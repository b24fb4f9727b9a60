"""Segment sum of edge messages by destination node — the GNN
message-passing primitive::

    out[n] = sum of messages[e] over edges e with dst[e] == n   # fp32 [N, D]

``messages`` are ``[E, D]`` fp32 or bf16, ``dst`` ``[E]`` int32; an edge
whose ``dst`` lies outside ``[0, num_nodes)`` is dropped, as the
reference drops it (its padding edges carry ``dst = -1``).  The name is the
reference's (``repro.kernels.segment_matmul``), whose TPU kernel computes
the sum as one-hot matrix products.

On the card, :func:`segment_matmul` sorts the edges by ``dst`` (stable) and
launches the hand-written Hopper kernel ``csrc/segment_matmul.cu``, which
replaces ``repro/kernels/segment_matmul.py::_kernel``: one thread per
(node, 16-byte column chunk) walks its node's edges in edge order and
writes its sum once — no atomics, so the result does not depend on the
launch.  The sum is bound by memory (the messages read once, the output
written once); the source note has the detail.

On the CPU it runs :func:`segment_matmul_plain`, the plain PyTorch version
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

# pointers and the stream as c_void_p, sizes and the dtype as C ints
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p)


def reset_launches() -> None:
    global launches
    launches = 0


def segment_matmul_plain(messages: torch.Tensor, dst: torch.Tensor,
                         num_nodes: int) -> torch.Tensor:
    """Plain PyTorch segment sum: ``index_add_`` of the fp32 messages whose
    ``dst`` lies in ``[0, num_nodes)`` (``index_add_`` itself would raise on
    the others)."""
    keep = (dst >= 0) & (dst < num_nodes)
    out = torch.zeros((num_nodes, messages.shape[1]), dtype=torch.float32,
                      device=messages.device)
    return out.index_add_(0, dst[keep], messages[keep].float())


def _check(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> None:
    if messages.dtype not in DTYPES or messages.dim() != 2:
        raise TypeError(f"messages must be a 2-D float32 or bfloat16 tensor, "
                        f"got {messages.dtype} {tuple(messages.shape)}")
    if dst.dtype != torch.int32 or dst.dim() != 1:
        raise TypeError(f"dst must be a 1-D int32 tensor, got {dst.dtype} "
                        f"{tuple(dst.shape)}")
    if dst.shape[0] != messages.shape[0]:
        raise ValueError(f"{dst.shape[0]} destinations for "
                         f"{messages.shape[0]} messages")
    if dst.device != messages.device:
        raise ValueError(f"dst is on {dst.device}, messages on "
                         f"{messages.device}")
    if num_nodes < 1 or messages.shape[1] < 1:
        raise ValueError(f"segment_matmul needs num_nodes, D >= 1, got "
                         f"num_nodes={num_nodes} D={messages.shape[1]}")


def edges_by_node(dst: torch.Tensor, num_nodes: int):
    """The kernel's view of ``dst``: ``order`` (int32 [E]), the edges
    sorted by destination, stable, and ``ptr`` (int32 [num_nodes + 1]),
    so that node n's edges are ``order[ptr[n]:ptr[n + 1]]``.  Edges whose
    ``dst`` lies outside ``[0, num_nodes)`` sort past ``ptr[num_nodes]``."""
    key = torch.where((dst >= 0) & (dst < num_nodes), dst, num_nodes)
    key, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(
        key, torch.arange(num_nodes + 1, dtype=torch.int32,
                          device=dst.device), out_int32=True)
    return order.to(torch.int32), ptr


def segment_matmul(messages: torch.Tensor, dst: torch.Tensor,
                   num_nodes: int) -> torch.Tensor:
    """``out[n] = Σ_{e: dst[e]==n} messages[e]``; fp32 ``[num_nodes, D]``.

    CUDA tensors go to the Hopper kernel, CPU tensors to
    :func:`segment_matmul_plain`; anything else raises."""
    global launches
    _check(messages, dst, num_nodes)
    device = messages.device
    if device.type == "cpu":
        return segment_matmul_plain(messages, dst, num_nodes)
    if device.type != "cuda":
        raise ValueError(f"segment_matmul runs on cuda or cpu, not {device}")
    if not messages.is_contiguous():
        raise ValueError("segment_matmul kernel needs contiguous messages")
    d = messages.shape[1]
    with torch.cuda.device(device):
        order, ptr = edges_by_node(dst, num_nodes)
        out = torch.empty((num_nodes, d), dtype=torch.float32, device=device)
        build.launch("segment_matmul", _ARGTYPES, messages.data_ptr(),
                     order.data_ptr(), ptr.data_ptr(), out.data_ptr(),
                     num_nodes, d, DTYPES[messages.dtype],
                     torch.cuda.current_stream(device).cuda_stream)
    launches += 1
    return out
