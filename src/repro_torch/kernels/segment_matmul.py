"""Segment sum of edge messages by destination node — the GNN
message-passing primitive::

    out[n] = sum of messages[e] over edges e with dst[e] == n   # fp32 [N, D]

``messages`` are ``[E, D]`` fp32 or bf16, ``dst`` ``[E]`` int32; an edge
whose ``dst`` lies outside ``[0, num_nodes)`` is dropped, as the
reference drops it (its padding edges carry ``dst = -1``).  The name is the
reference's (``repro.kernels.segment_matmul``), whose TPU kernel computes
the sum as one-hot matrix products.

On the card, :func:`segment_matmul` makes one call into the hand-written
Hopper library ``csrc/segment_matmul.cu``, which replaces
``repro/kernels/segment_matmul.py::_kernel``.  That call is one
cooperative launch of one persistent kernel on PyTorch's current stream:
grid-wide barriers separate its phases, which sort the edges by ``dst``
(stable) into a CSR — straight from the keys when the card finds them
sorted, else a count, a scan and a radix sort over the key bits — and then
sum.  The sum runs in two passes: each warp first sums the nodes of an
equal share of the rows, streaming the message rows through a ring in shared memory
with bulk asynchronous copies and adding each node's rows in fp32 in edge
order — no atomics, so the result does not depend on the launch — and
then zeroes the empty nodes of an equal share of the nodes with 16-byte
stores.  The call is bound by memory (the messages read once, the output
written once: 0.0864 ms in fp32 and 0.0649 ms in bf16 at the GraphSAGE
shape); its earlier form put ten device operations on the stream for
0.12 ms of device work, and the source note has what each part of the
design does about that.  :func:`csr_by_node` runs the same launch without
the sum, so that the card can hold the CSR against :func:`edges_by_node`,
the same CSR in plain PyTorch.

On the CPU it runs :func:`segment_matmul_plain`, the plain PyTorch version
that the CPU tests use and that the card's smoke run compares the kernel
with.  It does so only because the tensors lie on the CPU: for a CUDA
tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

#: kernel launches so far (the plain version does not count)
launches = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# segment_matmul_launch(msg, dst, scratch, scratch_elems, out, E, N, D,
# dtype, stream): pointers and the stream as c_void_p, the scratch size as
# a C long long, the rest as C ints
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

# the CSR build's tiles, as csrc/segment_matmul.cu has them
RADIX_TILE = 2048          # edges a radix tile (256 threads x 8)
SCAN_TILE = 4096           # counters a block of the ptr scan
DIGIT_BITS = 8


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


def _check_dst(dst: torch.Tensor, num_nodes: int) -> None:
    if dst.dtype != torch.int32 or dst.dim() != 1:
        raise TypeError(f"dst must be a 1-D int32 tensor, got {dst.dtype} "
                        f"{tuple(dst.shape)}")
    if num_nodes < 1:
        raise ValueError(f"segment_matmul needs num_nodes >= 1, got "
                         f"{num_nodes}")


def _check(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> None:
    if messages.dtype not in DTYPES or messages.dim() != 2:
        raise TypeError(f"messages must be a 2-D float32 or bfloat16 tensor, "
                        f"got {messages.dtype} {tuple(messages.shape)}")
    _check_dst(dst, num_nodes)
    if dst.shape[0] != messages.shape[0]:
        raise ValueError(f"{dst.shape[0]} destinations for "
                         f"{messages.shape[0]} messages")
    if dst.device != messages.device:
        raise ValueError(f"dst is on {dst.device}, messages on "
                         f"{messages.device}")
    if messages.shape[1] < 1:
        raise ValueError(f"segment_matmul needs D >= 1, got "
                         f"D={messages.shape[1]}")


def edges_by_node(dst: torch.Tensor, num_nodes: int):
    """The CSR of ``dst`` in plain PyTorch: ``order`` (int32 [E]), the
    edges sorted by destination, stable, and ``ptr`` (int32
    [num_nodes + 1]), so that node n's edges are ``order[ptr[n]:ptr[n + 1]]``.
    Edges whose ``dst`` lies outside ``[0, num_nodes)`` sort past
    ``ptr[num_nodes]``.  The kernels' CSR (:func:`csr_by_node`) is held to
    it."""
    key = torch.where((dst >= 0) & (dst < num_nodes), dst, num_nodes)
    key, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(
        key, torch.arange(num_nodes + 1, dtype=torch.int32,
                          device=dst.device), out_int32=True)
    return order.to(torch.int32), ptr


class CsrLayout(NamedTuple):
    """Offsets, in int32 elements, into the CSR build's scratch buffer, as
    ``csrc/segment_matmul.cu``'s ``Layout`` has them: ``ptr`` at 0 (N + 1
    words), one sortedness word per radix tile (``flags``), then the words
    the launch clears first, ``[counts, zeroed)``: the N + 1 key counts,
    the scan tiles' sums and the radix passes' digit totals; then the
    per-(pass, digit, tile) digit counts (``hist``), ``order`` and the
    radix passes' two buffers of keys and edge ids; ``total`` elements in
    all.  The launch's grid barrier keeps no word here."""
    passes: int
    tiles: int
    scan_tiles: int
    flags: int
    counts: int
    tile_sums: int
    totals: int
    zeroed: int
    hist: int
    order: int
    keys_a: int
    vals_a: int
    keys_b: int
    vals_b: int
    total: int


@functools.lru_cache(maxsize=256)
def _csr_layout(e: int, num_nodes: int) -> CsrLayout:
    """The scratch buffer's layout for ``e`` edges and ``num_nodes``
    nodes, as ``csrc/segment_matmul.cu``'s ``layout`` computes it."""
    passes = -(-num_nodes.bit_length() // DIGIT_BITS)
    tiles = -(-e // RADIX_TILE)
    scan_tiles = -(-(num_nodes + 1) // SCAN_TILE)
    flags = num_nodes + 1
    counts = flags + tiles
    tile_sums = counts + num_nodes + 1
    totals = tile_sums + scan_tiles
    zeroed = totals + passes * (1 << DIGIT_BITS)
    order = zeroed + passes * (1 << DIGIT_BITS) * tiles
    return CsrLayout(passes, tiles, scan_tiles, flags, counts, tile_sums,
                     totals, zeroed, hist=zeroed, order=order,
                     keys_a=order + e, vals_a=order + 2 * e,
                     keys_b=order + 3 * e, vals_b=order + 4 * e,
                     total=order + 5 * e)


def csr_radix_plain(dst: torch.Tensor, num_nodes: int):
    """The CSR build of ``csrc/segment_matmul.cu`` step for step in plain
    PyTorch, on any device: keys (``dst`` in range, else ``num_nodes``);
    if no key is smaller than the one before it, ``order[e] = e`` and
    ``ptr`` filled from the keys alone (``ptr[n] = e`` over each gap
    ``(key[e-1], key[e]]``, 0 over the head ``[0, key[0]]``, E over the
    tail ``(key[E-1], N]``); else the keys' counts and their exclusive scan
    into ``ptr``, and the LSD radix sort of the keys over 8-bit digits,
    pass by pass: per-(digit, tile) counts over tiles of ``RADIX_TILE``
    edges of the pass's input, their digit-major exclusive scan, and each
    edge placed at its digit's offset plus its rank among the edges of its
    tile with that digit.  Returns ``(order, ptr)`` as
    :func:`edges_by_node` does."""
    dev, e = dst.device, dst.shape[0]
    key = torch.where((dst >= 0) & (dst < num_nodes), dst,
                      num_nodes).long()
    edge = torch.arange(e, device=dev)
    if e == 0 or bool((key[1:] >= key[:-1]).all()):
        if e == 0:
            ptr = torch.zeros(num_nodes + 1, dtype=torch.long, device=dev)
        else:
            ptr = torch.cat([
                torch.zeros(int(key[0]) + 1, dtype=torch.long, device=dev),
                torch.repeat_interleave(edge[1:], key[1:] - key[:-1]),
                torch.full((num_nodes - int(key[-1]),), e, device=dev)])
        return edge.to(torch.int32), ptr.to(torch.int32)
    counts = torch.bincount(key, minlength=num_nodes + 1)
    ptr = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    digits = 1 << DIGIT_BITS
    tiles = -(-e // RADIX_TILE)
    pad = tiles * RADIX_TILE - e
    tile = torch.arange(tiles, device=dev)[:, None]
    real = (tile * RADIX_TILE + torch.arange(RADIX_TILE, device=dev) < e
            ).long()                                  # edges, not padding
    for shift in range(0, num_nodes.bit_length(), DIGIT_BITS):
        digit = (key >> shift) & (digits - 1)
        # a tile's last slots hold padding, which sorts after its edges
        padded = torch.cat([digit, digit.new_full((pad,), digits - 1)]
                           ).view(tiles, RADIX_TILE)
        hist = torch.zeros((digits, tiles), dtype=torch.long, device=dev)
        hist.index_put_((padded, tile.expand_as(padded)), real,
                        accumulate=True)
        offsets = (torch.cumsum(hist.flatten(), 0)
                   - hist.flatten()).view(digits, tiles)
        sorted_digit, slot = torch.sort(padded, dim=1, stable=True)
        start = torch.searchsorted(sorted_digit, sorted_digit)
        rank = torch.arange(RADIX_TILE, device=dev) - start
        dest = offsets[sorted_digit, tile] + rank
        src = (tile * RADIX_TILE + slot).flatten()
        dest, src = dest.flatten()[src < e], src[src < e]
        key = key.new_empty(e).index_put_((dest,), key[src])
        edge = edge.new_empty(e).index_put_((dest,), edge[src])
    return edge.to(torch.int32), ptr


def csr_by_node(dst: torch.Tensor, num_nodes: int):
    """``(order, ptr)`` of ``dst`` as :func:`edges_by_node` defines them,
    built on the card by the phases that :func:`segment_matmul`'s launch
    runs before its sum (one C call, the same kernel without the sum, no
    launch counted: it only exposes the CSR for checking).  CPU tensors run
    :func:`csr_radix_plain`."""
    _check_dst(dst, num_nodes)
    device = dst.device
    if device.type == "cpu":
        return csr_radix_plain(dst, num_nodes)
    scratch, order_at = _launch(None, dst, None, num_nodes, 0, 0)
    return scratch[order_at:order_at + dst.shape[0]], \
        scratch[:num_nodes + 1]


def _launch(messages, dst, out, num_nodes, d, dtype):
    """The library's one C call on ``dst``'s card — one cooperative launch:
    the CSR build into a scratch buffer allocated here (no clearing: the
    launch clears what it counts into), then the sum into ``out`` unless it
    is None.  Returns the scratch buffer and where ``order`` starts in
    it."""
    device = dst.device
    if device.type != "cuda":
        raise ValueError(f"segment_matmul runs on cuda or cpu, not {device}")
    if not dst.is_contiguous():
        raise ValueError("segment_matmul kernel needs a contiguous dst")
    e = dst.shape[0]
    layout = _csr_layout(e, num_nodes)
    scratch = torch.empty(layout.total, dtype=torch.int32, device=device)
    build.launch_on(device, "segment_matmul", _ARGTYPES,
                    None if messages is None else messages.data_ptr(),
                    dst.data_ptr(), scratch.data_ptr(), layout.total,
                    None if out is None else out.data_ptr(), e, num_nodes, d,
                    dtype)
    return scratch, layout.order


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
    if not messages.is_contiguous():
        raise ValueError("segment_matmul kernel needs contiguous messages")
    out = torch.empty((num_nodes, messages.shape[1]), dtype=torch.float32,
                      device=device)
    _launch(messages, dst, out, num_nodes, messages.shape[1],
            DTYPES[messages.dtype])
    launches += 1
    return out
