"""The clique computation's child rows for one engine step::

    out[m] = child(states_b[parent[m]], action[m]) if valid[m] else 0
                                                    # int32 [M, S]

``states_b`` is the step's dequeued batch ``[B, S]`` of clique states
(:mod:`repro_torch.core.clique`'s layout, ``S = 2W + 2``), ``parent`` and
``action`` ``[M]`` int64 name each selected child's parent row and added
vertex, ``valid`` ``[M]`` bool says which selections are children, and
``ext_mask`` ``[N, W]`` holds ``N(v) ∩ {u > v}`` for each vertex.  A child
is the clique computation's ``materialize`` of its parent and vertex (V
with the vertex's bit set, P ANDed with its ext row, ``|V| + 1``, the new
``|P|``); an invalid selection's row is zeros.  Every ``parent`` is in
``[0, B)`` and every ``action`` in ``[0, N)``, as the engine's selection
gives them.

On the card, :func:`clique_children` launches the hand-written Hopper
kernel ``csrc/clique_children.cu`` once.  It replaces no TPU kernel: the
JAX package computes these rows in plain ``jnp``, and in PyTorch the same
expression ran as some twenty kernels over the whole ``[M, S]`` block.
The kernel is bound by the block's one write (537 MB on the main path:
0.160 ms at 3.35 TB/s): a warp a row, zero rows stored 16 bytes a lane,
valid rows computed from their parent and ext rows.  The source note has
the detail.

On the CPU it runs :func:`clique_children_plain`, the engine's expression
(gather, :func:`child_rows`, ``where``) that the card's smoke run compares
the kernel with.  :func:`child_rows` is the clique computation's
``materialize`` itself, so the plain rows are the ones the JAX parity
tests hold.  It does so only because the tensors lie on the CPU: for a
CUDA tensor the wrapper launches the kernel or raises.

:func:`weighted_clique_children` is the same for the maximum-weight
clique's states (``w(V)`` and ``w(P)`` where the clique's hold ``|V|`` and
``|P|``, given the vertices' int32 ``weights``): the kernel's weighted
form, one launch, beside its plain version
:func:`weighted_clique_children_plain` and :func:`weighted_child_rows`.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import bitset
from . import build
from .weighted_intersect import weight_planes, weighted_popcount

#: kernel launches so far (the plain versions do not count): the clique
#: rows, and the weighted rows
launches = 0
weighted_launches = 0

# pointers and the stream as c_void_p, M, B and N as int64, W as a C int
_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p)


def reset_launches() -> None:
    global launches, weighted_launches
    launches = weighted_launches = 0


def child_rows(parents: torch.Tensor, action: torch.Tensor,
               ext_mask: torch.Tensor) -> torch.Tensor:
    """The clique computation's ``materialize``: each parent row's child by
    its vertex, int32 ``[..., S]`` (V with the bit set, P ANDed with the
    vertex's ext row, ``|V| + 1``, the new ``|P|``)."""
    w = ext_mask.shape[1]
    v_bits = bitset.set_bit(parents[..., :w], action)
    p_bits = parents[..., w:2 * w] & ext_mask[action]
    size = parents[..., 2 * w] + 1
    return torch.cat([v_bits, p_bits, size[..., None],
                      bitset.popcount(p_bits)[..., None]], dim=-1)


def clique_children_plain(states_b: torch.Tensor, parent: torch.Tensor,
                          action: torch.Tensor, valid: torch.Tensor,
                          ext_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch child rows: the parents gathered, :func:`child_rows`
    on every row, then the invalid rows zeroed."""
    children = child_rows(states_b[parent], action, ext_mask)
    return torch.where(valid[:, None], children, 0)


def weighted_child_rows(parents: torch.Tensor, action: torch.Tensor,
                        ext_mask: torch.Tensor, weights: torch.Tensor,
                        planes: torch.Tensor) -> torch.Tensor:
    """The maximum-weight clique computation's ``materialize``: each parent
    row's child by its vertex, int32 ``[..., S]`` (V with the bit set, P
    ANDed with the vertex's ext row, ``w(V) + w(vertex)``, the new P's
    weight by the weights' bit ``planes``)."""
    w = ext_mask.shape[1]
    v_bits = bitset.set_bit(parents[..., :w], action)
    p_bits = parents[..., w:2 * w] & ext_mask[action]
    weight = parents[..., 2 * w] + weights[action]
    return torch.cat([v_bits, p_bits, weight[..., None],
                      weighted_popcount(p_bits, planes)[..., None]], dim=-1)


def weighted_clique_children_plain(states_b: torch.Tensor,
                                   parent: torch.Tensor, action: torch.Tensor,
                                   valid: torch.Tensor, ext_mask: torch.Tensor,
                                   weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch weighted child rows: the parents gathered,
    :func:`weighted_child_rows` on every row, then the invalid rows
    zeroed."""
    planes = weight_planes(weights.cpu().numpy(), weights.device)
    children = weighted_child_rows(states_b[parent], action, ext_mask,
                                   weights, planes)
    return torch.where(valid[:, None], children, 0)


def _check(states_b, parent, action, valid, ext_mask, weights=None) -> None:
    operands = [("states_b", states_b, torch.int32, 2),
                ("parent", parent, torch.int64, 1),
                ("action", action, torch.int64, 1),
                ("valid", valid, torch.bool, 1),
                ("ext_mask", ext_mask, torch.int32, 2)]
    if weights is not None:
        operands.append(("weights", weights, torch.int32, 1))
    for name, t, dtype, dim in operands:
        if t.dtype != dtype or t.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D {dtype} tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != states_b.device:
            raise ValueError(f"{name} is on {t.device}, states_b on "
                             f"{states_b.device}")
    w = ext_mask.shape[1]
    if states_b.shape[1] != 2 * w + 2:
        raise ValueError(f"states of {states_b.shape[1]} words; clique "
                         f"states over W={w} words have {2 * w + 2}")
    if not parent.shape == action.shape == valid.shape:
        raise ValueError(f"parent {tuple(parent.shape)}, action "
                         f"{tuple(action.shape)} and valid "
                         f"{tuple(valid.shape)} must have one length M")
    if min(states_b.shape[0], parent.shape[0], ext_mask.shape[0], w) < 1:
        raise ValueError(f"clique_children needs B, M, N, W >= 1, got "
                         f"B={states_b.shape[0]} M={parent.shape[0]} "
                         f"N={ext_mask.shape[0]} W={w}")
    if weights is not None and weights.shape[0] != ext_mask.shape[0]:
        raise ValueError(f"{weights.shape[0]} weights for "
                         f"{ext_mask.shape[0]} vertices")


def clique_children(states_b: torch.Tensor, parent: torch.Tensor,
                    action: torch.Tensor, valid: torch.Tensor,
                    ext_mask: torch.Tensor) -> torch.Tensor:
    """The step's child rows, int32 ``[M, S]`` (zeros where not
    ``valid``).

    CUDA tensors go to the Hopper kernel (contiguous, ``W < 2^30``), CPU
    tensors to :func:`clique_children_plain`; anything else raises."""
    global launches
    _check(states_b, parent, action, valid, ext_mask)
    if states_b.device.type == "cpu":
        return clique_children_plain(states_b, parent, action, valid,
                                     ext_mask)
    out = _launch(states_b, parent, action, valid, ext_mask, None)
    launches += 1
    return out


def weighted_clique_children(states_b: torch.Tensor, parent: torch.Tensor,
                             action: torch.Tensor, valid: torch.Tensor,
                             ext_mask: torch.Tensor,
                             weights: torch.Tensor) -> torch.Tensor:
    """The step's weighted child rows, int32 ``[M, S]`` (zeros where not
    ``valid``): as :func:`clique_children`, with the vertices' int32
    ``weights [N]``."""
    global weighted_launches
    _check(states_b, parent, action, valid, ext_mask, weights)
    if states_b.device.type == "cpu":
        return weighted_clique_children_plain(states_b, parent, action,
                                              valid, ext_mask, weights)
    out = _launch(states_b, parent, action, valid, ext_mask, weights)
    weighted_launches += 1
    return out


def _launch(states_b, parent, action, valid, ext_mask, weights):
    """One launch of the kernel (its weighted form when ``weights``)."""
    device = states_b.device
    if device.type != "cuda":
        raise ValueError(f"clique_children runs on cuda or cpu, not "
                         f"{device}")
    operands = (states_b, parent, action, valid, ext_mask)
    if weights is not None:
        operands += (weights,)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("clique_children kernel needs contiguous operands")
    (b, s), m, (n, w) = states_b.shape, parent.shape[0], ext_mask.shape
    if w >= 2 ** 30:
        raise ValueError(f"clique_children kernel needs W < 2^30, got {w}")
    out = torch.empty((m, s), dtype=torch.int32, device=device)
    build.launch_on(device, "clique_children", _ARGTYPES,
                    *(t.data_ptr() for t in operands[:5]),
                    None if weights is None else weights.data_ptr(),
                    out.data_ptr(), m, b, n, w)
    return out
