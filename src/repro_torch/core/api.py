"""User-facing computational model — the paper's Table-1 API, batched.

Same contract as ``repro.core.api`` (see its docstring for the mapping of
the paper's five user functions): states are fixed-width ``int32`` rows,
actions are integers in ``[0, num_actions)``, ``score_children`` returns
``NEG`` priority for every (state, action) that must not be created.  The
callbacks take and return ``torch`` tensors on :attr:`SubgraphComputation.
device`, which is where the engine keeps its pool.  :func:`from_pointwise`
builds one from scalar functions over a single state, vmapped.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch
from torch.func import vmap

NEG = torch.iinfo(torch.int32).min  # "-inf" for int32 keys

# elements that the pointwise callbacks' vmapped calls may hold at once,
# counting each call as its state unpacked to bits (32 per word), as
# masked_intersect_plain bounds its chunks
POINTWISE_MAX_ELEMENTS = 1 << 26


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no device given and no CUDA device present this raises
    rather than carrying on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        device = "cuda"
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class SubgraphComputation:
    """A batched top-k subgraph-discovery computation."""

    name: str
    state_width: int   # S: int32 words per subgraph state
    num_actions: int   # A: action space (e.g. N vertices)

    # () -> (states [n0, S], prio [n0], ub [n0])
    init_frontier: Callable[[], Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]]

    # states [B, S] -> (child_prio [B, A], child_ub [B, A]); NEG = not expandable
    score_children: Callable[[torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]]

    # (parent_states [M, S], actions [M]) -> child states [M, S]
    materialize: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    # states [B, S] -> result keys [B] (NEG when not relevant)
    result_key: Callable[[torch.Tensor], torch.Tensor]

    # states [B, S] -> result-space upper bound [B]
    upper_bound: Callable[[torch.Tensor], torch.Tensor]

    # pretty-printer for result states (host-side)
    describe: Optional[Callable] = None

    # where the callbacks' tensors live; the engine keeps its pool there
    # (None: cuda, as for every entry point)
    device: Optional[torch.device] = None

    # (states_b [B, S], parent [M], action [M], valid [M]) -> child states
    # [M, S]: materialize of states_b[parent] and action where valid, zero
    # rows elsewhere, in one call; the engine calls it in place of gathering
    # the parents, materialize and zeroing the invalid rows (None: it does
    # those)
    materialize_selected: Optional[Callable[..., torch.Tensor]] = None

    def __post_init__(self):
        if self.state_width <= 0:
            raise ValueError(
                f"{self.name}: state_width must be positive, "
                f"got {self.state_width}")
        if self.num_actions <= 0:
            raise ValueError(
                f"{self.name}: num_actions must be positive, "
                f"got {self.num_actions}")


def chunk_size(calls: int, per_call: int) -> Optional[int]:
    """``chunk_size`` for a vmap of ``calls`` calls that hold ``per_call``
    elements each: as many as fit in :data:`POINTWISE_MAX_ELEMENTS`, None
    when all of them do."""
    size = max(1, POINTWISE_MAX_ELEMENTS // max(1, per_call))
    return None if size >= calls else size


def from_pointwise(name: str,
                   state_width: int,
                   num_actions: int,
                   init_frontier,
                   expandable,       # (state [S], action) -> bool
                   child_priority,   # (state [S], action) -> int32
                   child_ub,         # (state [S], action) -> int32
                   materialize_one,  # (state [S], action) -> state [S]
                   relevant,         # (state [S]) -> bool
                   result_key_one,   # (state [S]) -> int32
                   upper_bound_one,  # (state [S]) -> int32
                   describe=None,
                   device=None) -> SubgraphComputation:
    """Succinct per-subgraph API (the paper's Listing-1 style), vmapped.

    Users write scalar functions over a single state (0-d tensors for an
    action and a result; no ``.item()`` and no Python branch on a tensor);
    this adapter builds the batched computation on ``device`` (default
    ``cuda``) with ``torch.func.vmap``, over states and then over actions.
    The ``[B, A, ...]`` that the per-action map would hold at once is cut
    into chunks of actions (``vmap``'s ``chunk_size``) so that it stays
    within :data:`POINTWISE_MAX_ELEMENTS`, counting each call as its state
    unpacked to bits; the numbers are the same for any chunking.  The fused
    batched path (e.g. :mod:`repro_torch.core.clique`) is preferred for hot
    computations.
    """
    device = resolve_device(device)
    actions = torch.arange(num_actions, dtype=torch.int32, device=device)
    per_call = 32 * state_width

    def score_children(states):
        def per_state(s):
            def per_action(a):
                ok = expandable(s, a)
                return (torch.where(ok, child_priority(s, a), NEG),
                        torch.where(ok, child_ub(s, a), NEG))
            return vmap(per_action, chunk_size=chunk_size(
                num_actions, states.shape[0] * per_call))(actions)
        return vmap(per_state)(states)

    def materialize(states, acts):
        return vmap(materialize_one, chunk_size=chunk_size(
            states.shape[0], per_call))(states, acts)

    def result_key(states):
        def one(s):
            return torch.where(relevant(s), result_key_one(s), NEG)
        return vmap(one, chunk_size=chunk_size(states.shape[0], per_call))(
            states)

    def upper_bound(states):
        return vmap(upper_bound_one, chunk_size=chunk_size(
            states.shape[0], per_call))(states)

    return SubgraphComputation(
        name=name, state_width=state_width, num_actions=num_actions,
        init_frontier=init_frontier, score_children=score_children,
        materialize=materialize, result_key=result_key,
        upper_bound=upper_bound, describe=describe, device=device)
