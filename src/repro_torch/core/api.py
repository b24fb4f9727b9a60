"""User-facing computational model — the paper's Table-1 API, batched.

Same contract as ``repro.core.api`` (see its docstring for the mapping of
the paper's five user functions): states are fixed-width ``int32`` rows,
actions are integers in ``[0, num_actions)``, ``score_children`` returns
``NEG`` priority for every (state, action) that must not be created.  The
callbacks take and return ``torch`` tensors on :attr:`SubgraphComputation.
device`, which is where the engine keeps its pool.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

NEG = torch.iinfo(torch.int32).min  # "-inf" for int32 keys


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

    def __post_init__(self):
        if self.state_width <= 0:
            raise ValueError(
                f"{self.name}: state_width must be positive, "
                f"got {self.state_width}")
        if self.num_actions <= 0:
            raise ValueError(
                f"{self.name}: num_actions must be positive, "
                f"got {self.num_actions}")
