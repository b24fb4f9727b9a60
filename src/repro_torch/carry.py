"""Carry data and engine state across from the reference package.

The data takes the place of weights here: a graph built by ``repro`` comes
across through its numpy fields (:func:`graph_from_arrays`), and a
reference :class:`~repro.core.engine.EngineState` through its arrays and
scalar counters (:func:`state_from_arrays`), so that a run started by the
reference can be continued by the port.  Both take plain numpy and Python
values: nothing of ``repro`` is imported.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .core.engine import Engine, EngineState
from .core.graph import GraphStore
from .core.vpq import VirtualPriorityQueue

#: reference EngineState scalars carried verbatim
STATE_SCALARS = ("steps", "candidates", "expanded", "pruned", "refilled",
                 "syncs", "host_syncs", "threshold", "pool_occupancy", "done")

#: reference EngineState arrays (int32)
STATE_ARRAYS = ("pool_states", "pool_prio", "pool_ub", "result_states",
                "result_keys")


def graph_from_arrays(n: int, indptr: np.ndarray, indices: np.ndarray,
                      labels: Optional[np.ndarray] = None,
                      edge_labels: Optional[np.ndarray] = None
                      ) -> GraphStore:
    """The port's :class:`GraphStore` over a reference graph's CSR fields
    (same dtypes, so the fingerprint and every bitset view agree)."""
    def i32(x):
        return None if x is None else np.ascontiguousarray(x, np.int32)
    return GraphStore(n=int(n), indptr=i32(indptr), indices=i32(indices),
                      labels=i32(labels), edge_labels=i32(edge_labels))


def state_from_arrays(engine: Engine, arrays: Mapping[str, np.ndarray],
                      counters: Mapping[str, object]) -> EngineState:
    """A port :class:`EngineState` on ``engine``'s device from a reference
    state's arrays (:data:`STATE_ARRAYS`, as numpy) and counters
    (:data:`STATE_SCALARS`, plus ``vpq_len``, ``spilled`` and
    ``late_pruned`` from its queue).

    The spill queue does not come across, so a reference state whose queue
    still holds entries (``vpq_len > 0``) is rejected; the queue's running
    totals carry over so the finished result counts what the reference
    spilled before the hand-over.
    """
    if int(counters["vpq_len"]) != 0:
        raise ValueError(
            f"the reference state's spill queue holds {counters['vpq_len']} "
            f"entries; only a state with an empty queue can be carried")
    shapes = {"pool_states": (engine.C, engine.S), "pool_prio": (engine.C,),
              "pool_ub": (engine.C,), "result_states": (engine.k, engine.S),
              "result_keys": (engine.k,)}
    tensors = {}
    for name in STATE_ARRAYS:
        a = np.asarray(arrays[name])
        if a.shape != shapes[name] or a.dtype != np.int32:
            raise ValueError(f"{name}: expected int32 {shapes[name]}, got "
                             f"{a.dtype} {a.shape}")
        tensors[name] = torch.from_numpy(a.copy()).to(engine.device)
    cfg = engine.cfg
    vpq = VirtualPriorityQueue(state_width=engine.S, backend=cfg.spill,
                               spill_dir=cfg.spill_dir, obs=engine.obs)
    vpq.total_spilled = int(counters.get("spilled", 0))
    vpq.total_late_pruned = int(counters.get("late_pruned", 0))
    scalars = {name: (bool if name == "done" else int)(counters[name])
               for name in STATE_SCALARS}
    return EngineState(vpq=vpq, **tensors, **scalars)
