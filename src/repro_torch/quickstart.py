"""Quickstart: top-k subgraph discovery with the PyTorch port.

Finds the maximum clique in a synthetic social graph on the card (or on
the CPU with ``--device cpu``), the counterpart of ``examples/quickstart.py``,
and compares its candidate count with Nuri-NP's (no prioritization, no
pruning).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.clique import make_clique_computation
from repro_torch.core.engine import Engine, EngineConfig
from repro_torch.core.exhaustive import nuri_np_clique_candidates
from repro_torch.data.synthetic_graphs import planted_clique_graph


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    args = ap.parse_args(argv)

    print("building a 500-vertex graph with a planted 9-clique...")
    g = planted_clique_graph(n=500, m=3000, clique_size=9, seed=42)

    comp = make_clique_computation(g, device=args.device)
    eng = Engine(comp, EngineConfig(k=3, batch=64, pool_capacity=16384))
    t0 = time.perf_counter()
    res = eng.run()
    if comp.device.type == "cuda":
        torch.cuda.synchronize(comp.device)
    dt = time.perf_counter() - t0

    where = (torch.cuda.get_device_name(comp.device)
             if comp.device.type == "cuda" else "cpu")
    print(f"\ntop-3 cliques (sizes {[int(x) for x in res.result_keys]}) "
          f"in {dt:.2f}s on {where}")
    print(f"  best clique: {comp.describe(res.result_states[0])}")
    print(f"  candidates examined: {res.candidates}  "
          f"(expanded {res.expanded}, pruned {res.pruned}, "
          f"steps {res.steps})")

    print("\ncomparing against Nuri-NP (no prioritization/pruning)...")
    np_res = nuri_np_clique_candidates(g, max_candidates=2_000_000)
    suffix = "" if np_res["completed"] else "+ (budget hit)"
    print(f"  Nuri-NP candidates: {np_res['candidates']}{suffix}")
    print(f"  reduction from prioritization+pruning: "
          f"{np_res['candidates'] / res.candidates:.1f}x")
    return res


if __name__ == "__main__":
    main()
