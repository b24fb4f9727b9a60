#!/usr/bin/env python3
"""The device intervals of one profiled run read two ways, on one NVIDIA
card, in one process, and held to each other:

- the chrome trace, exported to a file and parsed as JSON (its ``X``
  events of category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``);
- the profiler's own events (``chip_smoke.device_busy``: the events
  of ``prof.profiler.kineto_results`` on the device, told apart as
  ``chip_smoke.device_activity`` says), which is how ``chip_smoke.py``'s
  profiled reruns read them.

    python3 scripts/trace_ab.py [--shards 8] [--steps-per-sync 1]

The run is ``chip_smoke.py``'s phase 4 cell (``planted_clique_graph(32768,
354000, 32, seed=0)``, k = 3, B = 64, C = 16,384) through
``ShardedEngine`` at ``--shards`` (phase 12's profiled rerun at the
default 8) or, at ``--shards 1``, through ``Engine``.  Both readings must
give the same launches by kernel name, the same device ms by kernel name
(within 1e-6 relative) and the same busy time, the union of the intervals
(within 1e-3 relative: the idle share is printed to three decimals).
Prints the card's name and power limit, then one JSON line: the run's
wall, the profiler's stop, each reading's seconds and its busy time, the
chrome trace's size, and the largest differences; then fails if the
readings disagree.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (device_busy, nvidia_smi, fail, ...)

#: the chrome trace's device rows: kernels, copies and sets
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
#: the device ms by kernel name must agree to rounding; the busy time
#: (the union of the intervals) to 1e-3 relative, below the idle share's
#: printed precision: the exported trace places a few intervals
#: differently (1.3e-4 relative at 8 shards, NVIDIA H100 80GB HBM3, 700 W)
NAME_REL = 1e-6
BUSY_REL = 1e-3


def device_busy_json(trace_path: str):
    """``chip_smoke.device_busy``'s three values from an exported chrome
    trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name, counts = [], {}, {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_ACTIVITIES:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            if e["cat"] == "kernel":
                name = e["name"][:60]
                by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
                counts[e["name"]] = counts.get(e["name"], 0) + 1
            else:
                by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, by_name, counts


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1e-12)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--steps-per-sync", type=int, default=1)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script needs an NVIDIA card")
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.distributed import ShardedEngine

    print(chip_smoke.nvidia_smi("name,power.limit"))
    comp = make_clique_computation(
        planted_clique_graph(**chip_smoke.FULL_GRAPH), device="cuda")
    cfg = EngineConfig(**chip_smoke.FULL_ENGINE, shards=args.shards,
                       steps_per_sync=args.steps_per_sync)
    eng = (ShardedEngine if args.shards > 1 else Engine)(comp, cfg)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_run = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    stop_s = time.perf_counter() - t_end

    t0 = time.perf_counter()
    events = chip_smoke.device_busy(prof)
    events_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        export_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        trace = device_busy_json(path)
        parse_s = time.perf_counter() - t0

    busy_e, by_name_e, counts_e = events
    busy_j, by_name_j, counts_j = trace
    if set(by_name_e) != set(by_name_j) or counts_e != counts_j:
        diff = {k: (counts_e.get(k), counts_j.get(k))
                for k in set(counts_e) | set(counts_j)
                if counts_e.get(k) != counts_j.get(k)}
        chip_smoke.fail(f"the readings differ in their kernels (events, "
                        f"trace): {sorted(diff.items())[:12]}; names only "
                        f"in one: {sorted(set(by_name_e) ^ set(by_name_j))}")
    name_diff = max((rel(by_name_e[k], by_name_j[k]) for k in by_name_e),
                    default=0.0)
    busy_diff = rel(busy_e, busy_j)
    print(json.dumps(dict(
        shards=args.shards, steps_per_sync=args.steps_per_sync,
        steps=res.steps, run_wall_s=t_end - t_run,
        profiler_stop_s=stop_s, events_read_s=events_s,
        trace_export_s=export_s, trace_parse_s=parse_s,
        trace_bytes=size, busy_s_events=busy_e, busy_s_trace=busy_j,
        busy_rel_diff=busy_diff, ms_by_name_max_rel_diff=name_diff,
        launches=sum(counts_e.values()),
        masked_intersect_launches=chip_smoke.kernel_launches(
            counts_e, chip_smoke.MI_KERNEL))))
    if busy_diff > BUSY_REL or name_diff > NAME_REL:
        chip_smoke.fail(f"busy {busy_e} against {busy_j} (rel "
                        f"{busy_diff:.3g}); ms by name rel {name_diff:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
