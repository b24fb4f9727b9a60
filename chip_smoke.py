#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each
kernel against its plain PyTorch version on the card, drives the port's
main path — single-device maximum-clique discovery — at full width, and
prints where the time went.  Phases, one line each (plus detail):

1. environment: the card's name and power limit, the kernels' build;
2. each kernel against its plain version on the card, exact equality, at
   ragged shapes and at the main-path shape, with its time, the plain
   version's time and the least time the card could take (bound);
3. the quickstart config and the spill probe on ``cuda`` and on ``cpu``:
   byte-identical answers and the reference's counters;
4. the main path: ``planted_clique_graph(32768, 354000, 32, seed=0)`` with
   ``EngineConfig(k=3, batch=64, pool_capacity=16384)`` must find the
   planted 32-clique, and every kernel of the path must have launched;
5. the main path once more under ``torch.profiler``: the device's idle
   share of the wall time and the kernels that take the device time.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero with no
result line.  Without a CUDA device, or without the repository's
``src/repro_torch`` beside this file, it fails at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# the full-width configuration (PERF.md, "Cells")
FULL_GRAPH = dict(n=32768, m=354_000, clique_size=32, seed=0)
FULL_ENGINE = dict(k=3, batch=64, pool_capacity=16384, spill="host")
# counters of the reference package on the quickstart graph (CPU JAX)
QUICKSTART_GRAPH = dict(n=500, m=3000, clique_size=9, seed=42)
QUICKSTART_CASES = {
    "quickstart": (dict(k=3, batch=64, pool_capacity=16384),
                   dict(steps=24, candidates=1479, expanded=574, pruned=905,
                        spilled=0, refilled=0, late_pruned=0)),
    "spill_probe": (dict(k=3, batch=64, pool_capacity=96),
                    dict(steps=10, candidates=1479, expanded=574, pruned=32,
                         spilled=1049, refilled=176, late_pruned=873)),
}
COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "syncs", "host_syncs")

# masked_intersect (B, N, W): ragged edges in every dimension (the sweeps
# of tests/test_kernels.py among them), then the main path's call shape
RAGGED_SHAPES = ((1, 1, 1), (1, 16, 1), (5, 257, 1), (7, 1, 2), (13, 100, 7),
                 (32, 300, 4), (8, 128, 32), (67, 1000, 33))
MAIN_SHAPE = (64, 32768, 1024)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
POPC_PER_CLOCK_PER_SM = 16       # CUDA C++ Programming Guide, CC 9.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median time of ``fn()`` on the card, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_environment():
    import torch
    from repro_torch.kernels import build
    smi = nvidia_smi("name,power.limit")
    print(smi)
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    max_clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"[1 env] device={name!r} count={torch.cuda.device_count()} "
          f"sms={props.multi_processor_count} max_sm_clock={max_clock_mhz} MHz "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"build={build_s:.2f}s kernels={sorted(report)}")
    for kname, rep in report.items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {kname}: {line.strip()}")
    return dict(name=name, smi=smi, sms=props.multi_processor_count,
                clock_hz=max_clock_mhz * 1e6)


def masked_intersect_bound_ms(b: int, n: int, w: int, masked: bool,
                              env: dict):
    """Least time for one call: bytes read once and written once over the
    HBM rate, or the B*N*W popcounts over the card's popcount rate."""
    nbytes = 4 * (b * w * (2 if masked else 1) + n * w + b * n)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * b * n * w / (POPC_PER_CLOCK_PER_SM * env["sms"]
                                * env["clock_hz"])
    return max(bytes_ms, ops_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_kernels(env: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import masked_intersect as mi

    rng = np.random.default_rng(0)

    def words(*shape):
        x = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        return torch.from_numpy(x.view(np.int32)).cuda()

    max_err = 0
    record = None
    for (b, n, w) in RAGGED_SHAPES + (MAIN_SHAPE,):
        for masked in (False, True):
            a, cols = words(b, w), words(n, w)
            mask = words(b, w) if masked else None
            got = mi.masked_intersect(a, cols, mask)
            want = mi.masked_intersect_plain(a, cols, mask)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"masked_intersect B={b} N={n} W={w} mask={masked}: "
                     f"max abs err {err}")
            line = f"[2 kernel] masked_intersect B={b} N={n} W={w} " \
                   f"mask={masked}: exact"
            if (b, n, w) == MAIN_SHAPE:
                ms = cuda_ms(lambda: mi.masked_intersect(a, cols, mask), 20)
                plain_ms = cuda_ms(
                    lambda: mi.masked_intersect_plain(a, cols, mask), 3, 1)
                bound_ms, bound_by = masked_intersect_bound_ms(
                    b, n, w, masked, env)
                line += (f" ms={ms:.4f} plain_ms={plain_ms:.3f} "
                         f"bound_ms={bound_ms:.4f} ({bound_by}) "
                         f"library_ms=null")
                if not masked:      # the main path calls the mask-free form
                    record = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
            print(line)
    record["max_abs_err"] = max_err
    return record


def phase_quickstart_parity():
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data.synthetic_graphs import planted_clique_graph

    g = planted_clique_graph(**QUICKSTART_GRAPH)
    for case, (cfg, want) in QUICKSTART_CASES.items():
        res = {}
        for device in ("cuda", "cpu"):
            comp = make_clique_computation(g, device=device)
            res[device] = Engine(comp, EngineConfig(**cfg)).run()
        cu, cpu = res["cuda"], res["cpu"]
        if cu.result_keys.tobytes() != cpu.result_keys.tobytes() or \
                cu.result_states.tobytes() != cpu.result_states.tobytes():
            fail(f"{case}: cuda and cpu results differ")
        for name in COUNTERS:
            if getattr(cu, name) != getattr(cpu, name):
                fail(f"{case}: {name} cuda={getattr(cu, name)} "
                     f"cpu={getattr(cpu, name)}")
        got = {name: getattr(cu, name) for name in want}
        if got != want or list(cu.result_keys) != [9, 8, 8]:
            fail(f"{case}: counters {got} keys {list(cu.result_keys)}, "
                 f"reference {want} keys [9, 8, 8]")
        print(f"[3 parity] {case}: cuda == cpu byte for byte, keys "
              f"{[int(x) for x in cu.result_keys]}, counters {got}")


def phase_main_path() -> int:
    import numpy as np
    import torch
    from repro_torch.core.clique import make_clique_computation
    from repro_torch.core.engine import Engine, EngineConfig
    from repro_torch.data.synthetic_graphs import planted_clique_graph
    from repro_torch.kernels import masked_intersect as mi
    from repro_torch.obs import Observability, aggregate, format_table

    t0 = time.perf_counter()
    g = planted_clique_graph(**FULL_GRAPH)
    comp = make_clique_computation(g, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    obs = Observability()
    eng = Engine(comp, EngineConfig(**FULL_ENGINE, observe=True,
                                    observability=obs))
    torch.cuda.reset_peak_memory_stats()

    mi.reset_launches()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = mi.launches

    members = np.random.default_rng(FULL_GRAPH["seed"]).choice(
        FULL_GRAPH["n"], FULL_GRAPH["clique_size"], replace=False)
    best = comp.describe(res.result_states[0])
    counters = {name: getattr(res, name) for name in COUNTERS}
    print(f"[4 main] N={g.n} edges={g.num_edges} setup={setup_s:.2f}s "
          f"keys={[int(x) for x in res.result_keys]} {counters} "
          f"wall={wall_s:.3f}s ms_per_step={1e3 * wall_s / res.steps:.3f} "
          f"masked_intersect_launches={launches} "
          f"peak_mem={torch.cuda.max_memory_allocated() / 2**30:.2f}GiB")
    spans = obs.tracer.spans()
    agg = aggregate(spans)
    parts = {name: round(1e3 * agg[name]["total_s"] / res.steps, 4)
             for name in ("engine.device_compute", "engine.host_sync",
                          "engine.spill", "engine.refill") if name in agg}
    print(f"[4 main] ms per step by span: {parts}")
    print(format_table(spans, wall_s=wall_s))
    if int(res.result_keys[0]) != FULL_GRAPH["clique_size"]:
        fail(f"best clique size {int(res.result_keys[0])}, planted "
             f"{FULL_GRAPH['clique_size']}")
    if best != sorted(int(v) for v in members):
        fail(f"best clique {best} is not the planted one")
    if launches != res.steps:
        fail(f"masked_intersect launched {launches} times in "
             f"{res.steps} steps")
    return launches, comp, res


def device_busy(trace_path: str):
    """Device time from a profiler trace: the union of kernel, copy and
    set intervals (s), and the summed time of each kernel name (ms)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((e["ts"], e["ts"] + e["dur"]))
            if e["cat"] == "kernel":
                name = e["name"][:60]
                by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
            else:
                by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + e["dur"] / 1e3
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6, by_name        # trace times are in us


def phase_profile(comp, want) -> None:
    """The main path once more under torch.profiler: the device's busy and
    idle share of the run's wall time, and the kernels that take it."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import Engine, EngineConfig

    eng = Engine(comp, EngineConfig(**FULL_ENGINE))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if res.result_states.tobytes() != want.result_states.tobytes() or \
            res.steps != want.steps:
        fail("the profiled run differs from the main-path run")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/trace.json"
        prof.export_chrome_trace(path)
        busy_s, by_name = device_busy(path)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"[5 profile] wall={wall_s:.3f}s (profiler on) "
          f"device_busy={busy_s:.3f}s "
          f"idle_share={1 - busy_s / wall_s:.3f} steps={res.steps}")
    for name, ms in top:
        print(f"  {ms:10.3f} ms  {ms / res.steps:8.4f} ms/step  {name}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the "
             f"repository")
    sys.path.insert(0, str(SRC))

    env = phase_environment()
    kernel = phase_kernels(env)
    phase_quickstart_parity()
    launches, comp, res = phase_main_path()
    phase_profile(comp, res)
    kernels = [dict(
        name="masked_intersect", route="cuda",
        source="src/repro_torch/kernels/csrc/masked_intersect.cu",
        replaces="src/repro/kernels/masked_intersect.py:96",
        launches=launches, max_abs_err=kernel["max_abs_err"],
        ms=kernel["ms"], plain_ms=kernel["plain_ms"],
        bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
        library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
