"""Readings of the numbers that decide ``correct``, over many seeds in one
process: the program's runs, and the control's.

    python3 nuribench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--step-budget N]

Each seed runs the cell as ``run.py`` does (set-up, a window of
``--seconds``, the reference's judgement) and prints one JSON line: the
seed, ``correct``, ``attempted``, ``failed`` and every number compared
with its limit.  With ``--step-budget`` the window's requests carry that
``step_budget``: the control, the program's own path that breaks the
exactness guarantee (a run cut before it completes).  The benchmark's own
runs never take this path.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from nuribench.run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--step-budget", type=int, default=None)
    args = p.parse_args(argv)
    _environment()
    import torch
    from nuribench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    overrides = (None if args.step_budget is None
                 else dict(step_budget=args.step_budget))
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(ROOT, manifest, args.workload, seed,
                             args.seconds, False, t_start=t0,
                             overrides=overrides, log=lambda line: None)
        print(json.dumps(dict(
            seed=seed, control=args.step_budget is not None,
            correct=r["correct"], attempted=r["attempted"],
            failed=r["failed"],
            checks={k: c["value"] for k, c in r["checks"].items()},
            limits={k: c["limit"] for k, c in r["checks"].items()},
            metrics={k: m["value"] for k, m in r["metrics"].items()})),
            flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
