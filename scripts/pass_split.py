"""The split of one traced benchmark run's device time over the engine's
pass windows, on the card.

    python3 scripts/pass_split.py --workload clique-densify.t1 \\
        --seed 2147483911 [--seconds 51]

runs the cell once as ``nuribench/run.py --trace 1`` does, and prints, as
one JSON line each: the run's result line (``RESULT``), and the split of
its profiled part (``SPLIT``, :func:`nuribench.passes.split`): each pass's
windows with the busy and idle time inside them, the share of the device's
busy time inside some window, what lies outside them by operation, and
whether any window overlaps another of its step or leaves it, and the
latencies of the requests after the profiled part.  The split's seconds are
the device's, on the host's ``perf_counter`` clock.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    args = p.parse_args()
    from nuribench import harness, passes
    from nuribench import run as bench_run

    bench_run._environment()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    manifest = harness.load_json(ROOT / "BENCHMARK.json")
    runs = []
    read = harness.read_metric

    def spy(name, run):
        runs.append(run)
        return read(name, run)

    harness.read_metric = spy
    result = harness.run_cell(ROOT, manifest, args.workload, args.seed,
                              args.seconds, True, t_start=T_START)
    split = passes.split(runs[0])
    split.update(workload=args.workload, seed=args.seed,
                 card=torch.cuda.get_device_name(0),
                 query_steps=runs[0].steps(runs[0].device_part()),
                 unprofiled_latency_s=[s.recv - s.send
                                       for s in runs[0].host_part()])
    print("RESULT " + json.dumps(result))
    print("SPLIT " + json.dumps(split))
    return 0


if __name__ == "__main__":
    sys.exit(main())
