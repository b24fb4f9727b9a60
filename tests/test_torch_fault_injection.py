"""Crash injection for the port's durable runs: every cell of
tests/test_fault_injection.py (its 1-, 2- and 8-shard tiers), with the
port in the crash and resume children and the reference's uninterrupted
run as the oracle.

Each cell runs real subprocesses of this file (its ``__main__``):

1. **crash** — the port's engine on ``device="cpu"`` with periodic
   checkpoints, SIGKILLed at a fuzzed host-read boundary or inside a
   checkpoint commit (tmp dir written, rename not yet done);
2. optionally a second crash, resumed from the newest committed step;
3. **resume** — restart with ``resume=True`` and print the result.

The resumed result must equal the reference's uninterrupted run in keys,
states and every counter; no ``step_*.tmp`` dir may survive and the
resumed run's spill dir (every ``shard{i}`` under it) must be empty once
its queues close.  The reference's ``Engine`` runs in the test's own
process; its ``ShardedEngine`` needs one JAX device a shard, so the sharded
oracles run once, in one subprocess of this file under
``XLA_FLAGS=--xla_force_host_platform_device_count=8``.  The kill step is
drawn from a seeded RNG inside the run's span::

    PYTHONPATH=src python tests/test_torch_fault_injection.py \\
        --spec '<json>' --mode crash
"""
import argparse
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


# ------------------------------------------------------------- the child
def make_workload(kind: str, seed: int, ref: bool = False):
    """tests/fault_harness.py's seeded (graph, computation) pairs, built by
    the port on the CPU (``ref=False``) or by the reference."""
    if ref:
        from repro.core.clique import make_clique_computation as clique
        from repro.core.iso import build_iso_index, make_iso_computation
        from repro.core.weighted_clique import (
            make_weighted_clique_computation as weighted)
        from repro.data.synthetic_graphs import densifying_graph, \
            labeled_graph
        kw = {}
    else:
        from repro_torch.core.clique import make_clique_computation as clique
        from repro_torch.core.iso import build_iso_index, make_iso_computation
        from repro_torch.core.weighted_clique import (
            make_weighted_clique_computation as weighted)
        from repro_torch.data.synthetic_graphs import densifying_graph, \
            labeled_graph
        kw = dict(device="cpu")

    rng = np.random.default_rng(seed)
    n = int(rng.integers(64, 96))
    m = int(rng.integers(6 * n, 12 * n))
    if kind == "clique":
        return clique(densifying_graph(n, m, seed=seed), **kw)
    if kind == "weighted-clique":
        g = densifying_graph(n, m, seed=seed)
        return weighted(g, rng.integers(1, 20, g.n), **kw)
    assert kind == "iso", kind
    gl = labeled_graph(n=n, m=m, n_labels=3, seed=seed)
    return make_iso_computation(gl, [(0, 1), (1, 2), (0, 2)], [1, 1, 1],
                                build_iso_index(gl, max_hops=2, **kw), **kw)


def engine_config(spec: dict, checkpointed: bool) -> dict:
    return dict(
        k=spec.get("k", 3), batch=spec.get("batch", 4),
        pool_capacity=spec.get("pool_capacity", 48), max_steps=50_000,
        spill=spec.get("spill", "host"), spill_dir=spec.get("spill_dir"),
        shards=spec.get("shards", 1), steps_per_sync=spec.get("T", 1),
        sync_every=spec.get("K", 1),
        checkpoint_every=spec["checkpoint_every"] if checkpointed else 0,
        checkpoint_dir=spec["ckpt_dir"] if checkpointed else None)


def result_dict(res) -> dict:
    return {
        "result_keys": [int(x) for x in res.result_keys],
        "result_states": [[int(x) for x in row]
                          for row in res.result_states],
        "steps": res.steps, "candidates": res.candidates,
        "expanded": res.expanded, "pruned": res.pruned,
        "spilled": res.spilled, "refilled": res.refilled,
        "late_pruned": res.late_pruned, "syncs": res.syncs,
        "host_syncs": res.host_syncs, "rebalanced": res.rebalanced}


def _arm_kill_at_step(eng, n: int):
    """SIGKILL at the first host-read boundary where ``steps >= n``, with
    the writer thread possibly mid-flush."""
    inner = eng.step

    def step(st, max_inner=None):
        out = inner(st, max_inner=max_inner)
        if out.steps >= n:
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    eng.step = step


def _arm_kill_in_commit(n: int):
    """SIGKILL inside the ``n``-th commit, after the tmp dir is complete
    and before the rename."""
    from repro_torch.checkpoint.manager import CheckpointManager
    count = [0]
    inner = CheckpointManager._commit

    def commit(self, tmp, final):
        count[0] += 1
        if count[0] >= n:
            os.kill(os.getpid(), signal.SIGKILL)
        return inner(self, tmp, final)

    CheckpointManager._commit = commit


def build_engine(spec: dict, checkpointed: bool, ref: bool = False):
    """The reference's or the port's ``Engine`` (1 shard) or
    ``ShardedEngine`` (more) for ``spec``."""
    if ref:
        from repro.core.engine import Engine, EngineConfig
        from repro.distributed import ShardedEngine
    else:
        from repro_torch.core.engine import Engine, EngineConfig
        from repro_torch.distributed import ShardedEngine
    cfg = EngineConfig(**engine_config(spec, checkpointed))
    return (ShardedEngine if cfg.shards > 1 else Engine)(
        make_workload(spec["kind"], spec["seed"], ref=ref), cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True, help="JSON workload spec")
    ap.add_argument("--mode", required=True,
                    choices=("crash", "resume", "oracles"))
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)
    if args.mode == "oracles":    # {name: spec} -> the reference's results
        print("RESULT " + json.dumps({
            name: result_dict(build_engine(s, False, ref=True).run())
            for name, s in spec.items()}), flush=True)
        return 0
    eng = build_engine(spec, checkpointed=True)
    if args.mode == "crash":
        if spec.get("kill_in_commit"):
            _arm_kill_in_commit(int(spec["kill_in_commit"]))
        if spec.get("kill_at_step"):
            _arm_kill_at_step(eng, int(spec["kill_at_step"]))
        # spec["resume"] arms a second crash cycle from the newest commit
        eng.run(resume=bool(spec.get("resume")))
        print("crash mode survived to completion", file=sys.stderr)
        return 3
    res = eng.run(resume=True)
    print("RESULT " + json.dumps(result_dict(res), sort_keys=True),
          flush=True)
    return 0


# ------------------------------------------------------------ the parent
def _run_child(spec: dict, mode: str, timeout: int = 300, env=None):
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = SRC
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--spec",
         json.dumps(spec), "--mode", mode],
        capture_output=True, text=True, timeout=timeout, env=env)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
    return proc.returncode, result, proc.stderr


def _crash_resume_cycle(tmp_path, spec, oracle, kill, second_kill=None):
    spec = dict(spec, ckpt_dir=str(tmp_path / "ckpt"),
                spill_dir=str(tmp_path / "spill_oracle"))
    assert any(k > np.iinfo(np.int32).min for k in oracle["result_keys"])
    steps = oracle["steps"]
    assert steps > spec["checkpoint_every"] + 2, steps
    if callable(kill):
        kill = kill(steps)
    if callable(second_kill):
        second_kill = second_kill(steps)

    rc, res, err = _run_child(dict(spec, spill_dir=str(
        tmp_path / "spill_crash"), **kill), "crash")
    assert rc == -9, f"crash child did not die by SIGKILL (rc={rc}): {err}"
    assert res is None
    if second_kill is not None:
        rc, res, err = _run_child(dict(spec, spill_dir=str(
            tmp_path / "spill_crash2"), resume=True, **second_kill), "crash")
        assert rc == -9, f"second crash survived (rc={rc}): {err}"

    resume_dir = str(tmp_path / "spill_resume")
    rc, resumed, err = _run_child(dict(spec, spill_dir=resume_dir), "resume")
    assert rc == 0, err
    assert resumed == oracle, f"resumed:\n{resumed}\noracle:\n{oracle}"
    leaks = [d for d in os.listdir(spec["ckpt_dir"]) if d.endswith(".tmp")]
    assert not leaks, leaks
    if os.path.isdir(resume_dir):
        assert not [f for _, _, fs in os.walk(resume_dir) for f in fs]


def _fuzz_step(seed: int, lo: int, hi: int) -> int:
    return int(np.random.default_rng(seed).integers(lo, hi))


CELLS = {
    # clique/host: SIGKILL at a fuzzed step, resume, SIGKILL again later,
    # resume again — repeated crashes still converge to the oracle
    "kill_at_fuzzed_step_then_again": (
        dict(kind="clique", seed=31, spill="host", T=1, checkpoint_every=8),
        lambda steps: {"kill_at_step": _fuzz_step(101, 9, steps - 4)},
        lambda steps: {"kill_at_step": _fuzz_step(102, steps - 3,
                                                  steps - 1)}),
    # iso/disk, macro-stepped: SIGKILL between tmp-write and rename of the
    # 2nd commit — the newest committed step (the 1st) restores
    "kill_inside_commit_window": (
        dict(kind="iso", seed=32, spill="disk", T=4, checkpoint_every=16),
        {"kill_in_commit": 2}, None),
    # clique/disk: SIGKILL inside the first commit — nothing committed, the
    # resume starts fresh and still matches
    "kill_before_first_commit": (
        dict(kind="clique", seed=33, spill="disk", T=2, checkpoint_every=8),
        {"kill_in_commit": 1}, None),
    # weighted-clique/disk: a fuzzed mid-run SIGKILL on the widest state
    "kill_at_step_weighted_clique": (
        dict(kind="weighted-clique", seed=34, spill="disk", T=2,
             checkpoint_every=8),
        lambda steps: {"kill_at_step": _fuzz_step(104, 9, steps - 1)}, None),
    # iso × 2 shards with stale bounds (K=2) and macro-steps (T=2): the
    # per-shard queue snapshots and the one manifest restore together
    "kill_at_step_2shards": (
        dict(kind="iso", seed=35, spill="disk", shards=2, T=2, K=2,
             checkpoint_every=8),
        lambda steps: {"kill_at_step": _fuzz_step(105, 9, steps - 1)}, None),
    # clique × 2 shards, host spill: SIGKILL inside a commit with sharded
    # state — the shard{i} subdirs commit or vanish together
    "kill_inside_commit_2shards": (
        dict(kind="clique", seed=36, spill="host", shards=2, T=1, K=4,
             checkpoint_every=8),
        {"kill_in_commit": 2}, None),
    # clique × 8 shards: a fuzzed mid-run kill
    "kill_at_step_8shards": (
        dict(kind="clique", seed=37, spill="disk", shards=8, T=2, K=2,
             checkpoint_every=8),
        lambda steps: {"kill_at_step": _fuzz_step(107, 9, steps - 1)}, None),
    # weighted-clique × 8 shards: a kill inside a commit at scale
    "kill_inside_commit_8shards": (
        dict(kind="weighted-clique", seed=38, spill="host", shards=8, T=1,
             K=1, checkpoint_every=8),
        {"kill_in_commit": 2}, None),
}


@pytest.fixture(scope="module")
def sharded_oracles():
    """The reference's uninterrupted ShardedEngine runs of the sharded
    cells, from one subprocess with 8 forced host devices."""
    specs = {name: CELLS[name][0] for name in CELLS
             if CELLS[name][0].get("shards", 1) > 1}
    rc, result, err = _run_child(
        specs, "oracles", timeout=600,
        env=dict(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    assert rc == 0 and result is not None, err[-3000:]
    return result


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_crash_and_resume_equals_reference(tmp_path, request, cell):
    spec, kill, second_kill = CELLS[cell]
    if spec.get("shards", 1) > 1:
        oracle = request.getfixturevalue("sharded_oracles")[cell]
    else:
        oracle = result_dict(build_engine(dict(
            spec, spill_dir=str(tmp_path / "spill_oracle")), False,
            ref=True).run())
    _crash_resume_cycle(tmp_path, spec, oracle, kill, second_kill)


if __name__ == "__main__":
    sys.exit(main())
