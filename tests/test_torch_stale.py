"""Stale bounds and macro-steps under shards (the reference's DESIGN.md §13,
§14) in the port's ``ShardedEngine``, on the CPU against the reference —
the port of tests/test_stale_bound.py and of tests/test_macro_engine.py's
sharded cases:

* the fuzzed matrix (clique 11, 12, iso 13, weighted clique 14 × shards
  {1, 2, 8} × ``sync_every`` K {1, 2, 4, 8} × ``steps_per_sync`` T {1, 4}),
  each answer byte for byte the reference's single-device ``Engine``'s and
  ``syncs == ceil(steps / K)``;
* against the reference's ``ShardedEngine`` (every counter, every
  ``per_shard`` list with the bound traces, the pools, result sets,
  threshold and occupancies after every macro-step, the answer), a subset
  of the matrix that holds each (shards, K) pair once, the bound-trace
  runs, the budget cuts, and the sharded macro cases of
  tests/test_macro_engine.py (its dense spill graph at T 4 and 16, the
  disk spill's cleanup);
* the bound traces: used <= fresh, fresh monotone, equal at K = 1;
  ``syncs == ceil(steps / K)`` over K × T; a budget cuts at the same step
  for every (K, T); one scoring call a shard an enqueued inner step.

Every comparison is exact: bytes and counts, no tolerance.  The reference
runs every case once, in one subprocess of this file under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (one JAX device a
shard), as tests/test_torch_sharded.py's does; the port runs in the test
process.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.core import engine
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.iso import build_iso_index, make_iso_computation
from repro_torch.core.weighted_clique import make_weighted_clique_computation
from repro_torch.data import synthetic_graphs as gen
from repro_torch.distributed import ShardedEngine
from test_torch_sharded import _drive, _record

REPO = pathlib.Path(__file__).resolve().parent.parent
SHARDS = (1, 2, 8)
KS = (1, 2, 4, 8)
TS = (1, 4)
KINDS = (("clique", 11), ("clique", 12), ("iso", 13), ("weighted-clique", 14))
# tests/test_stale_bound.py's _CFG, and tests/test_macro_engine.py's
# clique_setup (a dense graph and a small pool: spill, refill, late pruning)
CFG = dict(k=3, batch=8, pool_capacity=64, max_steps=50_000)
DENSE_CFG = dict(k=3, batch=8, pool_capacity=128, max_steps=100_000)
TRIANGLE = ([(0, 1), (1, 2), (0, 2)], [1, 1, 1])


def _cases() -> dict:
    """name -> case run by both packages' ``ShardedEngine``: ``workload``
    (kind, seed), ``shards``, EngineConfig fields, ``budget`` (cut at half
    the unfused run's steps)."""
    cases = {}
    # each (shards, K) pair once; the workload and T rotate
    for si, shards in enumerate(SHARDS):
        for ki, K in enumerate(KS):
            kind, seed = KINDS[(si + ki) % len(KINDS)]
            T = (4, 1)[ki % 2]
            cases[f"{kind}{seed}-x{shards}-K{K}-T{T}"] = dict(
                workload=(kind, seed), shards=shards,
                cfg=dict(CFG, sync_every=K, steps_per_sync=T))
    for shards in SHARDS:
        for K in (1, 4):
            cases[f"trace-x{shards}-K{K}"] = dict(
                workload=("clique", 21), shards=shards,
                cfg=dict(CFG, sync_every=K, steps_per_sync=4,
                         record_bound_trace=True))
        cases[f"budget-x{shards}"] = dict(
            workload=("clique", 41), shards=shards, budget=True,
            cfg=dict(CFG, sync_every=2, steps_per_sync=4))
        for T in (4, 16):
            cases[f"macro-x{shards}-T{T}"] = dict(
                workload=("dense", 0), shards=shards,
                cfg=dict(DENSE_CFG, steps_per_sync=T))
    cases["macro-disk-x2-T16"] = dict(
        workload=("planted", 1), shards=2,
        cfg=dict(CFG, spill="disk", steps_per_sync=16))
    return cases


CASES = _cases()
PARTS = 2           # reference subprocesses, run at once
ENGINE_WORKLOADS = KINDS + (("dense", 0), ("planted", 1))


def _workload(kind: str, seed: int, ref: bool):
    """tests/test_stale_bound.py's ``_make_workload`` (and the macro
    cases' graphs) in the reference (``ref``) or in the port, on the
    CPU."""
    if ref:
        from repro.core.clique import make_clique_computation as clique
        from repro.core.iso import build_iso_index as index
        from repro.core.iso import make_iso_computation as iso
        from repro.core.weighted_clique import \
            make_weighted_clique_computation as weighted
        from repro.data import synthetic_graphs as graphs
        dev = {}
    else:
        clique, iso, weighted, graphs = (
            make_clique_computation, make_iso_computation,
            make_weighted_clique_computation, gen)
        dev = dict(device="cpu")

        def index(g, max_hops):
            return build_iso_index(g, max_hops, device="cpu")
    if kind == "dense":
        return clique(graphs.densifying_graph(96, 900, seed=seed), **dev)
    if kind == "planted":
        return clique(graphs.planted_clique_graph(80, 300, 6, seed), **dev)
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 72))
    m = int(rng.integers(2 * n, 5 * n))
    if kind == "clique":
        return clique(graphs.densifying_graph(n, m, seed=seed), **dev)
    if kind == "weighted-clique":
        g = graphs.densifying_graph(n, m, seed=seed)
        return weighted(g, rng.integers(1, 20, g.n), **dev)
    g = graphs.labeled_graph(n=n, m=m, n_labels=3, seed=seed)
    return iso(g, *TRIANGLE, index(g, max_hops=2), **dev)


def _config(make, sharded, comp, case: dict, spill_root: pathlib.Path):
    """The case's EngineConfig (``make``); a budget is half the steps of
    the unfused run at the same shard count (``sharded`` is that
    package's ShardedEngine)."""
    fields = dict(case["cfg"], shards=case["shards"])
    if fields.get("spill") == "disk":
        fields["spill_dir"] = str(spill_root)
    if case.get("budget"):
        full = sharded(comp, make(**CFG, shards=case["shards"])).run()
        fields["max_steps"] = max(2, full.steps // 2)
    return make(**fields)


def _reference_child(out: pathlib.Path, part: int) -> None:
    """Every ``PARTS``-th case from ``part`` on through the reference's
    ShardedEngine, and in part 0 each workload through its single-device
    Engine (this file as a script, with 8 forced host devices); each
    record to ``out``."""
    from repro.core import engine as ref_engine
    from repro.distributed import ShardedEngine as RefShardedEngine
    for kind, seed in ENGINE_WORKLOADS if part == 0 else ():
        cfg = DENSE_CFG if kind == "dense" else CFG
        res = ref_engine.Engine(_workload(kind, seed, ref=True),
                                ref_engine.EngineConfig(**cfg)).run()
        np.savez(out / f"engine-{kind}{seed}.npz",
                 keys=np.asarray(res.result_keys),
                 states=np.asarray(res.result_states))
    for name, case in list(CASES.items())[part::PARTS]:
        comp = _workload(*case["workload"], ref=True)
        cfg = _config(ref_engine.EngineConfig, RefShardedEngine, comp, case,
                      out / "spill" / name)
        counters, arrays = _record(*_drive(RefShardedEngine(comp, cfg),
                                           cfg.max_steps))
        np.savez(out / f"{name}.npz", **arrays)
        (out / f"{name}.json").write_text(json.dumps(counters))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(name -> (counters, arrays) of the reference's sharded run of each
    case, (kind, seed) -> (keys, states) of its single-device run)."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ,            # a stripped env can stall JAX start-up
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(out), str(part)],
                              env=env, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for part in range(PARTS)]
    try:
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-3000:]
    sharded = {name: (json.loads((out / f"{name}.json").read_text()),
                      dict(np.load(out / f"{name}.npz")))
               for name in CASES}
    single = {}
    for kind, seed in ENGINE_WORKLOADS:
        arrays = np.load(out / f"engine-{kind}{seed}.npz")
        single[kind, seed] = (arrays["keys"], arrays["states"])
    return sharded, single


@pytest.fixture(scope="module")
def comps():
    """(kind, seed) -> the port's computation, made once a module."""
    done = {}

    def get(kind, seed):
        if (kind, seed) not in done:
            done[kind, seed] = _workload(kind, seed, ref=False)
        return done[kind, seed]
    return get


def _run(comp, **fields) -> engine.EngineResult:
    return ShardedEngine(comp, engine.EngineConfig(**fields)).run()


def _same_answer(res, keys, states, ctx) -> None:
    assert res.result_keys.dtype == keys.dtype, ctx
    assert res.result_keys.tobytes() == keys.tobytes(), ctx
    assert res.result_states.tobytes() == states.tobytes(), ctx


# ----------------------------------------------------- fuzzed parity matrix
@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("workload", KINDS, ids=lambda w: f"{w[0]}{w[1]}")
def test_stale_parity_fuzzed(reference, comps, workload, shards, K, T):
    """A complete run gives the reference's single-device answer byte for
    byte at every (shards, K, T), with one exchange a segment."""
    res = _run(comps(*workload), **CFG, shards=shards, sync_every=K,
               steps_per_sync=T)
    _same_answer(res, *reference[1][workload], (workload, shards, K, T))
    assert res.syncs == math.ceil(res.steps / K)


# ------------------------------------------- against the reference, exactly
@pytest.mark.parametrize("name", list(CASES))
def test_stale_matches_reference_sharded_engine(reference, comps, name,
                                                tmp_path):
    """Every counter, every per_shard list (the bound traces among them),
    the pools, result sets, threshold and occupancies after every
    macro-step, and the answer: the reference's ShardedEngine's."""
    want_counters, want_arrays = reference[0][name]
    case = CASES[name]
    comp = comps(*case["workload"])
    cfg = _config(engine.EngineConfig, ShardedEngine, comp, case, tmp_path)
    got_counters, got_arrays = _record(*_drive(ShardedEngine(comp, cfg),
                                               cfg.max_steps))
    assert got_counters == want_counters
    for key, want in want_arrays.items():
        assert got_arrays[key].dtype == want.dtype, key
        assert got_arrays[key].tobytes() == want.tobytes(), key
    if cfg.spill == "disk":          # every run file gone
        dirs = [tmp_path / f"shard{i}" for i in range(case["shards"])]
        assert all(d.is_dir() and not any(d.iterdir()) for d in dirs)


def test_reference_cases_cover_every_shards_k_pair():
    pairs = {(c["shards"], c["cfg"]["sync_every"]) for c in CASES.values()
             if "sync_every" in c["cfg"]}
    assert pairs >= {(s, k) for s in SHARDS for k in KS}


# --------------------------------------------- monotonicity: stale <= fresh
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("shards", SHARDS)
def test_stale_bound_never_exceeds_fresh(reference, comps, shards, K):
    """The bound a shard prunes with is never above the fresh exchange at
    the same inner step, equals it at K = 1, and equals it at the segment
    heads; the fresh bound never falls.  Both traces are the
    reference's."""
    res = _run(comps("clique", 21), **CASES[f"trace-x{shards}-K{K}"]["cfg"],
               shards=shards)
    used = np.asarray(res.per_shard["bound_used"])
    fresh = np.asarray(res.per_shard["bound_fresh"])
    assert used.shape == fresh.shape == (shards, res.steps)
    assert np.all(used <= fresh)
    assert np.all(np.diff(fresh, axis=1) >= 0)
    if K == 1:
        np.testing.assert_array_equal(used, fresh)
    else:
        assert np.any(used == fresh)
    want = reference[0][f"trace-x{shards}-K{K}"][0]["per_shard"]
    assert res.per_shard["bound_used"] == want["bound_used"]
    assert res.per_shard["bound_fresh"] == want["bound_fresh"]


# ------------------------------------------------ collective-count contract
@pytest.mark.parametrize("shards", SHARDS)
def test_syncs_count_is_ceil_steps_over_k(comps, shards):
    for K in KS:
        for T in TS:
            res = _run(comps("clique", 31), **CFG, shards=shards,
                       sync_every=K, steps_per_sync=T)
            assert res.syncs == math.ceil(res.steps / K), (K, T)
            assert res.host_syncs <= res.syncs


# ------------------------------------------------------- budget truncation
@pytest.mark.parametrize("shards", SHARDS)
def test_budget_truncates_identically_across_k(comps, shards):
    """``max_steps`` cuts at the same step for every (K, T) at one shard
    count, with the same answer (``run`` caps each macro-step's inner
    steps at the budget left)."""
    comp = comps("clique", 41)
    budget = max(2, _run(comp, **CFG, shards=shards).steps // 2)
    first = None
    for K in (1, 2, 4):
        for T in TS:
            res = _run(comp, **dict(CFG, max_steps=budget), shards=shards,
                       sync_every=K, steps_per_sync=T)
            assert res.steps == budget, (K, T)
            first = first or res
            _same_answer(res, first.result_keys, first.result_states, (K, T))


# ------------------------------------- tests/test_macro_engine.py's sharded
@pytest.mark.parametrize("shards", SHARDS)
def test_sharded_macro_parity(reference, comps, shards):
    """Fused sharded runs give the unfused single-device answer; the
    exchange inside the fused loop and the global exit vote keep the spill
    accounting of the unfused sharded run."""
    comp = comps("dense", 0)
    unfused = _run(comp, **DENSE_CFG, shards=shards)
    for T in (4, 16):
        res = _run(comp, **DENSE_CFG, shards=shards, steps_per_sync=T)
        _same_answer(res, *reference[1]["dense", 0], T)
        assert res.host_syncs < res.steps or res.steps <= 1
        assert res.syncs == res.steps       # K = 1: one exchange a step
        assert res.spilled == unfused.spilled > 0
        assert res.late_pruned == unfused.late_pruned


def test_sharded_macro_disk_spill_cleanup(reference, comps, tmp_path):
    res = _run(comps("planted", 1), **CASES["macro-disk-x2-T16"]["cfg"],
               shards=2, spill_dir=str(tmp_path))
    _same_answer(res, *reference[1]["planted", 1], "disk")
    assert res.spilled > 0
    for i in range(2):
        assert not any((tmp_path / f"shard{i}").iterdir())


# --------------------------------------------------------- launches a step
@pytest.mark.parametrize("K", [1, 4])
def test_every_shard_scores_every_enqueued_step(comps, K):
    """One scoring call (one masked_intersect launch on the card) a shard
    for every inner step a macro-step enqueues, its no-op steps after the
    exit vote too: ``shards x sum(t_cap)``."""
    comp = comps("dense", 0)
    calls = []

    def score(states):
        calls.append(states.shape[0])
        return comp.score_children(states)

    eng = ShardedEngine(dataclasses.replace(comp, score_children=score),
                        engine.EngineConfig(**DENSE_CFG, shards=8,
                                            steps_per_sync=16, sync_every=K))
    st, caps = eng.start(), []
    while not st.done:
        caps.append(min(eng.T, eng.cfg.max_steps - st.steps))
        eng.step(st, max_inner=eng.cfg.max_steps - st.steps)
    res = eng.finalize(st)
    assert len(calls) == 8 * sum(caps) and set(calls) == {8}
    assert sum(caps) > res.steps        # no-op steps were enqueued
    assert res.host_syncs == len(caps)


def test_sync_every_is_clamped_to_the_accumulator(comps):
    """K is clamped so that one segment's blocks fit ``overflow_accum``,
    and T raised to a multiple of K (and to 2 under bound traces), as in
    the reference."""
    comp = comps("clique", 11)
    blk = CFG["batch"] + comp.num_actions

    def make(**fields):
        return ShardedEngine(comp, engine.EngineConfig(**CFG, shards=2,
                                                       **fields))
    assert (make(sync_every=4, overflow_accum=2 * blk).K,
            make(sync_every=4, overflow_accum=2 * blk).T) == (2, 2)
    assert (make(sync_every=3, steps_per_sync=4).K,
            make(sync_every=3, steps_per_sync=4).T) == (3, 6)
    assert make(record_bound_trace=True).T == 2
    assert make().T == 1


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]), int(sys.argv[2]))
