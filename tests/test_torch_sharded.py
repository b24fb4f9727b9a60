"""The port's sharded engine (``repro_torch.distributed``) on the CPU against
the reference's ``ShardedEngine``: byte for byte on result_keys /
result_states and on the pools and result sets after every step or
macro-step (the global layout the sharded checkpoint saves), with the
threshold and the pool occupancies the host holds there, equal on every
``EngineResult`` counter and every ``per_shard`` list —
tests/test_distributed_engine.py's clique and iso cases at 1, 2 and 8
shards, tests/test_labeled.py's labeled iso with both label filters at 1,
2 and 8 shards, its skewed case (spill, refill, rebalance, late pruning) at 2 and
8 with host and disk spill, and seeded random small configs (k, B, C,
``max_children``, ``max_steps`` truncation, odd shard counts); then the
same in macro-steps (``steps_per_sync``) with stale bounds
(``sync_every``): the skewed case with bound traces, clique, iso, and
random configs with the least ``overflow_accum`` (K clamped, the vote on a
full accumulator).  tests/test_torch_stale.py holds the reference's
tests/test_stale_bound.py matrices.

The reference needs one JAX device a shard, so its runs take one
subprocess of this file under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
tests/test_distributed_engine.py's ``_run_forced`` does), which writes
each case's result to a temporary directory; the port runs each case in
the test process.  Also here: ``sharded_bound`` against the reference's
collective, ``shards=1`` against the port's ``Engine``, one scoring call a
shard a step, and the disk spill's ``shard{i}`` directories left empty.
The sharded checkpoint is tests/test_torch_sharded_checkpoint.py's.
"""
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.core.graph import GraphStore as RefGraphStore
from repro.core.iso import build_iso_index as ref_build_iso_index
from repro.core.iso import make_iso_computation as ref_make_iso
from repro.core.labels import LabelPredicate as RefLabelPredicate
from repro.data import synthetic_graphs as ref_gen
from repro_torch.core import engine
from repro_torch.core.api import NEG
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.graph import GraphStore
from repro_torch.core.iso import build_iso_index, make_iso_computation
from repro_torch.core.labels import LabelPredicate
from repro_torch.data import synthetic_graphs as gen
from repro_torch.distributed import ShardedEngine

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "rebalanced", "late_pruned", "syncs", "host_syncs")
STATE_ARRAYS = ("pool_states", "pool_prio", "pool_ub", "result_states",
                "result_keys")
TRIANGLE = ([(0, 1), (1, 2), (0, 2)], [1, 1, 1])
# tests/test_distributed_engine.py's skewed case: a 12-clique on the even
# vertices 0-22 of densifying_graph(96, 500, seed=3), tiny pools
SKEWED_CFG = dict(k=3, batch=8, pool_capacity=64, max_steps=50_000)
SKEWED_MACRO = dict(steps_per_sync=4, sync_every=2, record_bound_trace=True)
# tests/test_labeled.py's sharded labeled iso
LABELED_PREDICATE = {"vertex_any_of": [1, 2],
                     "q_any_of": [[1, 2], [1], [1, 2]]}
LABEL_FILTERS = ("pushdown", "post")


def _cases() -> dict:
    """name -> case: ``graph`` (generator name and arguments, or
    "skewed"), ``hops`` for the iso triangle (``label_filter`` under
    :data:`LABELED_PREDICATE`), ``shards`` and the EngineConfig fields."""
    cases = {}
    for s in (1, 2, 8):
        cases[f"clique-x{s}"] = dict(
            graph=("planted_clique_graph", (80, 300, 6, 1)), shards=s,
            cfg=dict(k=3, batch=16, pool_capacity=512, max_steps=50_000))
        cases[f"iso-x{s}"] = dict(
            graph=("labeled_graph", (60, 150, 3, 5)), hops=2, shards=s,
            cfg=dict(k=3, batch=16, pool_capacity=1024, max_steps=50_000))
        for lf in LABEL_FILTERS:
            cases[f"labeled-{lf}-x{s}"] = dict(
                graph=("labeled_graph", (50, 160, 3, 7)), hops=2, shards=s,
                label_filter=lf,
                cfg=dict(k=4, batch=16, pool_capacity=1024, max_steps=50_000))
    for s in (2, 8):
        for spill in ("host", "disk"):
            cases[f"skewed-{spill}-x{s}"] = dict(
                graph="skewed", shards=s, cfg=dict(SKEWED_CFG, spill=spill))
    # macro-steps and stale bounds; the first is chip_smoke.py's phase 13d
    cases["skewed-host-x2-T4-K2-trace"] = dict(
        graph="skewed", shards=2, cfg=dict(SKEWED_CFG, **SKEWED_MACRO))
    cases["skewed-disk-x8-T16-K4"] = dict(
        graph="skewed", shards=8,
        cfg=dict(SKEWED_CFG, spill="disk", steps_per_sync=16, sync_every=4))
    cases["clique-x8-T16"] = dict(
        graph=("planted_clique_graph", (80, 300, 6, 1)), shards=8,
        cfg=dict(k=3, batch=16, pool_capacity=512, max_steps=50_000,
                 steps_per_sync=16))
    cases["iso-x2-T4-K4"] = dict(
        graph=("labeled_graph", (60, 150, 3, 5)), hops=2, shards=2,
        cfg=dict(k=3, batch=16, pool_capacity=1024, max_steps=50_000,
                 steps_per_sync=4, sync_every=4))
    rng = np.random.default_rng(2026)
    for j in range(5):
        n = int(rng.integers(40, 97))
        batch = int(rng.choice([1, 2, 4, 8]))
        shards = int(rng.choice([2, 3, 5, 8]))
        cfg = dict(
            k=int(rng.choice([1, 2, 3, 5])), batch=batch,
            pool_capacity=int(rng.integers(max(batch, 8), 129)),
            max_children=(None if rng.random() < 0.5
                          else int(rng.integers(n, batch * n + 1))),
            max_steps=(50_000 if rng.random() < 0.6
                       else int(rng.integers(3, 16))),
            spill=str(rng.choice(["host", "disk"])))
        cases[f"random{j}-x{shards}"] = dict(
            graph=("densifying_graph", (n, int(rng.integers(2 * n, 8 * n)),
                                        j)),
            shards=shards, cfg=cfg)
    # random macro configs: T, K, the least overflow_accum (one block: K
    # clamps to 1, and the vote stops on a full accumulator) or none
    rng = np.random.default_rng(2027)
    for j in range(4):
        n = int(rng.integers(40, 97))
        batch = int(rng.choice([2, 4, 8]))
        shards = int(rng.choice([2, 3, 8]))
        cfg = dict(
            k=int(rng.choice([1, 3, 5])), batch=batch,
            pool_capacity=int(rng.integers(max(batch, 16), 129)),
            max_steps=(50_000 if j % 2 == 0 else int(rng.integers(5, 30))),
            spill=str(rng.choice(["host", "disk"])),
            steps_per_sync=int(rng.choice([2, 3, 16])),
            sync_every=int(rng.choice([1, 2, 3, 5])),
            overflow_accum=(None if j < 2 else batch + n))
        cases[f"macro{j}-x{shards}"] = dict(
            graph=("densifying_graph", (n, int(rng.integers(2 * n, 8 * n)),
                                        10 + j)),
            shards=shards, cfg=cfg)
    return cases


CASES = _cases()


def _skewed(gen_mod, graph_store):
    g = gen_mod.densifying_graph(96, 500, seed=3)
    members = np.arange(0, 24, 2)
    extra = [(int(u), int(v)) for i, u in enumerate(members)
             for v in members[i + 1:]]
    return graph_store.from_edges(
        96, np.concatenate([g.edge_array, np.array(extra, np.int64)]))


def _computation(case: dict, ref: bool):
    """The case's computation in the reference (``ref``) or in the port, on
    the CPU."""
    if case["graph"] == "skewed":
        g = _skewed(ref_gen if ref else gen,
                    RefGraphStore if ref else GraphStore)
    else:
        fn, args = case["graph"]
        g = getattr(ref_gen if ref else gen, fn)(*args)
    if "hops" in case:
        labeled = {}
        if "label_filter" in case:
            labeled = dict(predicate=(RefLabelPredicate if ref
                                      else LabelPredicate).from_spec(
                LABELED_PREDICATE), label_filter=case["label_filter"])
        if ref:
            return ref_make_iso(g, *TRIANGLE,
                                ref_build_iso_index(g, max_hops=case["hops"]),
                                **labeled)
        return make_iso_computation(
            g, *TRIANGLE, build_iso_index(g, case["hops"], device="cpu"),
            device="cpu", **labeled)
    return ref_make_clique(g) if ref else make_clique_computation(
        g, device="cpu")


def _config(make, case: dict, spill_root: pathlib.Path):
    fields = dict(case["cfg"], shards=case["shards"])
    if fields.get("spill") == "disk":
        fields["spill_dir"] = str(spill_root)
    return make(**fields)


def _state_arrays(st) -> dict:
    return {name: np.asarray(getattr(st, name)) for name in STATE_ARRAYS}


def _drive(eng, max_steps: int):
    """``run()``'s loop: (result, a digest of the pools and result sets,
    the threshold and the pool occupancies after the start and after each
    step, the final arrays as numpy arrays)."""
    st = eng.start()
    digests = []
    while True:
        held = repr((int(st.threshold), st.pool_occupancy.tolist()))
        digests.append(hashlib.sha1(b"".join(
            a.tobytes() for a in _state_arrays(st).values())
            + held.encode()).hexdigest())
        if st.done or st.steps >= max_steps:
            break
        eng.step(st, max_inner=max_steps - st.steps)
    arrays = _state_arrays(st)
    return eng.finalize(st), digests, arrays


def _record(res, digests: list, arrays: dict) -> tuple:
    """(counters, per_shard lists and state digests, arrays to compare) of
    a run."""
    arrays = dict(arrays, final_keys=np.asarray(res.result_keys),
                  final_states=np.asarray(res.result_states))
    counters = {name: int(getattr(res, name)) for name in COUNTERS}
    counters.update(per_shard=res.per_shard, digests=digests)
    return counters, arrays


def _reference_child(out: pathlib.Path) -> None:
    """Run every case through the reference's ShardedEngine (this file as
    a script, with 8 forced host devices) and write each one's record."""
    from repro.distributed import ShardedEngine as RefShardedEngine
    for name, case in CASES.items():
        cfg = _config(ref_engine.EngineConfig, case, out / "spill" / name)
        counters, arrays = _record(*_drive(
            RefShardedEngine(_computation(case, ref=True), cfg),
            cfg.max_steps))
        np.savez(out / f"{name}.npz", **arrays)
        (out / f"{name}.json").write_text(json.dumps(counters))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """name -> (counters, arrays) of the reference's run of each case."""
    out = tmp_path_factory.mktemp("reference")
    env = dict(os.environ,            # a stripped env can stall JAX start-up
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {name: (json.loads((out / f"{name}.json").read_text()),
                   dict(np.load(out / f"{name}.npz")))
            for name in CASES}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``port_runs(name)`` -> (counters, arrays, spill root) of the port's
    run of a case, run once a module."""
    done = {}

    def run(name):
        if name not in done:
            case = CASES[name]
            root = tmp_path_factory.mktemp("port") / name
            cfg = _config(engine.EngineConfig, case, root)
            done[name] = _record(*_drive(
                ShardedEngine(_computation(case, ref=False), cfg),
                cfg.max_steps)) + (root,)
        return done[name]
    return run


# ------------------------------------------------------------ the parity
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_engine_matches_reference(reference, port_runs, name):
    want_counters, want_arrays = reference[name]
    got_counters, got_arrays, spill_root = port_runs(name)
    assert got_counters == want_counters
    for key, want in want_arrays.items():
        assert got_arrays[key].dtype == want.dtype, key
        assert got_arrays[key].tobytes() == want.tobytes(), key
    if CASES[name]["cfg"].get("spill") == "disk":   # every run file gone
        dirs = [spill_root / f"shard{i}" for i in range(CASES[name]["shards"])]
        assert all(d.is_dir() and not any(d.iterdir()) for d in dirs)


def test_skewed_case_exercises_every_host_path(reference):
    """The 2-shard skewed case spills, refills, rebalances and prunes
    late, with the reference's counters (the table the port was sized
    from)."""
    counters, arrays = reference["skewed-host-x2"]
    assert list(arrays["final_keys"]) == [12, 11, 11]
    assert len(counters["digests"]) == counters["steps"] + 1
    assert {name: counters[name] for name in COUNTERS} == dict(
        steps=19, candidates=676, expanded=138, pruned=128, spilled=437,
        refilled=9, rebalanced=18, late_pruned=410, syncs=19, host_syncs=19)
    assert counters["per_shard"] == dict(
        spilled=[359, 78], late_pruned=[341, 69], vpq_backlog=[0, 0],
        pool_occupancy=[0, 0])
    assert reference["skewed-disk-x2"][0] == counters


def test_skewed_macro_case_with_bound_traces(reference):
    """The skewed case at T = 4, K = 2 with bound traces (chip_smoke.py's
    phase 13d holds the card to this table): 10 exchanges in 20 steps, 6
    host reads, the used bound below the fresh one on shard 1 at steps 6,
    8 and 10 (segment tails)."""
    counters, arrays = reference["skewed-host-x2-T4-K2-trace"]
    assert list(arrays["final_keys"]) == [12, 11, 11]
    assert {name: counters[name] for name in COUNTERS} == dict(
        steps=20, candidates=673, expanded=135, pruned=131, spilled=437,
        refilled=11, rebalanced=19, late_pruned=407, syncs=10, host_syncs=6)
    fresh = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10] + [11] * 10
    assert counters["per_shard"] == dict(
        spilled=[359, 78], late_pruned=[340, 67], vpq_backlog=[0, 0],
        pool_occupancy=[0, 0],
        bound_used=[fresh, [1, 2, 3, 4, 5, 5, 7, 7, 9, 9] + [11] * 10],
        bound_fresh=[fresh, fresh])


def test_labeled_iso_parity_sharded(reference, port_runs):
    """tests/test_labeled.py's sharded case: labeled top-k is
    byte-identical across the two label filters and 1, 2 and 8 shards, in
    the port as in the reference."""
    names = [name for name in CASES if name.startswith("labeled-")]
    assert len(names) == 6
    first = reference[names[0]][1]
    assert (first["final_keys"] != NEG).any()
    for name in names:
        for arrays in (reference[name][1], port_runs(name)[1]):
            for key in ("final_keys", "final_states"):
                assert arrays[key].tobytes() == first[key].tobytes(), \
                    (name, key)


def test_random_cases_cover_truncation_and_odd_shard_counts():
    cases = [c for name, c in CASES.items() if name.startswith("random")]
    assert any(c["cfg"]["max_steps"] < 50_000 for c in cases)
    assert any(c["shards"] not in (1, 2, 8) for c in cases)
    assert any(c["cfg"]["max_children"] is not None for c in cases)
    macro = [c["cfg"] for name, c in CASES.items()
             if name.startswith("macro")]
    assert any(c["overflow_accum"] for c in macro)
    assert any(c["max_steps"] < 50_000 for c in macro)
    assert any(c["sync_every"] > 1 for c in macro)


# ------------------------------------------------------- the bound exchange
def _stack(entries: dict, shards: int = 8, k: int = 3):
    """tests/test_distributed_engine.py's pack: {shard: [(state, key)]} ->
    the global ``[shards·k, 2]`` states and ``[shards·k]`` keys."""
    states = np.zeros((shards, k, 2), np.int32)
    keys = np.full((shards, k), NEG, np.int32)
    for i, rows in entries.items():
        for j, (s, key) in enumerate(rows):
            states[i, j], keys[i, j] = s, key
    return torch.from_numpy(states.reshape(-1, 2)), \
        torch.from_numpy(keys.reshape(-1))


@pytest.mark.parametrize("entries,want", [
    ({0: [((1, 1), 50), ((2, 2), 10), ((3, 3), 5)],
      3: [((4, 4), 40), ((5, 5), 30)],
      7: [((6, 6), 45), ((7, 7), 2)]}, 40),
    # the same state in two shards' sets counts once: 30, not 45
    ({0: [((1, 1), 50), ((2, 2), 10)],
      3: [((1, 1), 50), ((5, 5), 30)],
      7: [((6, 6), 45)]}, 30),
    ({}, NEG)], ids=["distinct", "duplicate", "empty"])
def test_sharded_bound_cases_of_the_reference(entries, want):
    got = engine.sharded_bound(*_stack(entries), 3)
    assert got.dtype == torch.int32 and int(got) == want


@pytest.mark.parametrize("seed", range(4))
def test_sharded_bound_matches_reference_merge(seed):
    """Random stacked result rows with duplicates across shards, key ties
    and empty slots: the reference's collective is ``merge_topk`` over the
    gathered rows, then its k-th key."""
    rng = np.random.default_rng(seed)
    shards, k, s = int(rng.integers(2, 9)), int(rng.integers(1, 6)), 4
    states = rng.integers(-2, 3, (shards * k, s)).astype(np.int32)
    keys = rng.integers(0, 5, shards * k).astype(np.int32)
    keys[rng.random(shards * k) < 0.3] = NEG
    for dst, src in rng.integers(0, shards * k, (shards, 2)):
        states[dst], keys[dst] = states[src], keys[src]
    _, want = ref_engine.merge_topk(jnp.asarray(states), jnp.asarray(keys), k)
    got = engine.sharded_bound(torch.from_numpy(states),
                               torch.from_numpy(keys), k)
    assert int(got) == int(want[k - 1])


# ---------------------------------------------------- one shard, one device
def _clique_comp():
    return make_clique_computation(gen.planted_clique_graph(80, 300, 6, 1),
                                   device="cpu")


def test_single_shard_is_the_engine():
    """ShardedEngine(shards=1) gives the port's Engine's answer; its
    counters are the reference ShardedEngine's (syncs = steps), not
    Engine's (syncs = 0)."""
    comp = _clique_comp()
    cfg = engine.EngineConfig(k=3, batch=16, pool_capacity=512,
                              max_steps=50_000)
    want = engine.Engine(comp, cfg).run()
    got = ShardedEngine(comp, dataclasses.replace(cfg, shards=1)).run()
    assert got.result_keys.tobytes() == want.result_keys.tobytes()
    assert got.result_states.tobytes() == want.result_states.tobytes()
    assert got.rebalanced == 0 and got.per_shard["spilled"] == [0]
    assert got.syncs == got.host_syncs == got.steps == want.steps
    assert want.syncs == 0


def test_shards_beyond_jax_devices_run_on_one_device():
    """The shard axis is logical: 16 shards on one device (the reference
    rejects more shards than JAX devices)."""
    comp = _clique_comp()
    cfg = engine.EngineConfig(k=3, batch=4, pool_capacity=32)
    want = engine.Engine(comp, cfg).run()
    got = ShardedEngine(comp, dataclasses.replace(cfg, shards=16)).run()
    assert got.result_keys.tobytes() == want.result_keys.tobytes()
    assert got.result_states.tobytes() == want.result_states.tobytes()
    assert len(got.per_shard["spilled"]) == 16


def test_every_shard_scores_every_step():
    """One ``score_children`` call (one masked_intersect launch on the
    card) a shard a step, a shard with an empty pool too."""
    comp = _computation(CASES["skewed-host-x8"], ref=False)
    calls = []

    def score(states):
        calls.append(states.shape[0])
        return comp.score_children(states)

    counted = dataclasses.replace(comp, score_children=score)
    eng = ShardedEngine(counted, engine.EngineConfig(**SKEWED_CFG, shards=8))
    st = eng.start()
    empty_scored = False
    while not st.done:
        empty_scored |= bool((st.pool_occupancy == 0).any())
        eng.step(st)
    res = eng.finalize(st)
    assert len(calls) == 8 * res.steps and set(calls) == {8}
    assert empty_scored


# ------------------------------------------------------------------ guards
@pytest.mark.parametrize("fields", [dict(shards=0), dict(sync_every=0)])
def test_bad_counts_raise_value_error(fields):
    with pytest.raises(ValueError, match="must be >= 1"):
        ShardedEngine(_clique_comp(), engine.EngineConfig(k=1, **fields))


if __name__ == "__main__":
    _reference_child(pathlib.Path(sys.argv[1]))
