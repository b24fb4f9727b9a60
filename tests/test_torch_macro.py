"""The port's macro-steps (``steps_per_sync = T > 1``) on the CPU against
the reference's at the same T: byte for byte on result_keys /
result_states and equal on every EngineResult counter, ``host_syncs``
included — tests/test_macro_engine.py's single-device matrix (clique at
T = 2 and 16, iso at T = 16, host and disk spill; the minimum overflow
accumulator; max_steps truncation; late pruning) and the clique and iso
cells of benchmarks/bench_engine.py at their --fast sizes."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.core.iso import build_iso_index as ref_build_iso_index
from repro.core.iso import make_iso_computation as ref_make_iso
from repro.data import synthetic_graphs as ref_gen
from repro_torch.core import engine
from repro_torch.core.api import NEG
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.iso import build_iso_index, make_iso_computation
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "rebalanced", "syncs", "host_syncs")
TRIANGLE = ([(0, 1), (1, 2), (0, 2)], [1, 1, 1])

# (computation, EngineConfig fields) of each cell: test_macro_engine.py's
# clique_setup and iso graph, bench_engine.py's --fast clique and iso cells
CELLS = {
    "clique": (("densifying_graph", (96, 900, 0), None),
               dict(k=3, batch=8, pool_capacity=128, max_steps=100_000)),
    "iso": (("labeled_graph", (60, 220, 3, 5), 2),
            dict(k=3, batch=4, pool_capacity=32, max_steps=100_000)),
    "bench_clique": (("densifying_graph", (96, 1200, 0), None),
                     dict(k=3, batch=4, pool_capacity=128,
                          max_steps=200_000)),
    "bench_iso": (("labeled_graph", (64, 300, 3, 5), 2),
                  dict(k=3, batch=4, pool_capacity=32, max_steps=200_000)),
}


def _computations(cell):
    """(reference computation, port computation on the CPU) of a cell."""
    (graph_fn, args, hops), _ = CELLS[cell]
    ref_g, port_g = getattr(ref_gen, graph_fn)(*args), \
        getattr(gen, graph_fn)(*args)
    if hops is None:
        return ref_make_clique(ref_g), make_clique_computation(
            port_g, device="cpu")
    return (ref_make_iso(ref_g, *TRIANGLE, ref_build_iso_index(ref_g, hops)),
            make_iso_computation(port_g, *TRIANGLE,
                                 build_iso_index(port_g, hops, device="cpu"),
                                 device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(cell, **config)`` -> (reference result, port result) for the
    cell at the given EngineConfig fields; each pair is run once a module."""
    comps, done = {}, {}

    def run(cell, **fields):
        key = (cell,) + tuple(sorted(fields.items()))
        if key not in done:
            if cell not in comps:
                comps[cell] = _computations(cell)
            ref_comp, port_comp = comps[cell]
            cfg = dict(CELLS[cell][1], **fields)
            results = []
            for who, make, comp in (
                    ("ref", ref_engine.EngineConfig, ref_comp),
                    ("port", engine.EngineConfig, port_comp)):
                if cfg.get("spill") == "disk":
                    cfg["spill_dir"] = str(tmp_path_factory.mktemp(who))
                eng = (ref_engine.Engine if who == "ref" else
                       engine.Engine)(comp, make(**cfg))
                results.append(eng.run())
            done[key] = tuple(results)
        return done[key]
    return run


def _assert_same_result(got, want):
    assert got.result_keys.tobytes() == np.asarray(want.result_keys).tobytes()
    assert got.result_states.tobytes() == \
        np.asarray(want.result_states).tobytes()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name


# ------------------------------------------------------------ fused parity
@pytest.mark.parametrize("spill", ["host", "disk"])
@pytest.mark.parametrize("T", [2, 16])
def test_clique_macro_matches_reference(runs, spill, T):
    want, got = runs("clique", steps_per_sync=T, spill=spill)
    _assert_same_result(got, want)
    unfused = runs("clique", spill=spill)[1]
    assert got.host_syncs < got.steps == unfused.steps
    assert got.spilled > 0 and got.refilled > 0      # the regime under test
    assert got.result_keys.tobytes() == unfused.result_keys.tobytes()


@pytest.mark.parametrize("spill", ["host", "disk"])
def test_iso_macro_matches_reference(runs, spill):
    want, got = runs("iso", steps_per_sync=16, spill=spill)
    _assert_same_result(got, want)
    unfused = runs("iso", spill=spill)[1]
    assert got.host_syncs < got.steps or got.steps <= 1
    assert got.result_states.tobytes() == unfused.result_states.tobytes()


# -------------------------------------------------- accumulator early exit
def test_overflow_accumulator_fill_early_exits(runs):
    """An accumulator of one block (overflow_accum=1 is raised to B + M)
    sends the loop back to the host after every spilling step: more host
    syncs than the full-size run, the same answer, as in the reference."""
    want_full, full = runs("clique", steps_per_sync=16)
    want_tight, tight = runs("clique", steps_per_sync=16, overflow_accum=1)
    _assert_same_result(full, want_full)
    _assert_same_result(tight, want_tight)
    assert tight.host_syncs > full.host_syncs
    assert tight.host_syncs < tight.steps
    assert tight.spilled == full.spilled > 0


# ------------------------------------------------------- budget exactness
@pytest.mark.parametrize("T", [1, 4, 16])
def test_max_steps_truncates_identically(runs, T):
    want, got = runs("clique", max_steps=12, steps_per_sync=T)
    _assert_same_result(got, want)
    assert got.steps == 12
    assert got.host_syncs == -(-12 // T)


@pytest.mark.parametrize("T", [1, 16])
def test_late_pruned_matches_reference(runs, T):
    want, got = runs("clique", steps_per_sync=T)
    _assert_same_result(got, want)
    assert got.late_pruned == want.late_pruned > 0


# ---------------------------------------------------- bench_engine cells
@pytest.mark.parametrize("spill", ["host", "disk"])
@pytest.mark.parametrize("T", [1, 4, 16])
@pytest.mark.parametrize("cell", ["bench_clique", "bench_iso"])
def test_bench_engine_cells_match_reference(runs, cell, T, spill):
    want, got = runs(cell, steps_per_sync=T, spill=spill)
    _assert_same_result(got, want)
    if T > 1:
        assert got.host_syncs < got.steps


# ------------------------------------------------------------ no-op steps
def test_inactive_step_is_a_no_op():
    """A step with ``active`` false (a macro-step's step after the loop's
    exit) dequeues nothing: pool and result set come back unchanged, the
    overflow block holds no live row and the counts are zero."""
    g = gen.densifying_graph(96, 900, 0)
    eng = engine.Engine(make_clique_computation(g, device="cpu"),
                        engine.EngineConfig(k=3, batch=8, pool_capacity=128))
    st = eng.start()
    for _ in range(3):
        eng.step(st)
    before = (st.pool_states, st.pool_prio, st.pool_ub, st.result_states,
              st.result_keys)
    *after, overflow, stats = eng._step_impl(
        *before, active=torch.tensor(False))
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert not bool((overflow[1] > NEG).any())
    expanded, created, pruned, occ, threshold, spilled = stats.tolist()
    assert (expanded, created, pruned, spilled) == (0, 0, 0, 0)
    assert occ == st.pool_occupancy and threshold == st.threshold
    st.vpq.close()


def test_macro_accumulator_is_made_once():
    g = gen.densifying_graph(96, 900, 0)
    eng = engine.Engine(make_clique_computation(g, device="cpu"),
                        engine.EngineConfig(k=3, batch=8, pool_capacity=128,
                                            steps_per_sync=4))
    assert eng.acc_cap == 4 * (eng.B + eng.M)
    st = eng.start()
    eng.step(st)
    acc = eng._acc
    assert acc[0].shape == (eng.acc_cap + eng.B + eng.M, eng.S)
    eng.step(st)
    assert all(a is b for a, b in zip(acc, eng._acc))
    st.vpq.close()


def test_engine_config_t_fields_match_reference():
    comp = make_clique_computation(gen.densifying_graph(40, 60, 0),
                                   device="cpu")
    ref_comp = ref_make_clique(ref_gen.densifying_graph(40, 60, 0))
    for fields in (dict(steps_per_sync=16), dict(steps_per_sync=4,
                                                 overflow_accum=1),
                   dict(steps_per_sync=0), dict(steps_per_sync=3,
                                                overflow_accum=10 ** 6)):
        eng = engine.Engine(comp, dataclasses.replace(
            engine.EngineConfig(batch=8), **fields))
        ref = ref_engine.Engine(ref_comp, dataclasses.replace(
            ref_engine.EngineConfig(batch=8), **fields))
        assert (eng.T, eng.acc_cap) == (ref.T, ref.acc_cap), fields
