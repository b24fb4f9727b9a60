"""The port's engine on the CPU against repro's engine (CPU JAX): byte for
byte on result_keys / result_states and equal on every EngineResult
counter, for the quickstart config, the spill probe (host and disk) and the
bench_clique densifying graphs; merge_topk and the tie order of the
dequeue; a state carried across from the reference mid-run."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import engine as ref_engine
from repro.core.clique import make_clique_computation as ref_make_clique
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import engine
from repro_torch.core.api import NEG
from repro_torch.core.clique import make_clique_computation
from repro_torch.core.iso import build_iso_index, make_iso_computation
from repro_torch.core.weighted_clique import (
    make_pointwise_weighted_clique_computation,
    make_weighted_clique_computation)
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "rebalanced", "syncs", "host_syncs")
QUICKSTART = (500, 3000, 9, 42)        # planted_clique_graph arguments


def _assert_same_result(got, want):
    assert got.result_keys.dtype == want.result_keys.dtype
    assert got.result_keys.tobytes() == want.result_keys.tobytes()
    assert got.result_states.tobytes() == want.result_states.tobytes()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name


def _run_both(graph_fn, args, tmp_path=None, **cfg):
    if cfg.get("spill") == "disk":
        cfg_ref = dict(cfg, spill_dir=str(tmp_path / "ref"))
        cfg_port = dict(cfg, spill_dir=str(tmp_path / "port"))
    else:
        cfg_ref = cfg_port = cfg
    want = ref_engine.Engine(ref_make_clique(getattr(ref_gen, graph_fn)(*args)),
                             ref_engine.EngineConfig(**cfg_ref)).run()
    got = engine.Engine(
        make_clique_computation(getattr(gen, graph_fn)(*args), device="cpu"),
        engine.EngineConfig(**cfg_port)).run()
    _assert_same_result(got, want)
    return got


def test_quickstart_config_matches_reference():
    res = _run_both("planted_clique_graph", QUICKSTART,
                    k=3, batch=64, pool_capacity=16384)
    assert list(res.result_keys) == [9, 8, 8]
    assert (res.steps, res.candidates, res.expanded, res.pruned) == \
        (24, 1479, 574, 905)


@pytest.mark.parametrize("spill", ["host", "disk"])
def test_spill_probe_matches_reference(spill, tmp_path):
    res = _run_both("planted_clique_graph", QUICKSTART, tmp_path,
                    k=3, batch=64, pool_capacity=96, spill=spill)
    assert (res.steps, res.pruned, res.spilled, res.refilled,
            res.late_pruned) == (10, 32, 1049, 176, 873)
    if spill == "disk":
        assert not list((tmp_path / "port").glob("*.npy"))


@pytest.mark.parametrize("m", [500, 700, 900])
def test_bench_clique_densifying_graphs_match_reference(m):
    _run_both("densifying_graph", (200, m, 0),
              k=1, batch=64, pool_capacity=16384, max_steps=200000)


# ------------------------------------------------------------- merge_topk
@pytest.mark.parametrize("seed", range(6))
def test_merge_topk_matches_reference(seed):
    """Random rows with planted key ties, state ties broken at different
    words (sign bit included), exact duplicates and NEG keys."""
    rng = np.random.default_rng(seed)
    r, s, k = 23, 5, int(rng.integers(1, 8))
    states = rng.integers(-3, 3, (r, s)).astype(np.int32)
    states[:, 0] = rng.choice([np.iinfo(np.int32).min, -1, 0, 7], r)
    keys = rng.integers(0, 4, r).astype(np.int32)
    keys[rng.random(r) < 0.2] = NEG
    for dst, src in rng.integers(0, r, (6, 2)):          # duplicates
        states[dst], keys[dst] = states[src], keys[src]
    want_s, want_k = ref_engine.merge_topk(jnp.asarray(states),
                                           jnp.asarray(keys), k)
    got_s, got_k = engine.merge_topk(torch.from_numpy(states),
                                     torch.from_numpy(keys), k)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_merge_topk_collapses_duplicate_pairs():
    states = torch.tensor([[1, 2], [1, 2], [0, 5]], dtype=torch.int32)
    keys = torch.tensor([4, 4, 4], dtype=torch.int32)
    got_s, got_k = engine.merge_topk(states, keys, 3)
    assert got_k.tolist() == [4, 4, NEG]
    assert got_s.tolist() == [[0, 5], [1, 2], [0, 0]]


def _near_equal_rows(seed, r, s):
    """Rows equal except in their last 3 words, with duplicate (state, key)
    pairs, key ties and NEG keys: every pair is ordered deep in the row."""
    rng = np.random.default_rng(seed)
    states = np.tile(rng.integers(-2**31, 2**31, s, dtype=np.int64)
                     .astype(np.int32), (r, 1))
    states[:, -3:] = rng.integers(-2, 2, (r, 3))
    keys = rng.integers(0, 6, r).astype(np.int32)
    keys[rng.random(r) < 0.1] = NEG
    for dst, src in rng.integers(0, r, (r // 8, 2)):
        states[dst], keys[dst] = states[src], keys[src]
    return states, keys


def _assert_merge_like_reference(states, keys, k):
    want_s, want_k = ref_engine.merge_topk(jnp.asarray(states),
                                           jnp.asarray(keys), k)
    got_s, got_k = engine.merge_topk(torch.from_numpy(states),
                                     torch.from_numpy(keys), k)
    assert got_k.numpy().tobytes() == np.asarray(want_k).tobytes()
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()


@pytest.mark.parametrize("k", [1024, 2000])
def test_merge_topk_matches_reference_at_large_k(k):
    """R = k + B candidates (B = 64), more than one tile of the default
    budget at S = 64."""
    _assert_merge_like_reference(*_near_equal_rows(k, k + 64, 64), k)


@pytest.mark.parametrize("rows", [1, 3, 40])
def test_merge_topk_over_many_tiles_matches_reference(rows, monkeypatch):
    """A tile budget forced down to ``rows`` rows a tile."""
    r, s = 131, 9
    monkeypatch.setattr(engine, "RANK_BUDGET", rows * r * s)
    _assert_merge_like_reference(*_near_equal_rows(rows, r, s), 50)


# ------------------------------------------------------------- tie order
def test_equal_priorities_dequeue_like_lax_top_k():
    """A pool whose priorities tie across far more than B slots: which
    states the step dequeues (and so everything after) is decided by the
    tie order alone, which must be lax.top_k's lower-index-first."""
    g = gen.planted_clique_graph(*QUICKSTART)
    cfg = dict(k=3, batch=8, pool_capacity=64)
    port = engine.Engine(make_clique_computation(g, device="cpu"),
                         engine.EngineConfig(**cfg))
    ref = ref_engine.Engine(
        ref_make_clique(ref_gen.planted_clique_graph(*QUICKSTART)),
        ref_engine.EngineConfig(**cfg))
    states0, _, ub0 = port.comp.init_frontier()
    rng = np.random.default_rng(0)
    pick = rng.choice(g.n, 64, replace=False)
    pool_states = states0.numpy()[pick]
    pool_prio = np.full(64, 7, np.int32)
    pool_prio[::5] = 9                       # a few ranks above the tie
    pool_prio[3::11] = NEG                   # and some empty slots
    pool_ub = ub0.numpy()[pick]
    rs = np.zeros((3, port.S), np.int32)
    rk = np.full(3, NEG, np.int32)
    args = (pool_states, pool_prio, pool_ub, rs, rk)
    got = port._step_impl(*map(torch.from_numpy, args))
    want = ref._step(*map(jnp.asarray, args))
    for g_out, w_out in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))
    for g_out, w_out in zip(got[5], want[5]):         # the overflow block
        np.testing.assert_array_equal(g_out.numpy(), np.asarray(w_out))


# ----------------------------------------------------------------- carry
def test_state_carried_from_reference_finishes_identically():
    """Run the reference a few steps (its spill queue still empty), carry
    the state across, step both to the end, compare."""
    cfg = dict(k=3, batch=64, pool_capacity=16384)
    ref = ref_engine.Engine(
        ref_make_clique(ref_gen.planted_clique_graph(*QUICKSTART)),
        ref_engine.EngineConfig(**cfg))
    port = engine.Engine(
        make_clique_computation(gen.planted_clique_graph(*QUICKSTART),
                                device="cpu"),
        engine.EngineConfig(**cfg))
    st_ref = ref.start()
    for _ in range(5):
        ref.step(st_ref)
    assert len(st_ref.vpq) == 0 and not st_ref.done
    st = carry.state_from_arrays(
        port, {name: np.asarray(getattr(st_ref, name))
               for name in carry.STATE_ARRAYS},
        _counters(st_ref))
    while not st_ref.done:
        ref.step(st_ref)
    while not st.done:
        port.step(st)
    _assert_same_result(port.finalize(st), ref.finalize(st_ref))


def _counters(st_ref):
    counters = {name: getattr(st_ref, name) for name in carry.STATE_SCALARS}
    counters.update(vpq_len=len(st_ref.vpq),
                    spilled=st_ref.vpq.total_spilled,
                    late_pruned=st_ref.vpq.total_late_pruned)
    return counters


def test_carry_rejects_state_with_spilled_entries():
    cfg = dict(k=3, batch=64, pool_capacity=96)
    ref = ref_engine.Engine(
        ref_make_clique(ref_gen.planted_clique_graph(*QUICKSTART)),
        ref_engine.EngineConfig(**cfg))
    port = engine.Engine(
        make_clique_computation(gen.planted_clique_graph(*QUICKSTART),
                                device="cpu"),
        engine.EngineConfig(**cfg))
    st_ref = ref.start()
    assert len(st_ref.vpq) > 0
    with pytest.raises(ValueError, match="spill queue"):
        carry.state_from_arrays(
            port, {name: np.asarray(getattr(st_ref, name))
                   for name in carry.STATE_ARRAYS}, _counters(st_ref))
    st_ref.vpq.close()


# ------------------------------------------------- the materialize hook
def _iso_computation():
    g = gen.labeled_graph(90, 300, 3, seed=4)
    return make_iso_computation(g, [(0, 1), (1, 2), (2, 3)], [0, 1, 0, 2],
                                build_iso_index(g, 3, device="cpu"),
                                device="cpu")


def test_only_the_clique_computation_builds_its_child_rows_itself():
    """The clique computation carries materialize_selected, and so does
    the weighted clique's fused form, which clique.py builds; iso and the
    pointwise computations (weighted clique's pointwise form among them)
    keep the engine's generic gather, materialize and zeroing."""
    g = gen.densifying_graph(40, 60, 0)
    weights = np.arange(1, g.n + 1)
    for comp in (make_clique_computation(g, device="cpu"),
                 make_weighted_clique_computation(g, weights, device="cpu")):
        assert comp.materialize_selected is not None, comp.name
    pointwise = make_pointwise_weighted_clique_computation(g, weights,
                                                           device="cpu")
    for comp in (_iso_computation(), pointwise):
        assert comp.materialize_selected is None, comp.name


def _counting(comp, field):
    """comp with its callback ``field`` wrapped to count its calls."""
    calls = []
    fn = getattr(comp, field)

    def counted(*args):
        calls.append(args[1].shape[0])
        return fn(*args)
    return dataclasses.replace(comp, **{field: counted}), calls


@pytest.mark.parametrize("T", [1, 4])
def test_materialize_hook_runs_each_pass(T):
    """The engine calls materialize_selected once a pass, the no-op steps
    of a macro-step included: one a step at T = 1, T a host read at T = 4,
    and never the generic materialize.  The run equals the one through the
    generic path byte for byte, which calls materialize once a pass."""
    comp = make_clique_computation(gen.densifying_graph(60, 300, 1),
                                   device="cpu")
    cfg = engine.EngineConfig(k=3, batch=8, pool_capacity=64,
                              steps_per_sync=T)
    hooked, calls = _counting(comp, "materialize_selected")
    hooked, generic_calls = _counting(hooked, "materialize")
    res = engine.Engine(hooked, cfg).run()
    assert len(calls) == T * res.host_syncs >= res.steps > 1
    assert generic_calls == []
    plain, plain_calls = _counting(
        dataclasses.replace(comp, materialize_selected=None), "materialize")
    plain_res = engine.Engine(plain, cfg).run()
    _assert_same_result(res, plain_res)
    assert len(plain_calls) == T * plain_res.host_syncs


def test_iso_run_takes_the_generic_materialize():
    """An iso computation has no hook: each pass gathers its parents and
    calls the computation's own materialize."""
    comp, calls = _counting(_iso_computation(), "materialize")
    assert comp.materialize_selected is None
    res = engine.Engine(comp, engine.EngineConfig(
        k=3, batch=32, pool_capacity=4096)).run()
    assert res.steps > 1 and res.candidates > 0
    assert len(calls) == res.host_syncs == res.steps


# ------------------------------------------------------- device and config
def test_entry_point_raises_without_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = gen.planted_clique_graph(*QUICKSTART)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_clique_computation(g)


@pytest.mark.parametrize("field,value,item", [("interpret", True, "item 3")])
def test_unsupported_config_names_roadmap_item(field, value, item):
    comp = make_clique_computation(gen.densifying_graph(40, 60, 0),
                                   device="cpu")
    cfg = dataclasses.replace(engine.EngineConfig(), **{field: value})
    with pytest.raises(NotImplementedError, match=item):
        engine.Engine(comp, cfg)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("field,value", [
    ("shards", 2), ("sync_every", 4), ("record_bound_trace", True),
    ("use_pallas", True)])
def test_knobs_the_reference_engine_ignores(field, value, T):
    """The reference's single-device Engine does not read these four
    fields (ShardedEngine and the computations do): the port's runs with
    each set and gives the reference's bytes and counters."""
    cfg = dict(k=3, batch=8, pool_capacity=64, steps_per_sync=T,
               **{field: value})
    want = ref_engine.Engine(
        ref_make_clique(ref_gen.densifying_graph(40, 60, 0)),
        ref_engine.EngineConfig(**cfg)).run()
    got = engine.Engine(
        make_clique_computation(gen.densifying_graph(40, 60, 0),
                                device="cpu"),
        engine.EngineConfig(**cfg)).run()
    _assert_same_result(got, want)
    assert list(got.result_keys) == [3, 3, 3] and got.steps == 10


def test_engine_config_mirrors_reference_fields():
    names = [f.name for f in dataclasses.fields(engine.EngineConfig)]
    assert names == [f.name for f in
                     dataclasses.fields(ref_engine.EngineConfig)]


@pytest.mark.parametrize("graph_fn,args,cfg", [
    ("skewed_graph", (100, 249, 1.0), dict(k=5, batch=64, pool_capacity=33)),
    ("powerlaw_graph", (20, 5, 63),
     dict(k=17, batch=1, pool_capacity=16, max_children=40))],
    ids=["batch>pool_capacity", "max_children>batch*num_actions"])
def test_config_the_reference_rejects_raises_value_error(graph_fn, args, cfg):
    """The two configs whose first step makes the reference's lax.top_k
    raise ValueError: the port raises it too, when the engine is made."""
    ref = ref_engine.Engine(ref_make_clique(getattr(ref_gen, graph_fn)(*args)),
                            ref_engine.EngineConfig(**cfg))
    with pytest.raises(ValueError):
        ref.run()
    comp = make_clique_computation(getattr(gen, graph_fn)(*args),
                                   device="cpu")
    field = "batch" if "max_children" not in cfg else "max_children"
    with pytest.raises(ValueError, match=field):
        engine.Engine(comp, engine.EngineConfig(**cfg))
