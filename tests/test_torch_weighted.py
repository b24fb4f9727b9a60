"""The port's maximum-weight clique (``repro_torch.core.weighted_clique``)
and its pointwise API (``repro_torch.core.api.from_pointwise``) on the CPU
against the reference's: on tests/test_weighted_clique.py's seeds and
tests/test_macro_engine.py's spill case, result_keys / result_states byte
for byte and every EngineResult counter equal to the reference engine's,
at ``steps_per_sync`` 1 and 4; and the chunked vmap equal to one chunk."""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.weighted_clique import \
    make_weighted_clique_computation as ref_make_weighted
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import api, engine
from repro_torch.core.weighted_clique import (
    brute_force_max_weight_clique, make_weighted_clique_computation)
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "rebalanced", "syncs", "host_syncs")
# tests/test_weighted_clique.py's engine config, and
# tests/test_macro_engine.py's weighted case (a pool small enough to spill)
CONFIGS = {
    "bruteforce": dict(k=1, batch=16, pool_capacity=4096, max_steps=50_000),
    "spill": dict(k=2, batch=8, pool_capacity=64, max_steps=50_000),
}


def _case(seed):
    """The reference's graph and weights, the port's graph carried across."""
    ref_g = ref_gen.densifying_graph(50, 180, seed=seed)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices)
    assert port_g.fingerprint == ref_g.fingerprint
    weights = np.random.default_rng(seed).integers(1, 20, ref_g.n)
    return ref_g, port_g, weights


def _assert_same_result(got, want):
    assert got.result_keys.tobytes() == np.asarray(want.result_keys).tobytes()
    assert got.result_states.tobytes() == \
        np.asarray(want.result_states).tobytes()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.fixture(scope="module")
def reference():
    """``reference(seed, config, t)``: the reference engine's run, once."""
    done = {}

    def get(seed, config, t):
        if (seed, config, t) not in done:
            ref_g, _, weights = _case(seed)
            cfg = ref_engine.EngineConfig(**CONFIGS[config],
                                          steps_per_sync=t)
            done[seed, config, t] = ref_engine.Engine(
                ref_make_weighted(ref_g, weights), cfg).run()
        return done[seed, config, t]
    return get


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_weighted_clique_matches_reference(reference, seed, config, t):
    _, port_g, weights = _case(seed)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    got = engine.Engine(comp, engine.EngineConfig(**CONFIGS[config],
                                                  steps_per_sync=t)).run()
    _assert_same_result(got, reference(seed, config, t))
    if config == "spill" and t == 1:
        assert got.spilled > 0          # the regime under test


@pytest.mark.parametrize("seed", [0, 3])
def test_weighted_clique_matches_bruteforce(seed):
    _, port_g, weights = _case(seed)
    want_w, want_members = brute_force_max_weight_clique(port_g, weights)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    res = engine.Engine(comp, engine.EngineConfig(
        **CONFIGS["bruteforce"])).run()
    assert int(res.result_keys[0]) == want_w
    members = comp.describe(res.result_states[0])
    assert members == want_members
    for i, u in enumerate(members):
        for v in members[i + 1:]:
            assert port_g.has_edge(u, v)


def test_the_smoke_run_case():
    """The case the smoke run holds the card to (chip_smoke.py, phase 3),
    with the reference engine's answer and counters."""
    _, port_g, weights = _case(0)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    res = engine.Engine(comp, engine.EngineConfig(
        k=1, batch=16, pool_capacity=4096)).run()
    assert [int(x) for x in res.result_keys] == [43]
    assert comp.describe(res.result_states[0]) == [11, 29, 35]
    assert (res.steps, res.candidates, res.expanded, res.pruned) == \
        (8, 108, 25, 83)


def test_callbacks_keep_int32():
    _, port_g, weights = _case(3)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    states, prio, ub = comp.init_frontier()
    assert states.dtype == prio.dtype == ub.dtype == torch.int32
    child_prio, child_ub = comp.score_children(states[:8])
    assert child_prio.dtype == child_ub.dtype == torch.int32
    acts = torch.arange(8)
    assert comp.materialize(states[:8], acts).dtype == torch.int32
    assert comp.result_key(states).dtype == torch.int32
    assert comp.upper_bound(states).dtype == torch.int32


# -------------------------------------------------------- the chunked vmap
@pytest.mark.parametrize("budget", [1, 32 * 4 * 7, 1 << 40])
def test_chunked_vmap_equals_one_chunk(monkeypatch, budget):
    """Every callback gives the same numbers with the element budget cut
    down to one action (or state) a chunk, to a few, and with everything in
    one chunk; and a whole run is byte-identical."""
    _, port_g, weights = _case(0)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    states, _, _ = comp.init_frontier()
    batch = states[::3]
    acts = torch.arange(batch.shape[0]) % port_g.n

    def callbacks():
        return (*comp.score_children(batch), comp.materialize(batch, acts),
                comp.result_key(batch), comp.upper_bound(batch),
                *comp.init_frontier())
    whole = callbacks()
    want = engine.Engine(comp, engine.EngineConfig(
        **CONFIGS["spill"])).run()
    monkeypatch.setattr(api, "POINTWISE_MAX_ELEMENTS", budget)
    for a, b in zip(callbacks(), whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _assert_same_result(engine.Engine(comp, engine.EngineConfig(
        **CONFIGS["spill"])).run(), want)


def test_chunk_size_from_the_budget(monkeypatch):
    monkeypatch.setattr(api, "POINTWISE_MAX_ELEMENTS", 1000)
    assert api.chunk_size(10, 100) is None        # all ten fit
    assert api.chunk_size(11, 100) == 10
    assert api.chunk_size(50, 300) == 3
    assert api.chunk_size(50, 5000) == 1          # at least one a chunk


def test_from_pointwise_matches_a_batched_computation():
    """A toy pointwise computation against the same functions written out
    over the batch: the adapter's vmaps change nothing."""
    n = 7
    base = torch.arange(n, dtype=torch.int32)

    def init():
        s = torch.stack([base, base * 2], 1).to(torch.int32)
        return s, s[:, 0], s[:, 1]
    comp = api.from_pointwise(
        name="toy", state_width=2, num_actions=n, init_frontier=init,
        expandable=lambda s, a: (s[0] + a) % 3 != 0,
        child_priority=lambda s, a: s[0] * 10 + a,
        child_ub=lambda s, a: s[1] + a,
        materialize_one=lambda s, a: torch.stack([s[0] + a, s[1] - a]),
        relevant=lambda s: s[0] % 2 == 0,
        result_key_one=lambda s: s[1],
        upper_bound_one=lambda s: s[0] + s[1], device="cpu")
    states, _, _ = comp.init_frontier()
    a = torch.arange(n, dtype=torch.int32)
    ok = (states[:, :1] + a) % 3 != 0
    prio, ub = comp.score_children(states)
    assert torch.equal(prio, torch.where(ok, states[:, :1] * 10 + a,
                                         api.NEG))
    assert torch.equal(ub, torch.where(ok, states[:, 1:] + a, api.NEG))
    acts = a.flip(0)
    assert torch.equal(comp.materialize(states, acts), torch.stack(
        [states[:, 0] + acts, states[:, 1] - acts], 1))
    assert torch.equal(comp.result_key(states), torch.where(
        states[:, 0] % 2 == 0, states[:, 1], api.NEG))
    assert torch.equal(comp.upper_bound(states), states.sum(1,
                                                            dtype=torch.int32))


def test_weighted_clique_raises_without_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = gen.densifying_graph(20, 40, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_weighted_clique_computation(g, np.ones(g.n, np.int64))


def test_max_steps_truncation_matches_reference():
    """A run cut by ``max_steps``: the same partial answer and counters."""
    ref_g, port_g, weights = _case(3)
    comp = make_weighted_clique_computation(port_g, weights, device="cpu")
    ref_comp = ref_make_weighted(ref_g, weights)
    cfg = dict(CONFIGS["spill"], max_steps=5)
    for t in (1, 4):
        want = ref_engine.Engine(ref_comp, ref_engine.EngineConfig(
            **cfg, steps_per_sync=t)).run()
        got = engine.Engine(comp, engine.EngineConfig(
            **cfg, steps_per_sync=t)).run()
        _assert_same_result(got, want)
        assert got.steps == 5
