"""The port's isomorphism (``repro_torch.core.iso``) and label predicates
(``repro_torch.core.labels``) on the CPU against the reference's, on the
same graphs: ``build_iso_index`` byte for byte (with and without
``edge_any_of``), and engine runs byte for byte on result_keys /
result_states with every EngineResult counter equal, on every candidate
path (the kernel path, ``batched``, ``vmap``, ``map``), in both
``label_filter`` modes — the cases of tests/test_kernels.py's
iso-with-and-without-kernel test and of tests/test_labeled.py."""
import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core.iso import build_iso_index as ref_build_iso_index
from repro.core.iso import make_iso_computation as ref_make_iso
from repro.core.labels import LabelPredicate as RefPredicate
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import engine
from repro_torch.core.iso import build_iso_index, make_iso_computation
from repro_torch.core.labels import LABEL_FILTERS, LabelPredicate
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

NEG_KEY = np.iinfo(np.int32).min
COUNTERS = ("steps", "candidates", "expanded", "pruned", "spilled",
            "refilled", "late_pruned", "rebalanced", "syncs", "host_syncs")
PATHS = {"kernel": dict(use_pallas=True), "batched": {},
         "vmap": dict(cand_path="vmap"), "map": dict(cand_path="map")}
PATH_QUERY = ([(0, 1), (1, 2), (2, 3)], [0, 1, 0, 2])
TRIANGLE = ([(0, 1), (1, 2), (0, 2)], [1, 1, 1])
# tests/test_labeled.py's config and its three pushdown/post specs
LABELED_CFG = dict(k=4, batch=16, pool_capacity=2048, max_steps=50_000)
SPECS = {
    "vertex": {"vertex_any_of": [1, 2]},
    "classes": {"q_any_of": [[1, 2], [1], [0, 1]]},
    "both": {"vertex_any_of": [0, 1], "q_any_of": [[1, 2], [1], [0, 1]]},
}


def _assert_same_result(got, want):
    assert got.result_keys.tobytes() == np.asarray(want.result_keys).tobytes()
    assert got.result_states.tobytes() == \
        np.asarray(want.result_states).tobytes()
    for name in COUNTERS:
        assert getattr(got, name) == getattr(want, name), name


def _graphs(graph_fn, *args, **kwargs):
    """The reference's graph, and the port's carried across from its
    arrays (vertex and edge labels included)."""
    ref_g = getattr(ref_gen, graph_fn)(*args, **kwargs)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices,
                                     ref_g.labels, ref_g.edge_labels)
    assert port_g.fingerprint == ref_g.fingerprint
    return ref_g, port_g


@pytest.fixture(scope="module")
def reference():
    """``reference(key, make)``: ``make()``'s result, computed once."""
    done = {}

    def get(key, make):
        if key not in done:
            done[key] = make()
        return done[key]
    return get


# ----------------------------------------------------------------- the index
@pytest.mark.parametrize("graph,hops,spec", [
    (("labeled_graph", (90, 300, 3), {"seed": 4}), 3, None),
    (("labeled_graph", (50, 160, 3), {"seed": 7}), 2, None),
    (("attributed_graph", (40, 150, 2, 2), {"seed": 9}), 2, None),
    (("attributed_graph", (40, 150, 2, 2), {"seed": 9}), 2,
     {"edge_any_of": [0]}),
    (("attributed_graph", (60, 220, 4, 3), {"seed": 2}), 3,
     {"edge_any_of": [0, 2]})],
    ids=["labeled90", "labeled50", "attributed", "attributed-edge0",
         "attributed-edge02"])
def test_build_iso_index_matches_reference(graph, hops, spec):
    graph_fn, args, kwargs = graph
    ref_g, port_g = _graphs(graph_fn, *args, **kwargs)
    want = ref_build_iso_index(ref_g, hops, RefPredicate.from_spec(spec))
    got = build_iso_index(port_g, hops, LabelPredicate.from_spec(spec),
                          device="cpu")
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------- candidate paths
@pytest.fixture(scope="module")
def path_case(reference):
    """tests/test_kernels.py::_iso_run's case: the reference's batched run
    (its own test holds its four paths equal) and the port's graph."""
    ref_g, port_g = _graphs("labeled_graph", 90, 300, 3, seed=4)
    cfg = dict(k=3, batch=32, pool_capacity=4096, max_steps=20000)

    def run():
        index = ref_build_iso_index(ref_g, max_hops=3)
        return ref_engine.Engine(
            ref_make_iso(ref_g, *PATH_QUERY, index),
            ref_engine.EngineConfig(**cfg)).run()
    return reference("path", run), port_g, cfg


@pytest.mark.parametrize("path", list(PATHS))
def test_iso_candidate_paths_match_reference(path_case, path):
    want, port_g, cfg = path_case
    index = build_iso_index(port_g, max_hops=3, device="cpu")
    comp = make_iso_computation(port_g, *PATH_QUERY, index, device="cpu",
                                **PATHS[path])
    got = engine.Engine(comp, engine.EngineConfig(**cfg)).run()
    _assert_same_result(got, want)
    assert [int(x) for x in got.result_keys] == [42, 37, 37]


# ------------------------------------------------ pushdown / post matrix
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("label_filter", LABEL_FILTERS)
@pytest.mark.parametrize("spec", list(SPECS))
def test_pushdown_post_matrix_matches_reference(reference, spec,
                                                label_filter, use_pallas):
    """tests/test_labeled.py::test_iso_pushdown_post_parity_and_oracle's
    matrix: each (spec, filter, kernel) run of the port against the
    reference's run of that spec and filter (its kernel path gives the
    same run)."""
    ref_g, port_g = _graphs("labeled_graph", 50, 160, 3, seed=7)
    q_edges, q_labels = [(0, 1), (1, 2)], [1, 1, 1]

    def run():
        comp = ref_make_iso(ref_g, q_edges, q_labels,
                            ref_build_iso_index(ref_g, max_hops=2),
                            predicate=RefPredicate.from_spec(SPECS[spec]),
                            label_filter=label_filter)
        return ref_engine.Engine(comp,
                                 ref_engine.EngineConfig(**LABELED_CFG)).run()
    want = reference(("labeled", spec, label_filter), run)
    comp = make_iso_computation(
        port_g, q_edges, q_labels,
        build_iso_index(port_g, max_hops=2, device="cpu"),
        predicate=LabelPredicate.from_spec(SPECS[spec]),
        label_filter=label_filter, use_pallas=use_pallas, device="cpu")
    got = engine.Engine(comp, engine.EngineConfig(**LABELED_CFG)).run()
    _assert_same_result(got, want)
    assert int(got.result_keys[0]) > NEG_KEY


@pytest.mark.parametrize("use_pallas", [False, True])
def test_edge_predicate_with_restricted_index_matches_reference(use_pallas):
    """tests/test_labeled.py::test_iso_edge_predicate_matches_oracle: the
    index built on the type-restricted adjacency, the query run on it."""
    ref_g, port_g = _graphs("attributed_graph", 40, 150, 2, 2, seed=9)
    q_edges, q_labels = [(0, 1), (1, 2)], [0, 1, 0]
    spec = {"edge_any_of": [0]}
    ref_pred = RefPredicate.from_spec(spec)
    want = ref_engine.Engine(ref_make_iso(
        ref_g, q_edges, q_labels,
        ref_build_iso_index(ref_g, max_hops=2, predicate=ref_pred),
        predicate=ref_pred), ref_engine.EngineConfig(**LABELED_CFG)).run()
    pred = LabelPredicate.from_spec(spec)
    got = engine.Engine(make_iso_computation(
        port_g, q_edges, q_labels,
        build_iso_index(port_g, max_hops=2, predicate=pred, device="cpu"),
        predicate=pred, use_pallas=use_pallas, device="cpu"),
        engine.EngineConfig(**LABELED_CFG)).run()
    _assert_same_result(got, want)


@pytest.mark.parametrize("path", list(PATHS))
def test_cand_paths_agree_under_predicate(reference, path):
    """tests/test_labeled.py::test_iso_all_cand_paths_agree_under_predicate,
    each path of the port against the reference's batched run."""
    ref_g, port_g = _graphs("labeled_graph", 40, 120, 3, seed=3)
    spec = {"vertex_any_of": [0, 1]}

    def run():
        return ref_engine.Engine(ref_make_iso(
            ref_g, *TRIANGLE, ref_build_iso_index(ref_g, max_hops=2),
            predicate=RefPredicate.from_spec(spec)),
            ref_engine.EngineConfig(**LABELED_CFG)).run()
    want = reference("cand_paths_predicate", run)
    got = engine.Engine(make_iso_computation(
        port_g, *TRIANGLE, build_iso_index(port_g, max_hops=2, device="cpu"),
        predicate=LabelPredicate.from_spec(spec), device="cpu",
        **PATHS[path]), engine.EngineConfig(**LABELED_CFG)).run()
    _assert_same_result(got, want)


def test_non_induced_query_matches_reference():
    ref_g, port_g = _graphs("labeled_graph", 60, 220, 3, seed=5)
    cfg = dict(k=3, batch=8, pool_capacity=256)
    want = ref_engine.Engine(ref_make_iso(
        ref_g, *PATH_QUERY, ref_build_iso_index(ref_g, 3), induced=False),
        ref_engine.EngineConfig(**cfg)).run()
    got = engine.Engine(make_iso_computation(
        port_g, *PATH_QUERY, build_iso_index(port_g, 3, device="cpu"),
        induced=False, use_pallas=True, device="cpu"),
        engine.EngineConfig(**cfg)).run()
    _assert_same_result(got, want)


# -------------------------------------------------------------- predicates
@pytest.mark.parametrize("spec", [
    {"vertex_any_of": [2, 1, 2], "q_any_of": [[1], [3, 1]]},
    {"edge_any_of": [3, 0, 0]}, {"q_any_of": [[2], [0, 2, 1]]},
    {"vertex_any_of": [0]}, {}, None])
def test_predicate_canonical_form_matches_reference(spec):
    got = LabelPredicate.from_spec(spec)
    want = RefPredicate.from_spec(spec)
    if want is None:
        assert got is None
        return
    assert got.canonical() == want.canonical()
    assert (got.vertex_any_of, got.q_any_of, got.edge_any_of) == \
        (want.vertex_any_of, want.q_any_of, want.edge_any_of)
    assert LabelPredicate.from_spec(got) is got


def test_predicate_canonicalization_and_rejects():
    p = LabelPredicate.from_spec(
        {"vertex_any_of": [2, 1, 2], "q_any_of": [[1], [3, 1]]})
    assert p.vertex_any_of == (1, 2)
    assert p.q_any_of == ((1,), (1, 3))
    assert LabelPredicate.from_spec({}) is None
    assert LabelPredicate.from_spec(None) is None
    for bad in ({"vertex_any_of": []},
                {"vertex_any_of": [-1]},
                {"nope": [1]},
                {"vertex_any_of": "abc"},
                [1, 2]):
        with pytest.raises(ValueError):
            LabelPredicate.from_spec(bad)
    g = gen.labeled_graph(20, 40, 3, seed=0)
    with pytest.raises(ValueError, match="out of range"):
        LabelPredicate.from_spec({"vertex_any_of": [7]}).validate(g, "iso")
    with pytest.raises(ValueError, match="edge_labels"):
        LabelPredicate.from_spec({"edge_any_of": [0]}).validate(g, "iso")
    with pytest.raises(ValueError, match="iso only"):
        LabelPredicate.from_spec({"q_any_of": [[0]]}).validate(g, "pattern")
    with pytest.raises(ValueError, match="3 classes for 2"):
        LabelPredicate.from_spec(
            {"q_any_of": [[0], [1], [2]]}).validate(g, "iso", nq=2)


def test_predicate_bitset_views_match_reference():
    ref_g, port_g = _graphs("attributed_graph", 60, 220, 4, 3, seed=2)
    spec = {"vertex_any_of": [1, 3], "edge_any_of": [0, 2]}
    got, want = LabelPredicate.from_spec(spec), RefPredicate.from_spec(spec)
    for view in ("vertex_bits", "vertex_mask", "adjacency", "edge_mask_csr"):
        a, b = getattr(got, view)(port_g), getattr(want, view)(ref_g)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), view


# ------------------------------------------------------- device and config
def test_interpret_must_be_none():
    g = gen.labeled_graph(20, 40, 3, seed=0)
    index = build_iso_index(g, 2, device="cpu")
    with pytest.raises(ValueError, match="interpret"):
        make_iso_computation(g, *TRIANGLE, index, use_pallas=True,
                             interpret=True, device="cpu")


def test_iso_entry_points_raise_without_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = gen.labeled_graph(20, 40, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_iso_index(g, 2)
    index = build_iso_index(g, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_iso_computation(g, *TRIANGLE, index)


def test_iso_keys_and_states_stay_int32():
    g = gen.labeled_graph(60, 220, 3, seed=5)
    comp = make_iso_computation(g, *PATH_QUERY,
                                build_iso_index(g, 3, device="cpu"),
                                device="cpu")
    states, prio, ub = comp.init_frontier()
    assert states.dtype == prio.dtype == ub.dtype == torch.int32
    child_prio, child_ub = comp.score_children(states[:8])
    assert child_prio.dtype == child_ub.dtype == torch.int32
    assert comp.result_key(states).dtype == torch.int32
    assert comp.upper_bound(states).dtype == torch.int32
