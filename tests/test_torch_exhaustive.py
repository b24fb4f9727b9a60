"""The port's baselines and oracles (``repro_torch.core.exhaustive``) on the
CPU against the reference's, on the graphs of the reference's own tests
(built by the reference and carried across): equal outputs, equal candidate
counts and equal ``completed`` flags, budget stops included."""
import numpy as np
import pytest

from repro.core import exhaustive as ref_ex
from repro.core.graph import GraphStore as RefGraphStore
from repro.core.labels import LabelPredicate as RefPredicate
from repro.core.patterns import code_vertex_labels
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import exhaustive
from repro_torch.core.aggregate import topk_frequent_patterns
from repro_torch.core.labels import LabelPredicate


def _graphs(graph_fn, *args, **kwargs):
    """The reference's graph, and the port's carried across from its
    arrays (vertex and edge labels included)."""
    ref_g = getattr(ref_gen, graph_fn)(*args, **kwargs)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices,
                                     ref_g.labels, ref_g.edge_labels)
    assert port_g.fingerprint == ref_g.fingerprint
    return ref_g, port_g


# ------------------------------------------------------------------- clique
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n,m,k_clique", [(60, 200, 5), (120, 400, 7)])
def test_brute_force_max_clique_matches_reference(seed, n, m, k_clique):
    ref_g, port_g = _graphs("planted_clique_graph", n=n, m=m,
                            clique_size=k_clique, seed=seed)
    got = exhaustive.brute_force_max_clique(port_g)
    assert got == ref_ex.brute_force_max_clique(ref_g)
    assert got[0] >= k_clique


@pytest.mark.parametrize("max_size", [2, 3, 5])
def test_brute_force_cliques_matches_reference(max_size):
    ref_g, port_g = _graphs("densifying_graph", 40, 150, seed=3)
    got = exhaustive.brute_force_cliques(port_g, max_size)
    assert got == ref_ex.brute_force_cliques(ref_g, max_size)


@pytest.mark.parametrize("graph,budget", [
    (("densifying_graph", (100, 600), {"seed": 7}), 2_000_000),
    (("densifying_graph", (100, 600), {"seed": 7}), 5_000),
    (("planted_clique_graph", (60, 200, 5), {"seed": 1}), 2_000_000)],
    ids=["pruning-test", "budget", "planted"])
def test_arabesque_style_clique_matches_reference(graph, budget):
    graph_fn, args, kwargs = graph
    ref_g, port_g = _graphs(graph_fn, *args, **kwargs)
    got = exhaustive.ArabesqueStyleClique(port_g, budget).run()
    want = ref_ex.ArabesqueStyleClique(ref_g, budget).run()
    assert got == want
    assert got["completed"] == (budget > 5_000)


@pytest.mark.parametrize("graph,budget", [
    (("densifying_graph", (100, 600), {"seed": 7}), 5_000_000),
    (("densifying_graph", (100, 600), {"seed": 7}), 500),
    (("planted_clique_graph", (500, 3000, 9), {"seed": 42}), 2_000_000)],
    ids=["pruning-test", "budget", "quickstart"])
def test_nuri_np_matches_reference(graph, budget):
    graph_fn, args, kwargs = graph
    ref_g, port_g = _graphs(graph_fn, *args, **kwargs)
    got = exhaustive.nuri_np_clique_candidates(port_g, budget)
    assert got == ref_ex.nuri_np_clique_candidates(ref_g, budget)
    assert got["completed"] == (budget > 500)


def test_quickstart_nuri_np_count():
    """The count the port's quickstart prints and the smoke run holds the
    card's run to (chip_smoke.py, phase 3)."""
    _, port_g = _graphs("planted_clique_graph", n=500, m=3000,
                        clique_size=9, seed=42)
    assert exhaustive.nuri_np_clique_candidates(port_g, 2_000_000) == \
        dict(candidates=4283, max_clique_size=9, completed=True)


# ---------------------------------------------------------------------- iso
QUERIES = [
    ([(0, 1)], [0, 1]),                       # edge
    ([(0, 1), (1, 2)], [0, 1, 2]),            # path
    ([(0, 1), (1, 2), (0, 2)], [1, 1, 1]),    # triangle
    ([(0, 1), (1, 2), (2, 3)], [0, 1, 0, 2]),  # labeled path-4
]


@pytest.mark.parametrize("q_edges,q_labels", QUERIES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("induced", [True, False])
def test_brute_force_iso_matches_reference(q_edges, q_labels, k, induced):
    ref_g, port_g = _graphs("labeled_graph", n=120, m=420, n_labels=3,
                            seed=2)
    got = exhaustive.brute_force_iso(port_g, q_edges, q_labels, induced, k)
    assert got == ref_ex.brute_force_iso(ref_g, q_edges, q_labels, induced,
                                         k)


@pytest.mark.parametrize("graph,query,spec", [
    (("labeled_graph", (50, 160, 3), {"seed": 7}),
     ([(0, 1), (1, 2)], [1, 1, 1]), {"vertex_any_of": [1, 2]}),
    (("labeled_graph", (50, 160, 3), {"seed": 7}),
     ([(0, 1), (1, 2)], [1, 1, 1]), {"q_any_of": [[1, 2], [1], [0, 1]]}),
    (("labeled_graph", (50, 160, 3), {"seed": 7}),
     ([(0, 1), (1, 2)], [1, 1, 1]),
     {"vertex_any_of": [0, 1], "q_any_of": [[1, 2], [1], [0, 1]]}),
    (("attributed_graph", (40, 150, 2, 2), {"seed": 9}),
     ([(0, 1), (1, 2)], [0, 1, 0]), {"edge_any_of": [0]})],
    ids=["vertex", "classes", "both", "edge"])
def test_brute_force_iso_under_predicate_matches_reference(graph, query,
                                                           spec):
    """tests/test_labeled.py's oracle cases."""
    graph_fn, args, kwargs = graph
    ref_g, port_g = _graphs(graph_fn, *args, **kwargs)
    got = exhaustive.brute_force_iso(port_g, *query, k=4,
                                     predicate=LabelPredicate.from_spec(spec))
    want = ref_ex.brute_force_iso(ref_g, *query, k=4,
                                  predicate=RefPredicate.from_spec(spec))
    assert got == want and got


def test_brute_force_iso_rejects_unlabeled_graph():
    ref_g, port_g = _graphs("densifying_graph", 20, 40, seed=0)
    spec = {"vertex_any_of": [0]}
    with pytest.raises(ValueError, match="vertex-labeled"):
        ref_ex.brute_force_iso(ref_g, [(0, 1)], [0, 0],
                               predicate=RefPredicate.from_spec(spec))
    with pytest.raises(ValueError, match="vertex-labeled"):
        exhaustive.brute_force_iso(port_g, [(0, 1)], [0, 0],
                                   predicate=LabelPredicate.from_spec(spec))


# ------------------------------------------------------------------ pattern
def test_pattern_support_oracle_paper_example():
    edges = np.array([(0, 1), (1, 2), (1, 3), (2, 3), (4, 3)])
    labels = np.array([0, 1, 1, 1, 0])
    ref_g = RefGraphStore.from_edges(5, edges, labels=labels)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices,
                                     ref_g.labels)
    for p_edges, p_labels, sup in (([(0, 1)], [0, 1], 2),
                                   ([(0, 1)], [1, 1], 3),
                                   ([(0, 1), (1, 2)], [1, 1, 1], 3)):
        assert exhaustive.pattern_support_oracle(port_g, p_edges,
                                                 p_labels) == sup
        assert ref_ex.pattern_support_oracle(ref_g, p_edges, p_labels) == sup


@pytest.mark.parametrize("m_edges", [2, 3])
def test_pattern_support_oracle_matches_reference(m_edges):
    """tests/test_core_iso_patterns.py's case: the port's mined supports
    equal the port's oracle, which equals the reference's."""
    ref_g, port_g = _graphs("labeled_graph", n=60, m=150, n_labels=3,
                            seed=5)
    res = topk_frequent_patterns(port_g, m_edges, k=3, device="cpu")
    assert res.patterns
    for sup, code in res.patterns:
        vl = code_vertex_labels(code)
        pe = [(i, j) for i, j, _, _ in code]
        got = exhaustive.pattern_support_oracle(port_g, pe, vl)
        assert got == ref_ex.pattern_support_oracle(ref_g, pe, vl) == sup
