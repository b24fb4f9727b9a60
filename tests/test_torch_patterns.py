"""The port's pattern mining (``repro_torch.core.patterns`` and
``repro_torch.core.aggregate``) on the CPU against the reference's, on the
same graphs (built by the reference and carried across): the gSpan code
algebra, the seed groups, the edge probe on both paths, one expansion, and
whole mining runs — pattern lists, supports, every ``MiningResult`` counter
and ``completed`` — exactly, on the cases of the reference's own pattern
tests (tests/test_kernels.py, tests/test_core_iso_patterns.py,
tests/test_labeled.py).  The reference's ``use_pallas=True`` runs as
tests/test_kernels.py runs it (the Pallas kernel in interpret mode)."""
import itertools

import numpy as np
import pytest
import torch

from repro.core import aggregate as ref_agg
from repro.core import patterns as ref_pat
from repro.core.graph import GraphStore as RefGraphStore
from repro.core.labels import LabelPredicate as RefPredicate
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import aggregate, patterns
from repro_torch.core.labels import LABEL_FILTERS, LabelPredicate
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

RESULT_FIELDS = ("patterns", "candidates", "groups_expanded",
                 "groups_pruned", "completed")
# tests/test_labeled.py's pushdown/post predicate and graph
LABELED_SPEC = {"vertex_any_of": [0, 1, 2], "edge_any_of": [0]}
LABELED_GRAPH = ("attributed_graph", (70, 260, 4, 2), {"seed": 5})
# every mining case: (graph, m_edges, k, max_candidates, spec); the
# reference's own pattern tests, and a stop on the candidate budget
MINING = {
    "kernels-m3": (("labeled_graph", (60, 180, 3), {"seed": 9}), 3, 3,
                   50_000_000, None),
    "oracle-m2": (("labeled_graph", (60, 150, 3), {"seed": 5}), 2, 3,
                  50_000_000, None),
    "oracle-m3": (("labeled_graph", (60, 150, 3), {"seed": 5}), 3, 3,
                  50_000_000, None),
    "labeled-pred": (LABELED_GRAPH, 2, 3, 50_000_000, LABELED_SPEC),
    "edge-pred": (("attributed_graph", (60, 220, 3, 2), {"seed": 11}), 2,
                  3, 50_000_000, {"edge_any_of": [1]}),
    "budget": (("labeled_graph", (60, 180, 3), {"seed": 9}), 3, 3, 2_000,
               None),
}


def _graphs(graph_fn, args, kwargs):
    """The reference's graph, and the port's carried across from its
    arrays (vertex and edge labels included)."""
    ref_g = getattr(ref_gen, graph_fn)(*args, **kwargs)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices,
                                     ref_g.labels, ref_g.edge_labels)
    assert port_g.fingerprint == ref_g.fingerprint
    return ref_g, port_g


def _predicates(spec):
    return RefPredicate.from_spec(spec), LabelPredicate.from_spec(spec)


def _same_groups(got, want):
    assert list(got) == list(want)
    for code, gr in want.items():
        assert got[code].code == gr.code
        assert got[code].embeddings.dtype == gr.embeddings.dtype
        assert got[code].embeddings.tobytes() == gr.embeddings.tobytes()


def _same_result(got, want):
    for name in RESULT_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.fixture(scope="module")
def reference():
    """``reference(key, make)``: ``make()``'s result, computed once."""
    done = {}

    def get(key, make):
        if key not in done:
            done[key] = make()
        return done[key]
    return get


# ---------------------------------------------------------- the code algebra
def _random_pattern(rng):
    """A small connected labeled graph: a random spanning tree plus a few
    random extra edges."""
    nv = int(rng.integers(2, 6))
    edges = {(int(rng.integers(0, v)), v) for v in range(1, nv)}
    for _ in range(int(rng.integers(0, 4))):
        a, b = (int(x) for x in rng.choice(nv, 2, replace=False))
        edges.add((min(a, b), max(a, b)))
    labels = [int(x) for x in rng.integers(0, 3, nv)]
    return labels, sorted(edges)


@pytest.mark.parametrize("seed", range(8))
def test_min_dfs_code_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        labels, edges = _random_pattern(rng)
        code = patterns.min_dfs_code(labels, edges)
        assert code == ref_pat.min_dfs_code(labels, edges)
        assert patterns.is_min_code(code) and ref_pat.is_min_code(code)
        assert patterns.code_rightmost_path(code) == \
            ref_pat.code_rightmost_path(code)
        assert patterns.code_vertex_labels(code) == \
            ref_pat.code_vertex_labels(code)
        # the same edges in another order, and relabelled: both packages
        # call each code minimal or not alike
        for perm in itertools.islice(itertools.permutations(code), 6):
            assert patterns.is_min_code(perm) == ref_pat.is_min_code(perm)


def test_min_code_canonical():
    assert not patterns.is_min_code(((0, 1, 1, 1), (0, 2, 1, 1)))
    assert patterns.is_min_code(((0, 1, 1, 1), (1, 2, 1, 1)))
    assert patterns.is_min_code(((0, 1, 0, 0), (1, 2, 0, 0), (2, 0, 0, 0)))


# -------------------------------------------------------------- seed groups
@pytest.mark.parametrize("graph,spec", [
    (("labeled_graph", (60, 150, 3), {"seed": 5}), None),
    (LABELED_GRAPH, None),
    (LABELED_GRAPH, LABELED_SPEC),
    (LABELED_GRAPH, {"vertex_any_of": [1, 3]})],
    ids=["labeled", "attributed", "attributed-pred", "attributed-vertex"])
def test_seed_groups_match_reference(graph, spec):
    ref_g, port_g = _graphs(*graph)
    ref_pred, port_pred = _predicates(spec)
    _same_groups(patterns.seed_groups(port_g, predicate=port_pred),
                 ref_pat.seed_groups(ref_g, predicate=ref_pred))


# --------------------------------------------------------------- edge probe
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("e", [1, 7, 8, 9, 100])
@pytest.mark.parametrize("spec", [None, {"edge_any_of": [0]}])
def test_edge_probe_matches_reference(use_pallas, e, spec):
    ref_g, port_g = _graphs(*LABELED_GRAPH)
    ref_pred, port_pred = _predicates(spec)
    rng = np.random.default_rng(e)
    # half the pairs are edges of the graph, half random pairs
    ea = ref_g.edge_array[rng.integers(0, len(ref_g.edge_array), e)]
    u = np.where(rng.random(e) < 0.5, ea[:, 0], rng.integers(0, ref_g.n, e))
    v = np.where(rng.random(e) < 0.5, ea[:, 1], rng.integers(0, ref_g.n, e))
    adj = ref_g.adj_bits if spec is None else ref_pred.adjacency(ref_g)
    want = ref_pat._has_edge_vec(adj, u, v)
    got = patterns._edge_probe(port_g, u, v, use_pallas=use_pallas,
                               predicate=port_pred, device="cpu")
    assert got.dtype == bool and got.tobytes() == want.tobytes()
    if use_pallas:
        kernel = ref_pat._edge_probe(ref_g, u, v, use_pallas=True,
                                     predicate=ref_pred)
        assert got.tobytes() == kernel.tobytes()


def test_edge_probe_empty():
    _, port_g = _graphs(*LABELED_GRAPH)
    none = np.zeros(0, np.int64)
    for use_pallas in (False, True):
        got = patterns._edge_probe(port_g, none, none, use_pallas,
                                   device="cpu")
        assert got.dtype == bool and got.shape == (0,)


# ---------------------------------------------------------------- expansion
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("label_filter", LABEL_FILTERS)
def test_expand_group_matches_reference(use_pallas, label_filter):
    """Two levels of expansion from every seed group: the same children
    (codes, embedding bytes) and the same ``created`` count."""
    ref_g, port_g = _graphs(*LABELED_GRAPH)
    ref_pred, port_pred = _predicates(LABELED_SPEC)
    kw = dict(use_pallas=use_pallas, label_filter=label_filter)
    level = ref_pat.seed_groups(ref_g, predicate=ref_pred)
    for _ in range(2):
        nxt = {}
        for gr in level.values():
            want, want_n = ref_pat.expand_group(ref_g, gr, predicate=ref_pred,
                                                **kw)
            got, got_n = patterns.expand_group(
                port_g, patterns.PatternGroup(gr.code, gr.embeddings),
                predicate=port_pred, device="cpu", **kw)
            assert got_n == want_n
            _same_groups(got, want)
            nxt.update(want)
        level = dict(itertools.islice(nxt.items(), 6))


# -------------------------------------------------------------- mining runs
def _mining_case(reference, case, use_pallas, label_filter="pushdown"):
    graph, m, k, budget, spec = MINING[case]
    ref_g, port_g = _graphs(*graph)
    ref_pred, port_pred = _predicates(spec)
    want = reference(
        (case, use_pallas, label_filter),
        lambda: ref_agg.topk_frequent_patterns(
            ref_g, m, k, budget, use_pallas=use_pallas, predicate=ref_pred,
            label_filter=label_filter))
    got = aggregate.topk_frequent_patterns(
        port_g, m, k, budget, use_pallas=use_pallas, predicate=port_pred,
        label_filter=label_filter, device="cpu")
    return got, want


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", list(MINING))
def test_topk_frequent_patterns_matches_reference(reference, case,
                                                  use_pallas):
    got, want = _mining_case(reference, case, use_pallas)
    _same_result(got, want)
    assert got.completed == (case != "budget")


def test_topk_answer_of_the_kernel_case(reference):
    """tests/test_kernels.py's case: the answer the smoke run holds the card
    to (chip_smoke.py, phase 3)."""
    got, _ = _mining_case(reference, "kernels-m3", True)
    assert [s for s, _ in got.patterns] == [18, 18, 18]
    assert (got.candidates, got.groups_expanded, got.groups_pruned) == \
        (10789, 7, 17)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("label_filter", LABEL_FILTERS)
def test_pushdown_post_matches_reference(reference, use_pallas,
                                         label_filter):
    got, want = _mining_case(reference, "labeled-pred", use_pallas,
                             label_filter)
    _same_result(got, want)


def test_paper_example_matches_reference():
    edges = np.array([(0, 1), (1, 2), (1, 3), (2, 3), (4, 3)])
    labels = np.array([0, 1, 1, 1, 0])
    ref_g = RefGraphStore.from_edges(5, edges, labels=labels)
    port_g = carry.graph_from_arrays(ref_g.n, ref_g.indptr, ref_g.indices,
                                     ref_g.labels)
    want = ref_agg.topk_frequent_patterns(ref_g, m_edges=2, k=1)
    got = aggregate.topk_frequent_patterns(port_g, m_edges=2, k=1,
                                           device="cpu")
    _same_result(got, want)
    assert got.patterns == [(3, ((0, 1, 1, 1), (1, 2, 1, 1)))]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_miner_steps_match_reference(use_pallas):
    """TopKPatternMiner stepped one group at a time: equal counters, heap
    size and result list after every step."""
    ref_g, port_g = _graphs("labeled_graph", (60, 150, 3), {"seed": 5})
    want = ref_agg.TopKPatternMiner(ref_g, 3, k=3, use_pallas=use_pallas)
    got = aggregate.TopKPatternMiner(port_g, 3, k=3, use_pallas=use_pallas,
                                     device="cpu")
    while True:
        for name in ("steps", "candidates", "expanded", "pruned",
                     "completed", "done", "_results"):
            assert getattr(got, name) == getattr(want, name), name
        assert len(got._pq) == len(want._pq)
        if want.done:
            break
        want.step()
        got.step()
    assert got.steps > 10
    _same_result(got.result(), want.result())


def test_arabesque_and_max_support_match_reference():
    """tests/test_core_iso_patterns.py's baseline case: µ, and the
    level-synchronous baseline at T = µ and µ/3."""
    ref_g, port_g = _graphs("labeled_graph", (60, 180, 4), {"seed": 8})
    mu = ref_agg.max_support_of_size(ref_g, 3)
    assert aggregate.max_support_of_size(port_g, 3, device="cpu") == mu
    for t in (mu, max(1, mu // 3)):
        _same_result(aggregate.arabesque_style_mining(port_g, 3, t,
                                                      device="cpu"),
                     ref_agg.arabesque_style_mining(ref_g, 3, t))
    # and its budget stop
    _same_result(aggregate.arabesque_style_mining(port_g, 3, 1, 3_000,
                                                  device="cpu"),
                 ref_agg.arabesque_style_mining(ref_g, 3, 1, 3_000))


# --------------------------------------------------- device and host reads
def test_device_bits_cache_names_the_device():
    """One graph on two devices keeps two entries: a ``cpu`` entry is never
    returned for another device (the smoke run mines one graph on ``cuda``
    and then on ``cpu`` in one process).  ``meta`` stands in for the card
    here."""
    _, port_g = _graphs(*LABELED_GRAPH)
    cpu, meta = torch.device("cpu"), torch.device("meta")
    assert patterns._device_bits_key(port_g, "", cpu) != \
        patterns._device_bits_key(port_g, "", meta)
    patterns._DEVICE_BITS_CACHE.clear()
    on_cpu = patterns._device_bits(port_g, port_g.adj_bits, "", cpu)
    on_meta = patterns._device_bits(port_g, port_g.adj_bits, "", meta)
    assert all(t.device == cpu for t in on_cpu)
    assert all(t.device == meta for t in on_meta)
    assert patterns._device_bits(port_g, port_g.adj_bits, "", cpu) is on_cpu
    assert len(patterns._DEVICE_BITS_CACHE) == 2
    adj, eye, ones = on_cpu
    assert adj.dtype == eye.dtype == ones.dtype == torch.int32
    assert ones.shape == (1, adj.shape[1]) and bool((ones == -1).all())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_one_host_read_a_probe(use_pallas):
    ref_g, port_g = _graphs("labeled_graph", (60, 180, 3), {"seed": 9})
    probes = []
    real = patterns._edge_probe

    def counted(*args, **kwargs):
        probes.append(len(args[1]))
        return real(*args, **kwargs)
    patterns.reset_reads()
    try:
        patterns._edge_probe = counted
        aggregate.topk_frequent_patterns(port_g, 3, k=3,
                                         use_pallas=use_pallas,
                                         device="cpu")
    finally:
        patterns._edge_probe = real
    assert len(probes) == patterns.reads == 4
    assert max(probes) == 172


def test_interpret_must_be_none():
    _, port_g = _graphs(*LABELED_GRAPH)
    for call in (
            lambda: aggregate.topk_frequent_patterns(
                port_g, 2, interpret=True, device="cpu"),
            lambda: aggregate.arabesque_style_mining(
                port_g, 2, 1, interpret=False, device="cpu"),
            lambda: patterns._edge_probe(port_g, np.zeros(1, int),
                                         np.zeros(1, int), True, False,
                                         device="cpu")):
        with pytest.raises(ValueError, match="interpret"):
            call()


def test_mining_raises_without_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    g = gen.labeled_graph(20, 40, 3, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregate.topk_frequent_patterns(g, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aggregate.TopKPatternMiner(g, 2)
