"""The maximum-weight clique's plain reference (``reference/wclique.py``):
its heaviest clique is the program's brute force's, its list and its count
of the search's nodes agree with brute force on small graphs, its order
breaks ties of weight by the canonical order, its judgement counts every
kind of wrong answer; and the configuration's generator gives the
DIMACS-W weights and ``densifying_graph``'s edges, and a ``tiny`` that
spills."""
import functools
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from nuribench import harness
from nuribench.gen import graphs
from nuribench.reference import clique, wclique
from nuribench.reference.graph import NEG, Graph

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "nuribench/configs/wclique-densify.json")
                    .read_text())


def brute(g: Graph, weights):
    """Every clique with its weight and bound, grown one vertex at a time
    and checked pair by pair: the bound its weight plus the weights of the
    vertices above its last that are adjacent to all of it."""
    adj = {(int(a), int(b)) for a, b in zip(g.keys // g.n, g.keys % g.n)}
    out = []
    level = [[v] for v in range(g.n)]
    while level:
        grown = [c + [v] for c in level for v in range(c[-1] + 1, g.n)
                 if all((u, v) in adj for u in c)]
        for c in level:
            cand = [d[-1] for d in grown if d[:-1] == c]
            out.append((c, int(sum(weights[c])),
                        int(sum(weights[c]) + sum(weights[cand]))))
        level = grown
    return out


def brute_top(found, k):
    def order(a, b):
        if a[1] != b[1]:
            return -1 if a[1] > b[1] else 1
        return clique._canonical(a[0], b[0])
    return [c for c, _, _ in sorted(found,
                                    key=functools.cmp_to_key(order))[:k]]


def _case(seed, n=40, m=160, top=12):
    edges = graphs.densifying_edges(n, m, seed)
    weights = np.random.default_rng(seed).integers(1, top, n)
    return Graph(n, edges), edges, weights


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("k", [1, 7, 30])
def test_top_and_bound_count_equal_brute_force(seed, k):
    g, edges, weights = _case(seed)
    found = brute(g, weights)
    ref = wclique.Reference(g.n, edges)
    cliques = ref.cliques(weights)
    assert cliques.top(k) == brute_top(found, k)
    for key in (0, 5, 12, 20, 30):
        assert cliques.must_expand(key) == sum(b >= key for _, _, b in found)


@pytest.mark.parametrize("seed", range(3))
def test_heaviest_equals_the_programs_brute_force(seed):
    from repro_torch.core.graph import GraphStore
    from repro_torch.core.weighted_clique import \
        brute_force_max_weight_clique
    g, edges, weights = _case(seed, top=200)
    want_w, want_members = brute_force_max_weight_clique(
        GraphStore.from_edges(g.n, edges), weights)
    top = wclique.Reference(g.n, edges).cliques(weights).top(1)[0]
    assert int(weights[top].sum()) == want_w
    # the brute force keeps the first clique of the largest weight that it
    # meets; the reference's tie-break may name another of that weight
    assert int(weights[want_members].sum()) == want_w


def test_ties_of_weight_go_by_the_canonical_order():
    # all weights 1: the order is the unweighted reference's by size
    g, edges, _ = _case(2)
    ones = np.ones(g.n, np.int64)
    want = clique.Reference(g.n, edges).top(12)
    assert wclique.Reference(g.n, edges).cliques(ones).top(12) == want


def test_judge_counts_each_wrong_answer():
    g, edges, weights = _case(1)
    ref = wclique.Reference(g.n, edges)
    top = ref.cliques(weights).top(5)
    keys = [int(weights[c].sum()) for c in top]
    request = dict(k=5, weights=weights.tolist())
    ok = dict(result_keys=keys, results=top,
              stats=dict(expanded=10 ** 6))
    assert ref.judge(request, ok) == dict(wrong_keys=0, wrong_results=0,
                                          unexpanded=0)
    altered = [list(c) for c in top]
    altered[0][-1] = (altered[0][-1] + 1) % g.n
    assert ref.judge(request, dict(ok, results=altered))["wrong_results"] \
        >= 1
    assert ref.judge(request, dict(ok, result_keys=keys[::-1]))[
        "wrong_keys"] == int(keys != keys[::-1])
    need = ref.cliques(weights).must_expand(keys[-1])
    assert ref.judge(request, dict(ok, stats=dict(expanded=0)))[
        "unexpanded"] == need > 0
    # fewer cliques than k: the missing keys are NEG
    small = Graph(3, np.array([[0, 1]]))
    r = wclique.Reference(3, np.array([[0, 1]]))
    got = r.judge(dict(k=6, weights=[1, 2, 3]), dict(
        result_keys=[3, 3, 2, 1, NEG, NEG], results=[[0, 1], [2], [1], [0]],
        stats=dict(expanded=9)))
    assert small.n == 3 and got == dict(wrong_keys=0, wrong_results=0,
                                        unexpanded=0)


def test_generator_gives_the_dimacs_w_weights_and_the_clique_edges():
    config = dict(CONFIG, num_vertices=500, num_edges=3000)
    data = harness.make_data(ROOT, config, 2 ** 31 + 7)
    assert set(data) == {"n", "edges", "request"}
    assert data["request"]["weights"] == [i % 200 + 1 for i in range(500)]
    same = graphs.densifying_graph(500, 3000, 2 ** 31 + 7)
    assert np.array_equal(data["edges"], same["edges"])


def test_tiny_spills_and_the_search_is_checked():
    """At the configuration's ``tiny`` the seeds outnumber the pool (so the
    spill queue works), and a search cut short expands fewer cliques than
    the reference's count."""
    tiny = dict(CONFIG["tiny"])
    request = dict(CONFIG["request"], **tiny.pop("request"))
    config = dict(CONFIG, **tiny)
    data = harness.make_data(ROOT, config, 5)
    assert data["n"] > request["pool_capacity"]
    ref = wclique.Reference(data["n"], data["edges"])
    weights = np.asarray(data["request"]["weights"])
    top = ref.cliques(weights).top(request["k"])
    key = int(weights[top[-1]].sum())
    assert ref.cliques(weights).must_expand(key) > 20 * request["batch"]


def test_the_reference_imports_nothing_of_the_program():
    text = (ROOT / "nuribench/reference/wclique.py").read_text()
    assert "repro" not in text.replace("reproduce", "")
    assert not list(itertools.islice(
        (line for line in text.splitlines()
         if line.startswith(("import torch", "from torch"))), 1))
