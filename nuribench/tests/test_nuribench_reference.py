"""The plain reference: its list of the best cliques and its count of the
search's nodes agree with brute force on small graphs, its order is the
program's canonical one, and its judgement counts every kind of wrong
answer."""
import functools
import itertools

import numpy as np
import pytest

from nuribench.gen import graphs
from nuribench.reference import clique
from nuribench.reference.graph import NEG, Graph


def brute_cliques(g: Graph):
    """Every clique, grown one vertex at a time in plain Python and checked
    pair by pair, by size: lists of ``(clique, bound)``, the bound its size
    plus the vertices above its last that are adjacent to all of it."""
    adj = {(int(a), int(b)) for a, b in zip(g.keys // g.n, g.keys % g.n)}
    level, found = [[v] for v in range(g.n)], []
    while level:
        grown = [c + [v] for c in level for v in range(c[-1] + 1, g.n)
                 if all((u, v) in adj for u in c)]
        found.append([(c, len(c) + sum(d[:-1] == c for d in grown))
                      for c in level])
        level = grown
    return found


def brute_top(g: Graph, k: int):
    """The k best cliques: size descending, then the bitset words' order
    (each word an int32, word 0 first)."""
    w = (g.n + 31) // 32
    found = []
    for level in brute_cliques(g):
        ranked = []
        for c, _ in level:
            words = np.zeros(w, np.uint32)
            for v in c:
                words[v // 32] |= np.uint32(1) << np.uint32(v % 32)
            ranked.append((tuple(words.view(np.int32).tolist()), c))
        found.append([c for _, c in sorted(ranked)])
    return [c for level in reversed(found) for c in level][:k]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 3, 16, 40])
def test_top_equals_brute_force(seed, k):
    n = 40 if seed % 2 else 14          # 40 vertices: two bitset words
    d = graphs.densifying_graph(n, 3 * n, seed)
    g = Graph(n, d["edges"])
    assert clique.Cliques(g).top(k) == brute_top(g, k)


@pytest.mark.parametrize("seed", range(4))
def test_must_expand_equals_brute_force(seed):
    d = graphs.densifying_graph(40, 160, seed)
    g = Graph(40, d["edges"])
    bounds = [b for level in brute_cliques(g) for _, b in level]
    cliques = clique.Cliques(g)
    for key in range(1, max(bounds) + 2):
        assert cliques.must_expand(key) == sum(b >= key for b in bounds)


def test_canonical_order_reads_signed_words():
    # vertex 31 is word 0's sign bit: a clique holding it comes first;
    # a clique with no vertex in word 0 comes before one with vertex 5
    order = sorted([[5, 40], [31, 40], [33, 40]],
                   key=functools.cmp_to_key(clique._canonical))
    assert order == [[31, 40], [33, 40], [5, 40]]


def test_extend_lists_each_clique_once():
    e = [(a, b) for a, b in itertools.combinations(range(5), 2)]
    g = Graph(7, np.array(e + [(5, 6)]))
    level = np.arange(7)[:, None]
    sizes = []
    while len(level):
        sizes.append(len(level))
        level, parent = clique.extend(g, level)
        assert len(parent) == len(level)
    # K5 and an edge: 7 vertices, 11 edges, then C(5, r)
    assert sizes == [7, 11, 10, 5, 1]
    # vertex 0 heads K5's 4 edges from it, and the bounds follow
    assert clique.Cliques(g).bounds[0].tolist() == [5, 4, 3, 2, 1, 2, 1]


def test_top_over_chunks_equals_top_at_once(monkeypatch):
    d = graphs.densifying_graph(300, 2500, 4)
    g = Graph(300, d["edges"])
    want = clique.Cliques(g)
    monkeypatch.setattr(clique, "CHUNK", 7)
    got = clique.Cliques(g)
    assert got.top(20) == want.top(20)
    assert all(np.array_equal(a, b) for a, b in zip(got.bounds,
                                                    want.bounds))


def _response(keys, results, expanded):
    return dict(result_keys=keys, results=results,
                stats=dict(expanded=expanded))


def test_clique_judge_counts_each_fault():
    d = graphs.densifying_graph(200, 1500, 4)
    ref = clique.Reference(200, d["edges"])
    want = ref.top(5)
    keys = [len(c) for c in want]
    need = ref.cliques.must_expand(keys[-1])
    req = dict(k=5)

    def judge(keys, results, expanded=need):
        return ref.judge(req, _response(keys, results, expanded))

    assert judge(keys, want) == dict(wrong_keys=0, wrong_results=0,
                                     unexpanded=0)
    assert judge(keys, want, need + 100)["unexpanded"] == 0
    assert judge(keys, want, need - 7)["unexpanded"] == 7
    assert judge(keys[:-1] + [keys[-1] - 1], want)["wrong_keys"] == 1
    assert judge(keys, want[::-1])["wrong_results"] == 4
    assert judge(keys, want[:4])["wrong_results"] == 1
    assert judge(keys[:4] + [NEG], want[:4])["wrong_keys"] == 1
    assert judge(keys, want + [want[0]])["wrong_results"] == 1
    moved = [list(c) for c in want]
    moved[2][0] = (moved[2][0] + 1) % 200
    assert judge(keys, moved)["wrong_results"] == 1
    # the same vertices in another order are the same clique
    assert judge(keys, [c[::-1] for c in want])["wrong_results"] == 0
