"""repro_torch's graph store and generators against repro's: the same
arguments give the same graph, byte for byte (same numpy RNG calls)."""
import numpy as np
import pytest
import torch

from repro.core import bitset as ref_bitset
from repro.data import synthetic_graphs as ref_gen
from repro_torch import carry
from repro_torch.core import bitset
from repro_torch.data import synthetic_graphs as gen

torch.set_num_threads(2)

CASES = [
    ("densifying_graph", (200, 700, 0), {}),
    ("densifying_graph", (64, 300, 5), {}),
    ("planted_clique_graph", (500, 3000, 9, 42), {}),
    ("planted_clique_graph", (300, 1200, 6), {"seed": 3}),
    ("powerlaw_graph", (300, 3, 1), {}),
    ("labeled_graph", (90, 300, 3), {"seed": 4}),
    ("skewed_graph", (400, 1500), {"skew": 0.8, "clique_size": 6, "seed": 1}),
    ("decoy_trap_graph", (1000, 2500), {"skew": 0.5, "seed": 2}),
    ("attributed_graph", (120, 400, 4, 3), {"seed": 2}),
]


def _ids(case):
    return f"{case[0]}{case[1]}"


def _assert_same_graph(g, r):
    assert g.n == r.n
    assert g.fingerprint == r.fingerprint
    for name in ("indptr", "indices", "labels", "edge_labels", "degrees",
                 "edge_array", "adj_bits", "label_bits", "etype_adj_bits"):
        a, b = getattr(g, name), getattr(r, name)
        if b is None:
            assert a is None, name
        else:
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_generator_matches_reference(case):
    name, args, kwargs = case
    g = getattr(gen, name)(*args, **kwargs)
    r = getattr(ref_gen, name)(*args, **kwargs)
    _assert_same_graph(g, r)


@pytest.mark.parametrize("case", CASES[:1] + CASES[5:6] + CASES[-1:],
                         ids=_ids)
def test_graph_carried_from_arrays(case):
    name, args, kwargs = case
    r = getattr(ref_gen, name)(*args, **kwargs)
    g = carry.graph_from_arrays(r.n, r.indptr, r.indices, labels=r.labels,
                                edge_labels=r.edge_labels)
    _assert_same_graph(g, r)


def test_device_arrays_are_int32_views():
    g = gen.labeled_graph(90, 300, 3, seed=4)
    d = g.device_arrays("cpu")
    for name, want in (("adj_bits", g.adj_bits),
                       ("gt_bits", ref_bitset.lt_mask_table(g.n)),
                       ("label_bits", g.label_bits)):
        assert d[name].dtype == torch.int32 and d[name].device.type == "cpu"
        np.testing.assert_array_equal(d[name].numpy().view(np.uint32), want)
    for name in ("degrees", "indptr", "indices", "labels"):
        np.testing.assert_array_equal(d[name].numpy(), getattr(g, name))
    np.testing.assert_array_equal(bitset.lt_mask_table(g.n),
                                  ref_bitset.lt_mask_table(g.n))


def test_neighbors_and_bfs_match_reference():
    g = gen.planted_clique_graph(300, 1200, 6, seed=3)
    r = ref_gen.planted_clique_graph(300, 1200, 6, seed=3)
    for v in (0, 17, 299):
        np.testing.assert_array_equal(g.neighbors(v), r.neighbors(v))
        np.testing.assert_array_equal(g.bfs_hops(v, 3), r.bfs_hops(v, 3))
    assert g.has_edge(*g.edge_array[0]) and r.has_edge(*g.edge_array[0])
