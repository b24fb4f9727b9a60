"""The benchmark's frozen generator: determinism, the stated sizes, and
byte equality with the program's generator it was copied from."""
from pathlib import Path

import numpy as np
import pytest

from nuribench import harness
from nuribench.gen import graphs
from repro_torch.core.graph import GraphStore
from repro_torch.data import synthetic_graphs

ROOT = Path(__file__).resolve().parents[2]
SEEDS = [0, 7, 2 ** 31 + 11]


def _pairs(edges, n):
    e = np.asarray(edges, np.int64)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(np.minimum(e[:, 0], e[:, 1]) * n
                     + np.maximum(e[:, 0], e[:, 1]))


@pytest.mark.parametrize("seed", SEEDS)
def test_densifying_graph_is_deterministic_and_sized(seed):
    a = graphs.densifying_graph(400, 2000, seed)
    b = graphs.densifying_graph(400, 2000, seed)
    assert a["n"] == 400 and np.array_equal(a["edges"], b["edges"])
    assert len(a["edges"]) == 2000 == len(_pairs(a["edges"], 400))
    assert a["edges"].min() >= 0 and a["edges"].max() < 400
    other = graphs.densifying_graph(400, 2000, seed + 1)
    assert not np.array_equal(a["edges"], other["edges"])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n,m", [(60, 200), (600, 5000), (30, 400)])
def test_generators_equal_the_programs(seed, n, m):
    """(30, 400) fills most pairs, so the draw takes several batches."""
    want = synthetic_graphs.densifying_graph(n, m, seed=seed)
    got = graphs.densifying_graph(n, m, seed)
    assert GraphStore.from_edges(n, got["edges"]).fingerprint == \
        want.fingerprint


def test_too_many_edges_are_refused():
    with pytest.raises(ValueError):
        graphs.densifying_edges(5, 11, 0)


def test_make_graph_reads_a_configurations_sizes():
    """A configuration's generator file reads its own size keys."""
    config = dict(generator="densifying_graph", num_vertices=300,
                  num_edges=900, other_key=4)
    g = harness.make_data(ROOT, config, 3)
    want = graphs.densifying_graph(300, 900, 3)
    assert g["n"] == 300 and np.array_equal(g["edges"], want["edges"])
    assert set(g) == {"n", "edges"}


def test_make_data_refuses_what_data_does_not_hold(tmp_path):
    gen = tmp_path / "nuribench" / "gen"
    gen.mkdir(parents=True)
    (gen / "odd.py").write_text(
        "def make(config, seed):\n"
        "    return dict(n=2, edges=[[0, 1]], weights=[1, 1])\n")
    with pytest.raises(ValueError, match="weights"):
        harness.make_data(tmp_path, dict(generator="odd"), 0)
