"""The generator of the configurations on the paper's densification
protocol: ``num_vertices`` vertices and ``num_edges`` random distinct
edges (:func:`nuribench.gen.graphs.densifying_graph`), no labels and no
request fields."""
from nuribench.gen import graphs


def make(config: dict, seed: int) -> dict:
    return graphs.densifying_graph(config["num_vertices"],
                                   config["num_edges"], seed)
