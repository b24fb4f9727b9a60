"""The generator of the maximum-weight clique configurations on the
paper's densification protocol: ``densifying_graph``'s edges (the same
``num_vertices``, ``num_edges`` and seed give the same edges), no labels,
and the request field ``weights``, one a vertex, in the DIMACS-W
convention of the maximum-weight clique literature: ``w(i) = (i mod
weight_period) + 1`` (``weight_period`` 200).  The weights draw no random
number."""
import numpy as np

from nuribench.gen import graphs


def make(config: dict, seed: int) -> dict:
    data = graphs.densifying_graph(config["num_vertices"],
                                   config["num_edges"], seed)
    period = int(config["weight_period"])
    data["request"] = dict(
        weights=(np.arange(data["n"]) % period + 1).tolist())
    return data
