"""``kernel.wchildren_roofline`` (%): the least time of the weighted child
rows' work in the window's profiled part, over the device time of the
kernel that writes them there (``clique_children_kernel``: in a
``weighted-clique`` cell every launch is its weighted form, one a step).

A step writes ``M`` rows of ``S = 2W + 2`` int32 words (``M`` = the
graph's ``N`` vertices, the engine's child block) and reads their valid
flags, and each valid row (a child, counted by the responses'
``candidates`` less the ``N`` seeds) reads its vertex's ext row and its
two int64 indices: ``nuribench/wroofline.py``, at 3.35 TB/s, 0.160 ms a
step for the block at N = 46,336.  Nothing is read outside the weighted
workload."""
from nuribench.wroofline import wchildren_bound_s

CHILDREN = "clique_children_kernel"


def read(run):
    if run.device is None or \
            run.config["request"]["workload"] != "weighted-clique":
        return None
    sent = run.device_part()
    steps = run.steps(sent)
    busy = run.device.seconds_of(CHILDREN)
    if not steps or busy <= 0:
        return None
    n = run.config["num_vertices"]
    children = sum(max(0, s.response["stats"].get("candidates", 0) - n)
                   for s in sent if s.response and s.response.get("stats"))
    return 100.0 * wchildren_bound_s(steps, n, n, children) / busy
