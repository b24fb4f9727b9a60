"""``kernel.scoring_roofline`` (%): the least time of the scoring work the
engine steps of the window's profiled part need, over the device time of
the scoring kernels there (``masked_intersect_kernel*``, every variant and
launch).

One clique step scores its ``[B, W]`` candidate rows against the
``[N, W]`` adjacency columns (``B`` the request's ``batch``, ``N`` the
graph's vertices, ``W = ceil(N / 32)`` words): 4 (B W + N W + B N) bytes
at the card's 3.35 TB/s (``nuribench/roofline.py``), 0.0838 ms at B = 64,
N = 46,336.  The count is of the work a step needs, not of the launches
that do it, so no-op launches after a macro-step's exit add time and no
work.  Only the clique workload's unmasked scoring is counted here."""
from nuribench.roofline import scoring_bound_s

SCORING = "masked_intersect_kernel"      # every variant: _mma, _rows, the tile


def read(run):
    if run.device is None or run.config["request"]["workload"] != "clique":
        return None
    sent = run.device_part()
    steps = run.steps(sent)
    busy = run.device.seconds_of(SCORING)
    if not steps or busy <= 0:
        return None
    batch = int(sent[0].fields["batch"])
    least = steps * scoring_bound_s(batch, run.config["num_vertices"],
                                    masked=False)
    return 100.0 * least / busy
