"""``kernel.wscoring_roofline`` (%): the least time of the weighted scoring
work that the engine steps of the window's profiled part need, over the
device time of the kernel that does it there (``masked_intersect_kernel*``:
in a ``weighted-clique`` cell every launch of it is the scoring's one call
a step over the weights' bit planes).

One step scores its ``B`` candidate rows against the ``N`` vertices' ext
rows, each sum the weight of an intersection: 4 (B W + N W + B N) + 4 N
bytes at 3.35 TB/s (``nuribench/wroofline.py``), 0.0838 ms at B = 64, N =
46,336.  The rows' AND with the planes before the kernel and the planes'
shift and sum after it are not in the time (they are generic elementwise
kernels, in ``passes.score_ms``).  No-op launches after a macro-step's exit
add time and no work.  Nothing is read outside the weighted workload."""
from nuribench.wroofline import wscoring_bound_s

SCORING = "masked_intersect_kernel"      # every variant: _mma, _rows, the tile


def read(run):
    if run.device is None or \
            run.config["request"]["workload"] != "weighted-clique":
        return None
    sent = run.device_part()
    steps = run.steps(sent)
    busy = run.device.seconds_of(SCORING)
    if not steps or busy <= 0:
        return None
    batch = int(sent[0].fields["batch"])
    least = steps * wscoring_bound_s(batch, run.config["num_vertices"])
    return 100.0 * least / busy
