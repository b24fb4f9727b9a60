"""``passes.accumulate_ms`` (ms/step): the program's ``pass.accumulate``
device windows (a macro-step's ``index_copy_`` into the accumulator, its
sums and ``_cont_flag``), over the engine steps of the requests that ran
with no profiler; nothing where the program records no such window.  A
window is device stream time from the pass's first operation to its last,
the device's waits inside it for the host's enqueue included."""
from nuribench.passes import per_step_ms


def read(run):
    return per_step_ms(run, "pass.accumulate")
