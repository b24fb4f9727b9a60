"""``passes.select_ms`` (ms/step): the program's ``pass.select`` device
windows (``keep``, ``fits`` and its ``cumsum``, ``flat_prio``, the order
over B·A and the ``top_ci`` gathers), over the engine steps of the requests
that ran with no profiler; nothing where the program records no such
window.  A window is device stream time from the pass's first operation to
its last, the device's waits inside it for the host's enqueue included."""
from nuribench.passes import per_step_ms


def read(run):
    return per_step_ms(run, "pass.select")
