"""``passes.insert_ms`` (ms/step): the program's ``pass.insert`` device
windows (``_insert_impl`` of pool, children and deferred parents, and the
stats ``stack``), over the engine steps of the requests that ran with no
profiler; nothing where the program records no such window.  A window is
device stream time from the pass's first operation to its last, the
device's waits inside it for the host's enqueue included."""
from nuribench.passes import per_step_ms


def read(run):
    return per_step_ms(run, "pass.insert")
