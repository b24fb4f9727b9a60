"""``passes.materialize_ms`` (ms/step): the program's ``pass.materialize``
device windows (``states_b[sel_parent]``, ``materialize`` (``set_bit``,
``ext_mask[actions]``, ``_pack`` with its popcount) and the ``where`` calls),
over the engine steps of the requests that ran with no profiler; nothing
where the program records no such window.  A window is device stream time
from the pass's first operation to its last, the device's waits inside it
for the host's enqueue included."""
from nuribench.passes import per_step_ms


def read(run):
    return per_step_ms(run, "pass.materialize")
