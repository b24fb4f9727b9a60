"""``passes.dequeue_ms`` (ms/step): the program's ``pass.dequeue`` device
windows (``Engine._dequeue_merge``: the order over the pool, the gathers,
``index_put``, ``result_key`` and ``merge_topk``), over the engine steps of
the requests that ran with no profiler; nothing where the program records
no such window.  A window is device stream time from the pass's first
operation to its last, the device's waits inside it for the host's enqueue
included."""
from nuribench.passes import per_step_ms


def read(run):
    return per_step_ms(run, "pass.dequeue")
