"""``engine.enqueue_ms`` (ms/step): the program's ``engine.device_compute``
span, which times the host's enqueue of a step's device work (and at
``steps_per_sync`` > 1 its waits on a full launch queue), over the engine
steps of the requests that ran with no profiler."""


def read(run):
    sent = run.host_part()
    steps = run.steps(sent)
    return 1e3 * run.span_s("engine.device_compute", sent) / steps \
        if steps else None
