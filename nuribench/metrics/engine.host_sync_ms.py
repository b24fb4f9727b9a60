"""``engine.host_sync_ms`` (ms/step): the program's ``engine.host_sync``
span (the host's wait for the device and the read of a step's stats), over
the engine steps of the requests that ran with no profiler."""


def read(run):
    sent = run.host_part()
    steps = run.steps(sent)
    return 1e3 * run.span_s("engine.host_sync", sent) / steps \
        if steps else None
