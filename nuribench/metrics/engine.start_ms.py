"""``engine.start_ms`` (ms/request): the program's ``engine.start`` span
(the seeds' frontier; with more seeds than the pool holds, their read-back,
sort and push to the spill queue), over the requests that ran with no
profiler."""


def read(run):
    sent = run.host_part()
    if not sent:
        return None
    return 1e3 * run.span_s("engine.start", sent) / len(sent)
