"""``service.own_ms`` (ms/request): the program's ``service.admit``
(validation, the cache key, the task and its ``engine.start``, and on an
engine-cache miss ``service.compile``) and ``service.finalize`` (the task's
finalize and its response) spans less ``engine.start``, over the requests
that ran with no profiler; nothing where the program records no
``service.admit`` span.  The in-program counterpart of ``service.host_ms``,
which is a residual of the client's clock."""


def read(run):
    sent = run.host_part()
    if not sent or not any(s[0] == "service.admit" for s in run.spans):
        return None
    own = run.span_s("service.admit", sent) + \
        run.span_s("service.finalize", sent) - run.span_s("engine.start", sent)
    return 1e3 * own / len(sent)
