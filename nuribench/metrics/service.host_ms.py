"""``service.host_ms`` (ms/request): the host's time in ``serve`` outside
the program's ``service.drive`` and ``engine.start`` spans (validation,
the task's compile, finalize and the response's copies), over the
requests that ran with no profiler."""


def read(run):
    sent = run.host_part()
    if not sent:
        return None
    wall = sum(s.recv - s.send for s in sent)
    inside = run.span_s("service.drive", sent) + \
        run.span_s("engine.start", sent)
    return 1e3 * (wall - inside) / len(sent)
