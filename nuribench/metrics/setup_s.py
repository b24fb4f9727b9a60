"""``setup_s`` (s): from the first line of ``run.py`` until the window's
first request is sent: imports, the kernels' build or its cache, the data
graph, the service, the warm-up request (the iso index and the first
engine with it)."""


def read(run):
    return run.setup_s
