"""``query_s`` (s/query): the window's wall time, from its first send to
the answer of the last request sent before ``--seconds`` ran out, over the
requests answered in it."""


def read(run):
    answered = [s for s in run.sent if s.recv is not None]
    return (run.end - run.start) / len(answered) if answered else None
