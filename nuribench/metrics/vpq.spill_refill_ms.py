"""``vpq.spill_refill_ms`` (ms/step): the program's ``engine.spill`` and
``engine.refill`` spans (the overflow's copy to the host queue; the pops,
late pruning, copy back and insert), over the engine steps of the
requests that ran with no profiler; nothing where none of them spilled."""


def read(run):
    sent = run.host_part()
    steps = run.steps(sent)
    spilled = sum(s.response["stats"].get("spilled", 0) for s in sent)
    if not steps or not spilled:
        return None
    return 1e3 * (run.span_s("engine.spill", sent)
                  + run.span_s("engine.refill", sent)) / steps
