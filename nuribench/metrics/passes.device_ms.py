"""``passes.device_ms`` (ms/step): the device's busy time in the profiled
part of the window (the union of its kernels, copies and sets) less the
scoring kernel's (``masked_intersect_kernel*``), over the engine steps of
the profiled requests: the engine's own device passes (dequeue and merge,
expand and insert, ``merge_topk``, the accumulator, copies)."""

SCORING = "masked_intersect_kernel"      # every variant: _mma, _rows, the tile


def read(run):
    if run.device is None:
        return None
    steps = run.steps(run.device_part())
    if not steps or not run.device.busy:
        return None
    return 1e3 * (run.device.busy_s
                  - run.device.seconds_of(SCORING)) / steps
