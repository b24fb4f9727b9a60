"""``device.idle_share`` (%): the share of the profiled part's wall time
in which no kernel, copy or set ran on the device."""


def read(run):
    if run.device is None or run.device.window_s <= 0 or \
            not run.device.busy:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
