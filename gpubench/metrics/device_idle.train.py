"""device_idle: the share of the traced window in which no operation ran on
the device (the union of the profiler's device intervals), in %."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
