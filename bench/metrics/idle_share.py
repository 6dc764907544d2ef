"""idle_share: the share of the profiled rounds' wall time in which no
operation ran on the device (1 - the union of the device events'
intervals over the wall time), in percent.  Profiling adds host time,
so this is an upper bound of the unprofiled rounds' idle share.
"""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
