"""stage_s.host_other: seconds a round in the round loop's host stages:
sampling the active nodes, electing the next committee and paying
rewards (the runtime's ``sample``, ``elect`` and ``reward`` timings),
summed over the window's rounds and divided by them.
"""

KEYS = ("sample", "elect", "reward")


def read(run):
    if not run.rounds:
        return None
    return sum(t.get(k, 0.0) for t in run.timings for k in KEYS) / run.rounds
