"""stage_s.aggregate: seconds a round in the aggregator: fused int8 fedavg and the model block's append.

The runtime's own stage timing (``RoundPipeline._timed``: host clock, a
device synchronize after the stage), summed over the window's rounds and
divided by them.
"""


def read(run):
    if not run.rounds:
        return None
    return sum(t.get("aggregate", 0.0) for t in run.timings) / run.rounds
