"""stage_s.validate: seconds a round in the committee stage: the P x Q int8-view score matrix and median consensus.

The runtime's own stage timing (``RoundPipeline._timed``: host clock, a
device synchronize after the stage), summed over the window's rounds and
divided by them.
"""


def read(run):
    if not run.rounds:
        return None
    return sum(t.get("validate", 0.0) for t in run.timings) / run.rounds
