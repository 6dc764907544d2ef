"""stage_s.pack: seconds a round in the packer: the top k int8 blocks appended to the chain (SHA-256 over host copies).

The runtime's own stage timing (``RoundPipeline._timed``: host clock, a
device synchronize after the stage), summed over the window's rounds and
divided by them.
"""


def read(run):
    if not run.rounds:
        return None
    return sum(t.get("pack", 0.0) for t in run.timings) / run.rounds
