"""stage_s.train: seconds a round in the trainer stage: each cohort's local steps, batches drawn on the host.

The runtime's own stage timing (``RoundPipeline._timed``: host clock, a
device synchronize after the stage), summed over the window's rounds and
divided by them.
"""


def read(run):
    if not run.rounds:
        return None
    return sum(t.get("train", 0.0) for t in run.timings) / run.rounds
