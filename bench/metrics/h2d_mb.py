"""h2d_mb: megabytes a round copied from the host to the device through
the program's staging copy (its counter ``h2d_bytes``: the cohort's
batches, the members' validation batches, the aggregation weights), over
the window's rounds.  None when the rounds carry no counters.
"""


def read(run):
    rounds = [t.counts for t in run.timings if hasattr(t, "counts")]
    if not rounds:
        return None
    return sum(c.get("h2d_bytes", 0) for c in rounds) / len(rounds) / 1e6
