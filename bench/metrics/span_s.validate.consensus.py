"""span_s.validate.consensus: host seconds a round of the committee's host
work once the scores are on the host (the program's span
``validate.consensus``: the score table, the collusion overlay and the
median consensus), over the window's rounds.  None when the rounds carry
no spans.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    if not rounds:
        return None
    return sum(s["validate.consensus"].host_s for s in rounds
               if "validate.consensus" in s) / len(rounds)
