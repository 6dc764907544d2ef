"""span_s.train.draw: host seconds a round in which the trainer draws the
cohort's local batches on the host (the program's span ``train.draw``:
each trainer's gather of its steps x batch rows and the two stacks), over
the window's rounds.  None when the rounds carry no spans.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    if not rounds:
        return None
    return sum(s["train.draw"].host_s for s in rounds
               if "train.draw" in s) / len(rounds)
