"""span_s.train.h2d: host seconds a round of the trainer's host-to-device
copies (the program's span ``h2d`` with the stage ``train`` as parent:
the cohort's batches staged in pinned memory and their copies enqueued),
over the window's rounds.  None when the rounds carry no spans.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    if not rounds:
        return None
    return sum(s["h2d"].parents.get("train", 0.0) for s in rounds
               if "h2d" in s) / len(rounds)
