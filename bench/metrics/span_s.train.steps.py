"""span_s.train.steps: stream-elapsed seconds a round between the two
timing events of the program's span ``train.steps``, around the trainer's
launches of the cohort's local steps (read after the round): the steps'
device work and any idle time between their launches, over the window's
rounds.  None when the rounds carry no device time of that span.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    device = [s["train.steps"].device_s for s in rounds
              if "train.steps" in s]
    if not device or None in device:
        return None
    return sum(device) / len(rounds)
