"""span_s.validate.rebuild: stream-elapsed seconds a round of the program's
span ``validate.rebuild`` (each candidate rebuilt from its int8 row before
it is scored, in the streamed round, read after the round), over the
window's rounds.  None when the rounds carry no device time of that span.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    device = [s["validate.rebuild"].device_s for s in rounds
              if "validate.rebuild" in s]
    if not device or None in device:
        return None
    return sum(device) / len(rounds)
