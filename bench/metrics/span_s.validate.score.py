"""span_s.validate.score: stream-elapsed seconds a round between the two
timing events of the program's span ``validate.score``, around the loop
of the committee's scoring forwards (each candidate against all members'
batches; the codec and the candidates' rebuild are outside it): the
forwards' device work and any idle time between their launches, over the
window's rounds.  None when the rounds carry no device time of that span.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    device = [s["validate.score"].device_s for s in rounds
              if "validate.score" in s]
    if not device or None in device:
        return None
    return sum(device) / len(rounds)
