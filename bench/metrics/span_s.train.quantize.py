"""span_s.train.quantize: stream-elapsed seconds a round of the program's
span ``train.quantize`` (each streamed client's update flattened and
quantized into its row of the cohort's int8 stack, read after the round),
over the window's rounds.  None when the rounds carry no device time of
that span.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    device = [s["train.quantize"].device_s for s in rounds
              if "train.quantize" in s]
    if not device or None in device:
        return None
    return sum(device) / len(rounds)
