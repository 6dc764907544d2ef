"""span_s.train.client: stream-elapsed seconds a client of the program's
span ``train.client`` (one client's local steps in the streamed round,
read after the round), summed over the window's rounds and divided by
their trainers.  None when the rounds carry no device time of that span.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    device = [s["train.client"].device_s for s in rounds
              if "train.client" in s]
    clients = sum(log["trainers"] for log in run.logs)
    if not device or None in device or not clients:
        return None
    return sum(device) / clients
