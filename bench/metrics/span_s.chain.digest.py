"""span_s.chain.digest: host seconds a round of the chain's SHA-256 (the
program's span ``chain.digest``: each block payload copied to the host
and hashed, in the packer's and the aggregator's appends), over the
window's rounds.  None when the rounds carry no spans.
"""


def read(run):
    rounds = [t.spans for t in run.timings if hasattr(t, "spans")]
    if not rounds:
        return None
    return sum(s["chain.digest"].host_s for s in rounds
               if "chain.digest" in s) / len(rounds)
