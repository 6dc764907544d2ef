"""chain_hash_gbps: the chain's hashing rate, GB/s: the bytes the round's
block digests hashed (the program's counter ``chain_hashed_bytes``) over
the host seconds of its span ``chain.digest``, summed over the window's
rounds.  None when the rounds carry no spans or hashed nothing.
"""


def read(run):
    rounds = [t for t in run.timings if hasattr(t, "spans")]
    seconds = sum(t.spans["chain.digest"].host_s for t in rounds
                  if "chain.digest" in t.spans)
    hashed = sum(t.counts.get("chain_hashed_bytes", 0) for t in rounds)
    if seconds <= 0 or not hashed:
        return None
    return hashed / seconds / 1e9
