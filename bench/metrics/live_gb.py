"""live_gb: the most device memory the allocator held at the end of a
streamed client's training or a candidate's rebuild (the program's counter
``live_bytes``, a round's largest reading of
``torch.cuda.memory_allocated``), the largest over the window's rounds,
in GB.  None when the rounds carry no such counter.
"""


def read(run):
    seen = [t.counts["live_bytes"] for t in run.timings
            if hasattr(t, "counts") and "live_bytes" in t.counts]
    if not seen:
        return None
    return max(seen) / 1e9
