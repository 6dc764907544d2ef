"""mfu: the window's share of the card's float32 peak, in percent: the
FLOPs its rounds need, counted from the shapes (the family's
``round_flops``: every trainer's local steps and every committee
validation's forward), over the window's seconds and 67 TFLOP/s.  Work
repeated or wasted by an implementation does not count.
"""
from bench import counts


def read(run):
    if not run.rounds or run.window_s <= 0:
        return None
    flops = sum(run.round_flops(log) for log in run.logs)
    return 100.0 * flops / run.window_s / counts.F32_FLOPS_PER_S
