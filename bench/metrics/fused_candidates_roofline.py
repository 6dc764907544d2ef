"""fused_candidates_roofline: rebuilding the committee's candidates from
the int8 rows (base + dequant(q), one launch a cohort of P rows at the
padded dimension) against its bound, in percent.  The bound is
``counts.fused_candidates_bound_s`` of each profiled cohort; the time is
the device time of the kernel named below in the profiled rounds.
"""
from bench import counts

KERNELS = ("fused_candidates_kernel",)


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.time_of(KERNELS)
    if seconds <= 0:
        return None
    bound = 0.0
    for log in run.traced_logs:
        full, rest = divmod(log["trainers"], run.p_trainers)
        bound += full * counts.fused_candidates_bound_s(run.p_trainers, run.dim)
        if rest:
            bound += counts.fused_candidates_bound_s(rest, run.dim)
    return 100.0 * bound / seconds
