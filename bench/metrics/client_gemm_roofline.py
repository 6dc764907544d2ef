"""client_gemm_roofline: the CNN trainer's per-client products (the eleven
of each SGD step: forwards, input gradients, weight gradients with their
bias gradients) against their bound, in percent.  The bound is
``counts.gemm_step_bound_s`` for the profiled rounds' trainers and local
steps; the time is the device time of every kernel named below in the
profiled rounds.
"""

KERNELS = ("client_gemm_",)     # the tile, streaming and split-K reduce kernels


def read(run):
    if run.trace is None or not hasattr(run.family, "gemm_bound_s"):
        return None
    seconds = run.trace.time_of(KERNELS)
    if seconds <= 0:
        return None
    trainers = sum(log["trainers"] for log in run.traced_logs)
    bound = run.family.gemm_bound_s(run.spec.config, run.spec.traffic["bflc"],
                                    trainers)
    return 100.0 * bound / seconds
