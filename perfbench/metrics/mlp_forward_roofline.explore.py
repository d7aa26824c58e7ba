"""The whole-MLP forward's share of its roofline, %: the least time G's
products need at the call's rows (perfbench/lib/counts.py) over the device
time of the tensor-core tile's kernels, which only G launches while
exploring."""
KERNELS = ("gemm_3xtf32", "reduce_splits")


def read(tracer, window):
    t = tracer.device_seconds(*KERNELS)
    bound = window.counts.get("g_bound_s_per_call")
    if t <= 0 or bound is None:
        return None
    return 100.0 * bound * window.counts["calls"] / t
