"""The dense kernels' share of their roofline, %: the least time of the
products one Algorithm 1 step needs (perfbench/lib/counts.py) times the
steps, over the device time of the tensor-core tile's kernels (the dense
forward, dx and dW/db with their split sums and ReLU masks)."""
KERNELS = ("gemm_3xtf32", "reduce_splits", "relu_mask")


def read(tracer, window):
    t = tracer.device_seconds(*KERNELS)
    bound = window.counts.get("dense_bound_s_per_step")
    if t <= 0 or bound is None:
        return None
    return 100.0 * bound * window.counts["steps"] / t
