"""G's products in the traced window over the window, as a % of the
H100's dense TF32 peak (495 TFLOP/s at 700 W)."""
from perfbench.lib import counts


def read(tracer, window):
    flops = window.counts.get("g_flops_per_call")
    if flops is None or tracer.window_s <= 0:
        return None
    done = flops * window.counts["calls"]
    return 100.0 * done / tracer.window_s / counts.PEAK_TF32_FLOPS
