"""The share of the traced training window in which no operation ran on
the device, %."""


def read(tracer, window):
    if "steps" not in window.counts or tracer.window_s <= 0:
        return None
    return 100.0 * (1.0 - tracer.busy_s / tracer.window_s)
