"""The share of the traced exploring window in which no operation ran on
the device, %."""


def read(tracer, window):
    if "calls" not in window.counts or tracer.window_s <= 0:
        return None
    return 100.0 * (1.0 - tracer.busy_s / tracer.window_s)
