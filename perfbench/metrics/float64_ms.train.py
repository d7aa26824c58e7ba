"""Device ms a step of float64 kernels (Adam's rounding passes)."""


def read(tracer, window):
    steps = window.counts.get("steps")
    t = tracer.device_seconds("double")
    if not steps or t <= 0:
        return None
    return 1e3 * t / steps
