"""G's share of an exploring call: encode, noise, the host-to-device copy
and the whole-MLP forward, ms a call on the host clock, each span ended by
a synchronize."""
import statistics


def read(tracer, window):
    spans = tracer.span_seconds("G")
    return 1e3 * statistics.fmean(spans) if spans else None
