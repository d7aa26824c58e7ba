"""The select's share of an exploring call (enumerate, the float32
oracle, Algorithm 2's chain, the float64 host tail): ms a call on the
host clock."""
import statistics


def read(tracer, window):
    spans = tracer.span_seconds("select")
    return 1e3 * statistics.fmean(spans) if spans else None
