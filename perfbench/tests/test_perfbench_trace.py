"""The traced run's arithmetic on made-up events: busy time as a union,
idle time shared out by span, per-name sums and the readers on them."""
from __future__ import annotations

from perfbench.lib import counts, harness
from perfbench.lib.trace import Tracer


def traced(events, spans, t0=1000, t1=2000, mark=500):
    tr = Tracer("cpu")
    tr.spans = spans
    tr.window_s = (t1 - t0) / 1e9
    # the profiler's clock runs 7 ns ahead of the host's
    tr.reduce([(mark + 7, 1, "marker")]
              + [(a + 7, d, n) for a, d, n in events], mark, t0, t1)
    return tr


def test_busy_is_a_union_and_idle_goes_to_spans():
    tr = traced([(1100, 200, "gemm_3xtf32_kernel<1>"),
                 (1200, 200, "gemm_3xtf32_kernel<1>"),   # overlaps
                 (1700, 100, "vectorized_elementwise_kernel<double>")],
                [("G", 1000, 1500), ("select", 1500, 2000)])
    assert tr.busy_s * 1e9 == 400 and tr.by_name["marker"] == [0, 0.0]
    assert tr.by_name["gemm_3xtf32_kernel<1>"][0] == 2
    idle = {k: round(v * 1e9) for k, v in tr.idle_by_span.items()}
    assert idle == {"G": 200, "select": 400}
    assert tr.device_seconds("gemm_3xtf32") * 1e9 == 400
    assert tr.device_seconds("double") * 1e9 == 100


def test_readers_on_a_trace():
    tr = traced([(1000, 500, "gemm3::gemm_3xtf32_kernel<false>")],
                [("G", 1000, 1400), ("select", 1400, 2000)])
    win = harness.Window({}, 1, 0, counts={
        "calls": 2, "tasks": 8, "candidates": 40,
        "g_flops_per_call": 4.95e3, "g_bound_s_per_call": 1e-7})
    read = {m: harness.load_reader(m)(tr, win) for m in (
        "mlp_forward_roofline.explore", "device_idle.explore",
        "candidates_per_task.explore", "g_ms.explore", "explore_mfu",
        "dense_roofline.train")}
    assert abs(read["mlp_forward_roofline.explore"] - 100 * 2e-7 / 5e-7) < 1e-9
    assert abs(read["device_idle.explore"] - 50.0) < 1e-9
    assert read["candidates_per_task.explore"] == 5.0
    assert abs(read["g_ms.explore"] - 4e-4) < 1e-12
    assert abs(read["explore_mfu"] - 100 * 9.9e3 / 1e-6 / 495e12) < 1e-12
    assert read["dense_roofline.train"] is None     # not a training window
    assert counts.PEAK_TF32_FLOPS == 495e12


def test_a_trace_with_no_device_work_reads_nothing():
    tr = Tracer("cpu")
    tr.reduce([], 0, 0, 10)
    win = harness.Window({}, 1, 0, counts={"steps": 3, "step_flops": 1.0,
                                         "dense_bound_s_per_step": 1.0})
    assert harness.load_reader("dense_roofline.train")(tr, win) is None
    assert harness.load_reader("float64_ms.train")(tr, win) is None
