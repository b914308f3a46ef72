"""``portbench/spans.py`` on the CPU: device seconds by program span over a
synthetic Chrome trace (correlation ids, the innermost span, the benchmark's
own ranges passed over, the fallback on device-side ranges, ``unattributed``),
and a tiny traced G1 run read through the program's spans and counters."""

import pytest

from portbench import spans
from portbench.tests import tiny


def _x(cat, name, ts, dur, correlation=None):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if correlation is not None:
        event["args"] = {"correlation": correlation}
    return event


def test_device_time_goes_to_the_innermost_span_of_its_launch():
    events = [
        _x("user_annotation", "g1.step", 0, 100),
        _x("user_annotation", "layout", 10, 30),
        _x("user_annotation", "portbench::layout", 12, 20),     # the benchmark's, passed over
        _x("user_annotation", "pair", 50, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 55, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 2, correlation=3),   # g1.step only
        _x("cuda_runtime", "cudaMemcpyAsync", 150, 2, correlation=4),   # outside every span
        _x("kernel", "DeviceRadixSortOnesweepKernel", 300, 40, correlation=1),
        _x("kernel", "ab_pair_forces_cell_kernel", 340, 60, correlation=2),
        _x("kernel", "step_rest_kernel", 400, 10, correlation=3),
        _x("gpu_memcpy", "Memcpy DtoH", 500, 5, correlation=4),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 300, "id": 1},
    ]
    got = spans.device_by_span(events)
    assert got == pytest.approx({"layout": 40e-6, "pair": 60e-6, "g1.step": 10e-6,
                                 "unattributed": 5e-6})


def test_without_correlation_the_device_ranges_decide():
    events = [
        _x("gpu_user_annotation", "tick", 100, 50),
        _x("gpu_user_annotation", "layout", 100, 20),
        _x("kernel", "searchsorted_cuda_kernel", 105, 5),
        _x("kernel", "contact_tick_kernel", 125, 20),
        _x("gpu_memset", "Memset", 200, 3),
    ]
    got = spans.device_by_span(events)
    assert got == pytest.approx({"layout": 5e-6, "tick": 20e-6, "unattributed": 3e-6})


def test_a_traced_tiny_g1_run_reads_the_program_spans(tmp_path):
    with spans.program_tracing() as seen:
        result = tiny.run(tiny.cell(tmp_path, "g1", metrics=["g1.tick_ms"]), trace=True)
    assert result["correct"] is True
    program = spans.report(seen, "g1")
    numbers = program["numbers"]
    assert set(numbers) == {"g1.step_host_ms", "g1.layout_device_ms_per_step",
                            "g1.merge_ms_per_tick", "g1.host_syncs_per_step",
                            "g1.reruns_per_dump", "g1.store_mib_per_frame"}
    assert all(v is not None and v >= 0 for v in numbers.values()), numbers
    assert numbers["g1.step_host_ms"] > 0 and numbers["g1.store_mib_per_frame"] > 0
    named = {s["name"] for s in program["spans"]}
    assert {"g1.step", "layout", "pair", "noise", "rest", "tick", "merge", "g1.frame",
            "store"} <= named
    assert not [s for s in program["spans"]
                if s["parent"] == "g1.step" and s["name"].startswith("sync.")]
    assert "device_by_span" in program
