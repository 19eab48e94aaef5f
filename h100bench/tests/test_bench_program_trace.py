"""The program-span segment (program_trace.py): its reduction on a made-up
trace, and one segment of the tiny sweep on the CPU."""

import time

import numpy as np
import pytest
import torch

from h100bench import harness, program_trace
from h100bench.tests import tiny
from openfoam_tpp_tpu_torch.utils import profiling


def test_reduce_gives_each_gap_to_the_innermost_span():
    S = profiling.Span
    rec = profiling.Record(
        spans=[S("step", 100, 1000, None, 0), S("pressure.cg", 300, 800, 0, 0),
               S("host.sync", 400, 500, 1, 0)],
        host_reads={"poisson.cg": 3}, launches={"seven_point.apply_7pt": 4},
        steps=1)
    events = [("kernel_a", 100, 200, True, 0), ("kernel_b", 250, 350, True, 0),
              ("kernel_c", 600, 700, True, 0),
              ("kernel_d", 1100, 1150, True, 2),
              ("pressure.cg", 300, 800, True, 0),  # a mirrored span: not busy
              ("cudaLaunchKernel", 150, 160, False, 1),
              ("cudaLaunchKernel", 1050, 1060, False, 2)]
    r = program_trace.reduce(events, rec, 100, 1200)
    assert r.busy_s == pytest.approx(350e-9)
    assert r.idle_s == pytest.approx(750e-9)
    assert r.idle_by_span == pytest.approx({
        "step": 450e-9, "host.sync in pressure.cg": 250e-9,
        program_trace.BETWEEN: 50e-9})
    assert r.cg_idle_s == pytest.approx(350e-9) and r.cg_calls == 1
    assert (r.launch_calls, r.launch_calls_in_step) == (2, 1)
    assert (r.kernels_paired, r.kernels_after_launch) == (1, 1)
    assert r.launch_lag_min_ns == r.launch_lag_max_ns == 50
    assert program_trace.metrics(r) == pytest.approx({
        "host.syncs_per_step": 3.0, "host.sync_wait_ms_per_step": 1e-4,
        "pressure.cg_idle_ms_per_step": 3.5e-4})
    assert "host.sync in pressure.cg" in program_trace.table(r)


@pytest.mark.parametrize("offset", [0, -30, 20])
def test_reduce_shows_a_device_clock_offset(offset):
    """Kernels paired with their launch calls by correlation id: a device
    clock behind the host's puts kernels before their launches, one ahead
    raises the smallest lag."""
    rec = profiling.Record(spans=[profiling.Span("step", 0, 1000, None, 0)],
                           steps=1)
    launch = [("cudaLaunchKernel", 100 * i, 100 * i + 5, False, 10 + i)
              for i in range(1, 6)]
    lag = [10, 25, 10, 40, 15]          # true launch-to-start lags
    kernels = [(f"k{i}", a + d + offset, a + d + offset + 30, True, cid)
               for (_, a, _, _, cid), d, i in zip(launch, lag, range(5))]
    other = [("aten::add", 120, 130, False, 11)]  # a host op: no launch
    r = program_trace.reduce(launch + kernels + other, rec, 0, 1000)
    assert r.launch_calls == r.launch_calls_in_step == 5
    assert r.kernels_paired == 5
    assert r.kernels_after_launch == sum(d + offset >= 0 for d in lag)
    assert (r.launch_lag_min_ns, r.launch_lag_max_ns) == (10 + offset,
                                                          40 + offset)


def test_a_segment_of_the_tiny_sweep_counts_its_cg_tests():
    _, _, config, traffic = tiny.cell(tiny.SWEEP)
    dev = torch.device("cpu")
    system = harness.load_module("systems", config["system"]).build(
        config, dev)
    inputs = harness.tank(config).make_inputs(config, traffic, 77, dev)
    carry0 = system.start(inputs)
    n = 3
    held = {}

    def segment():
        held["out"] = harness._segment(system, carry0, n)

    t0 = time.perf_counter()
    r = program_trace.profile_program(segment, on_card=False)
    assert time.perf_counter() - t0 < 120
    iters = harness._records(held["out"][1])[:, 3].max(axis=1)
    m = program_trace.metrics(r)
    assert r.steps == n and r.cg_calls == n
    assert m["host.syncs_per_step"] == pytest.approx(np.mean(iters) + 1.0)
    assert r.busy_s == 0.0 and sum(r.idle_by_span.values()) == pytest.approx(
        r.idle_s)
