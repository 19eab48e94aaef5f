"""Device time of a call on the card, not paced by the host.

A kernel shorter than its wrapper's host cost, timed by events around a
loop of calls, reads the host's issue rate. `device_ms` queues the timed
calls behind a device-side wait long enough for the host to enqueue all
of them, so the events measure the device alone. `busy_union_us` reads a
torch.profiler trace's device busy time.
"""

from __future__ import annotations

import time

import torch


def device_ms(fn, reps: int = 20) -> float:
    """Device ms per call of `fn` on the current CUDA stream: 3 warm-up
    calls, then `reps` calls queued behind a device-side wait of twice the
    host's enqueue time of the same calls plus 1 ms (counted at 2 GHz)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_floor_ms(device=None, reps: int = 20) -> dict:
    """The card's floor for a kernel launch, timed as `device_ms` times
    the kernels: device ms per launch of an empty kernel of one block of
    256 threads, and of one full wave of 256-thread blocks (8 a
    multiprocessor), keyed "one block" and "one wave"."""
    from openfoam_tpp_tpu_torch.ops.kernels import _build
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

    dev = torch.device("cuda") if device is None else torch.device(device)
    lib = sp._batch_lib()
    stream = _build.stream_of(torch.empty(1, device=dev))
    wave = torch.cuda.get_device_properties(dev).multi_processor_count * 8

    def empty(blocks):
        return lambda: _build.check(
            lib.seven_point_batch_empty_launch(blocks, 256, stream),
            "empty kernel")

    return {"one block": device_ms(empty(1), reps),
            "one wave": device_ms(empty(wave), reps), "wave_blocks": wave}


def busy_union_us(events) -> float:
    """µs in which at least one of a torch.profiler trace's device events
    (kernels, copies, fills) runs: the union of their intervals."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == cuda)
    total, start, end = 0.0, None, None
    for s, e in spans:
        if end is None or s > end:
            total += 0.0 if end is None else end - start
            start, end = s, e
        else:
            end = max(end, e)
    return total + (0.0 if end is None else end - start)
