"""Device time of a call on the card, not paced by the host.

A kernel shorter than its wrapper's host cost, timed by events around a
loop of calls, reads the host's issue rate. `device_ms` queues the timed
calls behind a device-side wait long enough for the host to enqueue all
of them, so the events measure the device alone.
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
