"""The port's own spans on the device trace's clock: a traced segment with
CUDA activity only (as trace.py's first, so the host runs near untraced
speed) and the port's `utils/profiling.collect()` on.

The port stamps its spans with `time.time_ns()`, the unix-epoch clock
kineto reports its events on, so the spans and the device's busy
intervals share one timeline. Each idle gap between the busy intervals
(within the segment: from just before its first step to after its last
synchronize) goes to the innermost program span open at the gap's
midpoint, a `host.sync` span named with its parent ("host.sync in
pressure.cg"); a gap inside no span goes to "between steps", the
harness's synchronize at each step's end.

The readings, per step of the segment (`metrics`):
  host.syncs_per_step         host reads (`profiling.host_read`) a step
  host.sync_wait_ms_per_step  the `host.sync` spans' time a step: the
                              host blocked while the device works
  pressure.cg_idle_ms_per_step  device idle inside `pressure.cg` spans
                              a step (the gaps' overlap with the spans)

That the device's stamps share the spans' clock is read from the trace
itself. The launch calls (host side) lie inside the `step` spans; each
kernel is paired with its launch call by correlation id, and its lag
(kernel start - launch start, `ProgramReading.launch_lag_*`) would be
negative under a device clock behind the host's, and its smallest lag
bounds one ahead of it.

harness.py does not run this segment; scripts/port_program_trace.py
does.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

from h100bench.trace import _innermost, _union
from openfoam_tpp_tpu_torch.utils import profiling

BETWEEN = "between steps"


@dataclasses.dataclass
class ProgramReading:
    steps: int
    window_s: float          # the segment, first step's start to last sync
    busy_s: float            # union of the device's busy intervals in it
    idle_s: float            # window - busy
    idle_by_span: dict       # span name -> idle s (sums to idle_s)
    cg_idle_s: float         # idle inside pressure.cg spans
    cg_calls: int            # pressure.cg spans
    host_reads: dict         # site -> reads over the segment
    sync_wait_s: float       # summed host.sync span time
    launches: dict           # kernel entry -> launches over the segment
    launch_calls: int        # kernel-launch runtime calls in the window
    launch_calls_in_step: int  # ... of them inside a `step` span
    kernels_paired: int      # kernels paired with their launch call
    kernels_after_launch: int  # ... of them starting at or after it
    launch_lag_min_ns: int | None  # kernel start - launch call start
    launch_lag_max_ns: int | None


def profile_program(segment, on_card=True) -> ProgramReading:
    """Profile one call of `segment()` (its steps each end in a
    synchronize) with the port's spans on. Off the card (the tests) the
    profile records the host alone, so nothing is busy."""
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    sync()
    with profile(activities=acts) as prof:
        with profiling.collect() as rec:
            lo = time.time_ns()
            segment()
            sync()
            hi = time.time_ns()
    events = [(k.name(), k.start_ns(), k.start_ns() + k.duration_ns(),
               k.device_type() == torch.autograd.DeviceType.CUDA,
               k.correlation_id())
              for k in prof.profiler.kineto_results.events()]
    return reduce(events, rec, lo, hi)


def reduce(events, rec, lo, hi) -> ProgramReading:
    """`events`: (name, start ns, end ns, on the device, correlation id)
    of the trace;
    `rec`: the profiling.Record of the same block; [lo, hi] the
    segment's window in ns."""
    spans = rec.spans
    names = {s.name for s in spans}
    ops = [(a, b) for name, a, b, dev, _ in events
           if dev and name not in names and b > lo and a < hi]
    busy = _union([(max(a, lo), min(b, hi)) for a, b in ops])
    gaps, prev = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)

    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i].start_ns, -spans[i].end_ns, i))
    ranges = [(spans[i].start_ns, spans[i].end_ns, i) for i in order]
    at = _innermost(ranges, [(a + b) // 2 for a, b in gaps])
    idle_by = {}
    for (a, b), i in zip(gaps, at):
        key = BETWEEN if i is None else _label(spans, i)
        idle_by[key] = idle_by.get(key, 0) + (b - a)

    cg = [(s.start_ns, s.end_ns) for s in spans if s.name == "pressure.cg"]
    cg_idle = sum(max(0, min(b, e) - max(a, s))
                  for a, b in gaps for s, e in cg)
    steps = [(s.start_ns, s.end_ns) for s in spans
             if s.name == "step" and s.parent is None]
    starts = [s for s, _ in steps]
    launch_ev = [(cid, a) for name, a, _, dev, cid in events
                 if not dev and "LaunchKernel" in name and lo <= a <= hi]
    launch_at = [a for _, a in launch_ev]
    launch_of = dict(launch_ev)
    lags = [a - launch_of[cid] for name, a, _, dev, cid in events
            if dev and name not in names and cid in launch_of]

    def in_step(t):
        j = bisect.bisect_right(starts, t) - 1
        return j >= 0 and t <= steps[j][1]

    busy_ns = sum(b - a for a, b in busy)
    return ProgramReading(
        steps=rec.steps, window_s=(hi - lo) * 1e-9, busy_s=busy_ns * 1e-9,
        idle_s=(hi - lo - busy_ns) * 1e-9,
        idle_by_span={k: v * 1e-9 for k, v in
                      sorted(idle_by.items(), key=lambda kv: -kv[1])},
        cg_idle_s=cg_idle * 1e-9, cg_calls=len(cg),
        host_reads=dict(rec.host_reads),
        sync_wait_s=sum(s.end_ns - s.start_ns for s in spans
                        if s.name == "host.sync") * 1e-9,
        launches=dict(rec.launches), launch_calls=len(launch_at),
        launch_calls_in_step=sum(map(in_step, launch_at)),
        kernels_paired=len(lags),
        kernels_after_launch=sum(lag >= 0 for lag in lags),
        launch_lag_min_ns=min(lags, default=None),
        launch_lag_max_ns=max(lags, default=None))


def _label(spans, i) -> str:
    s = spans[i]
    if s.name == "host.sync" and s.parent is not None:
        return f"host.sync in {spans[s.parent].name}"
    return s.name


def metrics(r: ProgramReading) -> dict:
    """The three per-step readings of the module docstring."""
    n = max(r.steps, 1)
    return {"host.syncs_per_step": sum(r.host_reads.values()) / n,
            "host.sync_wait_ms_per_step": r.sync_wait_s * 1e3 / n,
            "pressure.cg_idle_ms_per_step": r.cg_idle_s * 1e3 / n}


def table(r: ProgramReading) -> str:
    """The idle-by-span table, ms a step and share of the idle."""
    n = max(r.steps, 1)
    rows = [f"idle by program span ({r.steps} steps, idle "
            f"{r.idle_s * 1e3 / n:.3f} ms a step of {r.window_s * 1e3 / n:.3f}"
            f", {100 * r.idle_s / r.window_s:.2f}%):"]
    rows += [f"  {k:32s} {v * 1e3 / n:10.3f} ms  "
             f"{100 * v / r.idle_s if r.idle_s > 0 else 0.0:6.2f}%"
             for k, v in r.idle_by_span.items()]
    return "\n".join(rows)
