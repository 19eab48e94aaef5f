"""The traced segments: spans and kernel calls from the benchmark's own
wrappers, device time from torch.profiler.

A traced run profiles two more segments after its window. The first
traces the device alone (CUDA activity: kernels, copies, fills and the
runtime calls, no host op records), so its wall stays near an untraced
segment's: it gives the busy union, the traced window (and from the two
the device's idle share) and the device ops.
The second also records the host (CPU activity) with the wrappers below
installed, which slows the host about 2.5× on these steps: it gives what
needs the host's ranges, each hand-written kernel's entry call and the
names of the idle gaps (measured on that slower timeline).

`spans.json` names the layer calls to wrap (label -> "module:function");
every file in kernel_bytes/ names a hand-written kernel entry of the
port (`MODULE`, the entry's function in openfoam_tpp_tpu_torch.ops.kernels)
and its bytes a call (`nbytes(args, kwargs, out)`). While one segment is
profiled each is replaced on its module by a wrapper that opens a
`record_function` range; a kernel entry called inside another (the
7-point entries dispatch a batched grid to their `_nb` forms) makes the
outer one a dispatcher, and only the innermost call counts. Afterwards
the wrappers are removed.

Each device operation of the trace is tied to the innermost of these
ranges it ran in: a hand-written kernel to its entry call, an idle gap
(between the device's busy intervals) to the span open across it, i.e.
what the host was doing while the device waited. The arithmetic of the
busy union and the device ops per step is the port's
scripts/port_step_profile.py's and utils/devtime.py's `busy_union_us`.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time

import torch

PORT = "openfoam_tpp_tpu_torch"


@dataclasses.dataclass
class Reading:
    busy_s: float            # union of the device's busy intervals
    window_s: float          # the traced segment's wall
    steps: int
    device_ops: int          # kernels, copies and fills in the segment
    calls: list              # [(entry, bytes, device seconds)] of leaf calls
    handwritten_share: float  # of the busy time, in the hand-written kernels
    breakdown: dict


class Wrappers:
    """The spans and kernel entries wrapped while a segment is traced."""

    def __init__(self, root):
        with open(root / "spans.json") as f:
            self.spans = json.load(f)
        self.kernels = {}
        for p in sorted((root / "kernel_bytes").glob("*.py")):
            if p.name.startswith("_"):
                continue
            from h100bench.harness import load_module

            self.kernels[p.stem] = load_module("kernel_bytes", p.stem)
        self.calls = []          # [entry, bytes or None, dispatcher]
        self._stack = []
        self._saved = []

    def _span(self, label, fn):
        def wrapped(*a, **k):
            with torch.profiler.record_function(f"span:{label}"):
                return fn(*a, **k)
        return wrapped

    def _kernel(self, entry, fn, nbytes):
        calls, stack = self.calls, self._stack

        def wrapped(*a, **k):
            idx = len(calls)
            if stack:
                calls[stack[-1]][2] = True
            calls.append([entry, None, False])
            stack.append(idx)
            try:
                with torch.profiler.record_function(f"kernel:{idx}"):
                    out = fn(*a, **k)
            finally:
                stack.pop()
            if not calls[idx][2]:
                calls[idx][1] = int(nbytes(a, k, out))
            return out
        wrapped.__dict__.update(fn.__dict__)
        return wrapped

    def install(self):
        for label, target in self.spans.items():
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._span(label, fn))
        for entry, spec in self.kernels.items():
            mod = importlib.import_module(f"{PORT}.ops.kernels.{spec.MODULE}")
            fn = getattr(mod, entry)
            self._saved.append((mod, entry, fn))
            setattr(mod, entry, self._kernel(entry, fn, spec.nbytes))

    def remove(self):
        for mod, attr, fn in reversed(self._saved):
            wrapped = getattr(mod, attr)
            if hasattr(wrapped, "launches"):
                fn.launches = wrapped.launches
            setattr(mod, attr, fn)
        self._saved.clear()


def _union(spans):
    """Merged (start, end) intervals of a list of (start, end)."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, times):
    """For each of `times`, the name of the innermost host range open at
    it, or None: one sweep over `ranges` ((start, end, name), properly
    nested, sorted by start) with a stack of the open ones."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def profile_segment(segment, n_steps, root, on_card=True) -> Reading:
    """Profile two calls of `segment()` (n_steps steps each), the device
    alone and then with the host and the wrappers; the reduction of both.
    Off the card (the tests) only the second, of the host, runs."""
    from torch.profiler import ProfilerActivity, profile

    device = None
    if on_card:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            segment()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        device = (events_of(prof), wall)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    wr = Wrappers(root)
    wr.install()
    try:
        sync()
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("span:segment"):
                segment()
                sync()
    finally:
        wr.remove()
    return reduce(events_of(prof), wr.calls, n_steps, device)


@dataclasses.dataclass
class Event:
    name: str
    start: float             # µs on the trace's clock (host and device share it)
    end: float
    device: bool
    corr: int                # correlation id (a launch's, on the host)
    linked: int | None       # a device op's launch's correlation id


def events_of(prof) -> list:
    """The trace's raw events (torch.profiler's kineto results, which
    carry each device op's launch correlation in every torch version the
    card has had), without building its function-event tree."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for k in prof.profiler.kineto_results.events():
        linked = getattr(k, "linked_correlation_id", None)
        out.append(Event(k.name(), k.start_ns() / 1e3,
                         (k.start_ns() + k.duration_ns()) / 1e3,
                         k.device_type() == cuda, k.correlation_id(),
                         None if linked is None else linked()))
    return out


def _order(r):
    """Sort key of nested ranges: by start, the longer first, a span
    outside a kernel call, an outer call before the calls it dispatches."""
    start, end, name = r
    inner = int(name.split(":")[1]) if name.startswith("kernel:") else -1
    return (start, -end, inner)


def _device_pass(events, wall_s):
    """(busy s, device ops, seconds by op name) of a device-only trace."""
    ops = [e for e in events
           if e.device and not e.name.startswith(("span:", "kernel:"))]
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start)
    busy = _union([(e.start, e.end) for e in ops])
    return sum(b - a for a, b in busy) * 1e-6, len(ops), by_name


def reduce(events, calls, n_steps, device=None) -> Reading:
    """Device ops are tied to the benchmark's ranges on the device's own
    timeline where the trace has them (kineto mirrors each host range that
    launched work as a range over the device ops it launched), else
    through each op's launch correlation on the host."""
    ops, host, dev_ranges, launch = [], [], [], {}
    seg = None
    for e in events:
        ranged = e.name.startswith(("span:", "kernel:"))
        if e.device and ranged:
            dev_ranges.append((e.start, e.end, e.name))
        elif e.device:
            ops.append(e)
        elif ranged:
            host.append((e.start, e.end, e.name))
            if e.name == "span:segment":
                seg = (e.start, e.end)
        elif e.name.startswith(("cuda", "cu")):
            launch[e.corr] = e.start
    lo, hi = seg
    ops = sorted((e for e in ops if e.start >= lo and e.end <= hi),
                 key=lambda e: e.start)
    busy = _union([(e.start, e.end) for e in ops])

    if dev_ranges:
        ranges = sorted(dev_ranges, key=_order)
        where = lambda ts: _innermost(ranges, ts)
        at_op = where([0.5 * (e.start + e.end) for e in ops])
    else:
        ranges = sorted(host, key=_order)
        where = None
        t_launch = [launch.get(e.linked) for e in ops]
        known = [i for i, t in enumerate(t_launch) if t is not None]
        found = dict(zip(known, _innermost(ranges, [t_launch[i] for i in known])))
        at_op = [found.get(i) for i in range(len(ops))]

    per_call, by_name = {}, {}
    for e, name in zip(ops, at_op):
        dur = e.end - e.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dur
        if (name is not None and name.startswith("kernel:")
                and not _is_library(e.name)):
            idx = int(name.split(":")[1])
            per_call[idx] = per_call.get(idx, 0.0) + dur
    leaf = [(c[0], c[1], per_call.get(i, 0.0) * 1e-6)
            for i, c in enumerate(calls) if not c[2] and c[1] is not None]

    # idle gaps between the busy intervals, by the range open across each
    gaps, spans = {}, []
    prev_end = lo
    for start, end in busy + [[hi, hi]]:
        if start > prev_end:
            spans.append((prev_end, start))
        prev_end = max(prev_end, end)
    if where is not None:
        names = where([0.5 * (a + b) for a, b in spans])
    else:
        first = {e.start: i for i, e in reversed(list(enumerate(ops)))}
        names = [at_op[first[b]] if b in first else None for _, b in spans]
    for (a, b), name in zip(spans, names):
        key = _span_name(name, calls) if b < hi else "segment end"
        gaps[key] = gaps.get(key, 0.0) + (b - a)
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    busy_s = sum(b - a for a, b in busy) * 1e-6
    share = sum(per_call.values()) * 1e-6 / busy_s if busy_s > 0 else 0.0
    window_s, n_ops = (hi - lo) * 1e-6, len(ops)
    if device is not None:
        busy_s, n_ops, by_name = _device_pass(*device)
        window_s = device[1]
    return Reading(
        busy_s=busy_s, window_s=window_s, steps=n_steps, device_ops=n_ops,
        calls=leaf, handwritten_share=share,
        breakdown={"device_ops": [[k[:160], v] for k, v in top(by_name)],
                   "idle_gaps": top(gaps)})


def _is_library(name: str) -> bool:
    """A PyTorch or runtime operation, not a hand-written kernel."""
    return ("at::" in name or name.startswith(("Memcpy", "Memset", "memcpy",
                                               "memset"))
            or "cub::" in name or "cutlass" in name)


def _span_name(name, calls) -> str:
    if name is None:
        return "outside the spans"
    if name.startswith("kernel:"):
        return "kernel " + calls[int(name.split(":")[1])][0]
    return name.split(":", 1)[1]
