"""On-device profiling — port of openfoam_tpp_tpu/utils/profiling.py.

  * ``trace(logdir)`` — context manager around ``torch.profiler`` (CPU
    activity, and CUDA activity when a card is present) that writes a
    Chrome trace, ``trace.json``, into `logdir` (chrome://tracing or
    Perfetto load it).
  * ``profile_case(case_dir, n_steps)`` — start from the case's latest
    checkpoint (or a fresh state), take 3 warm-up steps, run ``n_steps``
    solver steps under the trace and ``collect()``, and write a summary
    (per-step wall ms, cell-updates/s; each span's self time, the host
    reads by site and the kernel launches by entry, per step) next to the
    trace under ``postProcessing/profile/``.
  * ``span(name)``, ``step_span()`` — the spans the step path opens
    (solver/timestep.py, solver/poisson.py, ops/mules.py,
    parallel/sweep.py). While nothing collects they return one shared
    context that does nothing.
  * ``host_read(t, site)`` — the one way the step path turns a device
    tensor into a Python value (the CG's convergence test, a refresh's
    step count, a sweep loop's test): counted by site, its wait timed as
    a ``host.sync`` span, while ``collect()`` is on.
  * ``collect()`` — spans and read counters on for a block; yields a
    ``Record`` (the spans, host reads by site, kernel launches by entry
    and CUDA graph captures and replays by site over the block) filled
    when the block ends.
  * ``launch_counts()`` — every kernel entry's launch counter, by name;
    ``entry_launches()`` the same keyed by the entry itself.
  * ``graph_captured(site, launches)``, ``graph_replayed(site,
    launches)`` — a CUDA graph of the step path (the pressure CG's
    iteration, solver/poisson.py) captured or replayed at `site`,
    counted in the process (``graph_counts()``) and in a ``Record``.
    `launches` ({entry: n}, an ``entry_launches()`` delta over the
    capture): a capture runs nothing, so they are taken back; each
    replay credits them again, so ``launch_counts()`` stays the launches
    that ran.

Span stamps are ``time.time_ns()``: the unix-epoch clock kineto reports
its events on, so a span lines up with the device operations of a
``torch.profiler`` trace taken over the same block (tests/
test_torch_spans.py holds the two within 50 µs).

Exposed by the command line as ``--action profile`` (manager/cli.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import NamedTuple

import numpy as np
import torch

TRACE_FILE = "trace.json"
# The spans a step opens (PERF.md section 3 names what reads each).
STEP_SPANS = ("step", "step.cfl", "alpha.advect", "pressure.operator",
              "pressure.bundle", "momentum", "pressure.solve", "pressure.cg",
              "correction", "step.diagnostics", "host.sync")


# ------------------------------------------------------------------ spans

# What span() returns while nothing collects: one shared context that
# does nothing.
_NO_SPAN = contextlib.nullcontext()
_collector = None    # the _Collector of the open collect(), else None


class Span(NamedTuple):
    """One closed span of a `Record`."""

    name: str
    start_ns: int          # time.time_ns() at entry
    end_ns: int            # ... at exit
    parent: int | None     # index in Record.spans of the enclosing span
    step: int | None       # the step (0, 1, ...) it lies in, None outside


@dataclasses.dataclass
class Record:
    """What one `collect()` block gathered; filled when the block ends."""

    spans: list = dataclasses.field(default_factory=list)
    host_reads: dict = dataclasses.field(default_factory=dict)  # site -> n
    launches: dict = dataclasses.field(default_factory=dict)  # entry -> n
    steps: int = 0
    graph_captures: dict = dataclasses.field(default_factory=dict)  # site -> n
    graph_replays: dict = dataclasses.field(default_factory=dict)   # site -> n


class _Collector:
    def __init__(self):
        self.spans = []      # [name, start_ns, end_ns, parent, step]
        self.stack = []      # indices of the open spans
        self.step = None     # index of the open step, None outside one
        self.n_steps = 0
        self.reads = {}


class _Span:
    __slots__ = ("_c", "_name", "_root", "_i", "_rf")

    def __init__(self, c, name, root=False):
        self._c, self._name, self._root = c, name, root

    # The stamps enclose the record_function range: a span holds the
    # kineto range it opens.
    def __enter__(self):
        c = self._c
        if self._root:
            c.step = c.n_steps
            c.n_steps += 1
        self._i = len(c.spans)
        c.spans.append([self._name, time.time_ns(), None,
                        c.stack[-1] if c.stack else None, c.step])
        c.stack.append(self._i)
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()

    def __exit__(self, *exc):
        c = self._c
        self._rf.__exit__(*exc)
        c.spans[self._i][2] = time.time_ns()
        c.stack.pop()
        if self._root:
            c.step = None
        return False


def span(name: str):
    """A context around one part of the step, recorded while `collect()`
    is on (with a `torch.profiler.record_function` of the same name)."""
    if _collector is None:
        return _NO_SPAN
    return _Span(_collector, name)


def step_span():
    """The `step` span, the root of one step. Inside a step already open
    (a sweep's batched step runs make_step_core's step) it does nothing,
    so every step has one."""
    c = _collector
    if c is None or c.step is not None:
        return _NO_SPAN
    return _Span(c, "step", root=True)


def host_read(t: torch.Tensor, site: str):
    """`t.item()` for a 0-d tensor (the Python bool, int or float that
    bool(), int() or float() of it gives), else `t.tolist()`. Waits for
    the device to compute `t`. While `collect()` is on the read is
    counted under `site` and its wait recorded as a `host.sync` span."""
    c = _collector
    if c is None:
        return t.item() if t.dim() == 0 else t.tolist()
    c.reads[site] = c.reads.get(site, 0) + 1
    with _Span(c, "host.sync"):
        return t.item() if t.dim() == 0 else t.tolist()


@contextlib.contextmanager
def collect():
    """Spans and host-read counters on for the block. Yields a `Record`,
    filled when the block ends (nothing is written out before): the
    spans, the host reads by site and each kernel entry's launches over
    the block (deltas of `launch_counts()`)."""
    global _collector
    if _collector is not None:
        raise RuntimeError("collect() is already on")
    rec, c = Record(), _Collector()
    before, graphs = launch_counts(), graph_counts()
    _collector = c
    try:
        yield rec
    finally:
        _collector = None
        rec.spans = [Span(*s) for s in c.spans]
        rec.host_reads = dict(c.reads)
        rec.launches = _deltas(before, launch_counts())
        rec.steps = c.n_steps
        after = graph_counts()
        rec.graph_captures = _deltas(graphs["captures"], after["captures"])
        rec.graph_replays = _deltas(graphs["replays"], after["replays"])


def _deltas(before: dict, after: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def per_step_counts(rec: Record) -> dict:
    """A collected record per step: each span's self time
    (`self_ms_per_step.<span>`, ms), the host reads by site
    (`host_reads_per_step.<site>`), the kernel launches by entry
    (`launches_per_step.<entry>`) and the CUDA graphs captured and
    replayed by site (`graph_captures_per_step.<site>`,
    `graph_replays_per_step.<site>`)."""
    n = max(rec.steps, 1)
    self_ms = {}
    for s, ns in zip(rec.spans, self_ns(rec.spans)):
        self_ms[s.name] = self_ms.get(s.name, 0.0) + ns * 1e-6
    out = {f"self_ms_per_step.{k}": v / n for k, v in sorted(self_ms.items())}
    out.update((f"host_reads_per_step.{k}", v / n)
               for k, v in sorted(rec.host_reads.items()))
    out.update((f"launches_per_step.{k}", v / n)
               for k, v in sorted(rec.launches.items()))
    out.update((f"graph_captures_per_step.{k}", v / n)
               for k, v in sorted(rec.graph_captures.items()))
    out.update((f"graph_replays_per_step.{k}", v / n)
               for k, v in sorted(rec.graph_replays.items()))
    return out


def self_ns(spans) -> list:
    """Each span's duration less what its children cover."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent is not None:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def _entries():
    """('module.function', entry) of every kernel entry point (the kernel
    modules of ops/kernels; an entry carries a `launches` counter)."""
    from openfoam_tpp_tpu_torch.ops.kernels import (correction, halo7,
                                                    mom_finish, momentum_rhs,
                                                    mules_fct, mules_flux,
                                                    seven_point)

    for mod in (seven_point, halo7, mules_flux, mules_fct, momentum_rhs,
                correction, mom_finish):
        short = mod.__name__.rsplit(".", 1)[1]
        for name, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches"):
                yield f"{short}.{name}", fn


def launch_counts() -> dict:
    """Every kernel entry point's launch count in this process, keyed
    'module.function'."""
    return {key: fn.launches for key, fn in _entries()}


def entry_launches() -> dict:
    """Every kernel entry point's launch count, keyed by the entry."""
    return {fn: fn.launches for _, fn in _entries()}


def _add_launches(counts: dict, sign: int) -> None:
    """Add `sign` times `counts` ({entry: n}) to the entries' counters."""
    for fn, n in counts.items():
        fn.launches += sign * n


# CUDA graph captures and replays of the process by site.
_GRAPHS = {"captures": {}, "replays": {}}


def graph_counts() -> dict:
    """{"captures": {site: n}, "replays": {site: n}} over the process."""
    return {kind: dict(by_site) for kind, by_site in _GRAPHS.items()}


def graph_captured(site: str, launches: dict) -> None:
    """A CUDA graph captured at `site`; `launches`: the launches its
    kernel entries counted while capturing (taken back: none ran)."""
    _add_launches(launches, -1)
    by_site = _GRAPHS["captures"]
    by_site[site] = by_site.get(site, 0) + 1


def graph_replayed(site: str, launches: dict) -> None:
    """One replay of the graph captured at `site`, which ran `launches`."""
    _add_launches(launches, 1)
    by_site = _GRAPHS["replays"]
    by_site[site] = by_site.get(site, 0) + 1


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the block, exported to logdir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def profile_case(case_dir: str, n_steps: int = 20, props=None, controls=None,
                 log=print, device="cuda") -> dict:
    """Profile `n_steps` solver steps of a case on `device` (from its
    latest checkpoint: run the case first so the adaptive dt reflects
    real flow). On a CUDA device the hand-written kernels are on
    (`use_pallas=True`), as `run_case` runs them."""
    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.device import resolve_device
    from openfoam_tpp_tpu_torch.manager.cases import load_case_params
    from openfoam_tpp_tpu_torch.manager.runner import (_case_shape_hint,
                                                       build_case_geometry,
                                                       build_case_motion)
    from openfoam_tpp_tpu_torch.solver.timestep import make_step
    from openfoam_tpp_tpu_torch.utils.io import (latest_checkpoint,
                                                 load_checkpoint, to_state)

    dev = resolve_device(device)
    props = props or PhysicalProperties()
    controls = controls or SolverControls()
    params = load_case_params(case_dir)
    geom = build_case_geometry(params, _case_shape_hint(case_dir))
    if dev.type == "cuda":
        controls = dataclasses.replace(controls, use_pallas=True)
    motion = build_case_motion(params, case_dir, device=dev)
    step = make_step(geom, props, controls, motion=motion, device=dev)

    if params.get("model") == "tank6dof":
        cp = CaseParams.make(R=0.0, freq=0.0, duration=params["duration"],
                             device=dev)
    else:
        cp = CaseParams.make(R=params["R"], freq=params["freq"],
                             duration=params["duration"],
                             ramp=params.get("ramp", 0.0), device=dev)

    chk = latest_checkpoint(case_dir)
    if chk is not None:
        state = to_state(load_checkpoint(chk[1]), device=dev)
        log(f"  Profiling from checkpoint t={chk[0]:.4f} s")
    else:
        state = init_state(geom, dt0=params["dt"], device=dev)
        log("  Profiling from t=0 (no checkpoint found — dt still settling)")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(3):   # warm-up: kernel builds, allocator, dt
        state, diag = step(state, cp)
    sync()

    outdir = os.path.join(case_dir, "postProcessing", "profile")
    os.makedirs(outdir, exist_ok=True)
    step_walls = []
    with trace(outdir), collect() as rec:
        for _ in range(n_steps):
            w0 = time.perf_counter()
            state, diag = step(state, cp)
            sync()
            step_walls.append(time.perf_counter() - w0)

    walls = np.asarray(step_walls)
    n_cells = geom.n_fluid_cells
    stats = {
        "n_steps": n_steps,
        "fluid_cells": n_cells,
        "grid": list(geom.shape),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "mean_step_ms": float(walls.mean() * 1e3),
        "p50_step_ms": float(np.percentile(walls, 50) * 1e3),
        "p95_step_ms": float(np.percentile(walls, 95) * 1e3),
        "cell_updates_per_sec": float(n_cells / walls.mean()),
        "final_dt": float(state.dt),
        "p_iters": int(diag.p_iters),
        "trace_dir": outdir,
    }
    with open(os.path.join(outdir, "summary.txt"), "w") as f:
        for k, v in {**stats, **per_step_counts(rec)}.items():
            f.write(f"{k}: {v}\n")
    log(f"  Step wall: mean {stats['mean_step_ms']:.2f} ms  "
        f"p95 {stats['p95_step_ms']:.2f} ms  "
        f"({stats['cell_updates_per_sec']:.3g} cell-updates/s)")
    log(f"  torch.profiler trace ({TRACE_FILE}) + summary in {outdir}")
    return stats
