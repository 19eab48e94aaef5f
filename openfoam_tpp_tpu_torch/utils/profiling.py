"""On-device profiling — port of openfoam_tpp_tpu/utils/profiling.py.

  * ``trace(logdir)`` — context manager around ``torch.profiler`` (CPU
    activity, and CUDA activity when a card is present) that writes a
    Chrome trace, ``trace.json``, into `logdir` (chrome://tracing or
    Perfetto load it).
  * ``profile_case(case_dir, n_steps)`` — start from the case's latest
    checkpoint (or a fresh state), take 3 warm-up steps, run ``n_steps``
    solver steps under the trace, and write a summary (per-step wall ms,
    cell-updates/s) next to the trace under ``postProcessing/profile/``.

Exposed by the command line as ``--action profile`` (manager/cli.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import torch

TRACE_FILE = "trace.json"


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
    with trace(outdir):
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
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
    log(f"  Step wall: mean {stats['mean_step_ms']:.2f} ms  "
        f"p95 {stats['p95_step_ms']:.2f} ms  "
        f"({stats['cell_updates_per_sec']:.3g} cell-updates/s)")
    log(f"  torch.profiler trace ({TRACE_FILE}) + summary in {outdir}")
    return stats
