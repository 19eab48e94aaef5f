"""Batched sweep execution through the manager: run MANY built cases as
ONE batch on one card — port of openfoam_tpp_tpu/manager/sweeprun.py,
with the same on-disk contract as the single-case runner (per-case
chk_t*.npz checkpoints on the 0.05 s write grid, per-case probe files,
resume-from-latest).

Cases are grouped into compatible batches: same model family, same mesh
spacing (build_batched_geometry's rule), same duration, and same current
progress time (fresh and resumed cases batch separately). Geometry
(H, D, geo) may differ within a batch: the per-case cut-cell arrays ride
the trailing case axis.

By default all cases in a batch share one adaptive dt (the batch min).
`lockstep=False` (manager `runsweep --percase-dt`) instead gives every
case its own adaptive dt with holds at write targets: each case
integrates with the dt it would take as a solo run, so a stiff case does
not throttle its batchmates.

The JAX package jits the advance as one device loop; here it is a Python
loop that reads `min(t) < t_target` on the host once per step. Probe rows
go into a preallocated device buffer by index and reach the host once per
advance call.

`devices=N` farms the batch over an N-position `case`-axis mesh
(parallel/sharding.py): each position steps its slice of the cases on its
own device, with the batch-native kernels, and only the lockstep dt's
minimum crosses positions (none with `lockstep=False`). The JAX package
farms in the leading layout and lets GSPMD split it; here the host
splits the batch, in the trailing layout the batch-native kernels need.
One device is the farm of one position.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.state import SimState
from openfoam_tpp_tpu_torch.device import device_positions, resolve_device
from openfoam_tpp_tpu_torch.manager.cases import load_case_params
from openfoam_tpp_tpu_torch.parallel import sharding as sh
from openfoam_tpp_tpu_torch.parallel.sweep import (_STATE_FIELDS,
                                                   _min_over, _stack_states,
                                                   batch_params,
                                                   batch_states_geom,
                                                   build_batched_geometry,
                                                   make_geom_sweep_step)
from openfoam_tpp_tpu_torch.post.probes import (ProbeWriter,
                                                default_probe_points,
                                                default_wave_columns,
                                                probe_pack,
                                                sample_rows_batched,
                                                stack_packs)
from openfoam_tpp_tpu_torch.utils.io import (latest_checkpoint,
                                             load_checkpoint, save_checkpoint,
                                             to_state)

_EPS = 1e-6
_MAX_STEPS = 4000


def group_cases(case_dirs: list[str]) -> list[list[str]]:
    """Partition case dirs into batches that can run together."""
    groups: dict = {}
    for d in case_dirs:
        p = load_case_params(d)
        if p.get("model") == "tank6dof":
            key = ("solo", d)   # table-driven motion — run individually
        else:
            chk = latest_checkpoint(d)
            t_now = round(chk[0], 4) if chk else 0.0
            key = ("batch", p["mesh"], p["duration"], p["dt"], t_now)
        groups.setdefault(key, []).append(d)
    return list(groups.values())


def _unpack_case(states: SimState, i: int, axis: int = -1) -> SimState:
    """Per-case SimState view i out of a batched SimState."""
    def take(a):
        if a.dim() == 0:
            return a
        if a.dim() == 1:       # scalar leaves batched to (n,)
            return a[i]
        return a.select(axis, i)

    return SimState(**{k: take(getattr(states, k)) for k in _STATE_FIELDS})


def _save_all(case_dirs, parts: list):
    """One checkpoint per case, from one host copy of each part of the
    batch (the parts hold the cases in order)."""
    i = 0
    for states in parts:
        host = SimState(**{k: getattr(states, k).cpu()
                           for k in _STATE_FIELDS})
        for j in range(host.t.shape[0]):
            save_checkpoint(case_dirs[i], _unpack_case(host, j))
            i += 1


def run_cases_batched(case_dirs: list[str],
                      props: PhysicalProperties = PhysicalProperties(),
                      controls: SolverControls = SolverControls(),
                      log=print, axis: int = -1, lockstep: bool = True,
                      devices: int = 1, device="cuda") -> dict:
    """Run one compatible batch of orbital-tank cases to their encoded
    duration on `device`, writing per-case checkpoints + probes at every
    write interval. Returns aggregate stats (the JAX package's keys, plus
    `io_seconds`: host time spent writing checkpoints and probe files).

    `devices=N` farms the batch over an N-position case-axis mesh, each
    position on the device `device` gives it ("cuda": the first N cards;
    "cuda:0" or "cpu": all on that one; a list: one each). Requires
    len(case_dirs) % N == 0 (action_runsweep splits the remainder off).
    The farm runs in the trailing layout: `axis` must be -1."""
    n_dev = int(np.prod(sh.parse_devices(devices)))
    positions = device_positions(device, n_dev)
    rows = [load_case_params(d) for d in case_dirs]
    if any(r.get("model") == "tank6dof" for r in rows):
        raise NotImplementedError("model 'tank6dof' runs alone (run_case, "
                                  "as group_cases groups it): a 6DoF case "
                                  "never forms a batch")
    durations = {r["duration"] for r in rows}
    meshes = {r["mesh"] for r in rows}
    if len(durations) > 1 or len(meshes) > 1:
        raise ValueError(
            "run_cases_batched needs one (mesh, duration) group — use "
            f"group_cases() first (got meshes={meshes}, "
            f"durations={durations})")
    duration = durations.pop()
    n = len(case_dirs)
    if n % n_dev:
        raise ValueError(
            f"run_cases_batched: {n} cases do not divide over {n_dev} "
            "devices — split the group first (action_runsweep does)")
    if axis not in (-1, 3):
        raise ValueError(f"axis={axis}: the farm runs with the case axis "
                         "trailing (axis=-1)")
    mesh = sh.make_mesh(n_dev, case_axis=n_dev, devices=positions)
    sharding = sh.state_sharding(mesh, batched=True)
    dev = resolve_device(sharding.devices[0])
    for d in sharding.devices[1:]:
        resolve_device(d)

    # The whole batch's shared grid, then each position's part of it.
    bgeom = build_batched_geometry(rows, round_to=4, axis=axis, device=dev)
    bgeoms = sh.shard_batched_geometry(bgeom, mesh)
    pparts = sh.params_sharding(mesh, batched=True).put(
        batch_params(rows, device=dev))
    farm = sh.sharded_step([make_geom_sweep_step(g, props, controls,
                                                 lockstep=lockstep)
                            for g in bgeoms], mesh, batched=True)

    # Resume: all cases in a group share the same progress time.
    io_seconds = 0.0
    chks = [latest_checkpoint(d) for d in case_dirs]
    if all(c is not None for c in chks):
        parts = sharding.put(_stack_states(
            [to_state(load_checkpoint(c[1]), device="cpu") for c in chks]))
        t_now = float(parts[0].t[0])
        log(f"  Resuming {n} cases from t={t_now:.4f} s")
    else:
        parts = [batch_states_geom(g, dt0=rows[0]["dt"]) for g in bgeoms]
        t_now = 0.0
        t_io = time.time()
        _save_all(case_dirs, parts)
        io_seconds += time.time() - t_io

    # Per-timestep probe channels, as in the solo runner: every case
    # samples its p probes AND η wave gauges at EVERY solver step into a
    # device-side row buffer, flushed per write interval. Per-case probe
    # constants ride as one case-stacked pack per position, so mixed
    # (H, D) geometries sample in one pass.
    probes, gauges, packs = [], [], []
    for d, g in zip(case_dirs, bgeom.geoms):
        pts = default_probe_points(g)
        cols = default_wave_columns(g)
        packs.append(probe_pack(g, pts, cols, device="cpu"))
        probes.append(ProbeWriter(d, pts, "p", start_time=t_now))
        gauges.append(ProbeWriter(
            d, np.column_stack([cols, np.zeros(len(cols))]), "eta",
            start_time=t_now))
    n_pts = len(default_probe_points(bgeom.geoms[0]))
    row_width = 1 + n_pts + len(default_wave_columns(bgeom.geoms[0]))
    bpacks = [{k: a.to(d) for k, a in stack_packs(packs[sl]).items()}
              for sl, d in zip(sharding.slices(n), sharding.devices)]

    def advance(parts, t_target):
        """Steps until every case has reached t_target (bounded by
        _MAX_STEPS): (parts, n_steps, row buffer per part)."""
        t_stop = torch.as_tensor(t_target, dtype=torch.float32, device=dev)
        bufs = [torch.zeros((_MAX_STEPS, p.t.shape[0], row_width),
                            dtype=torch.float32, device=p.t.device)
                for p in parts]
        k = 0
        while k < _MAX_STEPS and bool(
                _min_over([p.t.min() for p in parts]) < t_stop):
            parts, _ = farm(parts, pparts, t_stop=t_stop)
            for buf, p, bp in zip(bufs, parts, bpacks):
                buf[k] = sample_rows_batched(p, bp)
            k += 1
        return parts, k, bufs

    w = controls.write_interval
    w32 = np.float32(w)
    first_k = int(np.floor(t_now / w + _EPS)) + 1
    n_writes = int(np.floor(duration / w + 1e-9))
    targets = [float(np.float32(k) * w32)
               for k in range(first_k, n_writes + 1)]
    if not targets or targets[-1] < duration - 1e-9:
        targets.append(float(np.float32(duration)))

    wall0 = time.time()
    steps = 0
    for t_target in targets:
        while True:
            parts, k, bufs = advance(parts, t_target)
            steps += k
            if k:
                # (k, n, width) per-step rows; duplicate rows from cases
                # held at their write target (--percase-dt) are dropped
                # by append_rows' time dedup.
                rows_k = np.concatenate([b[:k].cpu().numpy() for b in bufs],
                                        axis=1)
                t_io = time.time()
                for i in range(n):
                    probes[i].append_rows(rows_k[:, i, 0],
                                          rows_k[:, i, 1 : 1 + n_pts])
                    gauges[i].append_rows(rows_k[:, i, 0],
                                          rows_k[:, i, 1 + n_pts :])
                io_seconds += time.time() - t_io
            if float(_min_over([p.t.min() for p in parts])) >= t_target \
                    or k == 0:
                break
        t_io = time.time()
        _save_all(case_dirs, parts)
        io_seconds += time.time() - t_io
        log(f"Time = {t_target:.6g} s  ({n} cases"
            + (f" over {n_dev} devices" if n_dev > 1 else "")
            + f", dt = {float(parts[0].dt[0]):.3e})")

    wall = time.time() - wall0
    cells = sum(g.n_fluid_cells for g in bgeom.geoms)
    stats = {
        "n_cases": n,
        "steps": steps,
        "wall_seconds": wall,
        "agg_cell_updates_per_sec": cells * steps / max(wall, 1e-9),
        "io_seconds": io_seconds,
    }
    log(f"  Batch done: {n} cases x {steps} steps in {wall:.1f} s wall "
        f"({stats['agg_cell_updates_per_sec']:.3g} agg cell-updates/s)")
    return stats
