"""Case execution: run (or resume) a case to its encoded duration.

Port of the single-device branches of openfoam_tpp_tpu/manager/runner.py:
the analytic-orbital cylinder and the closed 6DoF tank, whose motion
comes from the case's constant/6DoF.dat. The solver runs in-process: a loop
advances the state between write times; every `write_interval` of
simulated time a SimState checkpoint is persisted (time-directory
parity) and the per-step probe rows are appended. Resume from the latest
checkpoint is automatic (`startFrom latestTime` parity).

The JAX package jits the advance as one device loop and caches the
executable; PyTorch runs eagerly, so the loop is a Python loop and there
is nothing to cache: the step is built anew (and the OFTPP_* variables
read) at every `get_compiled_advance`.

`devices=N` (or 'NxM') lays the case's grid over a device mesh
(parallel/sharding.py) whose positions share one device: with N > 1 the
x-sharded step with its per-shard kernel islands (parallel/spmd.py)
where the JAX package runs them, else the global step on the rounded
grid (GSPMD's counterpart), with the kernels on a CUDA device
(`step_choice`; the run logs which). The run carries a global SimState
and writes global checkpoints, as the JAX package writes them (it packs
the state only to cross its sharded jit, a boundary the port does not
have).

Positions on distinct cards run as ranks, one spawned process a position
(parallel/ranks.py; OpenFOAM's `mpirun -np N foamRun -parallel`): each rank
steps its x-slab of the 1-D x decomposition, or its x·y block of the 2-D
one ('NxM', OpenFOAM's `hierarchical (N M 1)`), with the halo kernel
islands on its own card (`_rank_run`; OFTPP_SPMD_PALLAS=0, or the CPU
without OFTPP_SPMD_PALLAS=interpret, runs the plain step on every block
instead, and surface tension runs as on one device), rank 0 reads a resumed
state and scatters it, and gathers each checkpoint and the probe rows and
writes them: the same files, with the same write times. NCCL joins ranks on
distinct cards; `ranks=True` runs the ranks on positions that share a
device too, under gloo. The 6DoF tank runs there as the orbital case does
(rank 0 reads its motion table and broadcasts it), and so does any grid
whose nx (and ny) divides into even slabs (and rows of blocks) of at least
two cells, 8·N or not (a checkpoint's grid resumed on more cards). A grid
that does not divide so raises ValueError before a process is spawned
(`rank_choice`).

OFTPP_DEBUG_NANS=1 runs `run_case` under utils/nan_trap.py's trap: the
first operation or kernel that outputs a NaN raises FloatingPointError
before anything later is written (the JAX package's jax_debug_nans).
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.motion import TableMotion
from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
from openfoam_tpp_tpu_torch.device import device_positions, resolve_device
from openfoam_tpp_tpu_torch.manager.cases import load_case_params
from openfoam_tpp_tpu_torch.mesh import (build_box_geometry,
                                         build_chamfer_tank_geometry,
                                         build_tank_geometry)
from openfoam_tpp_tpu_torch.parallel import sharding as sh
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.post.probes import (ProbeWriter,
                                                default_probe_points,
                                                default_wave_columns,
                                                make_probe_sampler,
                                                probe_pack, sample_row)
from openfoam_tpp_tpu_torch.solver.timestep import (StepDiagnostics,
                                                    geometry_arrays,
                                                    make_step, make_step_ga)
from openfoam_tpp_tpu_torch.utils import nan_trap
from openfoam_tpp_tpu_torch.utils.io import (latest_checkpoint,
                                             list_checkpoints,
                                             load_checkpoint, read_6dof_table,
                                             save_checkpoint, to_state)

_MAX_STEPS_PER_WRITE = 4000


def _zero_diag(device):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return StepDiagnostics(z, z, z, torch.zeros((), dtype=torch.int32,
                                                device=device), z, z, z)


def make_advance(step_fn, max_steps: int = _MAX_STEPS_PER_WRITE,
                 sampler=None, sample_width: int = 0):
    """Loop: run steps until t >= t_target (bounded by max_steps).

    `sampler(state) -> (sample_width,) row` is evaluated after EVERY
    solver step into a preallocated (max_steps, sample_width) f32 buffer
    on the device, written by index, so sampling adds no host sync; the
    caller copies the rows to the host once per call. Returns (state,
    diag, n_steps[, samples]) with n_steps a Python int.

    Reading `state.t < t_target` costs one host sync per step (the JAX
    package runs a `lax.while_loop` on the device).

    A step_fn built with `carry_precond=True` (its `init_precond`
    attribute marks it) threads the preconditioner bundle through the
    loop, refreshed every controls.precond_refresh steps; one fresh
    bundle is built per advance call.

    A step_fn built by make_step_ga (its `takes_ga` attribute marks it)
    changes the signature to `advance(state, params, t_target, ga[,
    probe_pack])`; `sampler` is then post.probes.sample_row(state,
    pack).

    While a NaN trap is current (utils/nan_trap.py), each step adds one
    to its step count, which its error names."""
    init_precond = getattr(step_fn, "init_precond", None)
    takes_ga = getattr(step_fn, "takes_ga", False)

    def advance(state, params, t_target, *operands):
        ga_args = operands[:1] if takes_ga else ()
        pack = operands[1] if (takes_ga and sampler is not None) else None
        dev = state.t.device
        # t_stop makes the final step land EXACTLY on t_target
        # (adjustableRunTime parity).
        t_target = torch.as_tensor(t_target, dtype=torch.float32, device=dev)
        diag = _zero_diag(dev)
        buf = None
        if sampler is not None:
            buf = torch.zeros((max_steps, sample_width), dtype=torch.float32,
                              device=dev)
        bundle = None
        if init_precond is not None:
            bundle = init_precond(state, *ga_args)
        trap = nan_trap.current()
        n = 0
        while n < max_steps and bool(state.t < t_target):
            if trap is not None:
                trap.step += 1
            if init_precond is None:
                state, diag = step_fn(state, params, *ga_args,
                                      t_stop=t_target)
            else:
                state, diag, bundle = step_fn(state, params, *ga_args,
                                              t_stop=t_target, precond=bundle)
            if sampler is not None:
                buf[n] = sampler(state, pack) if takes_ga else sampler(state)
            n += 1
        if sampler is None:
            return state, diag, n
        return state, diag, n, buf

    return advance


def _spmd_kernels_wanted(device) -> bool:
    """True when a 1-D x-sharded run should use the per-shard kernel
    islands (parallel/spmd.py): on a CUDA device, or with
    OFTPP_SPMD_PALLAS=interpret (the islands' plain versions on the CPU,
    the CPU tests' mode); OFTPP_SPMD_PALLAS=0 turns them off. Shared by
    the geometry rounding policy and the step builder so they agree: the
    islands want nx a multiple of 8 per shard, a rounding the plain
    global step must not pay (the grid would differ from a solo run of
    the same case). The JAX package asks the same of its backend (TPU)."""
    env = os.environ.get("OFTPP_SPMD_PALLAS", "1")
    if env == "0":
        return False
    return torch.device(device).type == "cuda" or env == "interpret"


def build_case_geometry(params: dict, shape_hint: tuple | None = None,
                        devices=None, device="cuda"):
    """Geometry for a case. `shape_hint` (from an existing checkpoint's
    alpha shape) keeps resumed/postprocessed cases consistent with the
    grid they were started on, across round_to policy changes.
    `devices` (int N or 'NxM'): the grid's x (and y) extents must divide
    the device-mesh axes for sharded runs — rounds nx/ny up (with solid
    zero-aperture padding) when 8-rounding alone does not; `device` (the
    positions' device) decides, with OFTPP_SPMD_PALLAS, whether the 1-D
    kernel islands' rounding comes first. The same setting gives the
    JAX package's shapes, so checkpoints resume across the packages."""
    if params.get("model") == "tank6dof":
        if float(params.get("chamfer", 0.0)) > 0.0:
            # The tutorial tank's true shape class: 45°-chamfered bottom
            # and top edges.
            return build_chamfer_tank_geometry(
                params["Lx"], params["Ly"], params["Lz"], params["mesh"],
                chamfer=float(params["chamfer"]), z0=-params["Lz"] / 2.0,
            )
        return build_box_geometry(
            params["Lx"], params["Ly"], params["Lz"], params["mesh"],
            z0=-params["Lz"] / 2.0, open_top=False,
        )
    dx, dy = sh.parse_devices(devices)
    # round_to=8: nx/ny padded (with solid, zero-aperture cells) to a
    # multiple of 8, as the JAX package does, so both build the same grid.
    rounds = [8, 1]
    if dx * dy > 1:
        cands = [math.lcm(8, max(dx, dy))]
        if dy == 1 and _spmd_kernels_wanted(device):
            # The 1-D x decomposition with per-shard kernels: the local nx
            # stays a multiple of 8, so nx rounds to 8·dx first; the lcm
            # candidate remains for cases built under the other rounding.
            cands = [8 * dx] + cands
        rounds = cands + rounds
    for r in rounds:
        geom = build_tank_geometry(
            H=params["H"], D=params["D"], mesh=params["mesh"],
            geo=params["geo"], round_to=r,
        )
        if shape_hint is not None and tuple(geom.shape) != tuple(shape_hint):
            continue
        if dx * dy > 1 and (geom.shape[0] % dx or geom.shape[1] % dy):
            continue
        return geom
    raise ValueError(
        f"no geometry for {params} matches checkpoint grid {shape_hint}"
        + (f" with (nx, ny) divisible by ({dx}, {dy}) devices"
           if devices else "")
        + " — was the case built with different parameters?"
    )


def _case_shape_hint(case_dir: str):
    """Grid shape of the case's existing checkpoints (None if fresh)."""
    chk = latest_checkpoint(case_dir)
    if chk is None:
        return None
    return tuple(load_checkpoint(chk[1])["alpha"].shape)


def build_case_motion(params: dict, case_dir: str, device="cuda",
                      ranks=None):
    """TableMotion for the table-driven 6DoF model; None for the orbit.
    With `ranks` (a parallel.ranks.RankCtx) rank 0 reads the case's table
    and broadcasts its rows, so every rank builds the same bits."""
    if params.get("model") != "tank6dof":
        return None
    path = os.path.join(case_dir, "constant", "6DoF.dat")
    if ranks is None:
        t, trans, rot = read_6dof_table(path)
    else:
        t, trans, rot = ranks.broadcast(
            read_6dof_table(path) if ranks.rank == 0 else None)
    # Resampled to the solver's dt scale for smooth finite-difference
    # accelerations (the reference table is 100 coarse samples).
    return TableMotion.from_table(t, trans, rot,
                                  resample_dt=min(0.05, params["dt"] * 10),
                                  device=device)


def _mesh_device(devices, device):
    """(x shards, y shards, the one device of the run's mesh positions)."""
    d_x, d_y = sh.parse_devices(devices)
    positions = device_positions(device, d_x * d_y)
    if d_x * d_y > 1:
        mesh = sh.make_mesh(d_x * d_y, case_axis=1, y_axis=d_y,
                            devices=positions)
        positions = sh.case_devices(mesh)
    return d_x, d_y, resolve_device(positions[0])


def step_choice(params: dict, shape, d_x: int, d_y: int, dev):
    """(spmd, use the kernels, what runs) for a case on a (d_x, d_y) mesh
    whose positions share `dev`.

    The 1-D x decomposition with nx a multiple of 8·d_x runs the x-sharded
    step (`SpmdCtx(d_x)`, its halo kernel islands) where
    `_spmd_kernels_wanted`. Every other run computes the global step,
    which is what GSPMD computes on a shared device: on a CUDA device it
    runs with the single-grid kernels, as on one device (the JAX package
    runs 'NxM', a sharded 6DoF case and a grid the islands do not divide
    without kernels, since Pallas does not run under GSPMD; the port has
    no such limit). On the CPU the caller's controls stand."""
    n_dev = d_x * d_y
    if n_dev > 1:
        why = ("'NxM'" if d_y > 1
               else "a 6DoF case" if params.get("model") == "tank6dof"
               else f"nx {shape[0]} not a multiple of 8·{d_x}"
               if shape[0] % (8 * d_x)
               else None if _spmd_kernels_wanted(dev)
               else "OFTPP_SPMD_PALLAS=0")
        if why is None:
            return (SpmdCtx(d_x), True,
                    f"x-sharded step over {d_x} shards (halo kernel islands)")
    else:
        why = "one device"
    if dev.type == "cuda":
        return None, True, f"global step with the single-grid kernels ({why})"
    return None, False, f"global step, the caller's controls ({why})"


def get_compiled_advance(params: dict, props: PhysicalProperties,
                         controls: SolverControls, case_dir: str | None = None,
                         devices=None, device="cuda"):
    """Returns (geom, advance) with the preconditioner carried through the
    advance loop and the probe sampler run every step. `advance(state,
    case_params, t_target) -> (state, diag, n_steps, samples)`.

    An analytic-orbital case runs the geometry-as-operands step
    (make_step_ga), a 6DoF case the closure step (make_step) with the
    motion of its case directory's table. On a CUDA device the
    hand-written kernels are turned on (`use_pallas=True`), whatever the
    grid: they take any shape. On the CPU the caller's controls stand.

    `devices` (N > 1 or 'NxM', positions sharing one device): the same
    steps on the rounded grid (`step_choice`), except that the 1-D x
    decomposition runs the x-sharded closure step (`spmd=SpmdCtx(N)`)."""
    d_x, d_y, dev = _mesh_device(devices, device)
    geom, advance, _ = _compiled_advance(params, props, controls, case_dir,
                                         devices, d_x, d_y, dev)
    return geom, advance


def _compiled_advance(params, props, controls, case_dir, devices, d_x, d_y,
                      dev):
    """get_compiled_advance on a resolved mesh: (geom, advance, what
    runs)."""
    n_dev = d_x * d_y
    is_6dof = params.get("model") == "tank6dof"
    shape_hint = _case_shape_hint(case_dir) if case_dir else None
    geom = build_case_geometry(params, shape_hint,
                               devices=devices if n_dev > 1 else None,
                               device=dev)
    spmd, use_k, what = step_choice(params, geom.shape, d_x, d_y, dev)
    if use_k:
        controls = dataclasses.replace(controls, use_pallas=True)
    k_env = os.environ.get("OFTPP_PRECOND_REFRESH")
    if k_env is not None:
        controls = dataclasses.replace(controls, precond_refresh=int(k_env))

    points, columns = default_probe_points(geom), default_wave_columns(geom)
    if is_6dof or spmd is not None:
        motion = (build_case_motion(params, case_dir, device=dev)
                  if case_dir else None)
        step = make_step(geom, props, controls, motion=motion,
                         carry_precond=True, spmd=spmd, device=dev)
        sampler, width = make_probe_sampler(geom, points, columns,
                                            device=dev)
        return geom, make_advance(step, sampler=sampler,
                                  sample_width=width), what

    step = make_step_ga(geom.spacing, props, controls,
                        open_top=bool(np.any(geom.top_open > 0)),
                        carry_precond=True,
                        sealed_x=bool(np.all(geom.ax[-1] == 0.0)), device=dev)
    inner = make_advance(step, sampler=sample_row,
                         sample_width=1 + len(points) + len(columns))
    ga = geometry_arrays(geom, device=dev)
    pack = probe_pack(geom, points, columns, device=dev)

    def advance(state, case_params, t_target):
        return inner(state, case_params, t_target, ga, pack)

    return geom, advance, what


def run_case(
    case_dir: str,
    props: PhysicalProperties = PhysicalProperties(),
    controls: SolverControls = SolverControls(),
    log=print,
    write_checkpoints: bool = True,
    devices=None,
    device="cuda",
    ranks: bool = False,
) -> dict:
    """Run (or resume) a case to its encoded duration on `device`.
    Returns run stats: the JAX package's keys, plus `io_seconds` (host
    time spent writing checkpoints and probe files) and `intervals` (per
    write target: simulated time, steps, wall seconds).

    `devices` (int N, or 'NxM' for a 2-D x·y decomposition): the grid's
    spatial axes over a mesh of that many positions, one device each from
    `device` (device.py `device_positions`: "cuda" the first N cards, an
    indexed device or "cpu" all on it, or a list). Positions that share
    one device run in this process. Positions on distinct cards run the
    sharded step as N (or N·M, on x·y blocks) ranks, one process a
    position (parallel/ranks.py, `_run_case_ranks`); `ranks=True` runs the
    ranks where positions share a device too (gloo between them).
    Checkpoints, probes and resume work as on one device: the state is
    written globally (by rank 0).

    With OFTPP_DEBUG_NANS=1 the run is trapped for NaN (utils/nan_trap.py;
    the trap is on for this call only, where the JAX package's setting
    holds for the process; each rank traps its own)."""
    d_x, d_y = sh.parse_devices(devices)
    positions = device_positions(device, d_x * d_y)
    if ranks or len(set(positions)) > 1:
        return _run_case_ranks(case_dir, props, controls, log,
                               write_checkpoints, devices, positions)
    with nan_trap.trap_nans() as trap:
        if trap is not None:
            log(f"  (NaN trap on, {nan_trap.ENV_FLAG}=1: sigFpe-parity NaN "
                "trapping)")
        return _run_case(case_dir, props, controls, log, write_checkpoints,
                         devices, device)


def _case_params(params, device):
    if params.get("model") == "tank6dof":
        # The motion comes from the case's table; the params are inert.
        return CaseParams.make(R=0.0, freq=0.0, duration=params["duration"],
                               device=device)
    return CaseParams.make(R=params["R"], freq=params["freq"],
                           duration=params["duration"], ramp=params["ramp"],
                           device=device)


def _run_case(case_dir, props, controls, log, write_checkpoints, devices,
              device) -> dict:
    params = load_case_params(case_dir)
    is_6dof = params.get("model") == "tank6dof"
    d_x, d_y, device = _mesh_device(devices, device)
    geom, advance, what = _compiled_advance(params, props, controls, case_dir,
                                            devices, d_x, d_y, device)
    log(_mesh_line(geom, params)
        + (f", {devices} mesh positions (x·y) on {device}: {what}"
           if d_x * d_y > 1 else ""))

    io_seconds = 0.0
    chk = latest_checkpoint(case_dir)
    if chk is not None:
        state = to_state(load_checkpoint(chk[1]), device=device)
        log(f"  Resuming from t={chk[0]:.4f} s ({chk[1]})")
    else:
        # 6DoF tutorial tank: waterline at z=0.
        state = init_state(geom, fill_height=0.0 if is_6dof else None,
                           dt0=params["dt"], device=device)
        if write_checkpoints:
            t_io = time.time()
            save_checkpoint(case_dir, state)
            io_seconds += time.time() - t_io

    def save(state):
        save_checkpoint(case_dir, state)

    def samples(buf, n):
        return buf[:n].cpu().numpy()

    return _time_loop(case_dir, params, geom, controls, advance,
                      _case_params(params, device), state, log,
                      write_checkpoints, save, samples, io_seconds)


def _mesh_line(geom, params):
    return (f"  Mesh: {geom.shape[0]}x{geom.shape[1]}x{geom.shape[2]} grid, "
            f"{geom.n_fluid_cells} fluid cells (h={params['mesh']:g} m, "
            f"geo={params.get('geo', geom.geo)})")


def _time_loop(case_dir, params, geom, controls, advance, case_params, state,
               log, write_checkpoints, save, samples, io_seconds,
               writes=True):
    """Advance `state` to the case's duration, one write interval at a
    time: `samples(buf, n)` gives the interval's probe rows (numpy) and
    `save(state)` writes a checkpoint. `writes=False` (ranks other than
    0): no probe file is opened or written (`samples` gives None)."""
    # Per-timestep probe channels: pressure probes + η wave gauges,
    # accumulated on the device every solver step and flushed at each
    # write interval.
    probe_pts = default_probe_points(geom)
    wave_cols = default_wave_columns(geom)
    t_now = float(state.t)
    if writes:
        probes = ProbeWriter(case_dir, probe_pts, "p", start_time=t_now)
        gauges = ProbeWriter(
            case_dir,
            np.column_stack([wave_cols, np.zeros(len(wave_cols))]),
            "eta", start_time=t_now)
    n_pts = len(probe_pts)

    duration = params["duration"]
    w = controls.write_interval
    first_k = int(np.floor(t_now / w + 1e-6)) + 1
    # Targets are computed with the same f32 arithmetic the device uses to
    # snap landing times (k * f32(w)), so `state.t == t_target` bitwise at
    # each write — no epsilon drift across a 20 s / 400-write run.
    w32 = np.float32(w)
    n_writes = int(np.floor(duration / w + 1e-9))
    targets = [float(np.float32(k) * w32) for k in range(first_k, n_writes + 1)]
    # A duration that is not a write multiple (swept values like 0.33) must
    # still be reached, else is_case_done() never fires.
    if not targets or targets[-1] < duration - 1e-9:
        targets.append(float(np.float32(duration)))

    wall0 = time.time()
    steps_total = 0
    intervals = []
    for t_target in targets:
        wall_t = time.time()
        steps_t = 0
        # Re-invoke until the target is actually reached: one advance is
        # bounded at max_steps and may fall short on fine meshes.
        while True:
            state, diag, n, buf = advance(state, case_params, t_target)
            steps_t += n
            if n:
                rows = samples(buf, n)
                if writes:
                    t_io = time.time()
                    probes.append_rows(rows[:, 0], rows[:, 1 : 1 + n_pts])
                    gauges.append_rows(rows[:, 0], rows[:, 1 + n_pts :])
                    io_seconds += time.time() - t_io
            if float(state.t) >= t_target or n == 0:
                break
            log(f"  (write target {t_target:.6g} s not reached in "
                f"{n} steps; continuing)")
        steps_total += steps_t
        if write_checkpoints:
            t_io = time.time()
            save(state)
            io_seconds += time.time() - t_io
        intervals.append({"t": float(state.t), "steps": steps_t,
                          "wall_seconds": time.time() - wall_t})
        log(
            f"Time = {float(state.t):.6g} s  "
            f"dt = {float(state.dt):.3e}  "
            f"Co = {float(diag.courant):.3f}  alphaCo = {float(diag.alpha_courant):.3f}  "
            f"p: iters {int(diag.p_iters)}, res {float(diag.p_residual):.2e}  "
            f"alpha in [{float(diag.alpha_min):.4f}, {float(diag.alpha_max):.4f}]"
        )

    wall = time.time() - wall0
    sim_time = float(state.t) - t_now
    n_cells = geom.n_fluid_cells
    stats = {
        "n_cells": n_cells,
        "steps": steps_total,
        "wall_seconds": wall,
        "sim_seconds": sim_time,
        "cell_steps_per_sec": n_cells * steps_total / max(wall, 1e-9),
        "io_seconds": io_seconds,
        "intervals": intervals,
    }
    log(
        f"  Done: {steps_total} steps / {sim_time:.3g} s simulated in "
        f"{wall:.1f} s wall ({stats['cell_steps_per_sec']:.3g} cell-updates/s)"
    )
    return stats


def rank_choice(params: dict, shape, d_x: int, d_y: int, dev,
                props: PhysicalProperties = PhysicalProperties()) -> str:
    """What the ranks run for a case on a (d_x, d_y) mesh of one process a
    position ('what runs', for the run's log): the 1-D x decomposition,
    or with d_y > 1 the 2-D x·y one, the orbital case and the 6DoF tank
    alike, on any nx that divides into d_x even x-slabs of at least
    MAX_HALO planes and any ny that divides into d_y even rows of blocks
    of at least MAX_HALO (the JAX package's 8·N rounding is its kernels'
    need, not the islands'). With the kernel islands where
    `_spmd_kernels_wanted` (on a card, or OFTPP_SPMD_PALLAS=interpret),
    else the plain step on every block (OFTPP_SPMD_PALLAS=0, or the CPU:
    the JAX package's GSPMD-jnp route); with surface tension the CSF
    terms run plain between the islands. A grid that does not divide so
    raises ValueError, before any process is spawned."""
    # nx % d_x, ny % d_y, nxl or nyl < MAX_HALO: ValueError
    nxl, nyl = SpmdCtx(d_x, d_y).local_shape(shape)[:2]
    if nxl % 2:
        raise ValueError(
            f"grid nx={shape[0]} over {d_x} ranks: x-slabs of nxl = {nxl} "
            "planes, an odd number (the multigrid's 2:1 pairs start within "
            "a rank)")
    if d_y > 1 and nyl % 2:
        raise ValueError(
            f"grid ny={shape[1]} over {d_y} ranks along y: blocks of nyl = "
            f"{nyl} rows, an odd number (the multigrid's 2:1 pairs start "
            "within a rank)")
    if not _spmd_kernels_wanted(dev):
        terms = ("the plain step on every block (OFTPP_SPMD_PALLAS=0)"
                 if os.environ.get("OFTPP_SPMD_PALLAS") == "0" else
                 "the plain step on every block (no card: the islands' "
                 "plain versions need OFTPP_SPMD_PALLAS=interpret)")
    elif d_y > 1:
        terms = "halo kernel islands on y-extended blocks"
    else:
        terms = "halo kernel islands"
    if props.sigma != 0.0:
        terms += f", surface tension σ = {props.sigma:g} N/m (CSF plain)"
    if d_y > 1:
        return (f"x·y-sharded step over {d_x}x{d_y} ranks (y fastest), "
                f"blocks of nxl x nyl = {nxl} x {nyl} cells ({terms})")
    return (f"x-sharded step over {d_x} ranks, x-slabs of nxl = {nxl} "
            f"planes ({terms})")


def _run_case_ranks(case_dir, props, controls, log, write_checkpoints,
                    devices, positions) -> dict:
    """`run_case` over ranks: one spawned process a mesh position
    (parallel/ranks.py `launch`, the (d_x, d_y) rank grid), each running
    `_rank_run` on its block.
    Returns rank 0's stats with `ranks` added: every rank's exchange
    stats and kernel launch counts."""
    from openfoam_tpp_tpu_torch.parallel import ranks as rk

    params = load_case_params(case_dir)
    d_x, d_y = sh.parse_devices(devices)
    geom = build_case_geometry(params, _case_shape_hint(case_dir),
                               devices=devices, device=positions[0])
    what = rank_choice(params, geom.shape, d_x, d_y, positions[0], props)
    backend = rk.backend_for(positions)
    shared = len(set(positions)) < len(positions)
    log(_mesh_line(geom, params)
        + f", {devices} mesh positions on "
        f"{', '.join(str(p) for p in positions)}: {what}, backend {backend}"
        + (" (ranks share a device)" if shared else ""))
    results = rk.launch(_rank_run, positions, log=log, grid=(d_x, d_y),
                        args=(case_dir, props, controls, write_checkpoints,
                              devices))
    stats = results[0]["stats"]
    stats["ranks"] = [{"device": str(p), "backend": backend, **r["ranks"]}
                      for p, r in zip(positions, results)]
    return stats


def _rank_run(ctx, log, case_dir, props, controls, write_checkpoints,
              devices):
    """One rank of `run_case`: the sharded step (`SpmdCtx(d_x, d_y,
    ranks=ctx)`, ctx on the (d_x, d_y) rank grid) on this rank's block, its
    kernel islands on where `_spmd_kernels_wanted` (else the plain step on
    the block), with the case's motion table for a 6DoF case; rank 0 reads
    the resumed state (or fills the tank) and scatters it, gathers each
    checkpoint and the probe rows and writes them. Returns {"stats" (rank
    0's run stats), "ranks": {exchange stats, kernel launches, p_iters of
    every step, the motion table's digest}}."""
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.post.probes import make_rank_sampler

    dev = ctx.device
    lead = ctx.rank == 0
    params = load_case_params(case_dir)
    is_6dof = params.get("model") == "tank6dof"
    chk = latest_checkpoint(case_dir) if lead else None
    hint = ctx.broadcast(None if chk is None else tuple(
        load_checkpoint(chk[1])["alpha"].shape))
    geom = build_case_geometry(params, hint, devices=devices, device=dev)
    controls = dataclasses.replace(controls,
                                   use_pallas=_spmd_kernels_wanted(dev))
    k_env = os.environ.get("OFTPP_PRECOND_REFRESH")
    if k_env is not None:
        controls = dataclasses.replace(controls, precond_refresh=int(k_env))
    motion = build_case_motion(params, case_dir, device=dev, ranks=ctx)
    inner = make_step(geom, props, controls, motion=motion,
                      carry_precond=True,
                      spmd=SpmdCtx(*ctx.grid, ranks=ctx),
                      device=dev)
    iters = []

    def step(*a, **k):
        out = inner(*a, **k)
        iters.append(out[1].p_iters)
        return out

    step.init_precond = inner.init_precond
    sampler, width, rows = make_rank_sampler(
        geom, default_probe_points(geom), default_wave_columns(geom), ctx,
        device=dev)
    advance = make_advance(step, sampler=sampler, sample_width=width)

    io_seconds = 0.0
    whole = None
    if lead and chk is not None:
        whole = to_state(load_checkpoint(chk[1]), device="cpu")
        log(f"  Resuming from t={chk[0]:.4f} s ({chk[1]})")
    elif lead:
        whole = init_state(geom, fill_height=0.0 if is_6dof else None,
                           dt0=params["dt"], device="cpu")
        if write_checkpoints:
            t_io = time.time()
            save_checkpoint(case_dir, whole)
            io_seconds += time.time() - t_io
    state = rk.scatter_state(whole, geom.shape, ctx)

    def save(state):
        whole = rk.gather_state(state, ctx)
        if lead:
            save_checkpoint(case_dir, whole)

    def samples(buf, n):
        out = rows(ctx.all_gather(buf[:n]))
        return out.cpu().numpy() if lead else None

    with nan_trap.trap_nans():
        stats = _time_loop(case_dir, params, geom, controls, advance,
                           _case_params(params, dev), state, log,
                           write_checkpoints, save, samples, io_seconds,
                           writes=lead)
    return {"stats": stats, "ranks": {
        **ctx.stats.as_dict(), "launches": rk.launch_counts(),
        "p_iters": [int(i) for i in iters],
        "motion_sha256": None if motion is None else motion.sha256()}}


def iterate_snapshots(case_dir: str):
    """Yield (t, alpha) from all checkpoints — feeds post/interface.py."""
    for t, path in list_checkpoints(case_dir):
        yield t, load_checkpoint(path)["alpha"]
