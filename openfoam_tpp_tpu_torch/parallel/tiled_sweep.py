"""Tiled sweeps — port of openfoam_tpp_tpu/parallel/tiled_sweep.py: N
same-geometry cases merged into ONE grid along x.

The cases lie side by side along x. Each keeps its 1-cell solid padding
ring, so every junction face has zero aperture: fluxes, the pressure
operator and MULES are decoupled between blocks, while the step sees one
large dense grid and runs the single-grid kernels (with
`use_pallas=True`), with no case axis. The V-cycle coarsens within the
blocks while the per-case width halves; the CG runs on the union system,
so a tiled sweep agrees with the batched one (parallel/sweep.py) to the
solver's tolerance, not bitwise. Per-case forcing (R, freq, ramp) enters
through `make_step_core`'s `forcing` hook as a piecewise-constant-in-x
acceleration: G_x and G_y repeated over each block's nx cells, G_z (the
same for every case) kept 0-d.

One adaptive dt governs the whole batch (the minimum over cases, as the
lockstep sweep's). The JAX package advances the tiled state in a device
`while_loop`; here `run_tiled_sweep` is a host loop that reads `t` once
per step.

The merged grid composes with the x (and y) decomposition, as in the
JAX package's mesh: `make_tiled_sweep_step(..., spmd=SpmdCtx(N, M,
ranks=ctx))` steps one rank's x·y block of it (parallel/ranks.py, a
(1, N, M) rank grid), with the halo islands of parallel/spmd.py; the
forcing keeps returning the whole grid's repeated G_x, G_y, which the
step cuts to the block (solver/timestep.py `block_forcing`).
`run_tiled_sweep_ranks` is `run_tiled_sweep` over such ranks, one
spawned process a position. Where N divides the case count every rank
boundary lies on a sealed junction; the plane exchanges still run
there (nothing is skipped), so the step is the same program whatever
the cut.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core import motion as mo
from openfoam_tpp_tpu_torch.core.state import CaseParams, SimState, init_state
from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import TankGeometry
from openfoam_tpp_tpu_torch.parallel.sweep import batch_params, farm_block
from openfoam_tpp_tpu_torch.solver.timestep import (geometry_arrays,
                                                    make_step_core)


def tile_geometry(geom: TankGeometry, n_cases: int) -> TankGeometry:
    """N copies of `geom` laid out along x as one merged TankGeometry.
    The x-face apertures drop the duplicated last face of every block but
    the final one (both block-end faces are zero: the solid ring)."""
    assert n_cases >= 1
    ax = geom.ax
    if not (np.all(ax[0] == 0.0) and np.all(ax[-1] == 0.0)):
        raise ValueError("tile_geometry requires sealed x-boundary faces "
                         "(build the geometry with pad_cells >= 1)")
    merged_ax = np.concatenate([ax[:-1]] * n_cases + [ax[-1:]], axis=0)
    rep = lambda a: np.concatenate([a] * n_cases, axis=0)
    nx, ny, nz = geom.shape
    return dataclasses.replace(
        geom, shape=(nx * n_cases, ny, nz), vfrac=rep(geom.vfrac),
        ax=merged_ax, ay=rep(geom.ay), az=rep(geom.az),
        top_open=rep(geom.top_open))


def tile_state(geom: TankGeometry, n_cases: int, dt0: float = 1e-3,
               device="cuda", **init_kwargs) -> SimState:
    """Quiescent initial state of the tiled grid (the same in every
    block); u drops the duplicated block-end faces."""
    s = init_state(geom, dt0=dt0, device=device, **init_kwargs)

    def rep(a):
        if a.dim() == 0:
            return a
        return a.repeat(n_cases, *([1] * (a.dim() - 1)))

    tiled = SimState(**{f.name: rep(getattr(s, f.name))
                        for f in dataclasses.fields(SimState)})
    tiled.u = torch.cat([s.u[:-1]] * n_cases + [s.u[-1:]], dim=0)
    return tiled


def untile(arr, n_cases: int, face_x: bool = False) -> np.ndarray:
    """Split a merged-grid array back into per-case blocks (a leading
    case axis), as numpy. `face_x` re-duplicates the shared block-end
    x-faces."""
    a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
         else np.asarray(arr))
    if face_x:
        nxp = (a.shape[0] - 1) // n_cases
        return np.stack([a[i * nxp: i * nxp + nxp + 1]
                         for i in range(n_cases)])
    return np.stack(np.split(a, n_cases, axis=0))


def tiled_block(geom: TankGeometry, n_cases: int, grid) -> tuple:
    """(nxl, nyl, nz): the block each rank steps of `n_cases` tiled cases
    over a (1, N, M) (or (N, M)) rank `grid`. ValueError where the grid
    has case positions (the cases are merged into one grid), or the
    merged nx·n_cases (ny) does not divide into N (M) even blocks of at
    least two cells (parallel/sweep.py `farm_block`'s rules); callers
    check it before any process is spawned."""
    grid = tuple(int(g) for g in grid)
    if len(grid) == 2:
        grid = (1, *grid)
    if len(grid) != 3 or grid[0] != 1:
        raise ValueError(
            f"a tiled sweep over a {grid} rank grid: its cases are merged "
            "into one grid along x, so the grid is (1, N, M)")
    nx, ny, nz = geom.shape
    return farm_block((nx * n_cases, ny, nz), 1, grid)[:3]


def make_tiled_sweep_step(geom: TankGeometry, n_cases: int,
                          props: PhysicalProperties = PhysicalProperties(),
                          controls: SolverControls = SolverControls(),
                          device="cuda", spmd=None):
    """Step function advancing all tiled cases at once: `step(state,
    params, t_stop=None) -> (state', diag)` with `params` a batched
    CaseParams ((n_cases,) tensors, as from batch_params). `controls`
    are the caller's: `use_pallas=True` runs the single-grid kernels on
    the merged grid. `spmd`: the x-sharded step (`SpmdCtx(N)`, x-slabs in
    one process) or, with `SpmdCtx(N, M, ranks=ctx)` on a (1, N, M) rank
    grid, one rank's x·y block of the merged grid (`tiled_block`), its
    state from parallel/sharding.py `shard_state(..., ranks=)` and its
    params whole."""
    dev = resolve_device(device)
    ranks = None if spmd is None else spmd.ranks
    if ranks is not None:
        tiled_block(geom, n_cases, (ranks.cases, *ranks.grid))
    tgeom = tile_geometry(geom, n_cases)
    if spmd is not None and ranks is None:
        spmd.local_shape(tgeom.shape)
    ga = geometry_arrays(tgeom, device=dev, ranks=ranks)
    spacing = tuple(float(s) for s in geom.spacing)
    nx = geom.shape[0]

    def forcing(t, params):
        # Per-case uniform acceleration (3, n_cases), repeated across
        # each x block; G_z is gravity alone, the same for every case
        # (the orbit is horizontal).
        G = mo.effective_gravity(t, params, props.g)
        gx = G[0].repeat_interleave(nx).reshape(-1, 1, 1)
        gy = G[1].repeat_interleave(nx).reshape(-1, 1, 1)
        return gx, gy, G[2, 0]

    core = make_step_core(props, controls, open_top=True, forcing=forcing,
                          spmd=spmd)

    def step(state: SimState, params: CaseParams, t_stop=None):
        return core(state, params, ga, spacing, t_stop=t_stop)

    step.ranks = ranks
    return step


def run_tiled_sweep(geom: TankGeometry, param_rows: list[dict], t_end: float,
                    props: PhysicalProperties = PhysicalProperties(),
                    controls: SolverControls = SolverControls(),
                    max_steps: int = 100_000, device="cuda"):
    """Advance a tiled sweep to t_end. Returns (merged state, n_steps)."""
    n = len(param_rows)
    params = batch_params(param_rows, device=device)
    state = tile_state(geom, n, device=device)
    step = make_tiled_sweep_step(geom, n, props, controls, device=device)
    k = 0
    while k < max_steps and bool(state.t < t_end):
        state, _ = step(state, params)
        k += 1
    return state, k


def _tiled_rank(ctx, log, geom, param_rows, t_end, props, controls,
                max_steps):
    """One rank of `run_tiled_sweep_ranks`: its block of the merged grid
    stepped to t_end (the loop's test over every rank), the gathered
    state on rank 0, and each rank's exchange stats, kernel launches and
    p_iters."""
    from openfoam_tpp_tpu_torch.core.state import state_to_numpy
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx

    dev, n = ctx.device, len(param_rows)
    mesh = sh.make_mesh(ctx.world, y_axis=ctx.grid[1],
                        devices=[dev] * ctx.world)
    step = make_tiled_sweep_step(geom, n, props, controls, device=dev,
                                 spmd=SpmdCtx(*ctx.grid, ranks=ctx))
    run = sh.sharded_step(step, mesh, ranks=ctx)
    parts = sh.shard_state(tile_state(geom, n, device=dev), mesh, ranks=ctx)
    pparts = sh.params_sharding(mesh, ranks=ctx).put(
        batch_params(param_rows, device=dev))
    k, iters = 0, []
    t_min = lambda: ctx.all_reduce(parts[0].t, op="min")
    while k < max_steps and bool(t_min() < t_end):
        parts, diags = run(parts, pparts)
        iters.append(int(diags[0].p_iters))
        k += 1
    # numpy crosses to the parent: a tensor's storage would be shared
    # with a process that is about to end.
    state = run.sharding.gather(parts)
    return {"state": None if state is None else state_to_numpy(state),
            "n_steps": k,
            "ranks": {**ctx.stats.as_dict(), "launches": rk.launch_counts(),
                      "p_iters": iters}}


def run_tiled_sweep_ranks(geom: TankGeometry, param_rows: list[dict],
                          t_end: float, grid, positions,
                          props: PhysicalProperties = PhysicalProperties(),
                          controls: SolverControls = SolverControls(),
                          max_steps: int = 100_000, log=print):
    """`run_tiled_sweep` over a (1, N, M) grid of ranks, one spawned
    process a position in `positions` (parallel/ranks.py; gloo where
    positions share a device, NCCL between cards): each rank steps its
    x·y block of the merged grid with `make_tiled_sweep_step(...,
    spmd=SpmdCtx(N, M, ranks=ctx))`. Returns (the merged state on the
    CPU, n_steps, each rank's {exchange stats, "launches", "p_iters"}).
    The grid is checked before any process is spawned (`tiled_block`)."""
    from openfoam_tpp_tpu_torch.core.state import state_from_numpy
    from openfoam_tpp_tpu_torch.parallel import ranks as rk

    grid = tuple(int(g) for g in grid)
    block = tiled_block(geom, len(param_rows), grid)
    log(f"  tiled sweep of {len(param_rows)} cases "
        f"({geom.shape[0] * len(param_rows)} x {geom.shape[1]} x "
        f"{geom.shape[2]}) over {'x'.join(map(str, grid))} ranks: blocks "
        f"of {' x '.join(map(str, block))}")
    res = rk.launch(_tiled_rank, positions, log=log, grid=grid,
                    args=(geom, param_rows, t_end, props, controls,
                          max_steps))
    return (state_from_numpy(res[0]["state"], device="cpu"),
            res[0]["n_steps"], [r["ranks"] for r in res])
