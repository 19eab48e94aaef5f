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
from openfoam_tpp_tpu_torch.parallel.sweep import batch_params
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


def make_tiled_sweep_step(geom: TankGeometry, n_cases: int,
                          props: PhysicalProperties = PhysicalProperties(),
                          controls: SolverControls = SolverControls(),
                          device="cuda"):
    """Step function advancing all tiled cases at once: `step(state,
    params, t_stop=None) -> (state', diag)` with `params` a batched
    CaseParams ((n_cases,) tensors, as from batch_params). `controls`
    are the caller's: `use_pallas=True` runs the single-grid kernels on
    the merged grid."""
    dev = resolve_device(device)
    tgeom = tile_geometry(geom, n_cases)
    ga = geometry_arrays(tgeom, device=dev)
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

    core = make_step_core(props, controls, open_top=True, forcing=forcing)

    def step(state: SimState, params: CaseParams, t_stop=None):
        return core(state, params, ga, spacing, t_stop=t_stop)

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
