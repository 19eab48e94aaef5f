"""The VoF time step — port of openfoam_tpp_tpu/solver/timestep.py:

    per Δt: adapt dt from Co/alphaCo → α sub-cycles (MULES ×3) →
    explicit momentum (van Leer convection with rhoPhi, viscous, dev2) →
    uniform effective-gravity forcing G(t) = g − a_frame(t) [+ CSF
    surface tension] → pressure projection (MG-preconditioned CG) →
    velocity correction.

`make_step(geom, props, controls, device=...)` returns
`step(state, params) -> (state', diag)`. PyTorch runs eagerly, so there
is nothing to compile; `t` and `dt` stay 0-d device tensors and the dt
logic never reads them on the host. The CG loop syncs once per
iteration (solver/poisson.py), through `utils/profiling.host_read`, the
one way the step reads a device value. Under `utils/profiling.collect()`
the step records its spans: `step` (the root), `step.cfl`,
`alpha.advect` (ops/mules.py), `pressure.operator`, `pressure.bundle`,
`momentum`, `pressure.solve` (its `pressure.cg`, solver/poisson.py),
`correction` and `step.diagnostics`; a sweep's batched step is one
`step` (parallel/sweep.py `lockstep_step`).

Parameter sweeps: the step is rank-polymorphic. Grid arrays are
(nx, ny, nz) or, with many cases stacked on a trailing axis,
(nx, ny, nz, B); the per-case scalars (t, dt, step, the forcing
parameters, a per-case spacing) are then (B,) tensors, which broadcast
against the trailing axis as they are, and every reduction is over the
cells only, so the diagnostics come back per case. A lockstep sweep
gives every case the batch minimum of the CFL dt, which is what
`lax.pmin` over the vmapped axis does in the JAX step: it calls
`step.cfl_dt`, takes the minimum (over every position of a farm's
device mesh) and hands the step the result as `cfl=`
(parallel/sweep.py `lockstep_step`);
`batch_lanes` keeps MULES on its plain path while the 7-point passes run
the batch-native kernels (parallel/sweep.py sets both).

Ported configuration: the analytic orbital motion and the table-driven
motion of the closed 6DoF tank (`motion=TableMotion`, core/motion.py) on
one device, with every `SolverControls` the JAX step takes there. A
motion table replaces the orbit's G(t) by Rᵀ(g_lab − a(t)); with
rotation the step adds the centrifugal, Euler and Coriolis accelerations
of the tank frame (solver/frame.py) at the face coordinates `face_xyz`,
which `make_step` builds. Surface tension (`props.sigma != 0`) adds the
capillary dt bound, the curvature of the advected alpha
(`controls.csf_curvature`) and the CSF source (solver/momentum.py), all
plain PyTorch, as in the JAX step. `forcing(t, params) -> (Gx, Gy, Gz)`
replaces G(t): the tiled sweep's per-block acceleration
(parallel/tiled_sweep.py), whose x component varies along x and is
face-averaged. With `use_pallas` the
step runs the fused kernels behind the JAX step's gates, read when the
step is built: the momentum right-hand side (`OFTPP_MOM_PALLAS`), the
projection epilogue on the last corrector (`OFTPP_CORR_PALLAS`) and,
opt-in, the momentum finish (`OFTPP_FINISH_PALLAS=1`; off under a
rotating frame or surface tension, whose sources come between the
density scaling and the wall mask, and for a forcing component that is
not 0-d, as in the JAX step). The pressure
solver's knobs (`poisson.SolverKnobs`: OFTPP_SMOOTH_SWEEPS and the rest)
are read at the same moment and handed to the pressure solve. The gates
alone decide: the kernels take any 3-D f32 grid (the JAX kernels' slab and
VMEM shape checks are TPU limits), and a non-f32 operand raises.

`spmd=SpmdCtx(n)` (parallel/spmd.py) is the JAX package's x-sharded step:
every kernel call site becomes a per-shard island with the halo kernels
(the MULES flux build and limiter, the 7-point passes of the pressure
solve's top level, the momentum RHS, the last corrector's epilogue),
while the state and everything between islands stay global tensors. On
one card the n shards are x-slabs of the same tensors. The momentum
finish kernel stays off under `spmd` (no halo form), as in the JAX step.
A motion table shards too, rotating or not: the 6DoF tank's frame
sources are plain PyTorch between the islands, and its closed top runs
the epilogue island's closed-top form.

`spmd=SpmdCtx(n, ranks=ctx)` is the same step in one rank process of n
(parallel/ranks.py): `make_step` uploads the rank's x-slab of the
geometry, the state is the rank's slab (parallel/ranks.py
`scatter_state`), and the step runs inside ops/stencil.py's `rank_block`,
so every x-neighbour access between the islands takes the neighbour
rank's plane and every reduction (the Courant numbers, the dots, the
alpha bounds, the div max) is over the ranks: the dt, the CG's stop and
every diagnostic come out alike on every rank. `spmd=SpmdCtx(n, m,
ranks=ctx)` is the 2-D x·y decomposition over an (n, m) rank grid: the
rank holds an x·y block of the geometry (the (nx, ny) `top_open` plane
and the y apertures too) and of the state, the y-neighbour accesses
between the islands take the neighbour rank's rows, and the islands run
on y-extended blocks (parallel/spmd.py). It exists over ranks only. A motion table
runs there too (the 6DoF tank: each rank holds the same table bits, its
rotating frame's sources take the rank's own x coordinates, and the
closed tank's null-space projection and fluid mean sum over the ranks).
The rank form runs every configuration of the one-process step. A
`forcing=` callback keeps the JAX contract and returns whole-grid
components; the step cuts them to the rank's block (`block_forcing`):
each rank cuts its part of the same array, so the cut adds no
collective. With a fused-kernel gate
turned off (`mom_pallas=False`, OFTPP_MOM_PALLAS=0, OFTPP_CORR_PALLAS=0)
the momentum RHS and the projection epilogue run their plain versions on
the rank's block while the MULES and 7-point islands stay (MULES is
plain with `use_pallas=False` and in a sweep, as in one process);
with `use_pallas=False` everything on the block is plain (the JAX
package's GSPMD-jnp route, OFTPP_SPMD_PALLAS=0); with surface tension
the CSF terms run plain between the islands. Whatever runs plain is the
whole grid's step on the block: every neighbour access and pad at an
interior boundary takes the neighbour rank's plane (ops/stencil.py).
A sweep's batched block runs over ranks too (`batch_lanes` with
`SpmdCtx(n, m, ranks=ctx)` on a (C, n, m) rank grid: parallel/sweep.py
`make_sweep_step(spmd=...)`): its step is the plain step above on a
(nxl, nyl, nz, B/C) block, its 7-point passes the batch kernels on
extended blocks (parallel/spmd.py), its reductions per case over the
case group. The tiled sweep's merged grid runs over x·y ranks the same
way (parallel/tiled_sweep.py, `forcing=` cut per block), and the
geometry sweep's batched block with each case's cut cells and spacing
(parallel/sweep.py `make_geom_sweep_step(spmd=...)`).
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core import motion as mo
from openfoam_tpp_tpu_torch.core.state import (SimState, mixture_density,
                                               mixture_viscosity)
from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import TankGeometry
from openfoam_tpp_tpu_torch.ops import mules
from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import correction as _ck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as _mfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as _mrk
from openfoam_tpp_tpu_torch.parallel import spmd as _sm
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import frame as fr
from openfoam_tpp_tpu_torch.solver import momentum as mom
from openfoam_tpp_tpu_torch.solver import poisson
from openfoam_tpp_tpu_torch.utils.profiling import (host_read, span,
                                                    step_span)


def _mom_pallas_enabled(controls: SolverControls) -> bool:
    """Fused momentum right-hand side gate, as in the JAX step: an
    explicit `mom_pallas=False` pins it off and beats the environment;
    else OFTPP_MOM_PALLAS=0/1, else `mom_pallas`, else `use_pallas`."""
    if controls.mom_pallas is False:
        return False
    env = os.environ.get("OFTPP_MOM_PALLAS")
    if env is not None:
        return env == "1"
    if controls.mom_pallas is not None:
        return controls.mom_pallas
    return controls.use_pallas


def _finish_pallas_enabled(controls: SolverControls) -> bool:
    """Fused momentum finish gate: opt-in with OFTPP_FINISH_PALLAS=1, off
    under `mom_pallas=False`; it runs only after the right-hand side
    kernel."""
    if controls.mom_pallas is False:
        return False
    return os.environ.get("OFTPP_FINISH_PALLAS") == "1"


def _corr_pallas_enabled(controls: SolverControls) -> bool:
    """Fused projection epilogue gate: off under `mom_pallas=False`, else
    OFTPP_CORR_PALLAS=0/1, else `use_pallas`."""
    if controls.mom_pallas is False:
        return False
    env = os.environ.get("OFTPP_CORR_PALLAS")
    if env is not None:
        return env == "1"
    return controls.use_pallas


def _fct_bf16_enabled(controls: SolverControls) -> bool:
    """bf16 FCT streams: OFTPP_FCT_BF16=0/1 overrides `fct_bf16`."""
    env = os.environ.get("OFTPP_FCT_BF16")
    if env is not None:
        return env == "1"
    return controls.fct_bf16


class StepDiagnostics(NamedTuple):
    """Per-step scalars (0-d device tensors; (B,) per case on a batched
    step)."""

    courant: torch.Tensor
    alpha_courant: torch.Tensor
    p_residual: torch.Tensor
    p_iters: torch.Tensor
    div_error: torch.Tensor
    alpha_min: torch.Tensor
    alpha_max: torch.Tensor


class Cfl(NamedTuple):
    """The adaptive-dt block's results, which the rest of the step reads:
    the fluid mask, the Courant numbers at the old dt and the CFL dt
    (per case on a batched step). A lockstep farm (parallel/sharding.py)
    takes the batch minimum of `dt` over every position of its mesh
    between `step.cfl_dt` and the step that is handed the result."""

    fluid: torch.Tensor
    courant: torch.Tensor
    alpha_courant: torch.Tensor
    dt: torch.Tensor

    def synced(self, dt_min) -> "Cfl":
        """Every case's CFL dt replaced by `dt_min` (0-d)."""
        return self._replace(dt=dt_min.expand_as(self.dt).clone())


def geometry_arrays(geom: TankGeometry, dtype=torch.float32, device="cuda",
                    ranks=None):
    """Upload the static geometry to device tensors once; with `ranks` (a
    parallel.ranks.RankCtx) this rank's x·y block of it."""
    dev = resolve_device(device)
    cut = ((lambda a: a) if ranks is None
           else (lambda a: ranks.block(a, geom.shape)))
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(
        cut(np.asarray(a))), device=dev).to(dtype)
    return {"vfrac": as_t(geom.vfrac), "ax": as_t(geom.ax),
            "ay": as_t(geom.ay), "az": as_t(geom.az),
            "top_open": as_t(geom.top_open)}


def capillary_dt(props, controls, spacing, dtype, device):
    """Brackbill's capillary-wave dt limit on the finest spacing, formed in
    `dtype` as the JAX step forms it in f32 (per case for a per-case
    spacing)."""
    hx, hy, hz = (torch.as_tensor(h, dtype=dtype, device=device)
                  for h in spacing)
    h_min = torch.minimum(torch.minimum(hx, hy), hz)
    return controls.max_capillary_co * torch.sqrt(
        (props.rho1 + props.rho2) * h_min ** 3
        / (4.0 * np.pi * abs(props.sigma)))


def _check_slice(controls, spmd=None):
    """Raise for every argument of the JAX step this port does not cover."""
    if spmd is not None and not isinstance(spmd, SpmdCtx):
        raise TypeError(f"spmd= takes a parallel.spmd.SpmdCtx, not "
                        f"{type(spmd).__name__}")
    if spmd is not None and controls.batch_lanes and spmd.ranks is None:
        raise NotImplementedError(
            "spmd= with batch_lanes in one process: a sweep is not sharded "
            "through spmd (in the JAX package either); over ranks it runs "
            "on each rank's block (SpmdCtx(n, m, ranks=ctx), "
            "parallel/sweep.py make_sweep_step)")
    if spmd is not None and spmd.y_shards > 1 and spmd.ranks is None:
        raise NotImplementedError(
            f"spmd=SpmdCtx({spmd.n_shards}, {spmd.y_shards}) in one process: "
            "the one-process form holds x-slabs only; the x·y blocks run "
            "over ranks (SpmdCtx(n, m, ranks=ctx), parallel/ranks.py)")


def block_forcing(G, ranks, nxl: int, nyl: int):
    """A forcing's whole-grid components (JAX's contract: each 0-d, or
    3-D and broadcast against its face grid) cut to this rank's x·y block
    of nxl × nyl cells (`ranks` a parallel.ranks.RankCtx). A 0-d
    component stays as it is. Along x and y an extent of 1 is kept and
    the axis's global cell count is cut (RankCtx.cut); any other extent
    raises ValueError. A component that varies along its own axis (the
    tiled sweep's per-block G_x) is first averaged to its n + 1 faces on
    the whole grid, then cut with the shared face plane: the low face
    takes the left neighbour's last cell without an exchange, and the
    faces are bitwise those the one-process step averages. Every rank
    cuts its part of the same whole array: no collective."""
    n_glob = (nxl * ranks.grid[0], nyl * ranks.grid[1])
    out = []
    for ax, g in enumerate(G):
        if not isinstance(g, torch.Tensor) or g.dim() == 0:
            out.append(g)
            continue
        if g.dim() < 3:
            raise ValueError(
                f"forcing component {'xyz'[ax]} of shape {tuple(g.shape)} "
                "over ranks: 0-d, or 3-D and broadcast against its face grid")
        for d in (0, 1):
            if g.shape[d] == n_glob[d]:
                if d == ax:
                    with st.rank_block(None):
                        g = st.cells_to_faces_avg(g, d)
                g = ranks.cut(g, n_glob[d], d)
            elif g.shape[d] != 1:
                raise ValueError(
                    f"forcing component {'xyz'[ax]} of shape "
                    f"{tuple(g.shape)} over ranks: its {'xy'[d]} extent is "
                    f"neither 1 nor the grid's {n_glob[d]} cells")
        out.append(g)
    return tuple(out)


def make_step_core(props: PhysicalProperties = PhysicalProperties(),
                   controls: SolverControls = SolverControls(),
                   motion=None, open_top: bool = True, face_xyz=None,
                   forcing=None, carry_precond: bool = False,
                   sealed_x: bool = True, spmd=None):
    """Build `step(state, params, ga, spacing, t_stop=None, precond=None,
    cfl=None)`. `cfl` (a `Cfl` from `step.cfl_dt`, its dt synchronized
    by the caller) replaces the step's own adaptive-dt block.

    With `carry_precond` the step also takes and returns the bf16
    preconditioner bundle (poisson.make_bundle), rebuilt every
    `controls.precond_refresh` steps; the operator is fresh every step.

    `motion` (a TableMotion): table-driven forcing; with rotation it
    needs `face_xyz`, the three axes' face_coordinates. `forcing(t,
    params) -> (Gx, Gy, Gz)` replaces the uniform G(t); each component
    is 0-d, or 3-D and broadcast against its face grid (over ranks the
    whole grid's, cut to the block by `block_forcing`).

    The fused kernels write zeros for u's face-nx row, so they run only
    with `sealed_x` (the last x-aperture plane is all zero, true of every
    shipped geometry); an env force of one of them on an unsealed
    geometry raises ValueError, as in the JAX step."""
    _check_slice(controls, spmd=spmd)
    rot_enabled = motion is not None and motion.has_rotation
    if rot_enabled and face_xyz is None:
        raise ValueError("rotational motion requires face_xyz coordinates")
    if not sealed_x:
        for var in ("OFTPP_MOM_PALLAS", "OFTPP_FINISH_PALLAS",
                    "OFTPP_CORR_PALLAS"):
            if os.environ.get(var) == "1":
                raise ValueError(
                    f"{var}=1 forced on a geometry whose +x face is not "
                    "sealed (last x-aperture plane has open faces): the "
                    "fused kernels hard-code zeros there and would "
                    "silently diverge from the aperture-masked path")
    use_k = controls.use_pallas
    # batch_lanes (sweeps): the MULES kernels are single-grid; only the
    # 7-point family has batch-native kernels.
    use_mules_k = use_k and not controls.batch_lanes
    fct_bf16 = _fct_bf16_enabled(controls)
    use_mom_k = sealed_x and _mom_pallas_enabled(controls)
    # The finish kernel adds a uniform G alone: off under a rotating frame
    # or CSF (and, at call time, for a forcing component that is not 0-d).
    use_finish_k = (use_mom_k and spmd is None and not rot_enabled
                    and props.sigma == 0.0
                    and _finish_pallas_enabled(controls))
    use_corr_k = sealed_x and _corr_pallas_enabled(controls)
    knobs = poisson.SolverKnobs.from_env()
    ranks = None if spmd is None else spmd.ranks

    def slabs(state):
        """The stencil's x·y block of a rank process."""
        if ranks is None:
            return contextlib.nullcontext()
        return st.rank_block(ranks, *state.alpha.shape[:2])

    def make_bundle(pack):
        return poisson.make_bundle(pack, use_pallas=use_k, knobs=knobs,
                                   spmd=spmd)

    def effective_g(t, params):
        """Uniform body acceleration in the tank frame: G = g − a_frame,
        with rotation turned into the tank frame by Rᵀ."""
        if motion is None:
            return mo.effective_gravity(t, params, props.g)
        a = motion.acceleration(t)
        g_lab = torch.zeros_like(a)
        g_lab[2].fill_(-props.g)   # a fill, as mo.effective_gravity's
        if rot_enabled:
            R = mo.rotation_matrix(motion.orientation(t))
            return mo.matvec3(R.T, g_lab - a)
        return g_lab - a

    def interp_to_faces(q, qax, ax):
        """A velocity component on qax-faces, averaged to ax-faces."""
        if qax == ax:
            return q
        return st.cells_to_faces_avg(st.faces_to_cells_avg(q, qax), ax)

    def courant_numbers(u, v, w, alpha, dt, fluid, spacing):
        hx, hy, hz = spacing
        speed = (torch.abs(st.faces_to_cells_avg(u, 0)) / hx
                 + torch.abs(st.faces_to_cells_avg(v, 1)) / hy
                 + torch.abs(st.faces_to_cells_avg(w, 2)) / hz)
        co = dt * st.max_cells(torch.where(fluid, speed, 0.0))
        near_if = (alpha > 0.01) & (alpha < 0.99)
        co_a = dt * st.max_cells(torch.where(fluid & near_if, speed, 0.0))
        return co, co_a * (1.0 + controls.c_alpha)

    def cfl_dt(state: SimState, ga, spacing, fluid=None) -> Cfl:
        """The adaptive dt (adjustTimeStep) of every case, all on the
        device, before a lockstep sweep's batch minimum."""
        hx, hy, hz = spacing
        if fluid is None:
            fluid = ga["vfrac"] > 0.0
        co, co_a = courant_numbers(state.u, state.v, state.w, state.alpha,
                                   state.dt, fluid, spacing)
        limit = torch.minimum(
            controls.max_co / torch.clamp(co / state.dt, min=1e-10),
            controls.max_alpha_co / torch.clamp(co_a / state.dt, min=1e-10))
        dt_cfl = torch.clamp(torch.minimum(controls.dt_growth * state.dt,
                                           limit), max=controls.max_dt)
        if controls.max_diff_co > 0.0:
            inv_h2 = 1.0 / hx ** 2 + 1.0 / hy ** 2 + 1.0 / hz ** 2
            nu_max = max(props.nu1, props.nu2)
            dt_diff = controls.max_diff_co / (nu_max * inv_h2)
            dt_cfl = (torch.minimum(dt_cfl, dt_diff)
                      if isinstance(dt_diff, torch.Tensor)   # per-case hz
                      else torch.clamp(dt_cfl, max=dt_diff))
        if props.sigma != 0.0 and controls.max_capillary_co > 0.0:
            dt_cfl = torch.minimum(dt_cfl, capillary_dt(
                props, controls, spacing, state.dt.dtype, state.dt.device))
        return Cfl(fluid, co, co_a, dt_cfl)

    def step(state: SimState, params, ga, spacing, t_stop=None,
             precond=None, cfl=None):
        with step_span(), slabs(state):
            return step_slab(state, params, ga, spacing, t_stop, precond,
                             cfl)

    def step_slab(state, params, ga, spacing, t_stop, precond, cfl):
        fdt = state.dt.dtype
        dev = state.dt.device
        if spmd is not None and ranks is None and state.alpha.dim() != 3:
            raise NotImplementedError(
                "spmd= on a batched state in one process: a sweep is not "
                "sharded through spmd (in the JAX package either); over "
                "ranks it runs on each rank's block")
        with span("step.cfl"):
            if cfl is None:
                cfl = cfl_dt(state, ga, spacing)
            fluid, co, co_a, dt_cfl = cfl
            # --- adjustableRunTime: land exactly on the write grid /
            # t_stop. Python numbers become device scalars by a fill: a
            # host-to-device copy would wait for the device. ---
            w = float(controls.write_interval)
            if w > 0.0:
                wj = torch.full((), w, dtype=fdt, device=dev)
                k_next = torch.floor(state.t / wj + 1e-4) + 1.0
                t_next = k_next * wj
            else:
                t_next = torch.full((), float("inf"), dtype=fdt, device=dev)
            if t_stop is not None:
                t_next = torch.minimum(t_next, (
                    torch.full((), t_stop, dtype=fdt, device=dev)
                    if isinstance(t_stop, (int, float))
                    else torch.as_tensor(t_stop, dtype=fdt, device=dev)))
            rem = torch.clamp(t_next - state.t, min=1e-12)
            finite = torch.isfinite(rem)
            n_split = torch.clamp(torch.ceil(rem / dt_cfl - 1e-4), min=1.0)
            dt = torch.where(finite, rem / n_split, dt_cfl)
            t_new = torch.where(finite & (n_split <= 1.0), t_next,
                                state.t + dt)

        # --- alpha advection with the divergence-free flux of step n ---
        phi = (ga["ax"] * state.u, ga["ay"] * state.v, ga["az"] * state.w)
        alpha_new, rho_phi, _ = mules.advect_alpha(
            state.alpha, phi, ga, spacing, dt, props.rho1, props.rho2,
            c_alpha=controls.c_alpha,
            n_subcycles=controls.n_alpha_subcycles,
            n_limiter_iters=controls.n_limiter_iters,
            use_pallas=use_mules_k, fct_bf16=fct_bf16, spmd=spmd)

        rho_old = mixture_density(state.alpha, props)
        rho_new = mixture_density(alpha_new, props)
        mu = mixture_viscosity(alpha_new, props)

        # --- Poisson operator for the new density ---
        with span("pressure.operator"):
            prob, pack = poisson.build_operator(
                ga, spacing, rho_new, ga["top_open"] if open_top else None,
                use_pallas=use_k, spmd=spmd)
        K = max(int(controls.precond_refresh), 1)
        if (carry_precond and precond is not None and K > 1
                and state.step.dim() > 0):
            # The JAX step selects per case under vmap; the sweep entry
            # points carry no bundle, so nothing here needs that.
            raise NotImplementedError(
                "a carried preconditioner with precond_refresh > 1 on a "
                "batched state is not ported (sweeps rebuild it every step)")
        if (carry_precond and precond is not None and K > 1
                and host_read(state.step, "timestep.precond_refresh") % K):
            bundle = precond   # host read of step only when K > 1
        else:
            with span("pressure.bundle"):
                bundle = make_bundle(pack)
        prob = poisson.attach_precond(prob, bundle, knobs, spmd=spmd)
        beta_f = prob.beta_faces

        # --- explicit conservative momentum (no pressure) ---
        with span("momentum"):
            t_mid = state.t + 0.5 * dt
            if forcing is None:
                G = effective_g(t_mid, params)
            elif ranks is None:
                G = forcing(t_mid, params)
            else:
                G = block_forcing(forcing(t_mid, params), ranks,
                                  *state.alpha.shape[:2])
            kappa = None
            if props.sigma != 0.0:
                kappa = mom.curvature(alpha_new, spacing, vfrac=ga["vfrac"],
                                      method=controls.csf_curvature)
            vels = (state.u, state.v, state.w)
            frame = None
            if rot_enabled:
                # Centrifugal + Euler + Coriolis sources of the rotating tank
                # frame, explicit in the old velocity.
                omega_b, domega_b = fr.angular_rates(motion, t_mid)
                frame = [fr.rotational_acceleration(
                    ax, face_xyz[ax], omega_b, domega_b,
                    *(interp_to_faces(vels[q], q, ax) for q in range(3)))
                    for ax in range(3)]
            apertures = (ga["ax"], ga["ay"], ga["az"])
            div_u = (st.divergence(*phi, spacing) if controls.dev2_stress
                     else None)
            if use_mom_k and spmd is not None:
                vcs = _sm.momentum_rhs(*vels, rho_phi, mu, div_u, spacing,
                                       spmd, dev2=bool(controls.dev2_stress))
            elif use_mom_k:
                # visc + dev2 − conv of all three components in one kernel.
                vcs = _mrk.momentum_rhs(*vels, rho_phi, mu, div_u, spacing,
                                        dev2=bool(controls.dev2_stress))
            else:
                vcs = mom.explicit_rhs(vels, rho_phi, mu, div_u, spacing,
                                       dev2=controls.dev2_stress)
            # The finish kernel takes one uniform (3,) G: a forcing component
            # that is not 0-d keeps it off (a Python number counts as 0-d).
            if use_finish_k and all(getattr(g, "dim", lambda: 0)() == 0
                                    for g in G):
                # The kernel takes au cell-shaped (a contiguous view) and
                # writes u's zero face-nx row itself.
                u_c, v_c, w_c = _mfk.momentum_finish(
                    *vels, (vcs[0][:-1], vcs[1], vcs[2]), rho_old, rho_new,
                    *apertures, dt,
                    G if isinstance(G, torch.Tensor) else torch.stack(
                        [torch.as_tensor(g, dtype=fdt, device=dev)
                         for g in G]))
            else:
                # CSF: global plain tensors, sharded step or not, as in JAX.
                csf = (None if kappa is None else
                       [mom.csf_force(alpha_new, kappa, props.sigma, ax,
                                      spacing[ax], beta_f[ax])
                        for ax in range(3)])
                u_c, v_c, w_c = mom.explicit_update(
                    vels, vcs, rho_old, rho_new, apertures, dt, G, frame, csf)

        # --- projection (PIMPLE corrector loop) ---
        p_new = state.p
        n_corr = max(int(controls.n_correctors), 1)
        div_err = None
        for corr in range(n_corr):
            with span("pressure.solve"):
                div_star = st.divergence(ga["ax"] * u_c, ga["ay"] * v_c,
                                         ga["az"] * w_c, spacing)
                b = torch.where(fluid, -div_star / dt, 0.0)
                dp, p_res, p_iters = poisson.solve_pcg(
                    prob, b, p_new if corr == 0 else torch.zeros_like(p_new),
                    tol_rel=controls.p_tol_rel, tol_abs=controls.p_tol_abs,
                    tol_rel_b=controls.p_tol_rel_b,
                    max_iters=controls.p_max_iters)
                p_new = dp if corr == 0 else p_new + dp

            # velocity correction: exactly the operator's gradient; the
            # last corrector's, with the divergence error, in one kernel
            corr_args = (dp, u_c, v_c, w_c, beta_f, *apertures)
            with span("correction"):
                if use_corr_k and corr == n_corr - 1 and spmd is not None:
                    u_c, v_c, w_c, div_err = _sm.correct_divmax(
                        *corr_args, ga["vfrac"], ga["top_open"], rho_new, dt,
                        spacing, spmd, open_top=open_top)
                elif use_corr_k and corr == n_corr - 1:
                    u_c, v_c, w_c, div_err = _ck.correct_divmax(
                        *corr_args, ga["vfrac"], ga["top_open"], rho_new, dt,
                        spacing, open_top=open_top)
                else:
                    u_c, v_c, w_c = _ck.correct_velocities_plain(
                        *corr_args, ga["top_open"], rho_new, dt, spacing,
                        open_top=open_top)

        if div_err is None:
            with span("correction"):
                div_err = _ck.div_max_plain(u_c, v_c, w_c, *apertures,
                                            ga["vfrac"], spacing)
        with span("step.diagnostics"):
            # state.dt carries the UNCLIPPED CFL dt as the next growth base.
            new_state = SimState(alpha=alpha_new, u=u_c, v=v_c, w=w_c,
                                 p=p_new, t=t_new, dt=dt_cfl,
                                 step=state.step + 1)
            rescale = dt / torch.clamp(state.dt, min=1e-30)
            diag = StepDiagnostics(
                courant=co * rescale, alpha_courant=co_a * rescale,
                p_residual=p_res, p_iters=p_iters, div_error=div_err,
                alpha_min=st.min_cells(torch.where(fluid, alpha_new, 0.0)),
                alpha_max=st.max_cells(alpha_new))
        if carry_precond:
            return new_state, diag, bundle
        return new_state, diag

    def init_precond(state, ga, spacing):
        """The first bundle of a time loop's carry."""
        rho = mixture_density(state.alpha, props)
        with slabs(state):
            _, pack = poisson.build_operator(
                ga, spacing, rho, ga["top_open"] if open_top else None,
                use_pallas=use_k, spmd=spmd)
            return make_bundle(pack)

    step.cfl_dt = cfl_dt
    if carry_precond:
        step.init_precond = init_precond
    return step


def make_step(geom: TankGeometry,
              props: PhysicalProperties = PhysicalProperties(),
              controls: SolverControls = SolverControls(), motion=None,
              dtype=torch.float32, carry_precond: bool = False, spmd=None,
              device="cuda"):
    """The step function for a fixed geometry (uploaded once to `device`).

    `carry_precond=True`: `step(state, params, t_stop=None, precond=None)
    -> (state', diag, precond')`, and `step.init_precond(state)` builds
    the first bundle of a time loop's carry. `spmd=SpmdCtx(n)`: the
    x-sharded step (the grid's nx must divide into n slabs of at least two
    planes); `SpmdCtx(n, ranks=ctx)`: this rank's part of it, on the
    rank's slab of the geometry (an even number of planes: the multigrid's
    2:1 pairs start within the rank); `SpmdCtx(n, m, ranks=ctx)`: the
    same on x·y blocks (ny into m even rows of blocks of at least two).
    `motion` (a TableMotion on `device`): the 6DoF tank's table-driven
    forcing; the face coordinates of its rotating frame are built here
    (under ranks, the rank's x and y parts of them)."""
    _check_slice(controls, spmd=spmd)
    ranks = None
    if spmd is not None:
        nxl, nyl = spmd.local_shape(geom.shape)[:2]
        ranks = spmd.ranks
        if ranks is not None and nxl % 2:
            raise ValueError(f"x-slabs of {nxl} planes over ranks: the "
                             "rank form takes an even number")
        if ranks is not None and spmd.y_shards > 1 and nyl % 2:
            raise ValueError(f"y-blocks of nyl = {nyl} rows over ranks: the "
                             "rank form takes an even number")
    ga = geometry_arrays(geom, dtype, device=device, ranks=ranks)
    spacing = tuple(float(s) for s in geom.spacing)
    open_top = bool(np.any(geom.top_open > 0))
    face_xyz = (tuple(fr.face_coordinates(geom, ax, device, ranks=ranks)
                      for ax in range(3))
                if motion is not None and motion.has_rotation else None)
    core = make_step_core(props, controls, motion=motion, open_top=open_top,
                          face_xyz=face_xyz, carry_precond=carry_precond,
                          sealed_x=bool(np.all(geom.ax[-1] == 0.0)),
                          spmd=spmd)

    if carry_precond:
        def step(state, params, t_stop=None, precond=None):
            return core(state, params, ga, spacing, t_stop=t_stop,
                        precond=precond)

        step.init_precond = lambda state: core.init_precond(state, ga, spacing)
        step.ranks = ranks
        return step

    def step(state, params, t_stop=None):
        return core(state, params, ga, spacing, t_stop=t_stop)

    step.ranks = ranks
    return step


def make_step_ga(spacing, props: PhysicalProperties = PhysicalProperties(),
                 controls: SolverControls = SolverControls(), motion=None,
                 open_top: bool = True, face_xyz=None,
                 carry_precond: bool = False, sealed_x: bool = True,
                 spmd=None, device="cuda"):
    """Geometry-as-operands step: `step(state, params, ga, ...)` with `ga`
    from `geometry_arrays(geom, device=...)`. `device` is checked here so
    a CUDA request on a machine without a card fails at build time.
    `spmd` as in `make_step`; `motion` as there, with the caller's
    `face_xyz` (frame.face_coordinates per axis) when it rotates."""
    resolve_device(device)
    spacing = tuple(float(s) for s in spacing)
    core = make_step_core(props, controls, motion=motion, open_top=open_top,
                          face_xyz=face_xyz, carry_precond=carry_precond,
                          sealed_x=sealed_x, spmd=spmd)

    if carry_precond:
        def step(state, params, ga, t_stop=None, precond=None):
            return core(state, params, ga, spacing, t_stop=t_stop,
                        precond=precond)

        step.init_precond = lambda state, ga: core.init_precond(state, ga,
                                                                spacing)
        step.takes_ga = True
        return step

    def step(state, params, ga, t_stop=None):
        return core(state, params, ga, spacing, t_stop=t_stop)

    step.takes_ga = True
    return step


def make_multi_step(step_fn, n_inner: int):
    """`n_inner` steps in a loop; returns (final state, last diagnostics)."""

    def multi(state, params):
        diag = None
        for _ in range(n_inner):
            state, diag = step_fn(state, params)
        return state, diag

    return multi
