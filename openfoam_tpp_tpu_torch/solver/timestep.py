"""The VoF time step — port of openfoam_tpp_tpu/solver/timestep.py:

    per Δt: adapt dt from Co/alphaCo → α sub-cycles (MULES ×3) →
    explicit momentum (van Leer convection with rhoPhi, viscous, dev2) →
    uniform effective-gravity forcing G(t) = g − a_frame(t) →
    pressure projection (MG-preconditioned CG) → velocity correction.

`make_step(geom, props, controls, device=...)` returns
`step(state, params) -> (state', diag)`. PyTorch runs eagerly, so there
is nothing to compile; `t` and `dt` stay 0-d device tensors and the dt
logic never reads them on the host. The CG loop syncs once per
iteration (solver/poisson.py).

Ported configuration: the analytic orbital motion on one device, with
every `SolverControls` the JAX step takes there. With `use_pallas` the
step runs the fused kernels behind the JAX step's gates, read when the
step is built: the momentum right-hand side (`OFTPP_MOM_PALLAS`), the
projection epilogue on the last corrector (`OFTPP_CORR_PALLAS`) and,
opt-in, the momentum finish (`OFTPP_FINISH_PALLAS=1`). The gates alone
decide: the kernels take any 3-D f32 grid (the JAX kernels' slab and
VMEM shape checks are TPU limits), and a non-f32 operand raises. The
arguments of the JAX step outside this slice raise NotImplementedError.
"""

from __future__ import annotations

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
from openfoam_tpp_tpu_torch.solver import momentum as mom
from openfoam_tpp_tpu_torch.solver import poisson


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
    """Per-step scalars (0-d device tensors)."""

    courant: torch.Tensor
    alpha_courant: torch.Tensor
    p_residual: torch.Tensor
    p_iters: torch.Tensor
    div_error: torch.Tensor
    alpha_min: torch.Tensor
    alpha_max: torch.Tensor


def geometry_arrays(geom: TankGeometry, dtype=torch.float32, device="cuda"):
    """Upload the static geometry to device tensors once."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    return {"vfrac": as_t(geom.vfrac), "ax": as_t(geom.ax),
            "ay": as_t(geom.ay), "az": as_t(geom.az),
            "top_open": as_t(geom.top_open)}


def _check_slice(props, controls, motion=None, spmd=None, sync_axis=None,
                 forcing=None, face_xyz=None):
    """Raise for every argument of the JAX step this port does not cover."""
    for name, val in (("motion", motion), ("spmd", spmd),
                      ("sync_axis", sync_axis), ("forcing", forcing),
                      ("face_xyz", face_xyz)):
        if val is not None:
            raise NotImplementedError(
                f"{name}= is not ported yet (analytic orbital motion on "
                f"one device only)")
    if controls.batch_lanes:
        raise NotImplementedError("batch_lanes (vmapped sweeps) is not "
                                  "ported yet")
    if props.sigma != 0.0:
        raise NotImplementedError("surface tension (sigma != 0, CSF) is "
                                  "not ported yet")


def make_step_core(props: PhysicalProperties = PhysicalProperties(),
                   controls: SolverControls = SolverControls(),
                   motion=None, open_top: bool = True, face_xyz=None,
                   forcing=None, sync_axis=None, carry_precond: bool = False,
                   sealed_x: bool = True, spmd=None):
    """Build `step(state, params, ga, spacing, t_stop=None, precond=None)`.

    With `carry_precond` the step also takes and returns the bf16
    preconditioner bundle (poisson.make_bundle), rebuilt every
    `controls.precond_refresh` steps; the operator is fresh every step.

    The fused kernels write zeros for u's face-nx row, so they run only
    with `sealed_x` (the last x-aperture plane is all zero, true of every
    shipped geometry); an env force of one of them on an unsealed
    geometry raises ValueError, as in the JAX step."""
    _check_slice(props, controls, motion=motion, spmd=spmd,
                 sync_axis=sync_axis, forcing=forcing, face_xyz=face_xyz)
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
    fct_bf16 = _fct_bf16_enabled(controls)
    use_mom_k = sealed_x and _mom_pallas_enabled(controls)
    use_finish_k = use_mom_k and _finish_pallas_enabled(controls)
    use_corr_k = sealed_x and _corr_pallas_enabled(controls)

    def courant_numbers(u, v, w, alpha, dt, fluid, spacing):
        hx, hy, hz = spacing
        speed = (torch.abs(st.faces_to_cells_avg(u, 0)) / hx
                 + torch.abs(st.faces_to_cells_avg(v, 1)) / hy
                 + torch.abs(st.faces_to_cells_avg(w, 2)) / hz)
        co = dt * torch.where(fluid, speed, 0.0).max()
        near_if = (alpha > 0.01) & (alpha < 0.99)
        co_a = dt * torch.where(fluid & near_if, speed, 0.0).max()
        return co, co_a * (1.0 + controls.c_alpha)

    def step(state: SimState, params, ga, spacing, t_stop=None,
             precond=None):
        hx, hy, hz = spacing
        fdt = state.dt.dtype
        dev = state.dt.device
        fluid = ga["vfrac"] > 0.0
        # --- adaptive dt (adjustTimeStep), all on the device ---
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
            dt_cfl = torch.clamp(dt_cfl,
                                 max=controls.max_diff_co / (nu_max * inv_h2))
        # --- adjustableRunTime: land exactly on the write grid / t_stop ---
        w = float(controls.write_interval)
        if w > 0.0:
            wj = torch.tensor(w, dtype=fdt, device=dev)
            k_next = torch.floor(state.t / wj + 1e-4) + 1.0
            t_next = k_next * wj
        else:
            t_next = torch.tensor(float("inf"), dtype=fdt, device=dev)
        if t_stop is not None:
            t_next = torch.minimum(t_next, torch.as_tensor(
                t_stop, dtype=fdt, device=dev))
        rem = torch.clamp(t_next - state.t, min=1e-12)
        finite = torch.isfinite(rem)
        n_split = torch.clamp(torch.ceil(rem / dt_cfl - 1e-4), min=1.0)
        dt = torch.where(finite, rem / n_split, dt_cfl)
        t_new = torch.where(finite & (n_split <= 1.0), t_next, state.t + dt)

        # --- alpha advection with the divergence-free flux of step n ---
        phi = (ga["ax"] * state.u, ga["ay"] * state.v, ga["az"] * state.w)
        alpha_new, rho_phi, _ = mules.advect_alpha(
            state.alpha, phi, ga, spacing, dt, props.rho1, props.rho2,
            c_alpha=controls.c_alpha,
            n_subcycles=controls.n_alpha_subcycles,
            n_limiter_iters=controls.n_limiter_iters,
            use_pallas=use_k, fct_bf16=fct_bf16)

        rho_old = mixture_density(state.alpha, props)
        rho_new = mixture_density(alpha_new, props)
        mu = mixture_viscosity(alpha_new, props)

        # --- Poisson operator for the new density ---
        prob, pack = poisson.build_operator(
            ga, spacing, rho_new, ga["top_open"] if open_top else None,
            use_pallas=use_k)
        K = max(int(controls.precond_refresh), 1)
        if (carry_precond and precond is not None and K > 1
                and int(state.step) % K != 0):
            bundle = precond   # host read of step only when K > 1
        else:
            bundle = poisson.make_bundle(pack, use_pallas=use_k)
        prob = poisson.attach_precond(prob, bundle)
        beta_f = prob.beta_faces

        # --- explicit conservative momentum (no pressure) ---
        t_mid = state.t + 0.5 * dt
        G = mo.effective_gravity(t_mid, params, props.g)
        vels = (state.u, state.v, state.w)
        apertures = (ga["ax"], ga["ay"], ga["az"])
        div_u = st.divergence(*phi, spacing) if controls.dev2_stress else None
        if use_mom_k:
            # visc + dev2 − conv of all three components in one kernel.
            vcs = _mrk.momentum_rhs(*vels, rho_phi, mu, div_u, spacing,
                                    dev2=bool(controls.dev2_stress))
        else:
            vcs = mom.explicit_rhs(vels, rho_phi, mu, div_u, spacing,
                                   dev2=controls.dev2_stress)
        if use_finish_k:
            # The kernel takes au cell-shaped (a contiguous view) and
            # writes u's zero face-nx row itself.
            u_c, v_c, w_c = _mfk.momentum_finish(
                *vels, (vcs[0][:-1], vcs[1], vcs[2]), rho_old, rho_new,
                *apertures, dt, G)
        else:
            u_c, v_c, w_c = mom.explicit_update(vels, vcs, rho_old, rho_new,
                                                apertures, dt, G)

        # --- projection (PIMPLE corrector loop) ---
        p_new = state.p
        n_corr = max(int(controls.n_correctors), 1)
        div_err = None
        for corr in range(n_corr):
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
            if use_corr_k and corr == n_corr - 1:
                u_c, v_c, w_c, div_err = _ck.correct_divmax(
                    *corr_args, ga["vfrac"], ga["top_open"], rho_new, dt,
                    spacing, open_top=open_top)
            else:
                u_c, v_c, w_c = _ck.correct_velocities_plain(
                    *corr_args, ga["top_open"], rho_new, dt, spacing,
                    open_top=open_top)

        if div_err is None:
            div_err = _ck.div_max_plain(u_c, v_c, w_c, *apertures,
                                        ga["vfrac"], spacing)
        # state.dt carries the UNCLIPPED CFL dt as the next growth base.
        new_state = SimState(alpha=alpha_new, u=u_c, v=v_c, w=w_c, p=p_new,
                             t=t_new, dt=dt_cfl, step=state.step + 1)
        rescale = dt / torch.clamp(state.dt, min=1e-30)
        diag = StepDiagnostics(
            courant=co * rescale, alpha_courant=co_a * rescale,
            p_residual=p_res, p_iters=p_iters, div_error=div_err,
            alpha_min=torch.where(fluid, alpha_new, 0.0).min(),
            alpha_max=alpha_new.max())
        if carry_precond:
            return new_state, diag, bundle
        return new_state, diag

    return step


def make_step(geom: TankGeometry,
              props: PhysicalProperties = PhysicalProperties(),
              controls: SolverControls = SolverControls(), motion=None,
              dtype=torch.float32, carry_precond: bool = False, spmd=None,
              device="cuda"):
    """The step function for a fixed geometry (uploaded once to `device`).

    `carry_precond=True`: `step(state, params, t_stop=None, precond=None)
    -> (state', diag, precond')`, and `step.init_precond(state)` builds
    the first bundle of a time loop's carry."""
    _check_slice(props, controls, motion=motion, spmd=spmd)
    ga = geometry_arrays(geom, dtype, device=device)
    spacing = tuple(float(s) for s in geom.spacing)
    open_top = bool(np.any(geom.top_open > 0))
    core = make_step_core(props, controls, open_top=open_top,
                          carry_precond=carry_precond,
                          sealed_x=bool(np.all(geom.ax[-1] == 0.0)))

    if carry_precond:
        def step(state, params, t_stop=None, precond=None):
            return core(state, params, ga, spacing, t_stop=t_stop,
                        precond=precond)

        def init_precond(state):
            rho = mixture_density(state.alpha, props)
            _, pack = poisson.build_operator(
                ga, spacing, rho, ga["top_open"] if open_top else None,
                use_pallas=controls.use_pallas)
            return poisson.make_bundle(pack, use_pallas=controls.use_pallas)

        step.init_precond = init_precond
        return step

    def step(state, params, t_stop=None):
        return core(state, params, ga, spacing, t_stop=t_stop)

    return step


def make_step_ga(spacing, props: PhysicalProperties = PhysicalProperties(),
                 controls: SolverControls = SolverControls(), motion=None,
                 open_top: bool = True, face_xyz=None,
                 carry_precond: bool = False, sealed_x: bool = True,
                 device="cuda"):
    """Geometry-as-operands step: `step(state, params, ga, ...)` with `ga`
    from `geometry_arrays(geom, device=...)`. `device` is checked here so
    a CUDA request on a machine without a card fails at build time."""
    resolve_device(device)
    spacing = tuple(float(s) for s in spacing)
    core = make_step_core(props, controls, motion=motion, open_top=open_top,
                          face_xyz=face_xyz, carry_precond=carry_precond,
                          sealed_x=sealed_x)

    if carry_precond:
        def step(state, params, ga, t_stop=None, precond=None):
            return core(state, params, ga, spacing, t_stop=t_stop,
                        precond=precond)

        def init_precond(state, ga):
            rho = mixture_density(state.alpha, props)
            _, pack = poisson.build_operator(
                ga, spacing, rho, ga["top_open"] if open_top else None,
                use_pallas=controls.use_pallas)
            return poisson.make_bundle(pack, use_pallas=controls.use_pallas)

        step.init_precond = init_precond
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
