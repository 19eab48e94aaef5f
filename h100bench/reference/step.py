"""The VoF time step, plain PyTorch in f32: the reference every cell's
timed step is held against.

A frozen copy of the plain path of the port's solver/timestep.py
`make_step_core` for an open-top cylinder under the analytic orbital
forcing, one sweep, one corrector, no surface tension: adaptive dt from
the Courant numbers, landing on the write grid, MULES alpha advection,
mixture density and viscosity, the explicit momentum with dev2, the MG
pressure solve and the velocity correction. `lockstep=True` is the
port's batch sweep (parallel/sweep.py `make_sweep_step`): every case's
dt growth base is first set to the batch minimum.

The state is a dict of tensors: alpha (nx, ny, nz[, B]), u, v, w on
their face grids, p, and t, dt of shape () or (B,); the forcing is a
dict of R (orbit radius), omega and ramp_time of the same shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import momentum as mom
from h100bench.reference import mules
from h100bench.reference import poisson
from h100bench.reference import stencil as st

RHO1, RHO2 = 998.2, 1.0
NU1, NU2 = 1.0e-6, 1.48e-5
GRAVITY = 9.81

# SolverControls defaults of the configuration (config.py of the port).
CONTROLS = dict(max_co=0.5, max_alpha_co=0.5, max_dt=1.0, dt_growth=1.2,
                n_alpha_subcycles=3, n_limiter_iters=3, c_alpha=1.0,
                p_tol_rel=1e-3, p_tol_abs=1e-8, p_tol_rel_b=3e-4,
                p_max_iters=50, write_interval=0.05, max_diff_co=0.25)


def geometry_arrays(geom, device, batch=None):
    """The geometry's arrays as f32 tensors, repeated `batch` times along
    a trailing case axis when given."""
    out = {}
    for k in ("vfrac", "ax", "ay", "az", "top_open"):
        a = torch.as_tensor(np.ascontiguousarray(getattr(geom, k)),
                            dtype=torch.float32, device=device)
        if batch is not None:
            a = a.unsqueeze(-1).expand(*a.shape, batch).contiguous()
        out[k] = a
    return out


def _smootherstep(tau, d=0):
    tau = torch.clamp(tau, 0.0, 1.0)
    if d == 0:
        return tau * tau * tau * (tau * (tau * 6.0 - 15.0) + 10.0)
    if d == 1:
        return 30.0 * tau * tau * (tau - 1.0) * (tau - 1.0)
    return 60.0 * tau * (2.0 * tau - 1.0) * (tau - 1.0)


def effective_gravity(t, forcing):
    """G(t) = -g z - a_frame(t) of the ramped orbit, shape (3, ...)."""
    Tr = torch.clamp(forcing["ramp_time"], min=1e-30)
    tau = t / Tr
    R, om = forcing["R"], forcing["omega"]
    r = R * _smootherstep(tau)
    r1 = R * _smootherstep(tau, 1) / Tr
    r2 = R * _smootherstep(tau, 2) / (Tr * Tr)
    th = om * t
    c, s = torch.cos(th), torch.sin(th)
    radial = r2 - r * om * om
    a = torch.stack([radial * c - 2.0 * r1 * om * s,
                     radial * s + 2.0 * r1 * om * c, torch.zeros_like(c)])
    g = torch.zeros_like(a)
    g[2] = -GRAVITY
    return g - a


def _courant(state, dt, fluid, spacing):
    hx, hy, hz = spacing
    speed = (torch.abs(st.faces_to_cells_avg(state["u"], 0)) / hx
             + torch.abs(st.faces_to_cells_avg(state["v"], 1)) / hy
             + torch.abs(st.faces_to_cells_avg(state["w"], 2)) / hz)
    co = dt * st.max_cells(torch.where(fluid, speed, 0.0))
    near_if = (state["alpha"] > 0.01) & (state["alpha"] < 0.99)
    co_a = dt * st.max_cells(torch.where(fluid & near_if, speed, 0.0))
    return co, co_a * (1.0 + CONTROLS["c_alpha"])


def cfl_dt(state, fluid, spacing):
    """The adaptive dt (adjustTimeStep) from the Courant numbers at the
    state's dt, the growth limit, and the diffusion limit."""
    c = CONTROLS
    hx, hy, hz = spacing
    co, co_a = _courant(state, state["dt"], fluid, spacing)
    limit = torch.minimum(
        c["max_co"] / torch.clamp(co / state["dt"], min=1e-10),
        c["max_alpha_co"] / torch.clamp(co_a / state["dt"], min=1e-10))
    dt_cfl = torch.clamp(torch.minimum(c["dt_growth"] * state["dt"], limit),
                         max=c["max_dt"])
    inv_h2 = 1.0 / hx ** 2 + 1.0 / hy ** 2 + 1.0 / hz ** 2
    dt_diff = c["max_diff_co"] / (max(NU1, NU2) * inv_h2)
    return torch.clamp(dt_cfl, max=dt_diff)


def step(state, forcing, ga, spacing, lockstep=False):
    """One step: (state', p_iters)."""
    c = CONTROLS
    if lockstep:
        state = dict(state, dt=state["dt"].min().expand_as(state["dt"]).clone())
    fdt, dev = state["dt"].dtype, state["dt"].device
    fluid = ga["vfrac"] > 0.0
    dt_cfl = cfl_dt(state, fluid, spacing)
    t = state["t"]
    wj = torch.tensor(c["write_interval"], dtype=fdt, device=dev)
    t_next = (torch.floor(t / wj + 1e-4) + 1.0) * wj
    rem = torch.clamp(t_next - t, min=1e-12)
    n_split = torch.clamp(torch.ceil(rem / dt_cfl - 1e-4), min=1.0)
    dt = rem / n_split
    t_new = torch.where(n_split <= 1.0, t_next, t + dt)

    ax, ay, az = ga["ax"], ga["ay"], ga["az"]
    u, v, w = state["u"], state["v"], state["w"]
    phi = (ax * u, ay * v, az * w)
    alpha_new, rho_phi = mules.advect_alpha(
        state["alpha"], phi, ga, spacing, dt, RHO1, RHO2,
        c_alpha=c["c_alpha"], n_subcycles=c["n_alpha_subcycles"],
        n_limiter_iters=c["n_limiter_iters"])
    rho_old = state["alpha"] * RHO1 + (1.0 - state["alpha"]) * RHO2
    rho_new = alpha_new * RHO1 + (1.0 - alpha_new) * RHO2
    mu = alpha_new * (RHO1 * NU1) + (1.0 - alpha_new) * (RHO2 * NU2)

    prob = poisson.build(ga, spacing, rho_new, open_top=True)
    G = effective_gravity(t + 0.5 * dt, forcing)
    div_u = st.divergence(*phi, spacing)
    vcs = mom.explicit_rhs((u, v, w), rho_phi, mu, div_u, spacing, dev2=True)
    u_c, v_c, w_c = mom.explicit_update((u, v, w), vcs, rho_old, rho_new,
                                        (ax, ay, az), dt, G)

    div_star = st.divergence(ax * u_c, ay * v_c, az * w_c, spacing)
    b = torch.where(fluid, -div_star / dt, 0.0)
    dp, p_iters = poisson.solve(prob, b, state["p"], c["p_tol_rel"],
                                c["p_tol_abs"], c["p_tol_rel_b"],
                                c["p_max_iters"])
    hx, hy, hz = spacing
    bx, by, bz = prob.beta_faces
    u_c = u_c - dt * bx * st.gradient_at_faces(dp, 0, hx)
    v_c = v_c - dt * by * st.gradient_at_faces(dp, 1, hy)
    w_c = w_c - dt * bz * st.gradient_at_faces(dp, 2, hz)
    beta_top = torch.where(ga["top_open"] > 0, 1.0 / rho_new[:, :, -1], 0.0)
    w_c[:, :, -1] = w_c[:, :, -1] + dt * beta_top * 2.0 * dp[:, :, -1] / hz
    new = dict(alpha=alpha_new, u=torch.where(ax > 0.0, u_c, 0.0),
               v=torch.where(ay > 0.0, v_c, 0.0),
               w=torch.where(az > 0.0, w_c, 0.0), p=dp, t=t_new, dt=dt_cfl)
    return new, p_iters


def run(state, forcing, ga, spacing, n_steps, lockstep=False, hook=None):
    """`n_steps` steps; returns (state, [p_iters of each step], [dt of each
    step]). `hook(state) -> state` runs after every step (the control's
    rounding)."""
    iters, dts = [], []
    for _ in range(n_steps):
        t0 = state["t"]
        state, it = step(state, forcing, ga, spacing, lockstep=lockstep)
        iters.append(it)
        dts.append(state["t"] - t0)
        if hook is not None:
            state = hook(state)
    return state, iters, dts


def omega_of(freq):
    return 2.0 * math.pi * freq
