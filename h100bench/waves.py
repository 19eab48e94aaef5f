"""The benchmark's inputs: a developed sloshing wave made from the seed.

One general generator for every cell. It reads the configuration (the
tank and its forcing cases) and the traffic file (the wave model, the
amplitude cap, the fill depth) and builds, for each case, the forced
linear potential-flow response of the first m = 1 mode of an orbitally
shaken cylinder at the starting time t0 = ramp + (phase0 + k pi/2) / w,
the quarter turn k in {0, 1, 2, 3} drawn from the seed for each case
(every seed poses the same wave, turned by a multiple of 90 degrees):

  * wall amplitude A = 2 a F (1 + sum_n [(eps_n^2 - 1)(w_n^2/w^2 - 1)]^-1)
    with F = a w^2 / g, the reference's Bessel-root table (five zeros of
    J1' then (n + 1.25) pi), 30 modes, and |A| capped at
    `amplitude_cap_of_radius` times the tank radius near resonance;
  * free surface zeta = A cos(w t0 - theta) J1(eps_1 r / R) / J1(eps_1);
  * velocity potential of the water, -(A w / (lam tanh(lam d)))
    cosh(lam z) / cosh(lam d) sin(w t0 - theta) J1(lam r) / J1(eps_1),
    and of the air under the lid, the mirror image that decays from the
    surface to z = H; the face velocities are its gradient, zero outside
    the cylinder;
  * alpha the water fraction of each cell under the surface, the
    hydrostatic pressure of that surface, and dt the step that the
    Courant and diffusion limits of the solver's controls (the
    reference's `CONTROLS`, `NU1`, `NU2`) allow in that state.

Everything is computed in float64 on the target device and handed over
in float32; the seed draws only each case's quarter turn (numpy's PCG64).
The formulas are those of the port's utils/potential_flow.py, copied
here so that the inputs depend on nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h100bench.reference import step as rstep
from h100bench.reference.geometry import natural_shape

GRAVITY = 9.81
RHO1, RHO2 = 998.2, 1.0
_J1P_ZEROS = (1.8412, 5.3314, 8.5363, 11.7060, 14.8636)


def j1prime_zeros(n_modes: int) -> np.ndarray:
    eps = np.empty(n_modes)
    k = min(n_modes, len(_J1P_ZEROS))
    eps[:k] = _J1P_ZEROS[:k]
    for n in range(k, n_modes):
        eps[n] = (n + 1.25) * np.pi
    return eps


def wall_amplitude(R_tank, a, omega, d, n_modes=30, resonance_tol=1e-6):
    """Linear-theory wall amplitude A_PT of an orbit of radius `a` at
    angular frequency `omega`, liquid depth `d` (reference formula)."""
    froude = a * omega * omega / GRAVITY
    eps = j1prime_zeros(n_modes)
    lam = eps / R_tank
    omega_n = np.sqrt(GRAVITY * lam * np.tanh(lam * d))
    ratio_sq = (omega_n / omega) ** 2
    denom = (eps ** 2 - 1.0) * (ratio_sq - 1.0)
    keep = np.abs(ratio_sq - 1.0) >= resonance_tol
    series = np.sum(np.where(keep, 1.0 / np.where(keep, denom, 1.0), 0.0))
    return 2.0 * R_tank * froude * (1.0 + series)


def grid_of(tank: dict):
    """(shape, spacing, origin) of the port's grid for the tank (a
    configuration's H, D, mesh, geo, round_to): the cylinder's grid of
    `natural_shape`, centred in x and y, z from the bottom."""
    H, D, h = tank["H"], tank["D"], float(tank["mesh"])
    nx, ny, nz = natural_shape(H, D, h, tank["geo"],
                               round_to=int(tank["round_to"]))
    z_min = -D / 2.0 if tank["geo"] == "cap" else 0.0
    return (nx, ny, nz), (h, h, (H - z_min) / nz), (-nx * h / 2.0,
                                                    -ny * h / 2.0, z_min)


def case_rows(config: dict) -> list[dict]:
    """Every forcing case of the configuration: its own (R, freq,
    duration, ramp), or the Cartesian product of its `study` ranges (the
    reference manager's `parse_range`: start, step, count), frequency
    slowest."""
    if "study" not in config:
        return [{k: config[k] for k in ("R", "freq", "duration", "ramp")}]
    s = config["study"]
    f0, fstep, nf = s["freq"]
    r0, rstep, nr = s["R"]
    return [{"R": round(r0 + j * rstep, 12), "freq": round(f0 + i * fstep, 12),
             "duration": s["duration"], "ramp": s.get("ramp", -1.0)}
            for i in range(int(nf)) for j in range(int(nr))]


def _phases(rows, omega, seed, phase0):
    """t0 of each case: its ramp, then the orbit phase `phase0` plus a
    quarter turn k*pi/2 with k in {0, 1, 2, 3} drawn from the seed for
    each case. A quarter period later the wave and the forcing are those
    of t0 turned by 90 degrees about the tank's axis, under which the
    square grid and the cylinder are unchanged: every seed poses the same
    cases, each turned by its own multiple of 90 degrees."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    k = rng.integers(0, 4, size=len(rows))
    ramp = np.array([r["duration"] * 0.1 if r.get("ramp", -1.0) < 0
                     else r["ramp"] for r in rows])
    return ramp + (phase0 + k * (np.pi / 2.0)) / omega


def make_inputs(config: dict, traffic: dict, seed: int, device,
                rows: list[dict] | None = None) -> dict:
    """The seeded input: {"state": {alpha, u, v, w, p, t, dt} f32 tensors,
    "forcing": {R, omega, ramp_time} f32 tensors, "rows": the cases}.
    With more than one case every grid array has a trailing case axis and
    the scalars are (B,)."""
    rows = case_rows(config) if rows is None else rows
    shape, spacing, origin = grid_of(config)
    H, R_tank = config["H"], config["D"] / 2.0
    d = H * traffic["fill_of_height"]
    h_air = H - d
    eps1 = _J1P_ZEROS[0]
    lam = eps1 / R_tank
    j1e = float(torch.special.bessel_j1(torch.tensor(eps1,
                                                     dtype=torch.float64)))
    cap = traffic["amplitude_cap_of_radius"] * R_tank
    omega = np.array([np.float32(2.0 * np.pi * r["freq"]) for r in rows],
                     dtype=np.float64)
    t0 = _phases(rows, omega, seed, traffic["phase0_rad"])
    amp = np.array([wall_amplitude(R_tank, r["R"], w, d)
                    for r, w in zip(rows, omega)])
    amp = np.clip(amp, -cap, cap)

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    B = len(rows)
    batched = B > 1
    # per-case scalars broadcast along a trailing case axis
    tail = (lambda a: torch.as_tensor(a, **f64)) if batched else (
        lambda a: torch.as_tensor(a[0], **f64))
    A, W, T0 = tail(amp), tail(omega), tail(t0)
    sw, cw = torch.sin(W * T0), torch.cos(W * T0)
    nx, ny, nz = shape
    hx, hy, hz = spacing
    x0, y0, z0 = origin

    def axis_coords(n, h, o, faces):
        return o + (torch.arange(n + (1 if faces else 0), **f64)
                    + (0.0 if faces else 0.5)) * h

    def plane(faces_axis):
        """(x, y) of the points of a grid with faces along `faces_axis`
        (None: cell centres), shaped (nx', ny', 1[, 1])."""
        x = axis_coords(nx, hx, x0, faces_axis == 0)
        y = axis_coords(ny, hy, y0, faces_axis == 1)
        X, Y = torch.meshgrid(x, y, indexing="ij")
        X, Y = X[:, :, None], Y[:, :, None]
        if batched:
            X, Y = X[..., None], Y[..., None]
        return X, Y

    def bessel_terms(X, Y):
        r2 = X * X + Y * Y
        s = lam * torch.sqrt(r2)
        j1 = torch.special.bessel_j1(s)
        g = torch.where(s < 1e-6, torch.full_like(s, 0.5),
                        j1 / torch.where(s < 1e-6, torch.ones_like(s), s))
        q = (torch.special.bessel_j0(s) - 2.0 * g) / torch.clamp(r2, min=1e-30)
        return r2, g, q

    def surface(X, Y):
        """Surface height above the bottom and the in-cylinder mask."""
        r2, g, _ = bessel_terms(X, Y)
        # J1(s) cos(w t0 - theta) = lam g (cos(w t0) x + sin(w t0) y)
        zeta = A * lam * g * (cw * X + sw * Y) / j1e
        return d + zeta, r2 <= R_tank * R_tank

    def z_of(faces):
        z = axis_coords(nz, hz, z0, faces)
        return z[None, None, :, None] if batched else z[None, None, :]

    kw = A * W / (lam * math.tanh(lam * d)) / j1e
    ka = A * W / (lam * math.tanh(lam * h_air)) / j1e
    ch_w, ch_a = math.cosh(lam * d), math.cosh(lam * h_air)

    def velocity(axis):
        X, Y = plane(axis)
        r2, g, q = bessel_terms(X, Y)
        eta, inside = surface(X, Y)
        z = z_of(axis == 2)
        water = z < eta
        zc = torch.clamp(z, min=0.0, max=H)
        if axis == 2:
            F = lam * g * (sw * X - cw * Y)
            dkw = -kw * lam * torch.sinh(lam * zc) / ch_w
            dka = -ka * lam * torch.sinh(lam * (H - zc)) / ch_a
            vel = torch.where(water, dkw, dka) * F
        else:
            # dF/dx, dF/dy of F = sin(w t0) X' - cos(w t0) Y', with
            # X' = J1(lam r) x / r, Y' = J1(lam r) y / r
            lq = lam * q
            dXx = lam * g + lq * X * X
            dXy = lq * X * Y
            dYy = lam * g + lq * Y * Y
            dF = sw * dXx - cw * dXy if axis == 0 else sw * dXy - cw * dYy
            K = torch.where(water, -kw * torch.cosh(lam * zc) / ch_w,
                            ka * torch.cosh(lam * (H - zc)) / ch_a)
            vel = K * dF
        return torch.where(inside & (z >= 0.0) & (z <= H), vel, 0.0)

    Xc, Yc = plane(None)
    eta, inside = surface(Xc, Yc)
    zc = z_of(False)
    alpha = torch.clamp((eta - (zc - hz / 2.0)) / hz, 0.0, 1.0)
    alpha = torch.where(inside, alpha, 0.0)
    p = torch.where(zc < eta,
                    RHO2 * GRAVITY * (H - eta) + RHO1 * GRAVITY * (eta - zc),
                    RHO2 * GRAVITY * (H - zc))
    p = torch.where(inside, p, 0.0)
    u, v, w = velocity(0), velocity(1), velocity(2)

    speed = (torch.abs(0.5 * (u[1:] + u[:-1])) / hx
             + torch.abs(0.5 * (v[:, 1:] + v[:, :-1])) / hy
             + torch.abs(0.5 * (w[:, :, 1:] + w[:, :, :-1])) / hz)
    red = (lambda t: t.amax(dim=(0, 1, 2))) if batched else (lambda t: t.max())
    vmax = red(torch.where(inside, speed, 0.0))
    band = inside & (alpha > 0.01) & (alpha < 0.99)
    vmax_a = red(torch.where(band, speed, 0.0))
    c = rstep.CONTROLS
    dt = torch.minimum(
        c["max_co"] / torch.clamp(vmax, min=1e-10),
        c["max_alpha_co"] / torch.clamp((1.0 + c["c_alpha"]) * vmax_a,
                                        min=1e-10))
    dt_diff = c["max_diff_co"] / (max(rstep.NU1, rstep.NU2)
                                  * (1.0 / hx ** 2 + 1.0 / hy ** 2
                                     + 1.0 / hz ** 2))
    dt = torch.clamp(dt, max=min(c["max_dt"], dt_diff))

    f32 = lambda t: t.to(torch.float32).contiguous()
    state = {"alpha": f32(alpha.expand(nx, ny, nz, B) if batched else alpha),
             "u": f32(u), "v": f32(v), "w": f32(w),
             "p": f32(p.expand(nx, ny, nz, B) if batched else p),
             "t": f32(T0), "dt": f32(dt)}
    ramp = np.array([r["duration"] * 0.1 if r.get("ramp", -1.0) < 0
                     else r["ramp"] for r in rows])
    forcing = {"R": f32(tail(np.array([r["R"] for r in rows]))),
               "omega": f32(W), "ramp_time": f32(tail(ramp))}
    return {"state": state, "forcing": forcing, "rows": rows}
