"""Analytic orbital tank motion → tank-frame forcing, on the device.

Port of the analytic part of openfoam_tpp_tpu/core/motion.py. The solver
works in the tank frame: pure translation is a uniform body force
−a_frame(t) folded with gravity into G(t) = g − a_frame(t). The orbit is
x = r(t) cos ωt, y = r(t) sin ωt with r soft-started by smootherstep over
the ramp time. Table-driven 6DoF motion is not ported yet.
"""

from __future__ import annotations

import torch


def smootherstep(tau):
    """6τ⁵ − 15τ⁴ + 10τ³, clamped to [0, 1]."""
    tau = torch.clamp(tau, 0.0, 1.0)
    return tau * tau * tau * (tau * (tau * 6.0 - 15.0) + 10.0)


def _smootherstep_d1(tau):
    tau = torch.clamp(tau, 0.0, 1.0)
    return 30.0 * tau * tau * (tau - 1.0) * (tau - 1.0)


def _smootherstep_d2(tau):
    tau = torch.clamp(tau, 0.0, 1.0)
    return 60.0 * tau * (2.0 * tau - 1.0) * (tau - 1.0)


def orbital_position(t, params):
    """Tank-origin position in the lab frame (x, y, z)."""
    tau = t / torch.clamp(params.ramp_time, min=1e-30)
    r = params.orbit_radius * smootherstep(tau)
    th = params.omega * t
    return torch.stack([r * torch.cos(th), r * torch.sin(th),
                        torch.zeros_like(r)])


def orbital_acceleration(t, params):
    """Analytic d²/dt² of the ramped orbit:
    x'' = (r'' − rω²)cosθ − 2 r'ω sinθ, and symmetrically for y."""
    Tr = torch.clamp(params.ramp_time, min=1e-30)
    tau = t / Tr
    R, om = params.orbit_radius, params.omega
    r = R * smootherstep(tau)
    r1 = R * _smootherstep_d1(tau) / Tr
    r2 = R * _smootherstep_d2(tau) / (Tr * Tr)
    th = om * t
    c, s = torch.cos(th), torch.sin(th)
    radial = r2 - r * om * om
    ax = radial * c - 2.0 * r1 * om * s
    ay = radial * s + 2.0 * r1 * om * c
    return torch.stack([ax, ay, torch.zeros_like(ax)])


def effective_gravity(t, params, g: float = 9.81):
    """G(t) = −g ẑ − a_frame(t): uniform body acceleration in the tank
    frame, shape (3,)."""
    a = orbital_acceleration(t, params)
    g_vec = torch.zeros_like(a)
    g_vec[2] = -g
    return g_vec - a
