"""Axis-generic stencil primitives on the MAC grid (port of
openfoam_tpp_tpu/ops/stencil.py).

Cell arrays are (nx, ny, nz); a face array along `axis` has that axis
extended by one. Boundary convention: edge-clamped ghost cells. Wall
faces carry zero aperture, so clamped ghosts only influence
reconstruction order near boundaries, never fluxes through walls. Every
kernel's agreement with its plain version rests on these clamps.

Every function indexes dims 0–2 only, so arrays may carry a trailing case
axis, (nx, ny, nz, B) (parameter sweeps): it passes through untouched.
`sum_cells`, `max_cells` and `min_cells` reduce over the cells alone.
"""

from __future__ import annotations

import torch


def _sl(axis, s):
    """Build an nd slice tuple indexing `s` along `axis`."""
    out = [slice(None)] * 3
    out[axis] = s
    return tuple(out)


def sum_cells(t):
    """Sum over the cells: everything on a single grid, dims (0, 1, 2) —
    one value per case — on a batched (nx, ny, nz, B) one."""
    return t.sum() if t.dim() == 3 else t.sum(dim=(0, 1, 2))


def max_cells(t):
    return t.max() if t.dim() == 3 else t.amax(dim=(0, 1, 2))


def min_cells(t):
    return t.min() if t.dim() == 3 else t.amin(dim=(0, 1, 2))


def shift_down(a, axis):
    """result[i] = a[i-1], edge-clamped at i=0."""
    return torch.cat([a[_sl(axis, slice(0, 1))], a[_sl(axis, slice(0, -1))]],
                     dim=axis)


def shift_up(a, axis):
    """result[i] = a[i+1], edge-clamped at i=n-1."""
    return torch.cat([a[_sl(axis, slice(1, None))], a[_sl(axis, slice(-1, None))]],
                     dim=axis)


def cells_to_faces_avg(c, axis):
    """Arithmetic face interpolation; boundary faces take the edge cell."""
    lo = c[_sl(axis, slice(0, 1))]
    hi = c[_sl(axis, slice(-1, None))]
    mid = 0.5 * (c[_sl(axis, slice(0, -1))] + c[_sl(axis, slice(1, None))])
    return torch.cat([lo, mid, hi], dim=axis)


def cells_to_faces_harmonic(c, axis, eps=1e-30):
    """Harmonic face interpolation."""
    a = c[_sl(axis, slice(0, -1))]
    b = c[_sl(axis, slice(1, None))]
    mid = 2.0 * a * b / (a + b + eps)
    lo = c[_sl(axis, slice(0, 1))]
    hi = c[_sl(axis, slice(-1, None))]
    return torch.cat([lo, mid, hi], dim=axis)


def gradient_at_faces(c, axis, h):
    """(c[i] - c[i-1]) / h at interior faces, 0 at domain-boundary faces."""
    d = (c[_sl(axis, slice(1, None))] - c[_sl(axis, slice(0, -1))]) / h
    zshape = list(d.shape)
    zshape[axis] = 1
    z = torch.zeros(zshape, dtype=d.dtype, device=d.device)
    return torch.cat([z, d, z], dim=axis)


def faces_to_cells_avg(f, axis):
    """Average the two bracketing faces back to cells."""
    return 0.5 * (f[_sl(axis, slice(0, -1))] + f[_sl(axis, slice(1, None))])


def face_lr(c, axis):
    """Cell values seen from each face: (left/donor-below, right/donor-above),
    both face-shaped along `axis`; boundary faces clamp."""
    cl = torch.cat([c[_sl(axis, slice(0, 1))], c], dim=axis)
    cr = torch.cat([c, c[_sl(axis, slice(-1, None))]], dim=axis)
    return cl, cr


def upwind_faces(c, flux, axis):
    """First-order donor-cell face value by flux sign."""
    cl, cr = face_lr(c, axis)
    return torch.where(flux >= 0.0, cl, cr)


def divergence(fx, fy, fz, spacing):
    """Cell divergence of aperture-weighted face fluxes (per full cell
    volume): Σ_axis (f_hi − f_lo)/h_axis."""
    hx, hy, hz = spacing
    return (
        (fx[1:, :, :] - fx[:-1, :, :]) / hx
        + (fy[:, 1:, :] - fy[:, :-1, :]) / hy
        + (fz[:, :, 1:] - fz[:, :, :-1]) / hz
    )


def vanleer_limited(delta_up, delta_down, eps=1e-30):
    """van Leer limiter φ(r)·Δdown, r = Δup/Δdown."""
    signed_eps = torch.where(delta_down >= 0, eps, -eps).to(delta_down.dtype)
    safe = torch.where(delta_down.abs() > eps, delta_down, signed_eps)
    r = delta_up / safe
    phi = (r + r.abs()) / (1.0 + r.abs())
    return phi * delta_down


def vanleer_faces(c, flux, axis):
    """Second-order MUSCL face reconstruction with the van Leer limiter,
    upwinded by flux sign: c_f = c_d + 0.5·φ(r)·(c_a − c_d)."""
    dm = c - shift_down(c, axis)
    dp = shift_up(c, axis) - c
    up_plus = c + 0.5 * vanleer_limited(dm, dp)
    up_minus = c - 0.5 * vanleer_limited(dp, dm)
    fl, _ = face_lr(up_plus, axis)
    _, fr = face_lr(up_minus, axis)
    return torch.where(flux >= 0.0, fl, fr)


def max27(a):
    """Max over the 3x3x3 neighbourhood (edge-clamped)."""
    for ax in range(3):
        a = torch.maximum(a, torch.maximum(shift_down(a, ax), shift_up(a, ax)))
    return a


def min27(a):
    for ax in range(3):
        a = torch.minimum(a, torch.minimum(shift_down(a, ax), shift_up(a, ax)))
    return a
