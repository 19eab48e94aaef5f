"""Axis-generic stencil primitives on the MAC grid, plain PyTorch.

A frozen copy of the port's ops/stencil.py without its rank blocks: cell
arrays are (nx, ny, nz), a face array along `axis` has that axis longer
by one, ghost cells clamp at the edges. Every function indexes dims 0-2
only, so arrays may carry a trailing case axis (nx, ny, nz, B); the cell
reductions then give one value per case.
"""

from __future__ import annotations

import torch


def sl(axis, s):
    """An nd slice tuple indexing `s` along `axis`."""
    out = [slice(None)] * 3
    out[axis] = s
    return tuple(out)


def sum_cells(t):
    return t.sum() if t.dim() == 3 else t.sum(dim=(0, 1, 2))


def max_cells(t):
    return t.max() if t.dim() == 3 else t.amax(dim=(0, 1, 2))


def min_cells(t):
    return t.min() if t.dim() == 3 else t.amin(dim=(0, 1, 2))


def shift_down(a, axis):
    """result[i] = a[i-1], edge-clamped at i=0."""
    return torch.cat([a[sl(axis, slice(0, 1))], a[sl(axis, slice(0, -1))]],
                     dim=axis)


def shift_up(a, axis):
    """result[i] = a[i+1], edge-clamped at i=n-1."""
    return torch.cat([a[sl(axis, slice(1, None))], a[sl(axis, slice(-1, None))]],
                     dim=axis)


def shift_both(a, axis):
    return shift_down(a, axis), shift_up(a, axis)


def pad_zero(a, axis):
    """One zero plane more at each end of `axis`."""
    z = torch.zeros_like(a.narrow(axis, 0, 1))
    return torch.cat([z, a, z], dim=axis)


def next_plane(a, axis=0):
    return torch.zeros_like(a[sl(axis, slice(0, 1))])


def _faces_from_cells(c, axis, mid, edge):
    lo = edge(c[sl(axis, slice(0, 1))])
    hi = edge(c[sl(axis, slice(-1, None))])
    inner = mid(c[sl(axis, slice(0, -1))], c[sl(axis, slice(1, None))])
    return torch.cat([lo, inner, hi], dim=axis)


def cells_to_faces_avg(c, axis):
    """Arithmetic face interpolation; boundary faces take the edge cell."""
    return _faces_from_cells(c, axis, lambda a, b: 0.5 * (a + b), lambda e: e)


def gradient_at_faces(c, axis, h):
    """(c[i] - c[i-1]) / h at interior faces, 0 at domain-boundary faces."""
    return _faces_from_cells(c, axis, lambda a, b: (b - a) / h,
                             torch.zeros_like)


def faces_to_cells_avg(f, axis):
    return 0.5 * (f[sl(axis, slice(0, -1))] + f[sl(axis, slice(1, None))])


def face_lr(c, axis):
    """(left, right) cell values seen from each face; boundary faces clamp."""
    cl = torch.cat([c[sl(axis, slice(0, 1))], c], dim=axis)
    cr = torch.cat([c, c[sl(axis, slice(-1, None))]], dim=axis)
    return cl, cr


def upwind_faces(c, flux, axis):
    cl, cr = face_lr(c, axis)
    return torch.where(flux >= 0.0, cl, cr)


def divergence(fx, fy, fz, spacing):
    hx, hy, hz = spacing
    return ((fx[1:, :, :] - fx[:-1, :, :]) / hx
            + (fy[:, 1:, :] - fy[:, :-1, :]) / hy
            + (fz[:, :, 1:] - fz[:, :, :-1]) / hz)


def vanleer_limited(delta_up, delta_down, eps=1e-30):
    """van Leer limiter phi(r)*delta_down, r = delta_up/delta_down."""
    signed_eps = torch.where(delta_down >= 0, eps, -eps).to(delta_down.dtype)
    safe = torch.where(delta_down.abs() > eps, delta_down, signed_eps)
    r = delta_up / safe
    phi = (r + r.abs()) / (1.0 + r.abs())
    return phi * delta_down


def vanleer_faces(c, flux, axis):
    """MUSCL face value with the van Leer limiter, upwinded by flux sign."""
    down, up = shift_both(c, axis)
    dm = c - down
    dp = up - c
    up_plus = c + 0.5 * vanleer_limited(dm, dp)
    up_minus = c - 0.5 * vanleer_limited(dp, dm)
    fl, _ = face_lr(up_plus, axis)
    _, fr = face_lr(up_minus, axis)
    return torch.where(flux >= 0.0, fl, fr)
