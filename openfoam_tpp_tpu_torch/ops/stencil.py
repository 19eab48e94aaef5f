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

In a rank process of the x-sharded step (parallel/ranks.py) the arrays
are x-slabs, and `x_slabs(ranks, nxl)` makes that known for the block it
opens: there every x-neighbour access at a slab's interior boundary
takes the neighbour rank's plane (one `exchange` a call), the clamp or
the zero stays at the global ends alone, and the three cell reductions
reduce over the ranks. The same operands meet in the same order as on
the whole grid, so every value but the reductions' is the whole grid's,
bit for bit. `x_slabs(None)` closes it again for code that works on
whole arrays (the kernels' plain versions, the gathered multigrid
levels).
"""

from __future__ import annotations

import contextlib

import torch

# (RankCtx, local nx of the fine grid) while a rank's step runs, else None.
_X = None


@contextlib.contextmanager
def x_slabs(ranks, nxl: int | None = None):
    """Within the block, x-arrays are this rank's slabs of `nxl` cells
    (`ranks` a parallel.ranks.RankCtx); `ranks=None`: whole arrays."""
    global _X
    prev, _X = _X, (None if ranks is None else (ranks, nxl))
    try:
        yield
    finally:
        _X = prev


def x_ranks():
    """The RankCtx of the open `x_slabs` block, or None."""
    return None if _X is None else _X[0]


def _x_ghosts(a, lo=True, hi=True):
    """(lo, hi): the planes just outside an x-slab from the neighbour
    ranks, None at a global end or where not asked. A face array (nxl + 1
    planes) holds the plane it shares with the right neighbour, so its
    ghosts lie one plane further out."""
    ranks, nxl = _X
    f = 1 if a.shape[0] == nxl + 1 else 0
    n = a.shape[0]
    return ranks.exchange(a[f:f + 1] if hi else None,
                          a[n - 1 - f:n - f] if lo else None)


def _along_x(axis):
    return axis == 0 and _X is not None


def _sl(axis, s):
    """Build an nd slice tuple indexing `s` along `axis`."""
    out = [slice(None)] * 3
    out[axis] = s
    return tuple(out)


def _reduce(local, op):
    return local if _X is None else _X[0].all_reduce(local, op=op)


def sum_cells(t):
    """Sum over the cells: everything on a single grid, dims (0, 1, 2) —
    one value per case — on a batched (nx, ny, nz, B) one."""
    return _reduce(t.sum() if t.dim() == 3 else t.sum(dim=(0, 1, 2)), "sum")


def max_cells(t):
    return _reduce(t.max() if t.dim() == 3 else t.amax(dim=(0, 1, 2)), "max")


def min_cells(t):
    return _reduce(t.min() if t.dim() == 3 else t.amin(dim=(0, 1, 2)), "min")


def shift_down(a, axis):
    """result[i] = a[i-1], edge-clamped at i=0."""
    first = a[_sl(axis, slice(0, 1))]
    if _along_x(axis):
        lo, _ = _x_ghosts(a, hi=False)
        first = first if lo is None else lo
    return torch.cat([first, a[_sl(axis, slice(0, -1))]], dim=axis)


def shift_up(a, axis):
    """result[i] = a[i+1], edge-clamped at i=n-1."""
    last = a[_sl(axis, slice(-1, None))]
    if _along_x(axis):
        _, hi = _x_ghosts(a, lo=False)
        last = last if hi is None else hi
    return torch.cat([a[_sl(axis, slice(1, None))], last], dim=axis)


def shift_both(a, axis):
    """(shift_down(a, axis), shift_up(a, axis)), with one exchange."""
    if not _along_x(axis):
        return shift_down(a, axis), shift_up(a, axis)
    lo, hi = _x_ghosts(a)
    return (torch.cat([a[:1] if lo is None else lo, a[:-1]]),
            torch.cat([a[1:], a[-1:] if hi is None else hi]))


def x_next_plane(a):
    """The plane after an x-array's last (cells in the lower-face layout):
    zeros at the global end, the right neighbour rank's first plane at a
    slab's interior boundary."""
    if _X is not None:
        _, hi = _X[0].exchange(a[:1], None)
        if hi is not None:
            return hi
    return torch.zeros_like(a[:1])


def _faces_from_cells(c, axis, mid, edge):
    """Faces of a cell array: `mid(left, right)` at every face between two
    cells, `edge(c's end plane)` at the global ends; along x in a rank, the
    slab's end faces pair its end cells with the neighbours' planes."""
    lo = edge(c[_sl(axis, slice(0, 1))])
    hi = edge(c[_sl(axis, slice(-1, None))])
    if _along_x(axis):
        g_lo, g_hi = _x_ghosts(c)
        if g_lo is not None:
            lo = mid(g_lo, c[:1])
        if g_hi is not None:
            hi = mid(c[-1:], g_hi)
    inner = mid(c[_sl(axis, slice(0, -1))], c[_sl(axis, slice(1, None))])
    return torch.cat([lo, inner, hi], dim=axis)


def cells_to_faces_avg(c, axis):
    """Arithmetic face interpolation; boundary faces take the edge cell."""
    return _faces_from_cells(c, axis, lambda a, b: 0.5 * (a + b),
                             lambda e: e)


def cells_to_faces_harmonic(c, axis, eps=1e-30):
    """Harmonic face interpolation."""
    return _faces_from_cells(c, axis, lambda a, b: 2.0 * a * b / (a + b + eps),
                             lambda e: e)


def gradient_at_faces(c, axis, h):
    """(c[i] - c[i-1]) / h at interior faces, 0 at domain-boundary faces."""
    return _faces_from_cells(c, axis, lambda a, b: (b - a) / h,
                             torch.zeros_like)


def faces_to_cells_avg(f, axis):
    """Average the two bracketing faces back to cells."""
    return 0.5 * (f[_sl(axis, slice(0, -1))] + f[_sl(axis, slice(1, None))])


def face_lr(c, axis):
    """Cell values seen from each face: (left/donor-below, right/donor-above),
    both face-shaped along `axis`; boundary faces clamp."""
    lo = c[_sl(axis, slice(0, 1))]
    hi = c[_sl(axis, slice(-1, None))]
    if _along_x(axis):
        g_lo, g_hi = _x_ghosts(c)
        lo = lo if g_lo is None else g_lo
        hi = hi if g_hi is None else g_hi
    cl = torch.cat([lo, c], dim=axis)
    cr = torch.cat([c, hi], dim=axis)
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
    down, up = shift_both(c, axis)
    dm = c - down
    dp = up - c
    up_plus = c + 0.5 * vanleer_limited(dm, dp)
    up_minus = c - 0.5 * vanleer_limited(dp, dm)
    fl, _ = face_lr(up_plus, axis)
    _, fr = face_lr(up_minus, axis)
    return torch.where(flux >= 0.0, fl, fr)


def max27(a):
    """Max over the 3x3x3 neighbourhood (edge-clamped)."""
    for ax in range(3):
        down, up = shift_both(a, ax)
        a = torch.maximum(a, torch.maximum(down, up))
    return a


def min27(a):
    for ax in range(3):
        down, up = shift_both(a, ax)
        a = torch.minimum(a, torch.minimum(down, up))
    return a
