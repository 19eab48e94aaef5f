"""Matrix-free pressure Poisson solve, plain PyTorch: multigrid-
preconditioned CG.

A frozen copy of the plain path of the port's solver/poisson.py with its
default knobs: the 7-point operator A(p) = diag*p - sum_f w_f*p_nb
(w_f = a_f*beta_f/h^2) solved by CG in the diagonally scaled space
Ahat = D^-1/2 A D^-1/2, preconditioned by a bf16 V-cycle (one Chebyshev
sweep of degree 1 per pass on the scaled top level, the coarse correction
on the physical Galerkin hierarchy, 2x2x2 sum restriction, injection
prolongation, 24 Jacobi sweeps on the coarsest level, two visits of
level 1). The open top is a half-cell Dirichlet diagonal term. A batched
(nx, ny, nz, B) grid runs one CG whose converged cases hold their carry.
"""

from __future__ import annotations

import dataclasses

import torch

from h100bench.reference import stencil as st

JACOBI_OMEGA = 0.8
F32_CG_FLOOR = 3e-5
COARSEST_SWEEPS = 24
CHEB_LMAX = 2.0
CHEB_LMIN_FRAC = 0.10
MG_L1_GAMMA = 2
MG_DEEP_GAMMA = 1
PRECOND_DTYPE = torch.bfloat16


@dataclasses.dataclass
class Level:
    wx: torch.Tensor
    wy: torch.Tensor
    wz: torch.Tensor
    diag: torch.Tensor | None   # None on unit-diagonal levels
    shape: tuple
    unit_diag: bool = False


def weights_apply(level: Level, p):
    wx, wy, wz = level.wx, level.wy, level.wz
    (xd, xu), (yd, yu), (zd, zu) = (st.shift_both(p, ax) for ax in range(3))
    nb = (wx[:-1] * xd + wx[1:] * xu
          + wy[:, :-1] * yd + wy[:, 1:] * yu
          + wz[:, :, :-1] * zd + wz[:, :, 1:] * zu)
    if level.unit_diag:
        return p - nb
    return level.diag * p - nb


def _resid_scaled(level: Level, x, b):
    if level.unit_diag:
        return b - weights_apply(level, x)
    return (b - weights_apply(level, x)) / level.diag


def _jacobi(level: Level, x, b, n):
    if x is None and n > 0:
        x = JACOBI_OMEGA * b if level.unit_diag else JACOBI_OMEGA * b / level.diag
        n -= 1
    for _ in range(n):
        x = x + JACOBI_OMEGA * _resid_scaled(level, x, b)
    return x


def _smooth(level: Level, x, b):
    """One degree-1 Chebyshev sweep on [lmin_frac*lmax, lmax]."""
    a, c = CHEB_LMIN_FRAC * CHEB_LMAX, 1.02 * CHEB_LMAX
    theta = 0.5 * (c + a)
    if x is None:
        d = b if level.unit_diag else b / level.diag
    else:
        d = _resid_scaled(level, x, b)
    p = d / theta
    return p if x is None else x + p


def _pad_axis_even(a, axis):
    if a.shape[axis] % 2 == 0:
        return a
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _sum_pairs(a, axis):
    return a[st.sl(axis, slice(0, None, 2))] + a[st.sl(axis, slice(1, None, 2))]


def restrict_cells(a):
    for d in range(3):
        a = _sum_pairs(_pad_axis_even(a, d), d)
    return a


def prolong_cells(a, fine_shape):
    out = a.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return out[: fine_shape[0], : fine_shape[1], : fine_shape[2]]


def _coarsen_face_weights(w, axis):
    n_cells = w.shape[axis] - 1
    if n_cells % 2 == 1:
        shape = list(w.shape)
        shape[axis] = 1
        w = torch.cat([w, w.new_zeros(shape)], dim=axis)
    w = w[st.sl(axis, slice(0, None, 2))]
    for d in range(3):
        if d != axis:
            w = _sum_pairs(_pad_axis_even(w, d), d)
    return w


def coarse_levels(wx, wy, wz, extra, max_coarse=9, min_cells=256):
    levels = []
    shape = tuple(extra.shape[:3])
    while (len(levels) < max_coarse
           and shape[0] * shape[1] * shape[2] > min_cells and min(shape) > 2):
        wx = _coarsen_face_weights(wx, 0)
        wy = _coarsen_face_weights(wy, 1)
        wz = _coarsen_face_weights(wz, 2)
        extra = restrict_cells(extra)
        diag = (wx[:-1] + wx[1:] + wy[:, :-1] + wy[:, 1:]
                + wz[:, :, :-1] + wz[:, :, 1:] + extra)
        diag = torch.where(diag > 0, diag, 1.0)
        shape = tuple(extra.shape[:3])
        levels.append(Level(wx, wy, wz, diag, shape))
    return levels


def _vcycle(levels, li, b):
    level = levels[li]
    if li == len(levels) - 1:
        return _jacobi(level, None, b, COARSEST_SWEEPS)
    x = _smooth(level, None, b)
    gamma = MG_L1_GAMMA if li == 0 else MG_DEEP_GAMMA
    for g in range(max(gamma, 1)):
        if g:
            x = _smooth(level, x, b)
        r = b - weights_apply(level, x)
        ec = _vcycle(levels, li + 1, restrict_cells(r))
        x = x + prolong_cells(ec, level.shape)
    return _smooth(level, x, b)


def _vcycle_hybrid(top_hat, inv_s, coarse, b):
    """V-cycle on the scaled top level, the coarse correction on the
    physical hierarchy."""
    x = _smooth(top_hat, None, b)
    r = _resid_scaled(top_hat, x, b)
    if coarse:
        ec = _vcycle(coarse, 0, restrict_cells(inv_s * r))
        x = x + inv_s * prolong_cells(ec, top_hat.shape)
    else:
        x = x + _jacobi(top_hat, None, r, COARSEST_SWEEPS)
    return _smooth(top_hat, x, b)


@dataclasses.dataclass
class Problem:
    fluid: torch.Tensor
    beta_faces: tuple
    scale: torch.Tensor
    inv_scale: torch.Tensor
    apply_hat: object
    precond_hat: object


def build(ga, spacing, rho, open_top=True):
    """The operator for the density `rho` and its bf16 V-cycle."""
    hx, hy, hz = spacing
    fluid = ga["vfrac"] > 0.0
    bx = 1.0 / st.cells_to_faces_avg(rho, 0)
    by = 1.0 / st.cells_to_faces_avg(rho, 1)
    bz = 1.0 / st.cells_to_faces_avg(rho, 2)
    beta = torch.where(fluid, 1.0 / rho, 0.0)
    wx = ga["ax"] * bx / (hx * hx)
    wy = ga["ay"] * by / (hy * hy)
    wz = ga["az"] * bz / (hz * hz)
    wz[:, :, -1] = 0.0
    extra = torch.where(fluid, 0.0, 1.0).to(rho.dtype)
    if open_top:
        c_top = 2.0 * ga["top_open"] * beta[:, :, -1]
        extra[:, :, -1] = extra[:, :, -1] + c_top / (hz * hz)
    shape = tuple(extra.shape[:3])
    diag0 = (wx[:-1] + wx[1:] + wy[:, :-1] + wy[:, 1:]
             + wz[:, :, :-1] + wz[:, :, 1:] + extra)
    diag0 = torch.where(diag0 > 0, diag0, 1.0)
    s = torch.where(fluid, torch.rsqrt(diag0), 0.0)
    inv_s = torch.where(fluid, torch.sqrt(diag0), 0.0)
    sl_x, sr_x = st.face_lr(s, 0)
    sl_y, sr_y = st.face_lr(s, 1)
    sl_z, sr_z = st.face_lr(s, 2)
    hwx, hwy, hwz = wx * sl_x * sr_x, wy * sl_y * sr_y, wz * sl_z * sr_z
    top_hat = Level(hwx, hwy, hwz, None, shape, unit_diag=True)

    lp = PRECOND_DTYPE
    top16 = Level(hwx.to(lp), hwy.to(lp), hwz.to(lp), None, shape,
                  unit_diag=True)
    coarse16 = coarse_levels(wx.to(lp), wy.to(lp), wz.to(lp), extra.to(lp))
    inv_s16 = inv_s.to(lp)

    def precond_hat(r):
        return _vcycle_hybrid(top16, inv_s16, coarse16, r.to(lp)).to(r.dtype)

    return Problem(fluid=fluid, beta_faces=(bx, by, bz), scale=s,
                   inv_scale=inv_s,
                   apply_hat=lambda p: weights_apply(top_hat, p),
                   precond_hat=precond_hat)


def _dot(a, b):
    return st.sum_cells(a.float() * b.float())


def _cg(prob: Problem, b, tol, max_iters):
    """Preconditioned CG from zero in the scaled space: (x, iterations);
    on a batched grid the loop runs while any case is unconverged and the
    others hold their carry."""
    apply_h, precond_h = prob.apply_hat, prob.precond_hat
    r = b
    z = precond_h(r)
    rz = _dot(r, z)
    x = torch.zeros_like(b)
    p = z
    rr = _dot(r, r)
    tol2 = tol * tol
    safe = lambda d: torch.where(d.abs() > 1e-30, d, 1e-30)
    if b.dim() == 3:
        k = 0
        while k < max_iters and bool(rr > tol2):
            ap = apply_h(p)
            alpha = rz / safe(_dot(p, ap))
            x = x + alpha * p
            r = r - alpha * ap
            z = precond_h(r)
            rz_new = _dot(r, z)
            p = z + (rz_new / safe(rz)) * p
            rz = rz_new
            rr = _dot(r, r)
            k += 1
        return x, torch.as_tensor(k, dtype=torch.int32, device=b.device)
    k = torch.zeros_like(rr, dtype=torch.int32)
    active = rr > tol2
    while bool(active.any()):
        ap = apply_h(p)
        alpha = rz / safe(_dot(p, ap))
        x_new = x + alpha * p
        r_new = r - alpha * ap
        z = precond_h(r_new)
        rz_new = _dot(r_new, z)
        p_new = z + (rz_new / safe(rz)) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, _dot(r_new, r_new), rr)
        k = k + active.to(torch.int32)
        active = (k < max_iters) & (rr > tol2)
    return x, k


def solve(prob: Problem, b, x0, tol_rel, tol_abs, tol_rel_b, max_iters):
    """Stops at max(tol_rel*|r0|, tol_abs, tol_rel_b*|bhat|) in the scaled
    norm, one refinement pass (tol_rel >= 10 * the f32 floor). Returns
    (x, iterations)."""
    if tol_rel < 10.0 * F32_CG_FLOOR:
        raise NotImplementedError("the reference refines once: tol_rel must "
                                  "be at least ten times the f32 CG floor")
    s, inv_s = prob.scale, prob.inv_scale
    bh = s * b
    xh = inv_s * x0
    r = bh - prob.apply_hat(xh)
    tol = torch.clamp(tol_rel * torch.sqrt(_dot(r, r)), min=tol_abs)
    tol_rel_b = min(tol_rel_b, tol_rel)
    if tol_rel_b > 0.0:
        tol = torch.maximum(tol, tol_rel_b * torch.sqrt(_dot(bh, bh)))
    inner_tol = torch.maximum(F32_CG_FLOOR * torch.sqrt(_dot(r, r)), tol)
    dx, iters = _cg(prob, r, inner_tol, max_iters)
    return s * (xh + dx), iters
