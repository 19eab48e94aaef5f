"""Bounded compressive VoF advection (MULES-class), port of
openfoam_tpp_tpu/ops/mules.py.

Flux-corrected transport (Zalesak): donor-cell low-order flux, van Leer
MUSCL high-order flux plus the interface-compression flux
cAlpha·|u|·n̂ α(1−α), and an iterative limiter keeping alpha within
[max(0, local min), min(1, local max)]. Also returns the phase-consistent
mass flux rhoPhi used by conservative momentum transport.

With `use_pallas` the flux build and each limiter iteration go through
the kernels in ops/kernels/ (CUDA on the card, their plain versions on
the CPU) in the cell lower-face layout; the bf16 λ/anti streams are on
only on that path and only with `fct_bf16`, as in the JAX package.
With `spmd` (parallel/spmd.py, the x-sharded step) the flux build runs as
the per-shard `flux_all` island and all limiter iterations of a subcycle
as one `fct_iters` island; in a rank process (parallel/ranks.py) every
x-neighbour access between them goes through ops/stencil.py's exchange.
"""

from __future__ import annotations

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
from openfoam_tpp_tpu_torch.parallel import spmd as sm


def _neighbor_max(a):
    out = a
    for ax in range(3):
        down, up = st.shift_both(a, ax)
        out = torch.maximum(out, torch.maximum(down, up))
    return out


def _neighbor_min(a):
    out = a
    for ax in range(3):
        down, up = st.shift_both(a, ax)
        out = torch.minimum(out, torch.minimum(down, up))
    return out


def interface_normals_at_faces(alpha, spacing, eps=1e-8):
    """Unit interface normal components at the three face sets."""
    hx, hy, hz = spacing
    gx = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 0, hx), 0)
    gy = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 1, hy), 1)
    gz = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 2, hz), 2)
    mag = torch.sqrt(gx * gx + gy * gy + gz * gz) + eps
    return (st.cells_to_faces_avg(gx / mag, 0),
            st.cells_to_faces_avg(gy / mag, 1),
            st.cells_to_faces_avg(gz / mag, 2))


def compression_fluxes(alpha, phi, apertures, spacing, c_alpha):
    """Per-axis compression flux u_c = cAlpha·|u|·n̂·A, computed once per
    advection call (interFoam evaluates phic before the subcycles)."""
    if c_alpha <= 0.0:
        return None
    normals = interface_normals_at_faces(alpha, spacing)
    ucs = []
    for ax in range(3):
        a_ap = apertures[ax]
        u_face = phi[ax] / torch.clamp(a_ap, min=1e-6)
        ucs.append(c_alpha * torch.abs(u_face) * normals[ax] * a_ap)
    return tuple(ucs)


def _face_fluxes(alpha, phi, u_cs):
    """Per-axis (low-order, antidiffusive) alpha fluxes (face layout)."""
    lows, antis = [], []
    for ax in range(3):
        f = phi[ax]
        low = f * st.upwind_faces(alpha, f, ax)
        high = f * st.vanleer_faces(alpha, f, ax)
        if u_cs is not None:
            u_c = u_cs[ax]
            ac = st.vanleer_faces(alpha, u_c, ax)
            high = high + u_c * ac * (1.0 - ac)
        lows.append(low)
        antis.append(high - low)
    return lows, antis


def _apply_top_bc(flux_z, phi_z, alpha):
    """Atmosphere patch (inletOutlet, inletValue 0): outflow carries the
    interior alpha, inflow carries alpha = 0."""
    out = flux_z.clone()
    out[:, :, -1] = torch.clamp(phi_z[:, :, -1], min=0.0) * alpha[:, :, -1]
    return out


def _div(fluxes, spacing):
    return st.divergence(fluxes[0], fluxes[1], fluxes[2], spacing)


def _cell_to_faces(arrs):
    """Re-append the implicit zero upper-boundary plane per axis (along x
    in a rank, the right neighbour's first face, except at the global
    end)."""
    fx, fy, fz = arrs
    return [torch.cat([fx, st.x_next_plane(fx)], 0),
            torch.cat([fy, torch.zeros_like(fy[:, :1])], 1),
            torch.cat([fz, torch.zeros_like(fz[:, :, :1])], 2)]


def _cell_layout(faces):
    """Face arrays → cell lower-face layout (drop the upper boundary)."""
    return (faces[0][:-1].contiguous(), faces[1][:, :-1].contiguous(),
            faces[2][:, :, :-1].contiguous())


def _fct_limited(alpha_n, alpha_low, antis, dt, spacing, inv_vol, n_iters,
                 use_pallas=False, fct_bf16=False, spmd=None):
    """Iterative Zalesak limiter: the LIMITED antidiffusive fluxes λ·anti
    (face layout) after `n_iters` iterations."""
    hx, hy, hz = spacing
    amax = torch.clamp(_neighbor_max(torch.maximum(alpha_n, alpha_low)),
                       max=1.0)
    amin = torch.clamp(_neighbor_min(torch.minimum(alpha_n, alpha_low)),
                       min=0.0)

    if use_pallas:
        dt_iv = (dt * inv_vol).contiguous()
        lam_dt = torch.bfloat16 if fct_bf16 else alpha_low.dtype
        cell_antis = tuple(a.to(lam_dt) for a in _cell_layout(antis))
        lams = tuple(torch.zeros_like(alpha_low, dtype=lam_dt)
                     for _ in range(3))
        if spmd is not None:
            lams = sm.fct_iters(lams, cell_antis, alpha_low, amax, amin,
                                dt_iv, spacing, n_iters, spmd)
        else:
            for _ in range(n_iters):
                lams = mf.fct_iter(lams, cell_antis, alpha_low, amax, amin,
                                   dt_iv, spacing)
        f32 = alpha_low.dtype
        lim = tuple(l.to(f32) * a.to(f32) for l, a in zip(lams, cell_antis))
        return tuple(_cell_to_faces(lim))

    lam = [torch.zeros_like(a) for a in antis]
    eps = 1e-12
    for _ in range(n_iters):
        applied = tuple(l * a for l, a in zip(lam, antis))
        a_work = alpha_low - dt * inv_vol * _div(applied, spacing)
        rem = tuple((1.0 - l) * a for l, a in zip(lam, antis))
        p_in = torch.zeros_like(alpha_low)
        p_out = torch.zeros_like(alpha_low)
        for ax, h in zip(range(3), (hx, hy, hz)):
            r = rem[ax]
            lo = r[st._sl(ax, slice(0, -1))]
            hi = r[st._sl(ax, slice(1, None))]
            p_in = p_in + (torch.clamp(lo, min=0.0)
                           - torch.clamp(hi, max=0.0)) / h
            p_out = p_out + (torch.clamp(hi, min=0.0)
                             - torch.clamp(lo, max=0.0)) / h
        p_in = dt * inv_vol * p_in
        p_out = dt * inv_vol * p_out
        r_plus = torch.clamp((amax - a_work) / (p_in + eps), 0.0, 1.0)
        r_minus = torch.clamp((a_work - amin) / (p_out + eps), 0.0, 1.0)
        new_lam = []
        for ax in range(3):
            rp_l, rp_r = st.face_lr(r_plus, ax)
            rm_l, rm_r = st.face_lr(r_minus, ax)
            c = torch.where(rem[ax] >= 0.0, torch.minimum(rm_l, rp_r),
                            torch.minimum(rp_l, rm_r))
            new_lam.append(torch.clamp(lam[ax] + (1.0 - lam[ax]) * c,
                                       0.0, 1.0))
        lam = new_lam
    return tuple(l * a for l, a in zip(lam, antis))


def advect_alpha(alpha, phi, geom_arrays, spacing, dt, rho1, rho2,
                 c_alpha=1.0, n_subcycles=3, n_limiter_iters=3,
                 use_pallas=False, fct_bf16=False, spmd=None):
    """Advance alpha over `dt` (0-d tensor) with `n_subcycles` FCT
    sub-steps. Returns (alpha_new, rhoPhi, alpha_flux) where
    rhoPhi_f = rho1·Fα + rho2·(φ − Fα) from the time-averaged limited
    alpha flux Fα. `spmd`: the kernels run as per-shard islands."""
    vfrac = geom_arrays["vfrac"]
    apertures = (geom_arrays["ax"], geom_arrays["ay"], geom_arrays["az"])
    fluid = vfrac > 0.0
    inv_vol = torch.where(fluid, 1.0 / torch.clamp(vfrac, min=0.5), 0.0)

    dt_sub = dt / n_subcycles
    u_cs = compression_fluxes(alpha, phi, apertures, spacing, c_alpha)
    use_flux_kernel = use_pallas and u_cs is not None
    fct_bf16 = bool(fct_bf16) and use_pallas
    if use_flux_kernel:
        uc_dt = torch.bfloat16 if fct_bf16 else alpha.dtype
        phis_cell = _cell_layout(phi)
        ucs_cell = tuple(u.to(uc_dt) for u in _cell_layout(u_cs))

    a = alpha
    flux_acc = tuple(torch.zeros_like(p) for p in phi)
    for _ in range(n_subcycles):
        if use_flux_kernel:
            anti_dt = torch.bfloat16 if fct_bf16 else None
            if spmd is not None:
                lows_c, antis_c = sm.flux_all(a, phis_cell, ucs_cell, spmd,
                                              anti_dtype=anti_dt)
            else:
                lows_c, antis_c = mfx.flux_all(a, phis_cell, ucs_cell,
                                               anti_dtype=anti_dt)
            lows = _cell_to_faces(lows_c)
            antis = _cell_to_faces(antis_c)
        else:
            lows, antis = _face_fluxes(a, phi, u_cs)
        lows[2] = _apply_top_bc(lows[2], phi[2], a)
        antis[2] = antis[2].clone()
        antis[2][:, :, -1] = 0.0

        a_low = a - dt_sub * inv_vol * _div(lows, spacing)
        limited = _fct_limited(a, a_low, antis, dt_sub, spacing, inv_vol,
                               n_limiter_iters, use_pallas=use_pallas,
                               fct_bf16=fct_bf16, spmd=spmd)
        a_new = a_low - dt_sub * inv_vol * _div(limited, spacing)
        a = torch.where(fluid, torch.clamp(a_new, 0.0, 1.0), 0.0)
        flux_acc = tuple(acc + (lo + li) / n_subcycles
                         for acc, lo, li in zip(flux_acc, lows, limited))

    rho_phi = tuple(rho1 * fa + rho2 * (p - fa)
                    for fa, p in zip(flux_acc, phi))
    return a, rho_phi, flux_acc
