"""Bounded compressive VoF advection (MULES class), plain PyTorch in f32.

A frozen copy of the plain path of the port's ops/mules.py: donor-cell
low-order flux, van Leer high-order flux plus the compression flux
c_alpha*|u|*n*alpha*(1-alpha), Zalesak's iterative limiter, and the mass
flux rhoPhi for the momentum transport.
"""

from __future__ import annotations

import torch

from h100bench.reference import stencil as st


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
    hx, hy, hz = spacing
    gx = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 0, hx), 0)
    gy = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 1, hy), 1)
    gz = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 2, hz), 2)
    mag = torch.sqrt(gx * gx + gy * gy + gz * gz) + eps
    return (st.cells_to_faces_avg(gx / mag, 0),
            st.cells_to_faces_avg(gy / mag, 1),
            st.cells_to_faces_avg(gz / mag, 2))


def compression_fluxes(alpha, phi, apertures, spacing, c_alpha):
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
    """Atmosphere patch: outflow carries the interior alpha, inflow 0."""
    out = flux_z.clone()
    out[:, :, -1] = torch.clamp(phi_z[:, :, -1], min=0.0) * alpha[:, :, -1]
    return out


def _div(fluxes, spacing):
    return st.divergence(fluxes[0], fluxes[1], fluxes[2], spacing)


def _fct_limited(alpha_n, alpha_low, antis, dt, spacing, inv_vol, n_iters):
    hx, hy, hz = spacing
    amax = torch.clamp(_neighbor_max(torch.maximum(alpha_n, alpha_low)),
                       max=1.0)
    amin = torch.clamp(_neighbor_min(torch.minimum(alpha_n, alpha_low)),
                       min=0.0)
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
            lo = r[st.sl(ax, slice(0, -1))]
            hi = r[st.sl(ax, slice(1, None))]
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


def advect_alpha(alpha, phi, ga, spacing, dt, rho1, rho2, c_alpha=1.0,
                 n_subcycles=3, n_limiter_iters=3):
    """Advance alpha over `dt` with `n_subcycles` FCT sub-steps. Returns
    (alpha_new, rhoPhi)."""
    fluid = ga["vfrac"] > 0.0
    apertures = (ga["ax"], ga["ay"], ga["az"])
    inv_vol = torch.where(fluid, 1.0 / torch.clamp(ga["vfrac"], min=0.5), 0.0)
    dt_sub = dt / n_subcycles
    u_cs = compression_fluxes(alpha, phi, apertures, spacing, c_alpha)
    a = alpha
    flux_acc = tuple(torch.zeros_like(p) for p in phi)
    for _ in range(n_subcycles):
        lows, antis = _face_fluxes(a, phi, u_cs)
        lows[2] = _apply_top_bc(lows[2], phi[2], a)
        antis[2] = antis[2].clone()
        antis[2][:, :, -1] = 0.0
        a_low = a - dt_sub * inv_vol * _div(lows, spacing)
        limited = _fct_limited(a, a_low, antis, dt_sub, spacing, inv_vol,
                               n_limiter_iters)
        a_new = a_low - dt_sub * inv_vol * _div(limited, spacing)
        a = torch.where(fluid, torch.clamp(a_new, 0.0, 1.0), 0.0)
        flux_acc = tuple(acc + (lo + li) / n_subcycles
                         for acc, lo, li in zip(flux_acc, lows, limited))
    rho_phi = tuple(rho1 * fa + rho2 * (p - fa) for fa, p in zip(flux_acc, phi))
    return a, rho_phi
