"""Momentum transport on the staggered (MAC) grid — port of the terms of
openfoam_tpp_tpu/solver/momentum.py that the step runs without the fused
kernels: van Leer convection by the phase-consistent mass flux rhoPhi,
the variable-μ Laplacian, and the explicit dev2 transpose stress
∇·(μ[(∇U)ᵀ − (2/3)(∇·U)I]); `explicit_rhs` and `explicit_update` are the
step's two loops over the components, which the fused kernels' plain
versions reuse.

Forcing uses the total-pressure formulation (see the JAX module's note):
the uniform body acceleration G(t) is added to face velocities in the
time step and p absorbs the hydrostatic profile.

Surface tension (Brackbill CSF, σκ∇α at the faces): `csf_force`, and the
curvature estimators `smooth_alpha`, `curvature_vof`, `curvature_hf` and
`curvature` (the height-function / smoothed-VoF blend). They keep the
JAX module's operation order, so their f32 results track it. Like the
rest of the step they take a trailing case axis, (nx, ny, nz, B), with
the spacing as floats or per-case (B,) tensors; the height function sums
over z and pads x and y only. In a rank process of the step over ranks
every pad at a block's interior boundary takes the neighbour rank's
plane (ops/stencil.py `pad`), so the terms are the whole grid's.
"""

from __future__ import annotations

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st

_sl = st._sl


def _zero_pad_axis(f, axis):
    """Pad one zero slab on both ends of `axis` (in a rank block, the
    neighbour's slab at an interior boundary: ops/stencil.py `pad`)."""
    return st.pad(f, axis, "zero")


def convect_face_field(q, qax, rho_phi, spacing):
    """∇·(rhoPhi q) at the q-face points (conservative form). Parallel
    direction: mass flux averaged to cell centres; transverse: the
    transverse face flux averaged along qax to the edges. The advected
    value is van Leer-reconstructed upwind of the local mass flux."""
    conv = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            rp = rho_phi[d]
            g_center = 0.5 * (rp[_sl(d, slice(0, -1))] + rp[_sl(d, slice(1, None))])
            g = _zero_pad_axis(g_center, d)
        else:
            g = st.cells_to_faces_avg(rho_phi[d], qax)
        flux = g * st.vanleer_faces(q, g, d)
        conv = conv + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return conv


def edge_viscosities(mu):
    """The three edge-averaged μ arrays, one per axis pair."""
    return {
        frozenset((0, 1)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 0), 1),
        frozenset((0, 2)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 0), 2),
        frozenset((1, 2)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 1), 2),
    }


def _mu_edge(mu, qax, d, mu_edges):
    if mu_edges is not None:
        return mu_edges[frozenset((qax, d))]
    return st.cells_to_faces_avg(st.cells_to_faces_avg(mu, qax), d)


def viscous_face_field(q, qax, mu, spacing, mu_edges=None):
    """∇·(μ∇q) at the q-face points (Laplacian form)."""
    out = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            dq = (q[_sl(d, slice(1, None))] - q[_sl(d, slice(0, -1))]) / h
            flux = _zero_pad_axis(mu * dq, d)
        else:
            flux = _mu_edge(mu, qax, d, mu_edges) * st.gradient_at_faces(q, d, h)
        out = out + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return out


def transpose_viscous_face_field(vels, qax, mu, spacing, mu_edges=None,
                                 div_u=None):
    """∇·(μ [(∇U)ᵀ − (2/3)(∇·U) I]), component `qax`, at qax-face points
    (fvSchemes dev2 term). Zero for constant μ and ∇·U = 0."""
    q = vels[qax]
    out = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            dq = (q[_sl(d, slice(1, None))] - q[_sl(d, slice(0, -1))]) / h
            if div_u is not None:
                dq = dq - (2.0 / 3.0) * div_u
            flux = _zero_pad_axis(mu * dq, d)
        else:
            flux = (_mu_edge(mu, qax, d, mu_edges)
                    * st.gradient_at_faces(vels[d], qax, spacing[qax]))
        out = out + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return out


def explicit_rhs(vels, rho_phi, mu, div_u, spacing, dev2=True):
    """visc [+ dev2] − conv of the three components, on their face grids."""
    edges = edge_viscosities(mu)
    out = []
    for ax, q in enumerate(vels):
        vc = (viscous_face_field(q, ax, mu, spacing, edges)
              - convect_face_field(q, ax, rho_phi, spacing))
        if dev2:
            vc = vc + transpose_viscous_face_field(vels, ax, mu, spacing,
                                                   edges, div_u)
        out.append(vc)
    return out


def explicit_update(vels, vcs, rho_old, rho_new, apertures, dt, G,
                    extra=None, csf=None):
    """q* = (ρ_f^old·q + dt·vc)/ρ_f^new + dt·G [+ dt·extra] [+ dt·csf] per
    component, three separate adds as in the JAX step, zero where the
    aperture is 0 (ρ_f: arithmetic face means). A component of G that is
    3-D and varies along its own axis (the tiled sweep's per-block G_x) is
    face-averaged first, unless it is on that axis's faces already (a
    rank's cut of the whole grid's faces, solver/timestep.py
    `block_forcing`). `extra`: an optional per-axis source on each face
    grid (the rotating frame's accelerations, solver/frame.py); `csf`: the
    per-axis surface-tension acceleration (`csf_force`)."""
    out = []
    for ax, (q, vc, ap) in enumerate(zip(vels, vcs, apertures)):
        rof = st.cells_to_faces_avg(rho_old, ax)
        rnf = st.cells_to_faces_avg(rho_new, ax)
        q_star = (rof * q + dt * vc) / rnf
        Gc = G[ax]
        if (isinstance(Gc, torch.Tensor) and Gc.dim() == 3
                and Gc.shape[ax] not in (1, q.shape[ax])):
            Gc = st.cells_to_faces_avg(Gc, ax)
        q_star = q_star + dt * Gc
        if extra is not None:
            q_star = q_star + dt * extra[ax]
        if csf is not None:
            q_star = q_star + dt * csf[ax]
        out.append(torch.where(ap > 0.0, q_star, 0.0))
    return out


# ------------------------------------------------------------------ CSF

def csf_force(alpha, kappa, sigma, axis, h, beta_face):
    """Continuum-surface-force σ κ_f ∂α/∂n · β_f at the `axis` faces."""
    kf = st.cells_to_faces_avg(kappa, axis)
    da = st.gradient_at_faces(alpha, axis, h)
    return sigma * kf * da * beta_face


def smooth_alpha(alpha, n=2):
    """`n` passes of 7-point averaging of the VoF field, for the curvature
    estimate only (alpha itself is never smoothed)."""
    for _ in range(n):
        sm = alpha
        for ax in range(3):
            sm = sm + st.shift_down(alpha, ax) + st.shift_up(alpha, ax)
        # XLA folds the JAX module's `sm / 7.0` into this f32 product.
        alpha = sm * (1.0 / 7.0)
    return alpha


def curvature_vof(alpha, spacing, eps=1e-8, n_smooth=2):
    """κ = −∇·n̂ from smoothed VoF gradients (cell-centred); also returns
    the cell gradient and its magnitude, (gx, gy, gz, |g| + eps)."""
    hx, hy, hz = spacing
    alpha = smooth_alpha(alpha, n_smooth)
    gx = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 0, hx), 0)
    gy = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 1, hy), 1)
    gz = st.faces_to_cells_avg(st.gradient_at_faces(alpha, 2, hz), 2)
    mag = torch.sqrt(gx * gx + gy * gy + gz * gz) + eps
    nxf = st.cells_to_faces_avg(gx / mag, 0)
    nyf = st.cells_to_faces_avg(gy / mag, 1)
    nzf = st.cells_to_faces_avg(gz / mag, 2)
    kv = -st.divergence(nxf, nyf, nzf, spacing)
    return kv, (gx, gy, gz, mag)


def _pad_xy(a, edge):
    """One slab on both ends of dims 0 and 1: the edge value (`edge`) or
    zero / False; a trailing case axis passes through. In a rank block
    the neighbours' columns at an interior boundary, x first, so the y
    rows that travel carry the x·y corners (ops/stencil.py `pad`)."""
    for d in (0, 1):
        a = st.pad(a, d, "clamp" if edge else "zero")
    return a


def curvature_hf(alpha, spacing, vfrac):
    """Column height-function curvature κ(x, y), with a unit z axis that
    broadcasts over z: H = Σ_k α·hz over each wet (i, j) column, then
    κ = −(H_xx(1+H_y²) + H_yy(1+H_x²) − 2 H_x H_y H_xy) / W³,
    W = √(1+H_x²+H_y²), central differences; a neighbour column with no
    fluid cell gives way to the column's own H (zero gradient at walls).
    Returns (nx, ny, 1), or (nx, ny, 1, B) on a batch."""
    hx, hy, hz = spacing
    wet = vfrac.amax(dim=2) > 0.0
    H = torch.where(wet, alpha.sum(dim=2) * hz, 0.0)
    nx, ny = H.shape[0], H.shape[1]
    Hp = _pad_xy(H, edge=True)
    wp = _pad_xy(wet, edge=False)

    def nb(di, dj):
        v = Hp[1 + di:1 + di + nx, 1 + dj:1 + dj + ny]
        m = wp[1 + di:1 + di + nx, 1 + dj:1 + dj + ny]
        return torch.where(m, v, H)

    He, Hw = nb(1, 0), nb(-1, 0)
    Hn, Hs = nb(0, 1), nb(0, -1)
    Hx = (He - Hw) / (2.0 * hx)
    Hy = (Hn - Hs) / (2.0 * hy)
    Hxx = (He - 2.0 * H + Hw) / (hx * hx)
    Hyy = (Hn - 2.0 * H + Hs) / (hy * hy)
    Hxy = (nb(1, 1) - nb(1, -1) - nb(-1, 1) + nb(-1, -1)) / (4.0 * hx * hy)
    W2 = 1.0 + Hx * Hx + Hy * Hy
    k2d = -(Hxx * (1.0 + Hy * Hy) + Hyy * (1.0 + Hx * Hx)
            - 2.0 * Hx * Hy * Hxy) / (W2 * torch.sqrt(W2))
    return torch.where(wet, k2d, 0.0).unsqueeze(2)


def curvature(alpha, spacing, vfrac=None, method="blend", eps=1e-8,
              n_smooth=2):
    """CSF curvature (cell-centred). "blend" weights the height function
    by the interface's verticality n_z²/|n|² through the clip ramp
    clip((w − 0.25)·2, 0, 1): pure HF on a near-horizontal interface,
    pure smoothed VoF on a vertical one; "hf" / "vof" force one
    estimator ("hf" needs `vfrac`)."""
    if method == "hf":
        if vfrac is None:
            raise ValueError(
                "curvature(method='hf') requires vfrac (the cell fluid "
                "fractions): the height function integrates alpha over "
                "wet columns; pass vfrac or use method='vof'/'blend'")
        return curvature_hf(alpha, spacing, vfrac).expand(alpha.shape)
    kv, (gx, gy, gz, mag) = curvature_vof(alpha, spacing, eps, n_smooth)
    if method == "vof" or vfrac is None:
        return kv
    kh = curvature_hf(alpha, spacing, vfrac)
    w = (gz * gz) / (mag * mag)
    w = torch.clamp((w - 0.25) * 2.0, 0.0, 1.0)
    return w * kh + (1.0 - w) * kv
