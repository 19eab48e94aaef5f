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
"""

from __future__ import annotations

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st

_sl = st._sl


def _zero_pad_axis(f, axis):
    """Pad one zero slab on both ends of `axis`."""
    shape = list(f.shape)
    shape[axis] = 1
    z = torch.zeros(shape, dtype=f.dtype, device=f.device)
    return torch.cat([z, f, z], dim=axis)


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
                    extra=None):
    """q* = (ρ_f^old·q + dt·vc)/ρ_f^new + dt·G [+ dt·extra] per component,
    zero where the aperture is 0 (ρ_f: arithmetic face means). `extra`:
    an optional per-axis source on each face grid (the rotating frame's
    accelerations, solver/frame.py)."""
    out = []
    for ax, (q, vc, ap) in enumerate(zip(vels, vcs, apertures)):
        rof = st.cells_to_faces_avg(rho_old, ax)
        rnf = st.cells_to_faces_avg(rho_new, ax)
        q_star = (rof * q + dt * vc) / rnf
        q_star = q_star + dt * G[ax]
        if extra is not None:
            q_star = q_star + dt * extra[ax]
        out.append(torch.where(ap > 0.0, q_star, 0.0))
    return out
