"""Momentum transport on the MAC grid, plain PyTorch in f32.

A frozen copy of the terms of the port's solver/momentum.py that a step
without surface tension runs: van Leer convection by the mass flux
rhoPhi, the variable-mu Laplacian, the explicit dev2 transpose stress,
and the explicit update with the uniform body acceleration G.
"""

from __future__ import annotations

import torch

from h100bench.reference import stencil as st

_sl = st.sl


def convect_face_field(q, qax, rho_phi, spacing):
    conv = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            rp = rho_phi[d]
            g_center = 0.5 * (rp[_sl(d, slice(0, -1))] + rp[_sl(d, slice(1, None))])
            g = st.pad_zero(g_center, d)
        else:
            g = st.cells_to_faces_avg(rho_phi[d], qax)
        flux = g * st.vanleer_faces(q, g, d)
        conv = conv + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return conv


def edge_viscosities(mu):
    return {
        frozenset((0, 1)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 0), 1),
        frozenset((0, 2)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 0), 2),
        frozenset((1, 2)): st.cells_to_faces_avg(st.cells_to_faces_avg(mu, 1), 2),
    }


def viscous_face_field(q, qax, mu, spacing, mu_edges):
    out = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            dq = (q[_sl(d, slice(1, None))] - q[_sl(d, slice(0, -1))]) / h
            flux = st.pad_zero(mu * dq, d)
        else:
            flux = mu_edges[frozenset((qax, d))] * st.gradient_at_faces(q, d, h)
        out = out + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return out


def transpose_viscous_face_field(vels, qax, mu, spacing, mu_edges, div_u):
    q = vels[qax]
    out = torch.zeros_like(q)
    for d in range(3):
        h = spacing[d]
        if d == qax:
            dq = (q[_sl(d, slice(1, None))] - q[_sl(d, slice(0, -1))]) / h
            if div_u is not None:
                dq = dq - (2.0 / 3.0) * div_u
            flux = st.pad_zero(mu * dq, d)
        else:
            flux = (mu_edges[frozenset((qax, d))]
                    * st.gradient_at_faces(vels[d], qax, spacing[qax]))
        out = out + (flux[_sl(d, slice(1, None))] - flux[_sl(d, slice(0, -1))]) / h
    return out


def explicit_rhs(vels, rho_phi, mu, div_u, spacing, dev2=True):
    """visc [+ dev2] - conv of the three components, on their face grids."""
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


def explicit_update(vels, vcs, rho_old, rho_new, apertures, dt, G):
    """q* = (rho_f_old*q + dt*vc)/rho_f_new + dt*G, zero where closed."""
    out = []
    for ax, (q, vc, ap) in enumerate(zip(vels, vcs, apertures)):
        rof = st.cells_to_faces_avg(rho_old, ax)
        rnf = st.cells_to_faces_avg(rho_new, ax)
        q_star = (rof * q + dt * vc) / rnf
        q_star = q_star + dt * G[ax]
        out.append(torch.where(ap > 0.0, q_star, 0.0))
    return out
