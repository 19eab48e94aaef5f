"""Non-inertial (rotating + translating) tank-frame forces.

Port of openfoam_tpp_tpu/solver/frame.py. The solver works in the tank
frame on a static grid, so the prescribed rigid motion of the closed 6DoF
tank appears as body forces:

    a_fict(r, u) = Rᵀ(g_lab − a_lab)              uniform part
                   − dω×r − ω×(ω×r) − 2 ω×u       rotation part

with ω, dω the tank's angular velocity and acceleration in the tank frame
and r the position relative to the rotation centre (the origin).

From the xyz Euler angles (R = Rz·Ry·Rx, core/motion.rotation_matrix):

    ω_lab = ċ ẑ + ḃ (Rz ŷ) + ȧ (Rz Ry x̂) = E(b, c) · (ȧ, ḃ, ċ),
    ω_body = Rᵀ ω_lab,  ω̇_body = Rᵀ (E·(ä, b̈, c̈) + Ė·(ȧ, ḃ, ċ)),

the last term being the Euler-rate coupling.
"""

from __future__ import annotations

import numpy as np
import torch

from openfoam_tpp_tpu_torch.core import motion as mo
from openfoam_tpp_tpu_torch.device import resolve_device


def face_coordinates(geom, axis, device="cuda", ranks=None):
    """(X, Y, Z) 1-D f32 coordinate tensors broadcastable to the `axis`
    face set: the face-normal coordinate on grid planes, the tangential
    ones at cell centres (no 3-D coordinate tensors). With `ranks` (a
    parallel.ranks.RankCtx) X is this rank's x-slab of the global
    coordinates: nxl cell centres, or nxl + 1 x faces whose last is the
    right neighbour's first, the same bits on both ranks."""
    dev = resolve_device(device)
    h, o = geom.spacing, geom.origin
    coords = []
    for d in range(3):
        n = geom.shape[d]
        if d == axis:
            c = o[d] + np.arange(n + 1) * h[d]
        else:
            c = o[d] + (np.arange(n) + 0.5) * h[d]
        if d == 0 and ranks is not None:
            c = ranks.slab(c, n)
        shape = [1, 1, 1]
        shape[d] = -1
        coords.append(torch.as_tensor(c.reshape(shape).astype(np.float32),
                                      device=dev))
    return tuple(coords)


def angular_rates(motion, t):
    """(ω_body, dω_body) at time t from the tabulated Euler angles."""
    ang = motion.orientation(t)
    rates = motion.angular_velocity(t)       # (ȧ, ḃ, ċ) angle rates
    rates2 = motion.angular_acceleration(t)  # (ä, b̈, c̈)
    R = mo.rotation_matrix(ang)

    cz, sz = torch.cos(ang[2]), torch.sin(ang[2])
    cy, sy = torch.cos(ang[1]), torch.sin(ang[1])
    zero = torch.zeros_like(cz)
    # Columns of the Euler-rate map: the lab-frame axes the rates act about.
    ez = torch.stack([zero, zero, torch.ones_like(cz)])
    ey = torch.stack([-sz, cz, zero])                    # Rz·ŷ
    ex = torch.stack([cz * cy, sz * cy, -sy])            # Rz·Ry·x̂
    E = torch.stack([ex, ey, ez], dim=1)                 # (3 lab, 3 rates)
    omega_body = mo.matvec3(R.T, mo.matvec3(E, rates))
    # Euler-rate coupling Ė·rates, with Ėz = 0 and
    #   Ėy = ċ·(−cz, −sz, 0),  Ėx = ċ·(−sz·cy, cz·cy, 0) + ḃ·(−cz·sy,
    #   −sz·sy, −cy)  (chain rule on the columns above).
    da, db, dc = rates[0], rates[1], rates[2]
    edot_x = torch.stack([-sz * cy * dc - cz * sy * db,
                          cz * cy * dc - sz * sy * db,
                          -cy * db])
    edot_y = torch.stack([-cz * dc, -sz * dc, zero])
    coupling = da * edot_x + db * edot_y
    domega_body = mo.matvec3(R.T, mo.matvec3(E, rates2) + coupling)
    return omega_body, domega_body


def _cross_component(a, bx, by, bz, axis):
    """Component `axis` of a×b for a vector a (3,) and field components b."""
    if axis == 0:
        return a[1] * bz - a[2] * by
    if axis == 1:
        return a[2] * bx - a[0] * bz
    return a[0] * by - a[1] * bx


def rotational_acceleration(axis, coords, omega, domega, u_face, v_face,
                            w_face):
    """−dω×r − ω×(ω×r) − 2ω×u at the `axis` face set.

    `coords`: the broadcastable (X, Y, Z) of face_coordinates; u/v/w_face:
    all three velocity components interpolated to this face set."""
    X, Y, Z = coords
    wxr_x = omega[1] * Z - omega[2] * Y
    wxr_y = omega[2] * X - omega[0] * Z
    wxr_z = omega[0] * Y - omega[1] * X
    cent = _cross_component(omega, wxr_x, wxr_y, wxr_z, axis)
    eul = _cross_component(domega, X, Y, Z, axis)
    cor = 2.0 * _cross_component(omega, u_face, v_face, w_face, axis)
    return -(eul + cent + cor)
