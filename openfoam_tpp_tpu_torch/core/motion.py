"""Tank motion → tank-frame forcing, on the device.

Port of openfoam_tpp_tpu/core/motion.py. The solver works in the tank
frame: pure translation is a uniform body force −a_frame(t) folded with
gravity into G(t) = g − a_frame(t). The orbit is x = r(t) cos ωt,
y = r(t) sin ωt with r soft-started by smootherstep over the ramp time.

`TableMotion` is the table-driven motion of the closed 6DoF tank (a
6DoF.dat of times, translations and xyz Euler angles): accelerations and
angle rates come from float64 finite differences on the host, the tables
live on the device in f32, and each lookup interpolates on the device
with `jnp.interp`'s formula, so a 0-d device time is never read on the
host. `motion_from_numpy` carries a JAX `TableMotion`'s arrays across.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from openfoam_tpp_tpu_torch.device import resolve_device


def smootherstep(tau):
    """6τ⁵ − 15τ⁴ + 10τ³, clamped to [0, 1]."""
    tau = torch.clamp(tau, 0.0, 1.0)
    return tau * tau * tau * (tau * (tau * 6.0 - 15.0) + 10.0)


def _smootherstep_d1(tau):
    tau = torch.clamp(tau, 0.0, 1.0)
    return 30.0 * tau * tau * (tau - 1.0) * (tau - 1.0)


def _smootherstep_d2(tau):
    tau = torch.clamp(tau, 0.0, 1.0)
    return 60.0 * tau * (2.0 * tau - 1.0) * (tau - 1.0)


def orbital_position(t, params):
    """Tank-origin position in the lab frame (x, y, z)."""
    tau = t / torch.clamp(params.ramp_time, min=1e-30)
    r = params.orbit_radius * smootherstep(tau)
    th = params.omega * t
    return torch.stack([r * torch.cos(th), r * torch.sin(th),
                        torch.zeros_like(r)])


def orbital_acceleration(t, params):
    """Analytic d²/dt² of the ramped orbit:
    x'' = (r'' − rω²)cosθ − 2 r'ω sinθ, and symmetrically for y."""
    Tr = torch.clamp(params.ramp_time, min=1e-30)
    tau = t / Tr
    R, om = params.orbit_radius, params.omega
    r = R * smootherstep(tau)
    r1 = R * _smootherstep_d1(tau) / Tr
    r2 = R * _smootherstep_d2(tau) / (Tr * Tr)
    th = om * t
    c, s = torch.cos(th), torch.sin(th)
    radial = r2 - r * om * om
    ax = radial * c - 2.0 * r1 * om * s
    ay = radial * s + 2.0 * r1 * om * c
    return torch.stack([ax, ay, torch.zeros_like(ax)])


def effective_gravity(t, params, g: float = 9.81):
    """G(t) = −g ẑ − a_frame(t): uniform body acceleration in the tank
    frame, shape (3,)."""
    a = orbital_acceleration(t, params)
    g_vec = torch.zeros_like(a)
    g_vec[2] = -g
    return g_vec - a


def fma(a, b, c):
    """a·b + c rounded once to f32 (the fused multiply-add XLA emits for a
    product feeding a sum): the product is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def interp(t, xp, fp):
    """`jnp.interp(t, xp, fp[:, c])` for every column c of `fp` (n, k), at
    a 0-d time `t`: the interval from searchsorted(side='right') clipped to
    [1, n−1], fp[i−1] + (δ/dx)·df with the last product and sum fused, as
    XLA evaluates it, and the end rows held beyond both ends. Returns
    (k,), with no host sync."""
    n = xp.shape[0]
    t = torch.as_tensor(t, dtype=xp.dtype, device=xp.device).reshape(1)
    i = torch.clamp(torch.searchsorted(xp, t, right=True), 1, n - 1)
    f0 = fp[i - 1][0]
    df = fp[i][0] - f0
    dx = xp[i] - xp[i - 1]
    delta = t - xp[i - 1]
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, f0, fma(delta / torch.where(dx0, 1.0, dx), df, f0))
    f = torch.where(t < xp[0], fp[0], f)
    return torch.where(t > xp[-1], fp[-1], f)


class TableMotion:
    """Prescribed motion from a sampled table (6DoF.dat-class input).

    `times` (n,), `accel` (n, 3) translational acceleration, `omega` and
    `domega` (n, 3) Euler-angle rates and their rates [rad/s, rad/s²],
    `rot` (n, 3) xyz Euler angles [rad]: f32 tensors on `device`.
    `has_rotation` is decided on the host when the object is built."""

    def __init__(self, times, accel, omega, domega, rot, device="cuda"):
        dev = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
        self.times, self.accel, self.omega = f32(times), f32(accel), f32(omega)
        self.domega, self.rot = f32(domega), f32(rot)
        self.has_rotation = bool(np.any(np.abs(np.asarray(rot, np.float32))
                                        > 1e-12))

    @staticmethod
    def from_table(times, trans, rot_deg, resample_dt: float | None = None,
                   device="cuda") -> "TableMotion":
        """Build from raw (t, translation, rotation-in-degrees) rows, the
        content of a 6DoF.dat file: optionally resampled every
        `resample_dt`, then second-order central differences (float64)."""
        t = np.asarray(times, np.float64)
        x = np.asarray(trans, np.float64)
        r = np.deg2rad(np.asarray(rot_deg, np.float64))
        if resample_dt is not None and len(t) > 1:
            tq = np.arange(t[0], t[-1] + resample_dt / 2, resample_dt)
            x = np.stack([np.interp(tq, t, x[:, i]) for i in range(3)], -1)
            r = np.stack([np.interp(tq, t, r[:, i]) for i in range(3)], -1)
            t = tq
        acc = np.gradient(np.gradient(x, t, axis=0), t, axis=0)
        om = np.gradient(r, t, axis=0)
        dom = np.gradient(om, t, axis=0)
        return TableMotion(t, acc, om, dom, r, device=device)

    def sha256(self) -> str:
        """Digest of the table's bits (times, accel, omega, domega, rot):
        equal digests, equal forcing."""
        h = hashlib.sha256()
        for t in (self.times, self.accel, self.omega, self.domega, self.rot):
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def acceleration(self, t):
        return interp(t, self.times, self.accel)

    def angular_velocity(self, t):
        return interp(t, self.times, self.omega)

    def angular_acceleration(self, t):
        return interp(t, self.times, self.domega)

    def orientation(self, t):
        return interp(t, self.times, self.rot)


def motion_from_numpy(times, accel, omega, domega, rot,
                      device="cuda") -> TableMotion:
    """TableMotion from numpy arrays named like the JAX TableMotion's
    fields (the tests build the port's motion from the JAX one's)."""
    return TableMotion(times, accel, omega, domega, rot, device=device)


def matmul3(a, b):
    """a @ b of two (3, 3) tensors as XLA's dot sums each entry: the first
    product, then a fused multiply-add for each further term."""
    acc = a[:, 0:1] * b[0:1, :]
    acc = fma(a[:, 1:2], b[1:2, :], acc)
    return fma(a[:, 2:3], b[2:3, :], acc)


def matvec3(a, v):
    """a @ v of a (3, 3) tensor and a (3,) vector, summed as `matmul3`."""
    return fma(a[:, 2], v[2], fma(a[:, 1], v[1], a[:, 0] * v[0]))


def rotation_matrix(angles):
    """Body←lab rotation R = Rz(rz)·Ry(ry)·Rx(rx) from xyz Euler angles,
    the composition OpenFOAM's `quaternion(XYZ, rot)` applies to the
    tank. Lab vectors transform into the tank frame with Rᵀ."""
    rx, ry, rz = angles[0], angles[1], angles[2]
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    one, zero = torch.ones_like(rx), torch.zeros_like(rx)
    m = lambda rows: torch.stack([torch.stack(r) for r in rows])
    Rx = m([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    Ry = m([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    Rz = m([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return matmul3(matmul3(Rz, Ry), Rx)
