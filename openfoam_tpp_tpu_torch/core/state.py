"""Simulation state on the device (port of openfoam_tpp_tpu/core/state.py).

Initialization parity with the reference: alpha.water = 1 below H/2,
U = 0, p = 0. ``t`` and ``dt`` are 0-d device tensors so the adaptive
time step never needs a host round-trip.

``state_from_numpy`` / ``state_to_numpy`` (and ``params_from_numpy``)
carry a state across packages: they take the field names of the JAX
package's ``chk_t*.npz`` checkpoints (utils/io.py ``to_state``), so a
JAX state turned into numpy arrays drives the port from the identical
point.

A sweep's batched state has the same fields with the case axis trailing
the grid arrays, (nx, ny, nz, B), and ``t``, ``dt``, ``step`` and the
forcing parameters as (B,) tensors (parallel/sweep.py builds them); the
numpy crossings take either form as it is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties
from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import TankGeometry

_STATE_FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
_PARAM_FIELDS = ("orbit_radius", "omega", "ramp_time")


@dataclasses.dataclass
class CaseParams:
    """Per-case orbital forcing parameters as 0-d f32 device tensors
    ((B,) for a batch of cases)."""

    orbit_radius: torch.Tensor   # shaking radius R [m]
    omega: torch.Tensor          # angular frequency 2*pi*freq [rad/s]
    ramp_time: torch.Tensor      # soft-start duration [s]

    @staticmethod
    def make(R: float, freq: float, duration: float, ramp: float = -1.0,
             device="cuda") -> "CaseParams":
        dev = resolve_device(device)
        ramp_t = duration * 0.1 if ramp < 0 else ramp
        f32 = lambda v: torch.tensor(np.float32(v), device=dev)
        return CaseParams(orbit_radius=f32(R), omega=f32(2.0 * np.pi * freq),
                          ramp_time=f32(ramp_t))


@dataclasses.dataclass
class SimState:
    """Full solver state (MAC layout)."""

    alpha: torch.Tensor   # (nx, ny, nz)   water volume fraction
    u: torch.Tensor       # (nx+1, ny, nz) x-face velocity
    v: torch.Tensor       # (nx, ny+1, nz) y-face velocity
    w: torch.Tensor       # (nx, ny, nz+1) z-face velocity
    p: torch.Tensor       # (nx, ny, nz)   total pressure (gauge)
    t: torch.Tensor       # simulated time [s], 0-d
    dt: torch.Tensor      # current adaptive step [s], 0-d
    step: torch.Tensor    # step counter, 0-d int32


def init_state(geom: TankGeometry, fill_height: float | None = None,
               dt0: float = 1e-3, dtype=torch.float32,
               device="cuda") -> SimState:
    """Quiescent half-filled tank (setFields parity: water below H/2)."""
    dev = resolve_device(device)
    nx, ny, nz = geom.shape
    if fill_height is None:
        fill_height = geom.H / 2.0

    _, _, zc = geom.cell_centers()
    hz = geom.spacing[2]
    frac = np.clip((fill_height - (zc - hz / 2.0)) / hz, 0.0, 1.0)
    alpha = np.broadcast_to(frac[None, None, :], geom.shape).copy()
    alpha[~geom.fluid] = 0.0

    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    return SimState(
        alpha=torch.as_tensor(alpha.astype(np.float32), device=dev).to(dtype),
        u=z(nx + 1, ny, nz), v=z(nx, ny + 1, nz), w=z(nx, ny, nz + 1),
        p=z(nx, ny, nz),
        t=torch.tensor(0.0, dtype=dtype, device=dev),
        dt=torch.tensor(np.float32(dt0), dtype=dtype, device=dev),
        step=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def state_from_numpy(d, device="cuda") -> SimState:
    """SimState from a dict of numpy arrays with the checkpoint field
    names (alpha, u, v, w, p, t, dt, step)."""
    dev = resolve_device(device)
    f = {k: torch.as_tensor(np.array(d[k]), device=dev)
         for k in _STATE_FIELDS}
    return SimState(
        alpha=f["alpha"], u=f["u"], v=f["v"], w=f["w"], p=f["p"],
        t=f["t"].to(torch.float32), dt=f["dt"].to(torch.float32),
        step=f["step"].to(torch.int32))


def state_to_numpy(state: SimState) -> dict:
    """The inverse of state_from_numpy (host copies)."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in _STATE_FIELDS}


def params_from_numpy(d, device="cuda") -> CaseParams:
    """CaseParams from numpy scalars named like the JAX CaseParams fields."""
    dev = resolve_device(device)
    return CaseParams(**{
        k: torch.as_tensor(np.array(d[k], np.float32), device=dev)
        for k in _PARAM_FIELDS})


def mixture_density(alpha, props: PhysicalProperties):
    """rho = alpha*rho1 + (1-alpha)*rho2."""
    return alpha * props.rho1 + (1.0 - alpha) * props.rho2


def mixture_viscosity(alpha, props: PhysicalProperties):
    """mu = alpha*mu1 + (1-alpha)*mu2."""
    return alpha * props.mu1 + (1.0 - alpha) * props.mu2
