"""Fused momentum right-hand side: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/momentum_rhs.py `momentum_rhs`:
visc [+ dev2] − conv for all three MAC velocity components in one pass
(van Leer MUSCL convection by the mass flux ρφ, the variable-μ
Laplacian, and the dev2 transpose stress with its −(2/3)μ∇·U term). It
takes and returns the full face arrays; u's face-nx row (the sealed +x
wall) comes back as zeros, written by the kernel itself.

`momentum_rhs` launches csrc/momentum_rhs.cu for CUDA tensors and runs
`momentum_rhs_plain` for CPU tensors; any other device raises. Both check
their operands first. `momentum_rhs.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.solver import momentum as mom


def momentum_rhs_plain(u, v, w, rho_phi, mu, div_u, spacing, dev2=True):
    """The step's assembly from solver/momentum.py, with u's face-nx row
    set to zero as the kernel writes it."""
    outs = mom.explicit_rhs((u, v, w), rho_phi, mu, div_u, spacing, dev2)
    outs[0][-1] = 0.0
    return tuple(outs)


def _lib():
    lib = _build.load("momentum_rhs")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.momentum_rhs_launch.argtypes = ([ci] + [vp] * 11 + [ci] * 3
                                            + [cf] * 3 + [vp])
        lib.momentum_rhs_launch.restype = ci
        lib._typed = True
    return lib


def momentum_rhs(u, v, w, rho_phi, mu, div_u, spacing, dev2=True):
    """(au, av, aw) on the u, v, w face grids. `div_u` (cells) may be
    None: then dev2 has no −(2/3)∇·U term."""
    where = _build.route(mu, "momentum_rhs")
    nx, ny, nz = mu.shape
    faces = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    _build.require_f32("momentum_rhs", mu.device, *zip((u, v, w), faces),
                       *zip(rho_phi, faces), (mu, mu.shape),
                       *(() if div_u is None else ((div_u, mu.shape),)))
    if where == "cpu":
        return momentum_rhs_plain(u, v, w, rho_phi, mu, div_u, spacing, dev2)
    outs = [torch.empty(s, dtype=mu.dtype, device=mu.device) for s in faces]
    nul = ctypes.c_void_p(None)
    rc = _lib().momentum_rhs_launch(
        int(bool(dev2)), *(_build.ptr(t) for t in (u, v, w, *rho_phi, mu)),
        nul if div_u is None else _build.ptr(div_u),
        *(_build.ptr(o) for o in outs), nx, ny, nz,
        *(float(h) for h in spacing), _build.stream_of(mu))
    _build.check(rc, "momentum_rhs")
    momentum_rhs.launches += 1
    return tuple(outs)


momentum_rhs.launches = 0
