"""Fused momentum finish: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/mom_finish.py `momentum_finish`:
q* = (ρ_f^old·q + dt·vc)/ρ_f^new + dt·G, masked to zero where the
aperture is 0, for u, v and w in one pass (ρ_f the arithmetic face mean
of the cell densities). It follows the momentum right-hand side, whose x
component arrives cell-shaped; u's face-nx row (the sealed +x wall) comes
back as zeros. Valid only where the step adds nothing between the
density scaling and the mask: no rotating frame, no surface tension,
a uniform G.

`momentum_finish` launches csrc/mom_finish.cu for CUDA tensors and runs
`momentum_finish_plain` for CPU tensors; any other device raises. Both
check their operands first. `momentum_finish.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.solver import momentum as mom


def momentum_finish_plain(u, v, w, vc, rho_old, rho_new, ax, ay, az, dt, G):
    """The step's update from solver/momentum.py, u's face-nx row set to
    zero as the kernel writes it."""
    vcx = torch.cat([vc[0], torch.zeros_like(vc[0][:1])], 0)
    outs = mom.explicit_update((u, v, w), (vcx, vc[1], vc[2]), rho_old,
                               rho_new, (ax, ay, az), dt, G)
    outs[0][-1] = 0.0
    return tuple(outs)


def _lib():
    lib = _build.load("mom_finish")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mom_finish_launch.argtypes = [vp] * 16 + [ci] * 3 + [vp]
        lib.mom_finish_launch.restype = ci
        lib._typed = True
    return lib


def momentum_finish(u, v, w, vc, rho_old, rho_new, ax, ay, az, dt, G):
    """(u*, v*, w*) on the u, v, w face grids. `vc` = (au cell-shaped, av,
    aw); `dt` 0-d and `G` (3,), both on the device."""
    where = _build.route(rho_old, "momentum_finish")
    nx, ny, nz = rho_old.shape
    cells = (nx, ny, nz)
    faces = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    _build.require_f32(
        "momentum_finish", rho_old.device, *zip((u, v, w), faces),
        *zip(vc, (cells, *faces[1:])), (rho_old, cells), (rho_new, cells),
        *zip((ax, ay, az), faces), (dt, ()), (G, (3,)))
    if where == "cpu":
        return momentum_finish_plain(u, v, w, vc, rho_old, rho_new, ax, ay,
                                     az, dt, G)
    outs = [torch.empty(s, dtype=rho_old.dtype, device=rho_old.device)
            for s in faces]
    rc = _lib().mom_finish_launch(
        *(_build.ptr(t) for t in (dt, G, rho_old, rho_new, u, v, w, *vc,
                                  ax, ay, az, *outs)),
        nx, ny, nz, _build.stream_of(rho_old))
    _build.check(rc, "momentum_finish")
    momentum_finish.launches += 1
    return tuple(outs)


momentum_finish.launches = 0
