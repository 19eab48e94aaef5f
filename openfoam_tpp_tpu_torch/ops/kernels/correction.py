"""Fused projection epilogue: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/correction.py `correct_divmax`: after
the pressure solve, the MAC velocities are corrected with the operator's
gradient, q_c = (q − dt·β_f·∂dp/∂n)·[aperture > 0], w's open-top faces
get the half-cell Dirichlet term, and the divergence error
max|∇·(A·q_c)| over the fluid cells is taken, all in one pass. u's
face-nx row (the sealed +x wall) comes back as zeros.

`correct_divmax` launches csrc/correction.cu for CUDA tensors and runs
`correct_divmax_plain` for CPU tensors; any other device raises. Both
check their operands first. `correct_divmax.launches` counts kernel
launches. `correct_velocities_plain` is the correction alone, which the
step runs on every corrector but the last.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import _build


def correct_velocities_plain(dp, u_s, v_s, w_s, beta_f, ax, ay, az, top_open,
                             rho, dt, spacing, open_top=True):
    """The step's correction lines: velocities only. `rho` is the new cell
    density; only its top plane is read, for the open-top faces."""
    hx, hy, hz = spacing
    u_c = u_s - dt * beta_f[0] * st.gradient_at_faces(dp, 0, hx)
    v_c = v_s - dt * beta_f[1] * st.gradient_at_faces(dp, 1, hy)
    w_c = w_s - dt * beta_f[2] * st.gradient_at_faces(dp, 2, hz)
    if open_top:
        beta_top = torch.where(top_open > 0, 1.0 / rho[:, :, -1], 0.0)
        w_c[:, :, -1] = (w_c[:, :, -1]
                         + dt * beta_top * 2.0 * dp[:, :, -1] / hz)
    return (torch.where(ax > 0.0, u_c, 0.0), torch.where(ay > 0.0, v_c, 0.0),
            torch.where(az > 0.0, w_c, 0.0))


def div_max_plain(u_c, v_c, w_c, ax, ay, az, vfrac, spacing):
    """max|∇·(A·q)| over the fluid cells, a 0-d tensor."""
    return (torch.abs(st.divergence(ax * u_c, ay * v_c, az * w_c, spacing))
            * (vfrac > 0.0)).max()


def correct_divmax_plain(dp, u_s, v_s, w_s, beta_f, ax, ay, az, vfrac,
                         top_open, rho, dt, spacing, open_top=True):
    u_c, v_c, w_c = correct_velocities_plain(dp, u_s, v_s, w_s, beta_f, ax,
                                             ay, az, top_open, rho, dt,
                                             spacing, open_top)
    div_max = div_max_plain(u_c, v_c, w_c, ax, ay, az, vfrac, spacing)
    u_c[-1] = 0.0   # written as zeros, after the divergence, as the kernel does
    return u_c, v_c, w_c, div_max


def _lib():
    lib = _build.load("correction")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.correction_launch.argtypes = ([ci] + [vp] * 19 + [ci] * 3
                                          + [cf] * 3 + [vp])
        lib.correction_launch.restype = ci
        lib.correction_num_partials.argtypes = [ci] * 3
        lib.correction_num_partials.restype = ci
        lib._typed = True
    return lib


def correct_divmax(dp, u_s, v_s, w_s, beta_f, ax, ay, az, vfrac, top_open,
                   rho, dt, spacing, open_top=True):
    """(u_c, v_c, w_c, div_max). `rho` is the new cell density (its top
    plane is read); `top_open` the (nx, ny) atmosphere aperture, read only
    with `open_top`; `dt` a 0-d tensor on the device; div_max a 0-d
    tensor."""
    where = _build.route(dp, "correct_divmax")
    nx, ny, nz = dp.shape
    cells = (nx, ny, nz)
    faces = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    _build.require_f32(
        "correct_divmax", dp.device, (dp, cells), *zip((u_s, v_s, w_s), faces),
        *zip(beta_f, faces), *zip((ax, ay, az), faces), (vfrac, cells),
        (rho, cells), (dt, ()), *(((top_open, (nx, ny)),) if open_top else ()))
    if where == "cpu":
        return correct_divmax_plain(dp, u_s, v_s, w_s, beta_f, ax, ay, az,
                                    vfrac, top_open, rho, dt, spacing,
                                    open_top)
    lib = _lib()
    outs = [torch.empty(s, dtype=dp.dtype, device=dp.device) for s in faces]
    partial = torch.empty(lib.correction_num_partials(nx, ny, nz),
                          dtype=torch.float32, device=dp.device)
    div_max = torch.empty((), dtype=torch.float32, device=dp.device)
    topo = _build.ptr(top_open) if open_top else ctypes.c_void_p(None)
    rc = lib.correction_launch(
        int(bool(open_top)), _build.ptr(dt), _build.ptr(dp),
        *(_build.ptr(t) for t in (u_s, v_s, w_s, *beta_f, ax, ay, az, vfrac)),
        topo, _build.ptr(rho), *(_build.ptr(o) for o in outs),
        _build.ptr(partial), _build.ptr(div_max), nx, ny, nz,
        *(float(h) for h in spacing), _build.stream_of(dp))
    _build.check(rc, "correct_divmax")
    correct_divmax.launches += 1
    return (*outs, div_max)


correct_divmax.launches = 0
