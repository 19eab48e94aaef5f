"""MULES flux construction: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/mules_flux.py `flux_all`: all six
(low, anti) × (x, y, z) alpha fluxes of one subcycle in one pass, in the
cell lower-face layout (entry [i, j, k] of the x set is the face between
cells i−1 and i; the global upper-boundary faces are implicit zeros).
Alpha is read at cells i−2 … i+1 along each axis with edge clamps.

`flux_all` launches csrc/mules_flux.cu for CUDA tensors and runs
`flux_all_plain` for CPU tensors; any other device raises. The plain
version computes in f32 and rounds the anti outputs once, like the
kernel. `flux_all.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flux_all_plain(alpha, phis, ucs, anti_dtype=None):
    a_dt = anti_dtype or alpha.dtype
    lows, antis = [], []
    for ax in range(3):
        am1 = st.shift_down(alpha, ax)
        am2 = st.shift_down(am1, ax)
        ap1 = st.shift_up(alpha, ax)
        d0, d1, d2 = am1 - am2, alpha - am1, ap1 - alpha
        fl = am1 + 0.5 * st.vanleer_limited(d0, d1)
        fr = alpha - 0.5 * st.vanleer_limited(d2, d1)
        phi = phis[ax]
        uc = ucs[ax].float()
        low = phi * torch.where(phi >= 0.0, am1, alpha)
        high = phi * torch.where(phi >= 0.0, fl, fr)
        ac = torch.where(uc >= 0.0, fl, fr)
        high = high + uc * ac * (1.0 - ac)
        lows.append(low)
        antis.append((high - low).to(a_dt))
    return tuple(lows), tuple(antis)


def _lib():
    lib = _build.load("mules_flux")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.mules_flux_launch.argtypes = [ci, ci] + [vp] * 13 + [ci] * 3 + [vp]
        lib.mules_flux_launch.restype = ci
        lib._typed = True
    return lib


def flux_all(alpha, phis, ucs, anti_dtype=None):
    """(lows, antis) tuples in the cell lower-face layout. `phis` f32,
    `ucs` f32 or bf16 (widened in the kernel), `anti_dtype` narrows the
    antidiffusive outputs (e.g. bf16); the low-order fluxes stay f32."""
    if alpha.device.type == "cpu":
        return flux_all_plain(alpha, phis, ucs, anti_dtype)
    if alpha.device.type != "cuda":
        raise ValueError(f"flux_all runs on CUDA (kernel) or CPU (plain "
                         f"version), not {alpha.device}")
    a_dt = anti_dtype or alpha.dtype
    uc_dt = ucs[0].dtype
    if (alpha.dim() != 3 or alpha.dtype != torch.float32
            or uc_dt not in _DTYPES or a_dt not in _DTYPES):
        raise ValueError("flux_all kernel: 3-D f32 alpha, f32/bf16 uc/anti")
    for t, dt in ((alpha, torch.float32), *((f, torch.float32) for f in phis),
                  *((u, uc_dt) for u in ucs)):
        if (t.shape != alpha.shape or t.dtype != dt or t.device != alpha.device
                or not t.is_contiguous()):
            raise ValueError("flux_all kernel operands must share alpha's "
                             "shape and device and be contiguous")
    outs = []
    for _ in range(3):
        outs.append(torch.empty_like(alpha))
        outs.append(torch.empty_like(alpha, dtype=a_dt))
    nx, ny, nz = alpha.shape
    rc = _lib().mules_flux_launch(
        _DTYPES[uc_dt], _DTYPES[a_dt], _build.ptr(alpha),
        *(_build.ptr(f) for f in phis), *(_build.ptr(u) for u in ucs),
        *(_build.ptr(o) for o in outs), nx, ny, nz, _build.stream_of(alpha))
    _build.check(rc, "mules_flux")
    flux_all.launches += 1
    lx, ax_, ly, ay_, lz, az_ = outs
    return (lx, ly, lz), (ax_, ay_, az_)


flux_all.launches = 0
