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

`flux_all_h` is the per-shard form of the x-sharded step (port of
mules_flux.py `flux_all_h`): `h_lo` (2, ny, nz) and `h_hi` (1, ny, nz)
are alpha's exchanged x-planes −2, −1 and nxl. It launches the halo
instantiation of the same kernel (`flux_all_h.launches`); its plain
version puts the halo planes around the slab and runs `flux_all_plain`
on that block, keeping the slab's faces: an x-face reads alpha at cells
−2 … +1, which the halos cover exactly, so the block's own edge clamps
touch only the dropped halo faces. `out=` takes ((lx, ly, lz), (ax, ay,
az)) slab views of the island's outputs to write into.
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
        lib.mules_flux_halo_launch.argtypes = ([ci, ci] + [vp] * 15
                                               + [ci] * 3 + [vp])
        lib.mules_flux_halo_launch.restype = ci
        lib._typed = True
    return lib


def _check(alpha, phis, ucs, a_dt, *halos, out=None):
    uc_dt = ucs[0].dtype
    if (alpha.dim() != 3 or alpha.dtype != torch.float32
            or uc_dt not in _DTYPES or a_dt not in _DTYPES):
        raise ValueError("flux_all kernel: 3-D f32 alpha, f32/bf16 uc/anti")
    outs = () if out is None else tuple(zip(out[0], out[1]))
    for t, dt in ((alpha, torch.float32), *((f, torch.float32) for f in phis),
                  *((u, uc_dt) for u in ucs),
                  *((o, d) for lo_an in outs
                    for o, d in zip(lo_an, (torch.float32, a_dt)))):
        if (t.shape != alpha.shape or t.dtype != dt or t.device != alpha.device
                or not t.is_contiguous()):
            raise ValueError("flux_all kernel operands must share alpha's "
                             "shape and device and be contiguous")
    for h, w in zip(halos, (2, 1)):
        if (tuple(h.shape) != (w,) + tuple(alpha.shape[1:])
                or h.dtype != torch.float32 or h.device != alpha.device
                or not h.is_contiguous()):
            raise ValueError("flux_all halo kernel: h_lo (2, ny, nz) and "
                             "h_hi (1, ny, nz), contiguous f32")


def _outputs(alpha, a_dt, out):
    if out is not None:
        (lx, ly, lz), (ax_, ay_, az_) = out
        return [lx, ax_, ly, ay_, lz, az_]
    outs = []
    for _ in range(3):
        outs.append(torch.empty_like(alpha))
        outs.append(torch.empty_like(alpha, dtype=a_dt))
    return outs


def flux_all(alpha, phis, ucs, anti_dtype=None):
    """(lows, antis) tuples in the cell lower-face layout. `phis` f32,
    `ucs` f32 or bf16 (widened in the kernel), `anti_dtype` narrows the
    antidiffusive outputs (e.g. bf16); the low-order fluxes stay f32."""
    if _build.route(alpha, "flux_all") == "cpu":
        return flux_all_plain(alpha, phis, ucs, anti_dtype)
    a_dt = anti_dtype or alpha.dtype
    _check(alpha, phis, ucs, a_dt)
    outs = _outputs(alpha, a_dt, None)
    nx, ny, nz = alpha.shape
    rc = _lib().mules_flux_launch(
        _DTYPES[ucs[0].dtype], _DTYPES[a_dt], _build.ptr(alpha),
        *(_build.ptr(f) for f in phis), *(_build.ptr(u) for u in ucs),
        *(_build.ptr(o) for o in outs), nx, ny, nz, _build.stream_of(alpha))
    _build.check(rc, "mules_flux", *outs)
    flux_all.launches += 1
    lx, ax_, ly, ay_, lz, az_ = outs
    return (lx, ly, lz), (ax_, ay_, az_)


def flux_all_h_plain(alpha, h_lo, h_hi, phis, ucs, anti_dtype=None,
                     out=None):
    ext = lambda t: torch.cat([t.new_zeros((2,) + tuple(t.shape[1:])), t,
                               t.new_zeros((1,) + tuple(t.shape[1:]))])
    lows, antis = flux_all_plain(torch.cat([h_lo, alpha, h_hi]),
                                 tuple(ext(f) for f in phis),
                                 tuple(ext(u) for u in ucs), anti_dtype)
    lows = tuple(f[2:-1] for f in lows)
    antis = tuple(f[2:-1] for f in antis)
    if out is None:
        return lows, antis
    for o, r in zip((*out[0], *out[1]), (*lows, *antis)):
        o.copy_(r)
    return out


def flux_all_h(alpha, h_lo, h_hi, phis, ucs, anti_dtype=None, out=None):
    """`flux_all` on one shard's slab, with alpha's exchanged halo planes
    `h_lo` (x = −2, −1) and `h_hi` (x = nxl)."""
    if _build.route(alpha, "flux_all_h") == "cpu":
        return flux_all_h_plain(alpha, h_lo, h_hi, phis, ucs, anti_dtype, out)
    a_dt = anti_dtype or alpha.dtype
    _check(alpha, phis, ucs, a_dt, h_lo, h_hi, out=out)
    outs = _outputs(alpha, a_dt, out)
    nx, ny, nz = alpha.shape
    rc = _lib().mules_flux_halo_launch(
        _DTYPES[ucs[0].dtype], _DTYPES[a_dt], _build.ptr(alpha),
        _build.ptr(h_lo), _build.ptr(h_hi), *(_build.ptr(f) for f in phis),
        *(_build.ptr(u) for u in ucs), *(_build.ptr(o) for o in outs),
        nx, ny, nz, _build.stream_of(alpha))
    _build.check(rc, "mules_flux_halo", *outs)
    flux_all_h.launches += 1
    lx, ax_, ly, ay_, lz, az_ = outs
    return (lx, ly, lz), (ax_, ay_, az_)


flux_all.launches = 0
flux_all_h.launches = 0
