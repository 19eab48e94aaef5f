"""One Zalesak/FCT limiter iteration: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/mules_fct.py `fct_iter`. All arrays
are cell-shaped; face quantities use the cell lower-face layout with the
upper-boundary faces implicit zeros. λ and anti may be bf16 (the default
FCT streams); all arithmetic is f32 and λ is rounded once on output.

`fct_iter` launches csrc/mules_fct.cu for CUDA tensors and runs
`fct_iter_plain` for CPU tensors; any other device raises.
`fct_iter.launches` counts kernel launches.

`fct_iter_h` is the per-shard form of the x-sharded step (port of
mules_fct.py `fct_iter_h`, with its halo layout): `lam_halos` and
`anti_halos` are per axis (lo, hi) exchanged planes, hi only for x
((lo, None) for y and z: their upper faces lie in the slab);
`cell_lo_halos` the −1 planes of (alpha_low, amax, amin, dt_iv). It
launches the halo instantiation of the same kernel
(`fct_iter_h.launches`). Its plain version puts the halo planes around
the slab (the planes above it that no kept output reads are zero) and
runs `fct_iter_plain` on that block, keeping the slab: λ' of a slab face
needs R± of the cells on both sides of it, which read the faces of those
cells and the cells' values, so one plane each way covers it, and the
block's own edge treatment only touches the dropped halo planes. `out=`
takes three slab views of the island's λ outputs to write into.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _hi(f, axis):
    """Upper face of each cell: the next cell's lower face, zero past the
    domain end."""
    sl = st._sl
    return torch.cat([f[sl(axis, slice(1, None))],
                      torch.zeros_like(f[sl(axis, slice(0, 1))])], dim=axis)


def _rpm(hx, hy, hz, eps, lo, hi, al, amax, amin, dv):
    """(R+, R−) per cell from its lower/upper (λ, anti) faces per axis
    (tuples of three (lam, anti) pairs each) — the kernel's `rpm`."""
    (lxl, axl), (lyl, ayl), (lzl, azl) = lo
    (lxh, axh), (lyh, ayh), (lzh, azh) = hi
    appl = (lxh * axh - lxl * axl) / hx
    appl = appl + (lyh * ayh - lyl * ayl) / hy
    appl = appl + (lzh * azh - lzl * azl) / hz
    work = al - dv * appl
    rxl, rxh = (1.0 - lxl) * axl, (1.0 - lxh) * axh
    ryl, ryh = (1.0 - lyl) * ayl, (1.0 - lyh) * ayh
    rzl, rzh = (1.0 - lzl) * azl, (1.0 - lzh) * azh
    pos = lambda v: torch.clamp(v, min=0.0)
    neg = lambda v: torch.clamp(v, max=0.0)
    p_in = (pos(rxl) - neg(rxh)) / hx
    p_in = p_in + (pos(ryl) - neg(ryh)) / hy
    p_in = p_in + (pos(rzl) - neg(rzh)) / hz
    p_out = (pos(rxh) - neg(rxl)) / hx
    p_out = p_out + (pos(ryh) - neg(ryl)) / hy
    p_out = p_out + (pos(rzh) - neg(rzl)) / hz
    rp = torch.clamp((amax - work) / (dv * p_in + eps), 0.0, 1.0)
    rm = torch.clamp((work - amin) / (dv * p_out + eps), 0.0, 1.0)
    return rp, rm


def fct_iter_plain(lams, antis, alpha_low, amax, amin, dt_iv, spacing,
                   eps=1e-12):
    hx, hy, hz = spacing
    lam = tuple(l.float() for l in lams)
    ant = tuple(a.float() for a in antis)
    lo = tuple(zip(lam, ant))
    hi = tuple((_hi(l, ax), _hi(a, ax))
               for ax, (l, a) in enumerate(zip(lam, ant)))
    rp, rm = _rpm(hx, hy, hz, eps, lo, hi, alpha_low, amax, amin, dt_iv)
    # Lower x neighbour of plane 0: the clamped halo cell (plane 0's data
    # with its lower x face standing in for its upper one).
    p0 = lambda t: t[:1]
    g_lo = tuple((p0(l), p0(a)) for l, a in lo)
    g_hi = (g_lo[0],) + tuple((p0(l), p0(a)) for l, a in hi[1:])
    gp, gm = _rpm(hx, hy, hz, eps, g_lo, g_hi, p0(alpha_low), p0(amax),
                  p0(amin), p0(dt_iv))
    left = (
        (torch.cat([gp, rp[:-1]], 0), torch.cat([gm, rm[:-1]], 0)),
        (st.shift_down(rp, 1), st.shift_down(rm, 1)),
        (st.shift_down(rp, 2), st.shift_down(rm, 2)),
    )
    out = []
    for ax in range(3):
        l, a = lo[ax]
        lp, lm = left[ax]
        rem = (1.0 - l) * a
        c = torch.where(rem >= 0.0, torch.minimum(lm, rp),
                        torch.minimum(lp, rm))
        out.append(torch.clamp(l + (1.0 - l) * c, 0.0, 1.0).to(lams[ax].dtype))
    return tuple(out)


def _lib():
    lib = _build.load("mules_fct")
    if not getattr(lib, "_typed", False):
        vp, ci, cf, cd = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_double)
        lib.mules_fct_launch.argtypes = ([ci] + [vp] * 13 + [ci] * 3
                                         + [cd] * 3 + [cf, vp])
        lib.mules_fct_launch.restype = ci
        lib.mules_fct_halo_launch.argtypes = ([ci] + [vp] * 14 + [ci] * 3
                                              + [cd] * 3 + [cf, vp])
        lib.mules_fct_halo_launch.restype = ci
        lib._typed = True
    return lib


def _check(lams, antis, alpha_low, amax, amin, dt_iv, halos=(), out=None):
    f_dt = lams[0].dtype
    if alpha_low.dim() != 3 or f_dt not in _DTYPES:
        raise ValueError("fct_iter kernel: 3-D grid, f32/bf16 λ and anti")
    plane = (1,) + tuple(alpha_low.shape[1:])
    for t, dt, shape in (
            *((f, f_dt, alpha_low.shape)
              for f in (*lams, *antis, *(out or ()))),
            *((c, torch.float32, alpha_low.shape)
              for c in (alpha_low, amax, amin, dt_iv)),
            *((h, f_dt if n < 8 else torch.float32, plane)
              for n, h in enumerate(halos))):
        if (t.shape != shape or t.dtype != dt
                or t.device != alpha_low.device or not t.is_contiguous()):
            raise ValueError("fct_iter kernel operands must share alpha_low's "
                             "shape (halo planes: one plane of it) and device, "
                             "be contiguous, λ/anti one dtype and cell arrays "
                             "f32")


def fct_iter(lams, antis, alpha_low, amax, amin, dt_iv, spacing, eps=1e-12):
    """One limiter iteration: cell-layout (λx, λy, λz) → updated tuple."""
    if _build.route(alpha_low, "fct_iter") == "cpu":
        return fct_iter_plain(lams, antis, alpha_low, amax, amin, dt_iv,
                              spacing, eps)
    _check(lams, antis, alpha_low, amax, amin, dt_iv)
    outs = [torch.empty_like(lams[0]) for _ in range(3)]
    nx, ny, nz = alpha_low.shape
    hx, hy, hz = (float(h) for h in spacing)
    rc = _lib().mules_fct_launch(
        _DTYPES[lams[0].dtype], *(_build.ptr(f) for f in (*lams, *antis)),
        *(_build.ptr(c) for c in (alpha_low, amax, amin, dt_iv)),
        *(_build.ptr(o) for o in outs), nx, ny, nz, hx, hy, hz, float(eps),
        _build.stream_of(alpha_low))
    _build.check(rc, "mules_fct", *outs)
    fct_iter.launches += 1
    return tuple(outs)


def _halo_planes(lam_halos, anti_halos, cell_lo_halos):
    """The kernel's 12 halo planes in its order: λ and anti lo planes of
    x, y, z, the λ and anti x hi planes, the four cell lo planes."""
    return ([h[0] for h in lam_halos] + [h[0] for h in anti_halos]
            + [lam_halos[0][1], anti_halos[0][1]] + list(cell_lo_halos))


def fct_iter_h_plain(lams, lam_halos, antis, anti_halos, cell_lo_halos,
                     alpha_low, amax, amin, dt_iv, spacing, eps=1e-12,
                     out=None):
    def ext(t, lo, hi=None):
        return torch.cat([lo, t, torch.zeros_like(t[:1]) if hi is None
                          else hi])

    res = fct_iter_plain(
        tuple(ext(l, *h) for l, h in zip(lams, lam_halos)),
        tuple(ext(a, *h) for a, h in zip(antis, anti_halos)),
        *(ext(c, h) for c, h in zip((alpha_low, amax, amin, dt_iv),
                                    cell_lo_halos)), spacing, eps)
    res = tuple(r[1:-1] for r in res)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def fct_iter_h(lams, lam_halos, antis, anti_halos, cell_lo_halos, alpha_low,
               amax, amin, dt_iv, spacing, eps=1e-12, out=None):
    """One limiter iteration on one shard's slab, with the exchanged halo
    planes (global edges: lo clamp, x hi zero, carried by the halos)."""
    if _build.route(alpha_low, "fct_iter_h") == "cpu":
        return fct_iter_h_plain(lams, lam_halos, antis, anti_halos,
                                cell_lo_halos, alpha_low, amax, amin, dt_iv,
                                spacing, eps, out)
    halos = _halo_planes(lam_halos, anti_halos, cell_lo_halos)
    _check(lams, antis, alpha_low, amax, amin, dt_iv, halos, out)
    outs = ([torch.empty_like(lams[0]) for _ in range(3)] if out is None
            else list(out))
    nx, ny, nz = alpha_low.shape
    hx, hy, hz = (float(h) for h in spacing)
    halo_ptrs = (ctypes.c_void_p * len(halos))(*(h.data_ptr() for h in halos))
    rc = _lib().mules_fct_halo_launch(
        _DTYPES[lams[0].dtype], *(_build.ptr(f) for f in (*lams, *antis)),
        *(_build.ptr(c) for c in (alpha_low, amax, amin, dt_iv)),
        ctypes.cast(halo_ptrs, ctypes.c_void_p),
        *(_build.ptr(o) for o in outs), nx, ny, nz, hx, hy, hz, float(eps),
        _build.stream_of(alpha_low))
    _build.check(rc, "mules_fct_halo", *outs)
    fct_iter_h.launches += 1
    return tuple(outs)


fct_iter.launches = 0
fct_iter_h.launches = 0
