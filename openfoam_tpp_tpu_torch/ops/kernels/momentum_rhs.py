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

`momentum_rhs_h` is the per-shard form of the x-sharded step (port of
momentum_rhs.py `momentum_rhs_h`): u and ρφ_x come packed to the slab's
cells (`u_p = u[:-1]` slab), `halos` = (ulo, uhi, vlo, vhi, wlo, whi,
rxlo, rxhi, rylo, rzlo, mulo, muhi, dulo) with u/v/w 2 planes and the
rest 1 (`dulo` None with `div_u`), and it returns (au packed to cells, av,
aw). It launches the halo instantiation of the same kernel
(`momentum_rhs_h.launches`). Its plain version puts the halo planes
around the slab (two more planes each way for every array, zeros where no
halo was exchanged) and runs `momentum_rhs_plain` on that block, keeping
the slab's faces: an output face reads u, v, w up to two planes away
(the MUSCL stencil of the flux at its far side), ρφ_x and μ one plane
each way, ρφ_y, ρφ_z and ∇·U one plane below, which the halos cover
exactly, and the block's own end rules (zero-padded end fluxes, edge
averages, clamps, the wall row) apply two planes from the slab, to dropped
outputs only. `out=` takes (au, av, aw) slab views to write into.
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
        vp, ci, cd = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.momentum_rhs_launch.argtypes = ([ci] + [vp] * 11 + [ci] * 3
                                            + [cd] * 3 + [vp])
        lib.momentum_rhs_launch.restype = ci
        lib.momentum_rhs_halo_launch.argtypes = ([ci] + [vp] * 12 + [ci] * 3
                                                 + [cd] * 3 + [vp])
        lib.momentum_rhs_halo_launch.restype = ci
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
    _build.check(rc, "momentum_rhs", *outs)
    momentum_rhs.launches += 1
    return tuple(outs)


def _halo_shapes(nx, ny, nz):
    """Shapes of momentum_rhs_h's 13 halo blocks."""
    u, v, w = (ny, nz), (ny + 1, nz), (ny, nz + 1)
    return ((2,) + u, (2,) + u, (2,) + v, (2,) + v, (2,) + w, (2,) + w,
            (1,) + u, (1,) + u, (1,) + v, (1,) + w, (1, ny, nz), (1, ny, nz),
            (1, ny, nz))


def momentum_rhs_h_plain(u_p, v, w, rpx_p, rpy, rpz, mu, div_u, halos,
                         spacing, dev2=True, out=None):
    ulo, uhi, vlo, vhi, wlo, whi, rxlo, rxhi, rylo, rzlo, mulo, muhi, dulo = \
        halos

    def ext(t, lo=None, hi=None, n_lo=2, n_hi=2):
        """t with `lo` and `hi` next to it, then zero planes to n_lo / n_hi."""
        z = lambda n: t.new_zeros((n,) + tuple(t.shape[1:]))
        lo = z(0) if lo is None else lo
        hi = z(0) if hi is None else hi
        return torch.cat([z(n_lo - lo.shape[0]), lo, t, hi,
                          z(n_hi - hi.shape[0])])

    # The extended block has nxl + 4 cells: u and ρφ_x get its nxl + 5
    # faces, one more zero plane on top.
    res = momentum_rhs_plain(
        ext(u_p, ulo, uhi, n_hi=3), ext(v, vlo, vhi), ext(w, wlo, whi),
        (ext(rpx_p, rxlo, rxhi, n_hi=3), ext(rpy, rylo), ext(rpz, rzlo)),
        ext(mu, mulo, muhi), None if div_u is None else ext(div_u, dulo),
        spacing, dev2)
    nxl = mu.shape[0]
    res = tuple(r[2:2 + nxl] for r in res)
    if out is None:
        return res
    for o, r in zip(out, res):
        o.copy_(r)
    return tuple(out)


def momentum_rhs_h(u_p, v, w, rpx_p, rpy, rpz, mu, div_u, halos, spacing,
                   dev2=True, out=None):
    """`momentum_rhs` on one shard's slab: (au packed to cells, av, aw)."""
    where = _build.route(mu, "momentum_rhs_h")
    nx, ny, nz = mu.shape
    faces = ((nx, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    with_div = div_u is not None
    if with_div != (halos[12] is not None):
        raise ValueError("momentum_rhs_h: div_u and its halo come together")
    _build.require_f32(
        "momentum_rhs_h", mu.device, *zip((u_p, v, w), faces),
        *zip((rpx_p, rpy, rpz), faces), (mu, mu.shape),
        *(((div_u, mu.shape),) if with_div else ()),
        *((h, s) for h, s in zip(halos, _halo_shapes(nx, ny, nz))
          if h is not None),
        *(zip(out, faces) if out is not None else ()))
    if where == "cpu":
        return momentum_rhs_h_plain(u_p, v, w, rpx_p, rpy, rpz, mu, div_u,
                                    halos, spacing, dev2, out)
    outs = (list(out) if out is not None
            else [torch.empty(s, dtype=mu.dtype, device=mu.device)
                  for s in faces])
    nul = ctypes.c_void_p(None)
    halo_ptrs = (ctypes.c_void_p * 13)(
        *(0 if h is None else h.data_ptr() for h in halos))
    rc = _lib().momentum_rhs_halo_launch(
        int(bool(dev2)), *(_build.ptr(t) for t in (u_p, v, w, rpx_p, rpy, rpz,
                                                   mu)),
        nul if div_u is None else _build.ptr(div_u),
        ctypes.cast(halo_ptrs, ctypes.c_void_p),
        *(_build.ptr(o) for o in outs), nx, ny, nz,
        *(float(h) for h in spacing), _build.stream_of(mu))
    _build.check(rc, "momentum_rhs_halo", *outs)
    momentum_rhs_h.launches += 1
    return tuple(outs)


momentum_rhs.launches = 0
momentum_rhs_h.launches = 0
