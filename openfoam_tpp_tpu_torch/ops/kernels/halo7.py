"""Halo-plane variants of the 7-point family, for per-shard execution in
the x-sharded step (parallel/spmd.py): CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/halo7.py (`apply_7pt_h`,
`resid_scaled_7pt_h`, `apply_dot_7pt_h`). The single-grid kernels read
p's x-neighbour planes edge-clamped, which is right at the global ends
because domain-boundary faces carry zero weight. Per shard, the planes
beyond the slab belong to the neighbour shards: `h_lo` / `h_hi` are p's
exchanged ±1 planes, and `wx_hi` is the next shard's first face-lite wxl
plane (zero at the global end: the sealed wall's boundary-face weight),
which gives the slab's last high-x face term wx_hi·h_hi. At the global
ends the island fills the halos with the clamp planes, which reproduces
the single-grid result bitwise.

Each entry point launches the halo instantiation of
csrc/seven_point.cu (the same per-cell code as the single-grid kernels,
with the x-neighbour loads taken from the halo planes outside the slab)
for CUDA tensors and runs its plain version (`*_plain`) for CPU tensors;
any other device raises. The plain version puts the halo planes in front
of and behind the slab and runs the single-grid plain function on that
extended block: the stencil reaches one plane each way, the halos are
one plane wide, so every cell of the slab sees exactly its true
neighbours (the extended block's own edge clamps only touch the halo
planes' outputs, which are dropped). Weights of the extended planes that
no kept output reads are zero.

`out=` (optional) takes a contiguous tensor of p's shape and dtype, a
slab view of the island's global output, and the result is written into
it. `resid_scaled_7pt_h(..., chained=True)` launches its kernel as a
programmatic dependent of the launch before it on the stream (the
island's launch for the shard before): its blocks may start while that
launch drains, and it completes only after it. Each entry point counts
its kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.ops.stencil import sum_cells

_RESID_CHAINED = 3   # the C entry's mode for a chained resid launch


def _extend(p, h_lo, h_hi, wx_hi, split, *extra, fill=0.0):
    """The slab with its halo planes in front and behind: (p, split,
    *extra) on nxl + 2 planes. `extra` cell arrays get `fill` planes."""
    z = torch.zeros_like(p[:1])
    wx, wy, wz = split
    f = torch.full_like(p[:1], fill)
    return (torch.cat([h_lo, p, h_hi]),
            (torch.cat([z, wx, wx_hi]), torch.cat([z, wy, z]),
             torch.cat([z, wz, z])),
            *(None if e is None else torch.cat([f, e, f]) for e in extra))


def _give(res, out):
    if out is None:
        return res
    out.copy_(res)
    return out


def apply_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, diag=None, out=None):
    pe, se, de = _extend(p, h_lo, h_hi, wx_hi, split, diag, fill=1.0)
    return _give(sp.apply_7pt_plain(pe, se, de)[1:-1], out)


def resid_scaled_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, b, diag=None,
                             out=None):
    pe, se, be, de = _extend(p, h_lo, h_hi, wx_hi, split, b, diag, fill=1.0)
    return _give(sp.resid_scaled_7pt_plain(pe, se, de, be)[1:-1], out)


def apply_dot_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, out=None, acc=None):
    pe, se = _extend(p, h_lo, h_hi, wx_hi, split)
    ap = _give(sp.apply_7pt_plain(pe, se)[1:-1], out)
    dot = sum_cells(p.float() * ap.float())
    return ap, dot if acc is None else acc + dot


# ------------------------------------------------------------------ kernels

def _check(p, h_lo, h_hi, wx_hi, split, *extra, out=None):
    sp._check(p, split, *extra, out)
    plane = (1,) + tuple(p.shape[1:])
    for h in (h_lo, h_hi, wx_hi):
        if (tuple(h.shape) != plane or h.dtype != p.dtype
                or h.device != p.device or not h.is_contiguous()):
            raise ValueError(f"7-point halo kernel: halo planes must be "
                             f"contiguous {p.dtype} {plane} on {p.device}")


def _lib():
    lib = sp._lib()
    if not getattr(lib, "_halo_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seven_point_halo_launch.argtypes = ([ci, ci, ci] + [vp] * 14
                                                + [ci] * 3 + [vp])
        lib.seven_point_halo_launch.restype = ci
        lib._halo_typed = True
    return lib


def _launch(mode, p, h_lo, h_hi, wx_hi, split, diag=None, b=None, out=None,
            acc=None):
    lib = _lib()
    out = torch.empty_like(p) if out is None else out
    partial = dot = ticket = None
    if mode == sp._APPLY_DOT:
        partial, dot, ticket = sp._dot_scratch(lib, p)
    nul = ctypes.c_void_p(None)
    opt = lambda t: nul if t is None else _build.ptr(t)
    rc = lib.seven_point_halo_launch(
        mode, sp._DTYPES[p.dtype], int(diag is not None), _build.ptr(p),
        *(_build.ptr(h) for h in (h_lo, h_hi, wx_hi)),
        *(_build.ptr(w) for w in split), opt(diag), opt(b), _build.ptr(out),
        opt(partial), opt(dot), opt(ticket), opt(acc), *p.shape,
        _build.stream_of(p))
    _build.check(rc, "seven_point_halo", out, dot)
    return out, dot


def apply_7pt_h(p, h_lo, h_hi, wx_hi, split, diag=None, out=None):
    """A(p) on one shard; `h_lo`/`h_hi` p's exchanged ±1 x-planes,
    `wx_hi` the next shard's first wxl plane (zero at the global end)."""
    if _build.route(p, "apply_7pt_h") == "cpu":
        return apply_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, diag, out)
    _check(p, h_lo, h_hi, wx_hi, split, diag, out=out)
    res, _ = _launch(sp._APPLY, p, h_lo, h_hi, wx_hi, split, diag=diag,
                     out=out)
    apply_7pt_h.launches += 1
    return res


def resid_scaled_7pt_h(p, h_lo, h_hi, wx_hi, split, b, diag=None, out=None,
                       chained=False):
    """(b − A·p)/diag (b − Â·p with `diag=None`) on one shard.
    `chained`: this call comes right after the island's resid launch for
    the shard before it, on the same stream, and reads nothing that launch
    writes; the kernel is then launched as its programmatic dependent (it
    may start while that launch drains, and completes only after it), so
    the island is complete when its last launch is."""
    if _build.route(p, "resid_scaled_7pt_h") == "cpu":
        return resid_scaled_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, b, diag,
                                        out)
    _check(p, h_lo, h_hi, wx_hi, split, diag, b, out=out)
    res, _ = _launch(_RESID_CHAINED if chained else sp._RESID, p, h_lo, h_hi,
                     wx_hi, split, diag=diag, b=b, out=out)
    resid_scaled_7pt_h.launches += 1
    return res


def apply_dot_7pt_h(p, h_lo, h_hi, wx_hi, split, out=None, acc=None):
    """(Â·p, `acc` plus this shard's p·Â·p as a 0-d f32 tensor). `acc`
    (optional, a 0-d f32 tensor on p's device) is the dot of the shards
    before this one: the kernel adds this shard's planes to it in the
    order the single-grid kernel adds them, so the island's chain over
    the shards gives the single-grid dot bitwise."""
    if _build.route(p, "apply_dot_7pt_h") == "cpu":
        return apply_dot_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, out, acc)
    _check(p, h_lo, h_hi, wx_hi, split, out=out)
    if acc is not None and (acc.shape != () or acc.dtype != torch.float32
                            or acc.device != p.device):
        raise ValueError("apply_dot_7pt_h: acc must be a 0-d f32 tensor on "
                         f"{p.device}")
    res, dot = _launch(sp._APPLY_DOT, p, h_lo, h_hi, wx_hi, split, out=out,
                       acc=acc)
    apply_dot_7pt_h.launches += 1
    return res, dot


for _fn in (apply_7pt_h, resid_scaled_7pt_h, apply_dot_7pt_h):
    _fn.launches = 0
