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

Each entry point launches the halo form of csrc/seven_point.cu (the
single-grid kernels' per-cell arithmetic, with the x-neighbour loads
taken from the halo planes outside the slab) for CUDA tensors and
runs its plain version (`*_plain`) for CPU tensors; any other device
raises. The plain version puts the halo planes in front of and behind
the slab and runs the single-grid plain function on that extended
block: the stencil reaches one plane each way, the halos are one plane
wide, so every cell of the slab sees exactly its true neighbours (the
extended block's own edge clamps only touch the halo planes' outputs,
which are dropped). Weights of the extended planes that no kept output
reads are zero.

The island entry points `apply_7pt_hs` and `resid_scaled_7pt_hs` take
every slab an island holds (at most MAX_SLABS, all one shape, dtype and
device), each with its own halo planes, as parallel lists, and launch
one kernel over all of them: the shards run together, as the TPU mesh
runs them. `apply_7pt_h` and `resid_scaled_7pt_h` are that launch with a
table of one slab, the form a process holding one shard launches. The
island's plain versions run the per-shard plain functions slab by slab.

`apply_dot_7pt_h` takes a row window `rows=(y0, y1)`: only the cells of
y rows y0 … y1 − 1 enter its dot (Â·p is computed on every row). A rank
of the 2-D x·y decomposition runs it on its block extended by its y
neighbours' rows and passes its own; `rows=None` is the full window
(0, ny), the single grid's and the 1-D decomposition's, bitwise what the
entry point computed before it had a window.

`out=` (`outs=`, one per slab) optionally takes contiguous tensors of
p's shape and dtype, slab views of the island's global output, and the
result is written into them. Each entry point counts its kernel
launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.ops.stencil import sum_cells

# Slabs one island launch takes at most: csrc/seven_point.cu kMaxSlabs
# (`seven_point_max_slabs()`).
MAX_SLABS = 16


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


def window(rows, ny: int):
    """(y0, y1) of a row window, `None` the full one (0, ny); raises
    outside 0 <= y0 <= y1 <= ny."""
    y0, y1 = (0, ny) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= y0 <= y1 <= ny:
        raise ValueError(f"row window {rows} outside the block's {ny} rows")
    return y0, y1


def apply_dot_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, out=None, acc=None,
                          rows=None):
    y0, y1 = window(rows, p.shape[1])
    pe, se = _extend(p, h_lo, h_hi, wx_hi, split)
    ap = _give(sp.apply_7pt_plain(pe, se)[1:-1], out)
    prod = p.float() * ap.float()
    if (y0, y1) != (0, p.shape[1]):
        prod = prod[:, y0:y1]
    dot = sum_cells(prod)
    return ap, dot if acc is None else acc + dot


def _each(ts, n):
    return [None] * n if ts is None else ts


def apply_7pt_hs_plain(ps, h_los, h_his, wx_his, splits, diags=None,
                       outs=None):
    n = len(ps)
    return [apply_7pt_h_plain(*a) for a in zip(
        ps, h_los, h_his, wx_his, splits, _each(diags, n), _each(outs, n))]


def resid_scaled_7pt_hs_plain(ps, h_los, h_his, wx_his, splits, bs,
                              diags=None, outs=None):
    n = len(ps)
    return [resid_scaled_7pt_h_plain(*a) for a in zip(
        ps, h_los, h_his, wx_his, splits, bs, _each(diags, n),
        _each(outs, n))]


# ------------------------------------------------------------------ kernels

def _check(p, h_lo, h_hi, wx_hi, split, *extra, out=None):
    sp._check(p, split, *extra, out)
    plane = (1,) + tuple(p.shape[1:])
    for h in (h_lo, h_hi, wx_hi):
        if (tuple(h.shape) != plane or h.dtype != p.dtype
                or h.device != p.device or not h.is_contiguous()):
            raise ValueError(f"7-point halo kernel: halo planes must be "
                             f"contiguous {p.dtype} {plane} on {p.device}")


def _check_table(what, ps, h_los, h_his, wx_his, splits, bs=None,
                 diags=None, outs=None):
    """An island's slabs: 1 … MAX_SLABS of them, one list entry each
    (`bs`, `diags`, `outs` None, or one per slab: diagonals for all or
    for none), every slab a valid operand set of one shape, dtype and
    device."""
    n = len(ps)
    if not 1 <= n <= MAX_SLABS:
        raise ValueError(f"{what}: 1 to {MAX_SLABS} slabs a launch, got {n}")
    for ts in (h_los, h_his, wx_his, splits, bs, diags, outs):
        if ts is not None and len(ts) != n:
            raise ValueError(f"{what}: one entry per slab in every list")
    if diags is not None and any(d is None for d in diags):
        raise ValueError(f"{what}: a diagonal for every slab or for none")
    p0 = ps[0]
    for m, p in enumerate(ps):
        if (p.shape != p0.shape or p.dtype != p0.dtype
                or p.device != p0.device):
            raise ValueError(f"{what}: every slab must share the first's "
                             f"shape, dtype and device")
        extra = [t[m] for t in (diags, bs) if t is not None]
        _check(p, h_los[m], h_his[m], wx_his[m], splits[m], *extra,
               out=None if outs is None else outs[m])


def _lib():
    lib = sp._lib()
    if not getattr(lib, "_halo_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seven_point_halo_launch.argtypes = ([ci, ci, ci] + [vp] * 14
                                                + [ci] * 5 + [vp])
        lib.seven_point_halo_launch.restype = ci
        lib.seven_point_slabs_launch.argtypes = ([ci] * 4 + [vp] + [ci] * 3
                                                 + [vp])
        lib.seven_point_slabs_launch.restype = ci
        lib.seven_point_max_slabs.argtypes = []
        lib.seven_point_max_slabs.restype = ci
        lib._halo_typed = True
    return lib


def _launch_slabs(mode, ps, h_los, h_his, wx_his, splits, bs=None,
                  diags=None, outs=None):
    """One launch of apply (sp._APPLY) or resid (sp._RESID) over the
    slabs; returns their outputs."""
    lib = _lib()
    n = len(ps)
    outs = [torch.empty_like(p) if o is None else o
            for p, o in zip(ps, _each(outs, n))]
    table = (ctypes.c_void_p * (10 * n))()
    table[:] = [None if t is None else t.data_ptr() for m in range(n)
                for t in (ps[m], h_los[m], h_his[m], wx_his[m], *splits[m],
                          _each(diags, n)[m], _each(bs, n)[m], outs[m])]
    rc = lib.seven_point_slabs_launch(
        mode, sp._DTYPES[ps[0].dtype], int(diags is not None), n, table,
        *ps[0].shape, _build.stream_of(ps[0]))
    _build.check(rc, "seven_point_slabs", *outs)
    return outs


def apply_7pt_hs(ps, h_los, h_his, wx_his, splits, diags=None, outs=None):
    """A(p) on every slab of an island in one launch; per slab its halo
    planes as `apply_7pt_h` takes them. Returns the outputs, a list."""
    _check_table("apply_7pt_hs", ps, h_los, h_his, wx_his, splits,
                 diags=diags, outs=outs)
    if _build.route(ps[0], "apply_7pt_hs") == "cpu":
        return apply_7pt_hs_plain(ps, h_los, h_his, wx_his, splits, diags,
                                  outs)
    res = _launch_slabs(sp._APPLY, ps, h_los, h_his, wx_his, splits,
                        diags=diags, outs=outs)
    apply_7pt_hs.launches += 1
    return res


def resid_scaled_7pt_hs(ps, h_los, h_his, wx_his, splits, bs, diags=None,
                        outs=None):
    """(b − A·p)/diag (b − Â·p with `diags=None`) on every slab of an
    island in one launch. Returns the outputs, a list."""
    _check_table("resid_scaled_7pt_hs", ps, h_los, h_his, wx_his, splits,
                 bs=bs, diags=diags, outs=outs)
    if _build.route(ps[0], "resid_scaled_7pt_hs") == "cpu":
        return resid_scaled_7pt_hs_plain(ps, h_los, h_his, wx_his, splits,
                                         bs, diags, outs)
    res = _launch_slabs(sp._RESID, ps, h_los, h_his, wx_his, splits, bs=bs,
                        diags=diags, outs=outs)
    resid_scaled_7pt_hs.launches += 1
    return res


def apply_7pt_h(p, h_lo, h_hi, wx_hi, split, diag=None, out=None):
    """A(p) on one shard; `h_lo`/`h_hi` p's exchanged ±1 x-planes,
    `wx_hi` the next shard's first wxl plane (zero at the global end)."""
    if _build.route(p, "apply_7pt_h") == "cpu":
        return apply_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, diag, out)
    _check(p, h_lo, h_hi, wx_hi, split, diag, out=out)
    res, = _launch_slabs(sp._APPLY, [p], [h_lo], [h_hi], [wx_hi], [split],
                         diags=None if diag is None else [diag], outs=[out])
    apply_7pt_h.launches += 1
    return res


def resid_scaled_7pt_h(p, h_lo, h_hi, wx_hi, split, b, diag=None, out=None):
    """(b − A·p)/diag (b − Â·p with `diag=None`) on one shard."""
    if _build.route(p, "resid_scaled_7pt_h") == "cpu":
        return resid_scaled_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, b, diag,
                                        out)
    _check(p, h_lo, h_hi, wx_hi, split, diag, b, out=out)
    res, = _launch_slabs(sp._RESID, [p], [h_lo], [h_hi], [wx_hi], [split],
                         bs=[b], diags=None if diag is None else [diag],
                         outs=[out])
    resid_scaled_7pt_h.launches += 1
    return res


def apply_dot_7pt_h(p, h_lo, h_hi, wx_hi, split, out=None, acc=None,
                    rows=None):
    """(Â·p, `acc` plus this shard's p·Â·p as a 0-d f32 tensor). `acc`
    (optional, a 0-d f32 tensor on p's device) is the dot of the shards
    before this one: the kernel adds this shard's planes to it in the
    order the single-grid kernel adds them, so the island's chain over
    the shards gives the single-grid dot bitwise. `rows` (y0, y1): the
    dot over those y rows only (None: all)."""
    if _build.route(p, "apply_dot_7pt_h") == "cpu":
        return apply_dot_7pt_h_plain(p, h_lo, h_hi, wx_hi, split, out, acc,
                                     rows)
    y0, y1 = window(rows, p.shape[1])
    _check(p, h_lo, h_hi, wx_hi, split, out=out)
    if acc is not None and (acc.shape != () or acc.dtype != torch.float32
                            or acc.device != p.device):
        raise ValueError("apply_dot_7pt_h: acc must be a 0-d f32 tensor on "
                         f"{p.device}")
    lib = _lib()
    out = torch.empty_like(p) if out is None else out
    partial, dot, ticket = sp._dot_scratch(lib, p)
    rc = lib.seven_point_halo_launch(
        sp._APPLY_DOT, sp._DTYPES[p.dtype], 0, _build.ptr(p),
        *(_build.ptr(h) for h in (h_lo, h_hi, wx_hi)),
        *(_build.ptr(w) for w in split), None, None, _build.ptr(out),
        _build.ptr(partial), _build.ptr(dot), _build.ptr(ticket),
        None if acc is None else _build.ptr(acc), *p.shape, y0, y1,
        _build.stream_of(p))
    _build.check(rc, "seven_point_halo", out, dot)
    apply_dot_7pt_h.launches += 1
    return out, dot


for _fn in (apply_7pt_h, resid_scaled_7pt_h, apply_dot_7pt_h, apply_7pt_hs,
            resid_scaled_7pt_hs):
    _fn.launches = 0
del _fn
