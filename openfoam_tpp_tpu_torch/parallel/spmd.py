"""The x-sharded step's per-shard kernel islands — port of
openfoam_tpp_tpu/parallel/spmd.py.

In the JAX package the sharded step is one GSPMD program over a device
mesh: arrays are global between islands (GSPMD partitions the stencil
chains, the MG transfers and the CG recurrences), and each fused-kernel
call site is a `shard_map` island that exchanges ±1/±2 x-plane halos
with `lax.ppermute`, runs the halo variant of the kernel per shard and
reduces its scalars with `psum`/`pmax`.

Here, on one card, `SpmdCtx(n_shards=S)` cuts each island's global
tensors into S x-slabs of the same tensor. x is the leading, contiguous
dimension, so a slab and every plane of it is a contiguous view: an
interior halo is a view of the neighbour slab's planes (no copy), and
only the global-edge fills are small materialized planes. The 7-point
apply and resid islands launch one kernel over all held slabs, as the
mesh runs its shards at once; every other island runs its halo kernel
once per slab. Each writes a slab's output into the preallocated global
output at its x offset, and reduces the per-shard
scalars in shard order (a fixed order, so CG iteration counts repeat
from run to run): the max directly, the CG curvature dot as a chain in
which each shard's kernel adds its planes to the previous shards' dot,
so the island's dot is the single-grid kernel's. Everything between
islands stays the port's global-tensor code, which is what GSPMD
computes.

Each island is written over "the slabs this process holds"
(`SpmdCtx.held`): here all S; a torch.distributed form, one rank per
card, holds one and replaces only the exchange and the reductions.

Halo-plane edge semantics at the GLOBAL domain ends reproduce the
single-grid kernels: "clamp" edges replicate the edge plane (the
edge-clamped shift), "zero" edges supply the implicit zero boundary
faces (sealed walls, the zeroed top antidiffusive flux). The halo
kernels never clamp: the halo content carries the global-end semantics.
"""

from __future__ import annotations

import dataclasses

import torch

from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import halo7
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx

# The widest halo any island exchanges (u/v/w for the momentum RHS, alpha
# for the MULES fluxes): a shard must hold at least this many planes.
MAX_HALO = 2


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """The step runs x-sharded into `n_shards` slabs with per-shard halo
    kernels. `axis` names the sharded grid axis; only "x" (dimension 0)
    exists, as in the JAX package."""

    n_shards: int
    axis: str = "x"

    def __post_init__(self):
        if self.axis != "x":
            raise ValueError(f"SpmdCtx shards the grid's x axis only, not "
                             f"{self.axis!r}")
        if int(self.n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    @property
    def held(self) -> range:
        """Indices of the shards this process holds: all of them."""
        return range(self.n_shards)

    def supports(self, shape) -> bool:
        """nx divides over the shards into slabs of at least MAX_HALO
        planes. No other gate: the CUDA kernels take any slab."""
        nx = shape[0]
        return nx % self.n_shards == 0 and nx // self.n_shards >= MAX_HALO

    def local_shape(self, shape):
        """Per-shard shape of a dim-0-sharded cell array."""
        if not self.supports(shape):
            raise ValueError(
                f"grid nx={shape[0]} does not divide over {self.n_shards} "
                f"'{self.axis}' shards into slabs of at least {MAX_HALO} "
                f"planes (the widest halo)")
        return (shape[0] // self.n_shards,) + tuple(shape[1:])

    def split(self, a, nx=None):
        """The held x-slabs of `a` (views). `nx` is the sharded extent,
        default a.shape[0]; an x-face array of nx + 1 planes split with
        the cells' nx gives its first nx faces, packed to the cells."""
        nxl = self.local_shape((a.shape[0] if nx is None else nx,))[0]
        return [a[s * nxl:(s + 1) * nxl] for s in self.held]


def _edge_fill(a, width, edge, lo):
    if edge == "zero":
        return a.new_zeros((width,) + tuple(a.shape[1:]))
    plane = a[:1] if lo else a[-1:]
    return plane.expand((width,) + tuple(a.shape[1:])).contiguous()


def exchange_halo(slabs, width: int, ctx: SpmdCtx, lo_edge: str = "clamp",
                  hi_edge: str = "clamp"):
    """(lo, hi) halo blocks of `width` x-planes per held slab, from its
    ring neighbours.

    `lo` holds the left neighbour's LAST `width` planes (ghost rows
    −width…−1 of the slab); `hi` the right neighbour's FIRST `width`
    planes (ghost rows nxl…nxl+width−1). At the global ends "clamp"
    replicates the edge plane and "zero" gives zeros. Interior halos are
    views of the neighbour slab."""
    n = ctx.n_shards
    out = []
    for s in ctx.held:
        a = slabs[s]
        lo = (slabs[s - 1][-width:] if s > 0
              else _edge_fill(a, width, lo_edge, lo=True))
        hi = (slabs[s + 1][:width] if s < n - 1
              else _edge_fill(a, width, hi_edge, lo=False))
        out.append((lo, hi))
    return out


def exchange_hi(slabs, width: int, ctx: SpmdCtx, edge: str = "zero"):
    """One-sided halo per held slab: the right neighbour's FIRST `width`
    planes only (the face-lite wxl weight's high-x continuation)."""
    n = ctx.n_shards
    return [slabs[s + 1][:width] if s < n - 1
            else _edge_fill(slabs[s], width, edge, lo=False)
            for s in ctx.held]


def pmax_scalar(parts, ctx: SpmdCtx):
    """Maximum of the per-shard scalars (NaN propagates)."""
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p)
    return total


# --------------------------------------------------------------------- #
# The islands, one per kernel family. Each takes GLOBAL tensors and
# returns GLOBAL results, with the JAX island's signature.
# --------------------------------------------------------------------- #


def _seven_point_halos(p, split, ctx):
    ps = ctx.split(p)
    ws = [ctx.split(w) for w in split]
    halos = exchange_halo(ps, 1, ctx)
    wx_hi = exchange_hi(ws[0], 1, ctx, edge="zero")
    return ps, ws, halos, wx_hi


def _seven_point_island(island, p, split, ctx, *cells, diag=None):
    """`island` (an island entry point of halo7) over the held slabs, one
    launch per halo7.MAX_SLABS of them; `cells`: further cell arrays."""
    ps, ws, halos, wx_hi = _seven_point_halos(p, split, ctx)
    cols = [ps, [h[0] for h in halos], [h[1] for h in halos], wx_hi,
            [tuple(w[s] for w in ws) for s in range(len(ps))],
            *(ctx.split(c) for c in cells)]
    ds = None if diag is None else ctx.split(diag)
    out = torch.empty_like(p)
    outs = ctx.split(out)
    for g in range(0, len(ps), halo7.MAX_SLABS):
        part = slice(g, g + halo7.MAX_SLABS)
        island(*(c[part] for c in cols),
               diags=None if ds is None else ds[part], outs=outs[part])
    return out


def apply_7pt(p, split, ctx: SpmdCtx, diag=None):
    """Â(p) (or A(p) with diag), per shard with ±1 halos of p, all held
    shards in one launch. The face-lite wxl weight also sends its first
    plane left: the neighbour's missing high-face weight, zero at the
    global end (the sealed wall's boundary-face weight)."""
    return _seven_point_island(halo7.apply_7pt_hs, p, split, ctx, diag=diag)


def resid_scaled_7pt(p, split, ctx: SpmdCtx, b, diag=None):
    """(b − A·p)/diag (or b − Â·p), per shard with ±1 halos of p, all held
    shards in one launch."""
    return _seven_point_island(halo7.resid_scaled_7pt_hs, p, split, ctx, b,
                               diag=diag)


def apply_dot_7pt(p, split, ctx: SpmdCtx):
    """(Â·p, p·Â·p): per-shard kernels, each adding its shard's dot to the
    previous shards' in shard order (the psum of the partials, carried as
    a chain so that on the card the island's dot is the single-grid
    kernel's bitwise; shards on several cards would all-reduce instead)."""
    ps, ws, halos, wx_hi = _seven_point_halos(p, split, ctx)
    out = torch.empty_like(p)
    outs = ctx.split(out)
    dot = None
    for s in ctx.held:
        dot = halo7.apply_dot_7pt_h(ps[s], *halos[s], wx_hi[s],
                                    tuple(w[s] for w in ws), out=outs[s],
                                    acc=dot)[1]
    return out, dot


def flux_all(alpha, phis_cell, ucs_cell, ctx: SpmdCtx, anti_dtype=None):
    """All-axis MULES (low, anti) fluxes per shard: alpha's −2/−1/+1
    x-planes exchanged with clamp edges (the edge-clamped shifts)."""
    a_s = ctx.split(alpha)
    ph = [ctx.split(f) for f in phis_cell]
    uc = [ctx.split(f) for f in ucs_cell]
    halos = exchange_halo(a_s, 2, ctx)
    a_dt = anti_dtype or alpha.dtype
    lows = tuple(torch.empty_like(alpha) for _ in range(3))
    antis = tuple(torch.empty_like(alpha, dtype=a_dt) for _ in range(3))
    lo_s = [ctx.split(t) for t in lows]
    an_s = [ctx.split(t) for t in antis]
    for s in ctx.held:
        lo, hi = halos[s]
        mfx.flux_all_h(a_s[s], lo, hi[:1], tuple(f[s] for f in ph),
                       tuple(f[s] for f in uc), anti_dtype=anti_dtype,
                       out=(tuple(t[s] for t in lo_s),
                            tuple(t[s] for t in an_s)))
    return lows, antis


def fct_iters(lams0, antis, alpha_low, amax, amin, dt_iv, spacing,
              n_iters: int, ctx: SpmdCtx, eps=1e-12):
    """All `n_iters` FCT limiter iterations in one island: the anti and
    cell halos are exchanged once (they do not change), the λ halos once
    per iteration. x hi edges are zero (the implicit zero boundary face),
    lo edges clamp (harmless: zero antidiffusive boundary faces). λ is
    double-buffered: an iteration reads every slab's old λ, halos
    included, before any slab's new λ may overwrite it."""
    an = [ctx.split(a) for a in antis]
    ah = [exchange_halo(a, 1, ctx, hi_edge="zero") for a in an]
    cells = [ctx.split(c) for c in (alpha_low, amax, amin, dt_iv)]
    cell_los = [[h[0] for h in exchange_halo(c, 1, ctx)] for c in cells]
    bufs = [tuple(torch.empty_like(l) for l in lams0) for _ in
            range(min(n_iters, 2))]
    lams = tuple(lams0)
    for it in range(n_iters):
        ls = [ctx.split(l) for l in lams]
        lh = [exchange_halo(l, 1, ctx, hi_edge="zero") for l in ls]
        new = bufs[it % 2]
        outs = [ctx.split(t) for t in new]
        for s in ctx.held:
            lam_halos = ((lh[0][s][0], lh[0][s][1]), (lh[1][s][0], None),
                         (lh[2][s][0], None))
            anti_halos = ((ah[0][s][0], ah[0][s][1]), (ah[1][s][0], None),
                          (ah[2][s][0], None))
            mf.fct_iter_h(tuple(l[s] for l in ls), lam_halos,
                          tuple(a[s] for a in an), anti_halos,
                          tuple(c[s] for c in cell_los),
                          *(c[s] for c in cells), spacing, eps=eps,
                          out=tuple(o[s] for o in outs))
        lams = new
    return lams


def momentum_rhs(u, v, w, rho_phi, mu, div_u, spacing, ctx: SpmdCtx,
                 dev2=True):
    """Full momentum RHS per shard: u/v/w exchanged at width 2 (the MUSCL
    reach), rpx/μ at ±1, rpy/rpz/∇·U at −1. u and rpx enter packed to
    cells (u[:-1]: their global face-nx plane is the sealed wall, zero,
    and rides in the zero hi edge). Same signature and returns as the
    single-grid entry point: au's zero wall plane is written again."""
    rpx, rpy, rpz = rho_phi
    nx = mu.shape[0]
    us, rxs = ctx.split(u, nx), ctx.split(rpx, nx)
    vs, ws = ctx.split(v), ctx.split(w)
    rys, rzs, mus = ctx.split(rpy), ctx.split(rpz), ctx.split(mu)
    dus = None if div_u is None else ctx.split(div_u)
    uh = exchange_halo(us, 2, ctx, hi_edge="zero")
    vh = exchange_halo(vs, 2, ctx)
    wh = exchange_halo(ws, 2, ctx)
    rxh = exchange_halo(rxs, 1, ctx, hi_edge="zero")
    ryh = exchange_halo(rys, 1, ctx)
    rzh = exchange_halo(rzs, 1, ctx)
    muh = exchange_halo(mus, 1, ctx)
    duh = (None if dus is None
           else exchange_halo(dus, 1, ctx, lo_edge="zero"))
    au = torch.empty_like(u)
    au[-1] = 0.0
    av, aw = torch.empty_like(v), torch.empty_like(w)
    au_s, av_s, aw_s = ctx.split(au, nx), ctx.split(av), ctx.split(aw)
    for s in ctx.held:
        halos = (*uh[s], *vh[s], *wh[s], *rxh[s], ryh[s][0], rzh[s][0],
                 *muh[s], None if duh is None else duh[s][0])
        mrk.momentum_rhs_h(us[s], vs[s], ws[s], rxs[s], rys[s], rzs[s],
                           mus[s], None if dus is None else dus[s], halos,
                           spacing, dev2=dev2,
                           out=(au_s[s], av_s[s], aw_s[s]))
    return au, av, aw


def correct_divmax(dp, u_s, v_s, w_s, beta_f, ax_ap, ay_ap, az_ap, vfrac,
                   top_open, rho, dt, spacing, ctx: SpmdCtx, open_top=True):
    """Projection epilogue per shard: velocity correction and div max,
    ±1 dp halos (clamp edges), +1 halos of (u, βx, ax) (their global
    face-nx plane is the sealed wall, so the top edge fills zeros, the
    true values). Same signature and returns as the port's single-grid
    `correct_divmax` (`rho` the new cell density): u's zero wall plane
    is written again and the div max is the maximum over the shards."""
    nx = dp.shape[0]
    bx, by, bz = beta_f
    dps = ctx.split(dp)
    dh = exchange_halo(dps, 1, ctx)
    packed = [ctx.split(t, nx) for t in (u_s, bx, ax_ap)]
    his = [exchange_hi(t, 1, ctx, edge="zero") for t in packed]
    rest = [ctx.split(t) for t in (v_s, w_s, by, bz, ay_ap, az_ap, vfrac,
                                   rho)]
    topo = ctx.split(top_open) if open_top else None
    uc = torch.empty_like(u_s)
    uc[-1] = 0.0
    vc, wc = torch.empty_like(v_s), torch.empty_like(w_s)
    uc_s, vc_s, wc_s = ctx.split(uc, nx), ctx.split(vc), ctx.split(wc)
    parts = []
    for s in ctx.held:
        u_p, bx_p, ax_p = (t[s] for t in packed)
        h_u, h_bx, h_ax = (h[s] for h in his)
        v_, w_, by_, bz_, ay_, az_, vf_, rho_ = (t[s] for t in rest)
        parts.append(ck.correct_divmax_h(
            dps[s], *dh[s], u_p, h_u, v_, w_, bx_p, h_bx, by_, bz_, ax_p,
            h_ax, ay_, az_, vf_, None if topo is None else topo[s], rho_, dt,
            spacing, open_top=open_top,
            out=(uc_s[s], vc_s[s], wc_s[s]))[3])
    return uc, vc, wc, pmax_scalar(parts, ctx)
