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
(`SpmdCtx.held`): here all S. `SpmdCtx(S, ranks=ctx)` is the
torch.distributed form (parallel/ranks.py), one process a shard: the
process holds its own slab only, the arrays it passes are that slab (x-
face arrays with nxl + 1 planes, the last shared with the right
neighbour), and only the exchange and the reductions change: halos are
planes received from the neighbour ranks, the maxima and the curvature
dot all-reduce (one partial a rank), and a face array an island writes
packed takes its last plane from the right neighbour. The islands run
with ops/stencil.py's rank block closed: their kernels' plain versions
work on whole blocks.

`SpmdCtx(N, M, ranks=ctx)` is the 2-D x·y decomposition over an (N, M)
rank grid (OpenFOAM's `hierarchical (N M 1)`), one process a block of
nxl × nyl cells (y-face arrays with nyl + 1 rows, the last shared with
the upper neighbour); it exists over ranks only. Each island first
extends the rank's block in y by its y neighbours' rows (`YBlock`, one
row exchange), as many on each interior side as the island's x halos
are wide (MAX_HALO for the momentum RHS, 2 below and 1 above for the
MULES fluxes, 1 for the rest), nothing at a global y end. Only then does
it exchange its x halo planes, cut from the x neighbours' y-extended
blocks, so they carry the x·y corner cells that the momentum RHS's
cross terms read. The unchanged halo kernels run on the extended block,
and the rank's own rows are copied back out. This is the argument the
halo kernels' plain versions rest on in x: a kernel reaches no further
in y than the rows added, so the extended block's own end rules (a
clamp, a zero wall face) act only on outputs that are dropped, and at a
global y end no rows are added and the single grid's y rules apply where
they do now. The two islands that reduce pass their kernels the row
window of the rank's own rows, so ghost rows enter neither the CG
curvature dot nor the div max. With M = 1 nothing is extended and every
island is the 1-D decomposition's, bit for bit.

A sweep farmed over a (C, N, M) rank grid passes batched blocks,
(nxl, nyl, nz, B/C), to the 7-point islands alone, on every multigrid
level it holds as blocks (its MULES, momentum and correction terms are
plain): the batch kernels of
ops/kernels/seven_point.py have no halo form, so each call extends the
block by a cell a side in x and y (`XYBlock`), runs the unchanged kernel
on it and crops the owned cells; the apply-dot's per-case dot is over
its column window of owned cells, all-reduced over the case group.

Both forms run the orbital cylinder and the closed 6DoF tank, whose
table forcing and rotating-frame sources are plain PyTorch between the
islands and whose closed top takes the epilogue island's closed-top
form (`correct_divmax(..., open_top=False)`). A slab needs MAX_HALO
planes and nothing else of nx: the JAX package's multiple of 8 planes a
shard is its Pallas tiling's, not the islands'.

Halo-plane edge semantics at the GLOBAL domain ends reproduce the
single-grid kernels: "clamp" edges replicate the edge plane (the
edge-clamped shift), "zero" edges supply the implicit zero boundary
faces (sealed walls, the zeroed top antidiffusive flux). The halo
kernels never clamp: the halo content carries the global-end semantics.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import halo7
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

# The widest halo any island exchanges (u/v/w for the momentum RHS, alpha
# for the MULES fluxes): a shard must hold at least this many planes.
MAX_HALO = 2


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """The step runs x-sharded into `n_shards` slabs with per-shard halo
    kernels, and over ranks also into `y_shards` rows of blocks. `axis`
    names the sharded grid axis of the one-process form; only "x"
    (dimension 0) exists, as in the JAX package. `ranks` (a
    parallel.ranks.RankCtx on an (n_shards, y_shards) rank grid): one
    process a shard, this one holding its rank's block."""

    n_shards: int
    y_shards: int = 1
    axis: str = "x"
    ranks: object = None
    # Case positions of a sweep farmed over a (C, N, M) rank grid (its
    # ranks' `cases`): a batched block holds B/C of the batch's cases.
    cases: int = None

    def __post_init__(self):
        if self.axis != "x":
            raise ValueError(f"SpmdCtx shards the grid's x axis only, not "
                             f"{self.axis!r}")
        if int(self.n_shards) < 1 or int(self.y_shards) < 1:
            raise ValueError(f"n_shards and y_shards must be >= 1, got "
                             f"{self.n_shards} and {self.y_shards}")
        if self.ranks is not None and tuple(self.ranks.grid) != (
                self.n_shards, self.y_shards):
            raise ValueError(f"{self.n_shards}x{self.y_shards} shards over "
                             f"a {self.ranks.grid[0]}x{self.ranks.grid[1]} "
                             "rank grid: one rank a shard")
        held = 1 if self.ranks is None else self.ranks.cases
        if self.cases is None:
            object.__setattr__(self, "cases", held)
        if int(self.cases) < 1 or (self.ranks is not None
                                   and self.cases != held):
            raise ValueError(f"{self.cases} case positions over ranks with "
                             f"{held}: one case group a position")

    @property
    def held(self):
        """Indices of the shards this process holds: all of them, or its
        rank's."""
        if self.ranks is not None:
            return (self.ranks.rank,)
        return range(self.n_shards)

    def supports(self, shape) -> bool:
        """nx divides over the shards into slabs of at least MAX_HALO
        planes, ny over the y shards into rows of blocks of at least
        MAX_HALO rows, and a batch's cases over the case positions. No
        other gate: the CUDA kernels take any slab."""
        nx = shape[0]
        ok = nx % self.n_shards == 0 and nx // self.n_shards >= MAX_HALO
        if self.y_shards > 1:
            ny = shape[1]
            ok = ok and ny % self.y_shards == 0 and (
                ny // self.y_shards >= MAX_HALO)
        if len(shape) == 4:
            ok = ok and shape[3] % self.cases == 0
        return ok

    def local_shape(self, shape):
        """Per-shard shape of a cell array (dim 0 sharded, and dim 1 with
        y shards; a batched (nx, ny, nz, B) one's trailing case axis cut
        into the case positions)."""
        nx = shape[0]
        if nx % self.n_shards or nx // self.n_shards < MAX_HALO:
            raise ValueError(
                f"grid nx={nx} does not divide over {self.n_shards} "
                f"'{self.axis}' shards into slabs of at least {MAX_HALO} "
                f"planes (the widest halo)")
        out = (nx // self.n_shards,) + tuple(shape[1:])
        if self.y_shards > 1:
            ny = shape[1]
            if ny % self.y_shards or ny // self.y_shards < MAX_HALO:
                raise ValueError(
                    f"grid ny={ny} does not divide over {self.y_shards} 'y' "
                    f"shards into blocks of at least {MAX_HALO} rows (the "
                    f"widest halo): nyl = {ny / self.y_shards:g}")
            out = out[:1] + (ny // self.y_shards,) + out[2:]
        if len(shape) == 4:
            if shape[3] % self.cases:
                raise ValueError(f"{shape[3]} cases do not divide over "
                                 f"{self.cases} case positions")
            out = out[:3] + (shape[3] // self.cases,)
        return out

    def split(self, a, nx=None):
        """The held x-slabs of `a` (views), one per entry of `held`. `nx`
        is the sharded extent, default a.shape[0]; an x-face array of
        nx + 1 planes split with the cells' nx gives its first nx faces,
        packed to the cells. Under `ranks`, `a` is already the slab."""
        if self.ranks is not None:
            return [a[:a.shape[0] if nx is None else nx]]
        nxl = self.local_shape((a.shape[0] if nx is None else nx,))[0]
        return [a[s * nxl:(s + 1) * nxl] for s in self.held]


def _island(fn):
    """An island runs with the stencil's rank block closed."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with st.rank_block(None):
            return fn(*args, **kwargs)
    return run


class YBlock:
    """A rank's block extended in y for one island call: `lo` rows of
    the lower y neighbour's block below it and `hi` of the upper one's
    above it (none at a global y end, none with one row of ranks).
    `nyl` is the block's own cell rows; a y-face array (nyl + 1 rows,
    the last shared with the upper neighbour) extends to the extended
    cells' rows + 1. `rows` is the rank's own cell rows in the extended
    block, (lo, lo + nyl), or None where nothing is added."""

    def __init__(self, ctx: SpmdCtx, nyl: int, width):
        self.ctx, self.nyl, self.width = ctx, nyl, tuple(width)
        self.lo = self.hi = 0
        if ctx.ranks is not None and ctx.y_shards > 1:
            down, up = ctx.ranks.neighbours(1)
            self.lo = width[0] if down is not None else 0
            self.hi = width[1] if up is not None else 0

    @property
    def on(self) -> bool:
        return bool(self.lo or self.hi)

    @property
    def rows(self):
        return (self.lo, self.lo + self.nyl) if self.on else None

    def extend(self, *arrays):
        """The arrays (a rank's blocks; None passes through) extended, in
        one row exchange whatever their dtypes."""
        if not self.on:
            return list(arrays)
        live = [a for a in arrays if a is not None]
        f = [1 if a.shape[1] == self.nyl + 1 else 0 for a in live]
        # The lower neighbour's top extension is my first rows (above a
        # shared face row), the upper neighbour's bottom one my last.
        w_lo, w_hi = self.width
        to_lo = [a[:, g:g + w_hi] for a, g in zip(live, f)]
        to_hi = [a[:, a.shape[1] - g - w_lo:a.shape[1] - g]
                 for a, g in zip(live, f)]
        from_lo, from_hi = self.ctx.ranks.exchange(to_lo, to_hi, axis=1)
        from_lo, from_hi = iter(from_lo or ()), iter(from_hi or ())
        out = []
        for a in arrays:
            if a is None:
                out.append(None)
                continue
            parts = ([next(from_lo)] if self.lo else []) + [a] + (
                [next(from_hi)] if self.hi else [])
            out.append(torch.cat(parts, 1))
        return out

    def crop(self, t):
        """The rank's own rows of an extended array (cells, or y faces
        with the shared last row), contiguous."""
        if not self.on:
            return t
        f = t.shape[1] - (self.lo + self.nyl + self.hi)
        return t[:, self.lo:self.lo + self.nyl + f].contiguous()


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
    views of the neighbour slab (one process: `exchange_halos` takes the
    ranks' planes)."""
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


def exchange_halos(items, ctx: SpmdCtx):
    """`exchange_halo` of several arrays at once. Each item is (slabs,
    width, lo_edge, hi_edge), `width` an int or (lo width, hi width), 0
    for a side not wanted (None in its place). Returns one list of (lo,
    hi) per item, one pair per held slab. Under `ctx.ranks` every halo
    travels in one exchange, whatever the dtypes."""
    specs = [(sl, *((w, w) if isinstance(w, int) else w), le, he)
             for sl, w, le, he in items]
    if ctx.ranks is None:
        out = []
        for sl, lw, hw, le, he in specs:
            los = exchange_halo(sl, lw, ctx, le, he) if lw else None
            his = exchange_halo(sl, hw, ctx, le, he) if hw else None
            out.append([(los[i][0] if lw else None, his[i][1] if hw else None)
                        for i in range(len(sl))])
        return out
    to_lo = [sl[0][:hw] for sl, lw, hw, _, _ in specs if hw]
    to_hi = [sl[0][-lw:] for sl, lw, hw, _, _ in specs if lw]
    from_lo, from_hi = ctx.ranks.exchange(to_lo or None, to_hi or None)
    from_lo, from_hi = iter(from_lo or ()), iter(from_hi or ())
    out = []
    for sl, lw, hw, le, he in specs:
        a = sl[0]
        lo = (None if not lw else next(from_lo, None)
              if ctx.ranks.left is not None
              else _edge_fill(a, lw, le, lo=True))
        hi = (None if not hw else next(from_hi, None)
              if ctx.ranks.right is not None
              else _edge_fill(a, hw, he, lo=False))
        out.append([(lo, hi)])
    return out


def pmax_scalar(parts, ctx: SpmdCtx):
    """Maximum of the per-shard scalars (NaN propagates); over the ranks
    under `ctx.ranks`."""
    if ctx.ranks is not None:
        return ctx.ranks.all_reduce(parts[0], op="max")
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p)
    return total


def _fill_last_face(f, ctx: SpmdCtx):
    """Under `ctx.ranks`: the plane an x-face slab shares with its right
    neighbour, from that neighbour's first (the global wall plane, which
    the island wrote, stays)."""
    if ctx.ranks is not None:
        _, hi = ctx.ranks.exchange(f[:1], None)
        if hi is not None:
            f[-1:] = hi
    return f


# --------------------------------------------------------------------- #
# The islands, one per kernel family. Each takes GLOBAL tensors (the
# rank's blocks under `ctx.ranks`) and returns GLOBAL results, with the
# JAX island's signature. With y shards each first extends its inputs in
# y (`YBlock`) and crops its outputs back to the rank's rows.
# --------------------------------------------------------------------- #


class XYBlock:
    """A rank's batched (nxl, nyl, nz, B) block extended by one cell a
    side in x and in y for the batch 7-point kernels, which have no halo
    form: a row of each y neighbour's block (`YBlock`), then one plane of
    each x neighbour's y-extended block (one plane exchange, so the x·y
    corners travel), nothing at a global end. The unchanged kernels then
    run on the extended block: an owned cell reads its neighbours where
    the whole grid's kernel reads them, its own edge clamp and zero high
    face act only at a global end, as on the whole grid, and the added
    cells' outputs are cropped. `window` is the owned columns in the
    extended block, ((x0, x1), (y0, y1))."""

    def __init__(self, ctx: SpmdCtx, shape):
        if ctx.ranks is None:
            raise NotImplementedError(
                "a batched block in the one-process SpmdCtx: a sweep runs "
                "sharded over ranks only")
        self.ctx, self.nxl, self.nyl = ctx, shape[0], shape[1]
        self.yb = YBlock(ctx, shape[1], (1, 1))
        down, up = ctx.ranks.neighbours(0)
        self.lo, self.hi = int(down is not None), int(up is not None)

    @property
    def window(self):
        y0 = self.yb.lo
        return ((self.lo, self.lo + self.nxl), (y0, y0 + self.nyl))

    def extend(self, *arrays):
        """The cell arrays (None passes through) extended, in one row and
        one plane exchange whatever their dtypes."""
        arrays = self.yb.extend(*arrays)
        live = [a for a in arrays if a is not None]
        from_lo, from_hi = self.ctx.ranks.exchange(
            [a[:1] for a in live], [a[-1:] for a in live])
        from_lo, from_hi = iter(from_lo or ()), iter(from_hi or ())
        return [None if a is None else torch.cat(
            ([next(from_lo)] if self.lo else []) + [a]
            + ([next(from_hi)] if self.hi else []), 0) for a in arrays]

    def crop(self, t):
        """The owned cells of an extended array, contiguous."""
        (x0, x1), (y0, y1) = self.window
        return t[x0:x1, y0:y1].contiguous()


@_island
def _batch_island(kernel, p, split, ctx, *cells, diag=None):
    """`kernel` (a batch 7-point entry point of ops/kernels/seven_point.py,
    `kernel(p, split, diag, *cells)`) on the rank's extended block."""
    xb = XYBlock(ctx, p.shape)
    pe, *rest = xb.extend(p, *split, diag, *cells)
    return xb.crop(kernel(pe, tuple(rest[:3]), rest[3], *rest[4:]))


def _seven_point_halos(p, split, ctx):
    ps = ctx.split(p)
    ws = [ctx.split(w) for w in split]
    halos, wxh = exchange_halos([(ps, 1, "clamp", "clamp"),
                                 (ws[0], (0, 1), "zero", "zero")], ctx)
    return ps, ws, halos, [h[1] for h in wxh]


@_island
def _seven_point_island(island, p, split, ctx, *cells, diag=None):
    """`island` (an island entry point of halo7) over the held slabs, one
    launch per halo7.MAX_SLABS of them; `cells`: further cell arrays."""
    yb = YBlock(ctx, p.shape[1], (1, 1))
    if yb.on:
        p, *rest = yb.extend(p, *split, *cells, diag)
        split, cells, diag = tuple(rest[:3]), rest[3:-1], rest[-1]
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
    return yb.crop(out)


def apply_7pt(p, split, ctx: SpmdCtx, diag=None):
    """Â(p) (or A(p) with diag), per shard with ±1 halos of p, all held
    shards in one launch. The face-lite wxl weight also sends its first
    plane left: the neighbour's missing high-face weight, zero at the
    global end (the sealed wall's boundary-face weight)."""
    if p.dim() == 4:
        return _batch_island(sp.apply_7pt_nb, p, split, ctx, diag=diag)
    return _seven_point_island(halo7.apply_7pt_hs, p, split, ctx, diag=diag)


def resid_scaled_7pt(p, split, ctx: SpmdCtx, b, diag=None):
    """(b − A·p)/diag (or b − Â·p), per shard with ±1 halos of p, all held
    shards in one launch."""
    if p.dim() == 4:
        return _batch_island(sp.resid_scaled_7pt_nb, p, split, ctx, b,
                             diag=diag)
    return _seven_point_island(halo7.resid_scaled_7pt_hs, p, split, ctx, b,
                               diag=diag)


@_island
def apply_dot_7pt(p, split, ctx: SpmdCtx):
    """(Â·p, p·Â·p): per-shard kernels, each adding its shard's dot to the
    previous shards' in shard order (the psum of the partials, carried as
    a chain so that on the card the island's dot is the single-grid
    kernel's bitwise); under `ctx.ranks` each rank's dot is one partial,
    all-reduced: with y shards the dot of its own rows of the y-extended
    block (the kernel's row window). A rank's batched block runs the batch
    kernel on its extended block (`XYBlock`) with the column window of its
    own cells, and its per-case dots are all-reduced over its case
    group."""
    if p.dim() == 4:
        xb = XYBlock(ctx, p.shape)
        pe, *se = xb.extend(p, *split)
        ap, dot = sp.apply_dot_7pt_nb(pe, tuple(se), window=xb.window)
        return xb.crop(ap), ctx.ranks.all_reduce(dot)
    yb = YBlock(ctx, p.shape[1], (1, 1))
    p, *split = yb.extend(p, *split)
    ps, ws, halos, wx_hi = _seven_point_halos(p, split, ctx)
    out = torch.empty_like(p)
    outs = ctx.split(out)
    dot = None
    for s in range(len(ps)):
        dot = halo7.apply_dot_7pt_h(ps[s], *halos[s], wx_hi[s],
                                    tuple(w[s] for w in ws), out=outs[s],
                                    acc=dot, rows=yb.rows)[1]
    if ctx.ranks is not None:
        dot = ctx.ranks.all_reduce(dot)
    return yb.crop(out), dot


@_island
def flux_all(alpha, phis_cell, ucs_cell, ctx: SpmdCtx, anti_dtype=None):
    """All-axis MULES (low, anti) fluxes per shard: alpha's −2/−1/+1
    x-planes exchanged with clamp edges (the edge-clamped shifts); with
    y shards on blocks extended by 2 rows below and 1 above (the same
    reach along y)."""
    yb = YBlock(ctx, alpha.shape[1], (2, 1))
    if yb.on:
        alpha, *rest = yb.extend(alpha, *phis_cell, *ucs_cell)
        phis_cell, ucs_cell = rest[:3], rest[3:]
    a_s = ctx.split(alpha)
    ph = [ctx.split(f) for f in phis_cell]
    uc = [ctx.split(f) for f in ucs_cell]
    halos = exchange_halos([(a_s, (2, 1), "clamp", "clamp")], ctx)[0]
    a_dt = anti_dtype or alpha.dtype
    lows = tuple(torch.empty_like(alpha) for _ in range(3))
    antis = tuple(torch.empty_like(alpha, dtype=a_dt) for _ in range(3))
    lo_s = [ctx.split(t) for t in lows]
    an_s = [ctx.split(t) for t in antis]
    for s in range(len(a_s)):
        lo, hi = halos[s]
        mfx.flux_all_h(a_s[s], lo, hi[:1], tuple(f[s] for f in ph),
                       tuple(f[s] for f in uc), anti_dtype=anti_dtype,
                       out=(tuple(t[s] for t in lo_s),
                            tuple(t[s] for t in an_s)))
    if yb.on:
        lows, antis = (tuple(yb.crop(t) for t in ts) for ts in (lows, antis))
    return lows, antis


@_island
def fct_iters(lams0, antis, alpha_low, amax, amin, dt_iv, spacing,
              n_iters: int, ctx: SpmdCtx, eps=1e-12):
    """All `n_iters` FCT limiter iterations in one island: the anti and
    cell halos are exchanged once (they do not change), the λ halos once
    per iteration. x hi edges are zero (the implicit zero boundary face),
    lo edges clamp (harmless: zero antidiffusive boundary faces). λ is
    double-buffered: an iteration reads every slab's old λ, halos
    included, before any slab's new λ may overwrite it. With y shards the
    anti and cell arrays are extended by a row each way once, λ before
    every iteration, and each iteration's λ cropped to the rank's rows."""
    yb = YBlock(ctx, alpha_low.shape[1], (1, 1))
    antis = yb.extend(*antis)
    an = [ctx.split(a) for a in antis]
    cells = [ctx.split(c) for c in yb.extend(alpha_low, amax, amin, dt_iv)]
    ah = exchange_halos(
        [(a, 1 if ax == 0 else (1, 0), "clamp", "zero")
         for ax, a in enumerate(an)]
        + [(c, (1, 0), "clamp", "clamp") for c in cells], ctx)
    ah, cell_los = ah[:3], [[h[0] for h in c] for c in ah[3:]]
    bufs = None
    lams = tuple(lams0)
    for it in range(n_iters):
        lams_e = yb.extend(*lams)
        if bufs is None:
            bufs = [tuple(torch.empty_like(l) for l in lams_e) for _ in
                    range(min(n_iters, 2))]
        ls = [ctx.split(l) for l in lams_e]
        lh = exchange_halos([(l, 1 if ax == 0 else (1, 0), "clamp", "zero")
                             for ax, l in enumerate(ls)], ctx)
        new = bufs[it % 2]
        outs = [ctx.split(t) for t in new]
        for s in range(len(ls[0])):
            lam_halos = ((lh[0][s][0], lh[0][s][1]), (lh[1][s][0], None),
                         (lh[2][s][0], None))
            anti_halos = ((ah[0][s][0], ah[0][s][1]), (ah[1][s][0], None),
                          (ah[2][s][0], None))
            mf.fct_iter_h(tuple(l[s] for l in ls), lam_halos,
                          tuple(a[s] for a in an), anti_halos,
                          tuple(c[s] for c in cell_los),
                          *(c[s] for c in cells), spacing, eps=eps,
                          out=tuple(o[s] for o in outs))
        lams = tuple(yb.crop(t) for t in new) if yb.on else new
    return lams


@_island
def momentum_rhs(u, v, w, rho_phi, mu, div_u, spacing, ctx: SpmdCtx,
                 dev2=True):
    """Full momentum RHS per shard: u/v/w exchanged at width 2 (the MUSCL
    reach), rpx/μ at ±1, rpy/rpz/∇·U at −1. u and rpx enter packed to
    cells (u[:-1]: their global face-nx plane is the sealed wall, zero,
    and rides in the zero hi edge). Same signature and returns as the
    single-grid entry point: au's zero wall plane is written again. With
    y shards on blocks extended by MAX_HALO rows each way (the MUSCL reach
    along y; the x halo planes then carry the x·y corners that the dev2
    and convective cross terms read)."""
    yb = YBlock(ctx, mu.shape[1], (MAX_HALO, MAX_HALO))
    if yb.on:
        u, v, w, *rho_phi, mu, div_u = yb.extend(u, v, w, *rho_phi, mu,
                                                 div_u)
    rpx, rpy, rpz = rho_phi
    nx = mu.shape[0]
    us, rxs = ctx.split(u, nx), ctx.split(rpx, nx)
    vs, ws = ctx.split(v), ctx.split(w)
    rys, rzs, mus = ctx.split(rpy), ctx.split(rpz), ctx.split(mu)
    dus = None if div_u is None else ctx.split(div_u)
    uh, vh, wh, rxh, ryh, rzh, muh, *duh = exchange_halos(
        [(us, 2, "clamp", "zero"), (vs, 2, "clamp", "clamp"),
         (ws, 2, "clamp", "clamp"), (rxs, 1, "clamp", "zero"),
         (rys, (1, 0), "clamp", "clamp"), (rzs, (1, 0), "clamp", "clamp"),
         (mus, 1, "clamp", "clamp")]
        + ([] if dus is None else [(dus, (1, 0), "zero", "clamp")]), ctx)
    duh = duh[0] if duh else None
    au = torch.empty_like(u)
    au[-1] = 0.0
    av, aw = torch.empty_like(v), torch.empty_like(w)
    au_s, av_s, aw_s = ctx.split(au, nx), ctx.split(av), ctx.split(aw)
    for s in range(len(us)):
        halos = (*uh[s], *vh[s], *wh[s], *rxh[s], ryh[s][0], rzh[s][0],
                 *muh[s], None if duh is None else duh[s][0])
        mrk.momentum_rhs_h(us[s], vs[s], ws[s], rxs[s], rys[s], rzs[s],
                           mus[s], None if dus is None else dus[s], halos,
                           spacing, dev2=dev2,
                           out=(au_s[s], av_s[s], aw_s[s]))
    au = _fill_last_face(au, ctx)
    return yb.crop(au), yb.crop(av), yb.crop(aw)


@_island
def correct_divmax(dp, u_s, v_s, w_s, beta_f, ax_ap, ay_ap, az_ap, vfrac,
                   top_open, rho, dt, spacing, ctx: SpmdCtx, open_top=True):
    """Projection epilogue per shard: velocity correction and div max,
    ±1 dp halos (clamp edges), +1 halos of (u, βx, ax) (their global
    face-nx plane is the sealed wall, so the top edge fills zeros, the
    true values). Same signature and returns as the port's single-grid
    `correct_divmax` (`rho` the new cell density): u's zero wall plane
    is written again and the div max is the maximum over the shards.
    With y shards on blocks extended by a row each way, the div max over
    the rank's own rows (the kernel's row window)."""
    yb = YBlock(ctx, dp.shape[1], (1, 1))
    if yb.on:
        (dp, u_s, v_s, w_s, *beta_f, ax_ap, ay_ap, az_ap, vfrac, top_open,
         rho) = yb.extend(dp, u_s, v_s, w_s, *beta_f, ax_ap, ay_ap, az_ap,
                          vfrac, top_open if open_top else None, rho)
    nx = dp.shape[0]
    bx, by, bz = beta_f
    dps = ctx.split(dp)
    packed = [ctx.split(t, nx) for t in (u_s, bx, ax_ap)]
    dh, *his = exchange_halos([(dps, 1, "clamp", "clamp")]
                              + [(t, (0, 1), "zero", "zero") for t in packed],
                              ctx)
    his = [[h[1] for h in t] for t in his]
    rest = [ctx.split(t) for t in (v_s, w_s, by, bz, ay_ap, az_ap, vfrac,
                                   rho)]
    topo = ctx.split(top_open) if open_top else None
    uc = torch.empty_like(u_s)
    uc[-1] = 0.0
    vc, wc = torch.empty_like(v_s), torch.empty_like(w_s)
    uc_s, vc_s, wc_s = ctx.split(uc, nx), ctx.split(vc), ctx.split(wc)
    parts = []
    for s in range(len(dps)):
        u_p, bx_p, ax_p = (t[s] for t in packed)
        h_u, h_bx, h_ax = (h[s] for h in his)
        v_, w_, by_, bz_, ay_, az_, vf_, rho_ = (t[s] for t in rest)
        parts.append(ck.correct_divmax_h(
            dps[s], *dh[s], u_p, h_u, v_, w_, bx_p, h_bx, by_, bz_, ax_p,
            h_ax, ay_, az_, vf_, None if topo is None else topo[s], rho_, dt,
            spacing, open_top=open_top,
            out=(uc_s[s], vc_s[s], wc_s[s]), rows=yb.rows)[3])
    uc = _fill_last_face(uc, ctx)
    return (yb.crop(uc), yb.crop(vc), yb.crop(wc),
            pmax_scalar(parts, ctx))
