"""Matrix-free pressure Poisson solve: multigrid-preconditioned CG.

Port of openfoam_tpp_tpu/solver/poisson.py. The 7-point operator

    A(p)[c] = diag·p − Σ_f w_f·p_neighbor,   w_f = a_f β_f / h²

(a_f cut-cell apertures, β_f = 1/ρ at faces) is solved by CG in the
symmetrically diagonal-scaled space Â = D^-½ A D^-½ (scaling folded into
the face weights at build time), preconditioned by a bf16 V-cycle:
Chebyshev smoothing on the scaled top level and a coarse correction on
the physical Galerkin hierarchy (2×2×2 sum restriction, injection
prolongation). The open top is a half-cell Dirichlet diagonal term;
closed tanks are singular and the constant nullspace is projected out.

The knobs the JAX package reads from OFTPP_* variables at import are one
frozen record here, `SolverKnobs`, with the same variables and defaults.
`SolverKnobs.from_env()` reads them; the step (solver/timestep.py) and
`build_poisson` do so when they are built, and `make_bundle` /
`attach_precond` carry the record.

With `use_pallas` every level's stencil passes go through
ops/kernels/seven_point.py (any shape: the CUDA kernel has no slab or
VMEM limit), and the CG curvature step is the fused apply+dot. With two
Chebyshev sweeps (OFTPP_SMOOTH_SWEEPS=2) the top level's entry and exit
smoothing are one fused kernel each (`cheb2_pre_7pt`, `cheb2_post_7pt`),
and with OFTPP_FUSED_RZ (on by default) the exit kernel also returns
CG's r·z (`cheb2_post_dot_7pt`), so the separate dot is not paid. With
one sweep those kernels never run and r·z is a plain dot.

In the x-sharded step (`spmd`, parallel/spmd.py) the scaled top level
(f32 and the bf16 bundle top) and the physical f32 top level run the
7-point islands: per-shard halo kernels (ops/kernels/halo7.py), and the
CG curvature step is the apply+dot island whose per-shard partial dots
are summed in shard order. The coarse levels run the plain path, and the
fused cheb2 smoothers are off on sharded levels (two sweeps there take
the generic smoother, whose inner residual is the island), as in the JAX
package.

In a rank process of the sharded step (`SpmdCtx(ranks=...)`,
parallel/ranks.py) every array is the rank's x·y block: the dots
all-reduce (ops/stencil.py `sum_cells`), the plain coarse levels exchange
their x- and y-neighbour planes and rows, and the hierarchy is the
global one. Its levels and shapes follow from the global shape; a level
stays a block while its local nx and (with y shards) its local ny are
even (2:1 pairs within the rank; a y-face weight keeps its shared last
row, as an x-face weight its shared last plane), and the first level
whose local nx or ny is odd is gathered whole on every rank once per
bundle (its operator) and once per visit (its right-hand side): every
rank runs it and the levels below redundantly and keeps its own block
of the correction, OpenFOAM GAMG's processor agglomeration extended to
2-D blocks. The cycle is the single-process sharded cycle's, bit for
bit. On a sweep's batched block (a farm over a (C, N, M) rank grid)
every reduction and gather is over the rank's case group, and the
coarse levels keep the batch kernels as the one-process sweep does: on
blocks extended by a cell a side (parallel/spmd.py `XYBlock`) down to
the gathered level, on whole arrays from it on. Every level's values are
then the unfarmed batch's, bit for bit; only the dots' sum order
differs.

CG loop: the JAX `lax.while_loop` is a Python loop here that reads
`rr > tol2` on the host once per iteration — one device sync per CG
iteration (plus one before the first). The loop writes its carry (x, r,
p, r·z, ‖r‖²) in place, so on a card the body of one iteration between
two reads — the apply-dot, the updates, the V-cycle — is captured once a
call as a CUDA graph (`_IterGraph`) and replayed for the later
iterations: one launch where the host made a few hundred. The graph is
taken from the input alone: CUDA operands, no sharded or rank context
(its exchanges are host work) and no NaN trap (it reads the host); else
the same loop runs eagerly. Either way the arithmetic is the same, bit
for bit.

Parameter sweeps: every array may carry a trailing case axis,
(nx, ny, nz, B). Stencil passes then go to the batch-native kernels (the
rank dispatch of ops/kernels/seven_point.py), every dot, norm and
tolerance is per case, shape (B,), and the CG loop runs while any case
is unconverged and holds the converged ones (x, r, p, r·z, ‖r‖², count),
which is what `jax.vmap` makes of the JAX loop: a case's solve does not
depend on its batchmates, and its iteration count is its own. The fused
cheb2 kernels are single-grid: on a batched level two sweeps run as
batch-kernel passes and r·z is a plain per-case sum.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.parallel import spmd as sm
from openfoam_tpp_tpu_torch.utils.profiling import (entry_launches,
                                                    graph_captured,
                                                    graph_replayed, host_read,
                                                    span)

_JACOBI_OMEGA = 0.8
_F32_CG_FLOOR = 3e-5


@dataclasses.dataclass(frozen=True)
class SolverKnobs:
    """The pressure solver's tuning knobs; each field names its variable."""

    coarsest_sweeps: int = 24     # OFTPP_COARSEST_SWEEPS
    smooth_sweeps: int = 1        # OFTPP_SMOOTH_SWEEPS: sweeps per pass
    smoother: str = "chebyshev"   # OFTPP_SMOOTHER: 'chebyshev' | 'jacobi'
    cheb_lmax: float = 2.0        # OFTPP_CHEB_LMAX: Gershgorin bound
    cheb_lmin_frac: float = 0.10  # OFTPP_CHEB_LMIN: window's lower end
    fused_cheb: bool = True       # OFTPP_FUSED_CHEB != "0"
    mg_l1_gamma: int = 2          # OFTPP_MG_L1_GAMMA: visits at level 1
    mg_deep_gamma: int = 1        # OFTPP_MG_DEEP_GAMMA: visits below it
    fused_rz: bool = True         # OFTPP_FUSED_RZ == "1"
    precond_f32: bool = False     # OFTPP_PRECOND_F32 == "1"

    @staticmethod
    def from_env() -> "SolverKnobs":
        d, env = SolverKnobs(), os.environ.get
        return SolverKnobs(
            coarsest_sweeps=int(env("OFTPP_COARSEST_SWEEPS", d.coarsest_sweeps)),
            smooth_sweeps=int(env("OFTPP_SMOOTH_SWEEPS", d.smooth_sweeps)),
            smoother=env("OFTPP_SMOOTHER", d.smoother),
            cheb_lmax=float(env("OFTPP_CHEB_LMAX", d.cheb_lmax)),
            cheb_lmin_frac=float(env("OFTPP_CHEB_LMIN", d.cheb_lmin_frac)),
            fused_cheb=env("OFTPP_FUSED_CHEB", "1") != "0",
            mg_l1_gamma=int(env("OFTPP_MG_L1_GAMMA", d.mg_l1_gamma)),
            mg_deep_gamma=int(env("OFTPP_MG_DEEP_GAMMA", d.mg_deep_gamma)),
            fused_rz=env("OFTPP_FUSED_RZ", "1") == "1",
            precond_f32=env("OFTPP_PRECOND_F32") == "1",
        )

    @property
    def precond_dtype(self):
        return torch.float32 if self.precond_f32 else torch.bfloat16


@dataclasses.dataclass
class _Level:
    wx: torch.Tensor | None   # (nx+1, ny, nz) x-face weights
    wy: torch.Tensor | None
    wz: torch.Tensor | None
    diag: torch.Tensor | None   # None on unit-diagonal levels
    shape: tuple
    split: tuple | None = None  # face-lite weights: the kernel serves it
    unit_diag: bool = False
    spmd: object = None         # parallel.spmd.SpmdCtx: the kernel applies
                                # run as per-shard islands
    agg: object = None          # parallel.ranks.RankCtx: the first level
                                # gathered whole on every rank


@dataclasses.dataclass
class PoissonProblem:
    apply: Callable              # p -> A(p) (physical operator)
    precond: Callable | None     # r -> M⁻¹ r (physical space)
    diag: torch.Tensor
    fluid: torch.Tensor
    singular: bool
    beta_faces: tuple            # face 1/ρ, shared with the correction
    c_top: torch.Tensor | None   # top Dirichlet coefficient 2·a·β
    scale: torch.Tensor | None = None       # s = fluid / sqrt(diag)
    inv_scale: torch.Tensor | None = None   # fluid · sqrt(diag)
    apply_hat: Callable | None = None       # Â
    precond_hat: Callable | None = None     # M̂⁻¹ (bf16 V-cycle)
    apply_dot_hat: Callable | None = None   # p -> (Â·p, p·Â·p), kernel path
    precond_rz_hat: Callable | None = None  # r -> (M̂⁻¹r, r·M̂⁻¹r or None),
                                            # the dot from the exit kernel
    spmd: object = None          # parallel.spmd.SpmdCtx of the islands


def _weights_apply(level: _Level, p):
    if level.split is not None:
        diag = None if level.unit_diag else level.diag
        if level.spmd is not None:
            return sm.apply_7pt(p, level.split, level.spmd, diag=diag)
        return sp.apply_7pt(p, level.split, diag)
    wx, wy, wz = level.wx, level.wy, level.wz
    (xd, xu), (yd, yu), (zd, zu) = (st.shift_both(p, ax) for ax in range(3))
    nb = (
        wx[:-1] * xd + wx[1:] * xu
        + wy[:, :-1] * yd + wy[:, 1:] * yu
        + wz[:, :, :-1] * zd + wz[:, :, 1:] * zu
    )
    if level.unit_diag:
        return p - nb
    return level.diag * p - nb


def _resid_scaled(level: _Level, x, b):
    """(b − A·x)/diag (b − Â·x on unit-diagonal levels)."""
    if level.split is not None:
        diag = None if level.unit_diag else level.diag
        if level.spmd is not None:
            return sm.resid_scaled_7pt(x, level.split, level.spmd, b,
                                       diag=diag)
        return sp.resid_scaled_7pt(x, level.split, diag, b)
    if level.unit_diag:
        return b - _weights_apply(level, x)
    return (b - _weights_apply(level, x)) / level.diag


def _jacobi(level: _Level, x, b, n):
    """`x=None` means x≡0: the first sweep's apply is elided."""
    if x is None and n > 0:
        x = _JACOBI_OMEGA * b if level.unit_diag else _JACOBI_OMEGA * b / level.diag
        n -= 1
    for _ in range(n):
        x = x + _JACOBI_OMEGA * _resid_scaled(level, x, b)
    return x


def _chebyshev(level: _Level, x, b, degree, k: SolverKnobs):
    """Chebyshev smoother on the Jacobi-preconditioned operator over
    [cheb_lmin_frac·λmax, λmax]; `x=None` means x≡0."""
    lmax = k.cheb_lmax
    a, c = k.cheb_lmin_frac * lmax, 1.02 * lmax
    theta = 0.5 * (c + a)
    delta = 0.5 * (c - a)
    sigma = theta / delta
    if x is None:
        d = b if level.unit_diag else b / level.diag
    else:
        d = _resid_scaled(level, x, b)
    p = d / theta
    x = p if x is None else x + p
    rho = 1.0 / sigma
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = _resid_scaled(level, x, b)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * d
        x = x + p
        rho = rho_new
    return x


def _smooth(level: _Level, x, b, k: SolverKnobs):
    if k.smoother == "chebyshev":
        return _chebyshev(level, x, b, k.smooth_sweeps, k)
    return _jacobi(level, x, b, k.smooth_sweeps)


def _fused_cheb2(level: _Level, k: SolverKnobs) -> bool:
    """The degree-2 Chebyshev sweeps of a unit-diagonal kernel level run
    as one fused kernel pass each (seven_point.cheb2_*_7pt) instead of
    four stencil passes and the elementwise chains between them. Not on a
    sharded level: no halo form of them exists."""
    return (k.fused_cheb and level.split is not None and level.unit_diag
            and level.spmd is None and level.split[0].dim() == 3
            and k.smoother == "chebyshev" and k.smooth_sweeps == 2)


def _smooth_pre_resid(level: _Level, b, k: SolverKnobs):
    """(x, r): entry smoothing from x≡0 plus its residual."""
    if _fused_cheb2(level, k):
        return sp.cheb2_pre_7pt(b, level.split, k.cheb_lmax, k.cheb_lmin_frac)
    x = _smooth(level, None, b, k)
    r = (_resid_scaled(level, x, b) if level.unit_diag
         else b - _weights_apply(level, x))
    return x, r


def _smooth_post(level: _Level, x, b, k: SolverKnobs, out_dtype=None):
    """Exit smoothing continuing from the corrected x. On the fused route
    `out_dtype` widens the result on the kernel's store (bf16 cycle → f32
    CG hand-off) instead of a separate cast pass."""
    if _fused_cheb2(level, k):
        return sp.cheb2_post_7pt(x, b, level.split, k.cheb_lmax,
                                 k.cheb_lmin_frac, out_dtype=out_dtype)
    x = _smooth(level, x, b, k)
    return x if out_dtype is None else x.to(out_dtype)


def _pad_axis_even(a, axis):
    """Zero-pad one axis to even length (ghost cells carry zero weight)."""
    if a.shape[axis] % 2 == 0:
        return a
    shape = list(a.shape)
    shape[axis] = 1
    return torch.cat([a, a.new_zeros(shape)], dim=axis)


def _sum_pairs(a, axis):
    even = a[st._sl(axis, slice(0, None, 2))]
    odd = a[st._sl(axis, slice(1, None, 2))]
    return even + odd


def _restrict_cells(a):
    """2×2×2 sum of a cell array (zero-padded to even first)."""
    for d in range(3):
        a = _sum_pairs(_pad_axis_even(a, d), d)
    return a


def _prolong_cells(a, fine_shape):
    """Piecewise-constant injection back to the fine grid (keeps the
    coarse weights the exact Galerkin operator)."""
    out = a.repeat_interleave(2, 0).repeat_interleave(2, 1).repeat_interleave(2, 2)
    return out[: fine_shape[0], : fine_shape[1], : fine_shape[2]]


def _coarsen_face_weights(w, axis):
    """Coarse cross-face weights: fine faces at even positions along
    `axis`, 2×2-summed transversally."""
    n_cells = w.shape[axis] - 1
    if n_cells % 2 == 1:
        shape = list(w.shape)
        shape[axis] = 1
        w = torch.cat([w, w.new_zeros(shape)], dim=axis)
    w = w[st._sl(axis, slice(0, None, 2))]
    for d in range(3):
        if d != axis:
            w = _sum_pairs(_pad_axis_even(w, d), d)
    return w


def _build_coarse_levels(wx, wy, wz, extra, max_coarse=9, min_cells=256,
                         ranks=None):
    """Physical Galerkin hierarchy strictly below the given fine level.
    `ranks`: the operands are this rank's x·y blocks; the hierarchy is
    the global one, the first level of odd local nx (or, with y shards,
    odd local ny) and those below it gathered whole (`_Level.agg` marks
    the first)."""
    levels = []
    n, m = (1, 1) if ranks is None else ranks.grid
    shape = (extra.shape[0] * n, extra.shape[1] * m, extra.shape[2])
    while (len(levels) < max_coarse
           and shape[0] * shape[1] * shape[2] > min_cells
           and min(shape) > 2):
        wx = _coarsen_face_weights(wx, 0)
        wy = _coarsen_face_weights(wy, 1)
        wz = _coarsen_face_weights(wz, 2)
        extra = _restrict_cells(extra)
        diag = (wx[:-1] + wx[1:] + wy[:, :-1] + wy[:, 1:]
                + wz[:, :, :-1] + wz[:, :, 1:] + extra)
        diag = torch.where(diag > 0, diag, 1.0)
        agg = None
        if (n > 1 and extra.shape[0] % 2) or (m > 1 and extra.shape[1] % 2):
            agg = ranks
            wx = ranks.gather_block(wx, faces=0)
            wy = ranks.gather_block(wy, faces=1)
            wz, diag, extra = (ranks.gather_block(t)
                               for t in (wz, diag, extra))
            n = m = 1
        shape = (extra.shape[0] * n, extra.shape[1] * m, extra.shape[2])
        levels.append(_Level(wx=wx, wy=wy, wz=wz, diag=diag,
                             shape=tuple(extra.shape[:3]), agg=agg))
    return levels


def _vcycle(levels, li, b, k: SolverKnobs):
    level = levels[li]
    if level.agg is not None and st.block_ranks() is not None:
        # The first gathered level: its right-hand side whole on every
        # rank, the rest of the cycle on whole levels, this rank's block
        # of the correction.
        bg = level.agg.gather_block(b)
        with st.rank_block(None):
            xg = _vcycle(levels, li, bg, k)
        return level.agg.block(xg, xg.shape)
    if li == len(levels) - 1:
        return _jacobi(level, None, b, k.coarsest_sweeps)
    x = _smooth(level, None, b, k)
    gamma = k.mg_l1_gamma if li == 0 else k.mg_deep_gamma
    for g in range(max(gamma, 1)):
        if g:
            x = _smooth(level, x, b, k)
        r = b - _weights_apply(level, x)
        ec = _vcycle(levels, li + 1, _restrict_cells(r), k)
        x = x + _prolong_cells(ec, level.shape)
    return _smooth(level, x, b, k)


def _vcycle_hybrid(top_hat, inv_s, levels_coarse, b, k: SolverKnobs,
                   out_dtype=None, with_dot=False):
    """V-cycle on the SCALED top level with the coarse correction on the
    PHYSICAL Galerkin hierarchy (space conversion folded into the
    transfers: r_phys = inv_s ⊙ r̂, ê = inv_s ⊙ P e_phys).

    `with_dot`: return (z, Σ b·z) with the dot from the fused exit
    kernel, or (z, None) where that kernel does not serve the top level."""
    x, r = _smooth_pre_resid(top_hat, b, k)
    if levels_coarse:
        ec = _vcycle(levels_coarse, 0, _restrict_cells(inv_s * r), k)
        x = x + inv_s * _prolong_cells(ec, top_hat.shape)
    else:
        x = x + _jacobi(top_hat, None, r, k.coarsest_sweeps)
    if with_dot and _fused_cheb2(top_hat, k):
        return sp.cheb2_post_dot_7pt(x, b, top_hat.split, k.cheb_lmax,
                                     k.cheb_lmin_frac, out_dtype=out_dtype)
    x = _smooth_post(top_hat, x, b, k, out_dtype)
    return (x, None) if with_dot else x


def build_operator(geom_arrays, spacing, rho, top_open, use_pallas=False,
                   spmd=None):
    """The OPERATOR half of the pressure problem (fresh every step):
    physical A, the scaled Â with the scaling folded into the face
    weights, the scaling vectors and the face 1/ρ. Returns (problem,
    pack); `pack` feeds make_bundle. With `spmd` the kernel applies run
    as per-shard islands."""
    hx, hy, hz = spacing
    vfrac = geom_arrays["vfrac"]
    fluid = vfrac > 0.0

    # β = 1/⟨ρ⟩ with the arithmetic face density (hydrostatic balance).
    bx = 1.0 / st.cells_to_faces_avg(rho, 0)
    by = 1.0 / st.cells_to_faces_avg(rho, 1)
    bz = 1.0 / st.cells_to_faces_avg(rho, 2)
    beta = torch.where(fluid, 1.0 / rho, 0.0)
    wx = geom_arrays["ax"] * bx / (hx * hx)
    wy = geom_arrays["ay"] * by / (hy * hy)
    wz = geom_arrays["az"] * bz / (hz * hz)
    wz[:, :, -1] = 0.0   # the top face is a diagonal-only Dirichlet term

    singular = top_open is None
    extra = torch.where(fluid, 0.0, 1.0).to(rho.dtype)
    c_top = None
    if not singular:
        c_top = 2.0 * top_open * beta[:, :, -1]
        extra[:, :, -1] = extra[:, :, -1] + c_top / (hz * hz)

    shape = tuple(extra.shape[:3])
    diag0 = (wx[:-1] + wx[1:] + wy[:, :-1] + wy[:, 1:]
             + wz[:, :, :-1] + wz[:, :, 1:] + extra)
    diag0 = torch.where(diag0 > 0, diag0, 1.0)

    def _with_kernel(level: _Level) -> _Level:
        if not use_pallas:
            return level
        return dataclasses.replace(
            level, split=sp.split_weights(level.wx, level.wy, level.wz),
            spmd=spmd)

    top = _with_kernel(_Level(wx=wx, wy=wy, wz=wz, diag=diag0, shape=shape))

    # Scaled space: ŵ_f = w_f·s_left·s_right once per face; diag_hat ≡ 1
    # on fluid, solid rows identity with zero couplings.
    s = torch.where(fluid, torch.rsqrt(diag0), 0.0)
    inv_s = torch.where(fluid, torch.sqrt(diag0), 0.0)
    sl_x, sr_x = st.face_lr(s, 0)
    sl_y, sr_y = st.face_lr(s, 1)
    sl_z, sr_z = st.face_lr(s, 2)
    hwx = wx * sl_x * sr_x
    hwy = wy * sl_y * sr_y
    hwz = wz * sl_z * sr_z
    top_hat = _with_kernel(_Level(wx=hwx, wy=hwy, wz=hwz, diag=None,
                                  shape=shape, unit_diag=True))

    apply_dot_hat = None
    if top_hat.split is not None and spmd is not None:
        def apply_dot_hat(p):
            return sm.apply_dot_7pt(p, top_hat.split, spmd)
    elif top_hat.split is not None:
        def apply_dot_hat(p):
            return sp.apply_dot_7pt(p, top_hat.split)

    problem = PoissonProblem(
        apply=lambda p: _weights_apply(top, p), precond=None, diag=diag0,
        fluid=fluid, singular=bool(singular), beta_faces=(bx, by, bz),
        c_top=c_top, scale=s, inv_scale=inv_s,
        apply_hat=lambda p: _weights_apply(top_hat, p),
        apply_dot_hat=apply_dot_hat, spmd=spmd,
    )
    pack = {"wx": wx, "wy": wy, "wz": wz, "extra": extra,
            "hwx": hwx, "hwy": hwy, "hwz": hwz, "inv_s": inv_s}
    return problem, pack


def _bundle_entry(wx, wy, wz, use_pallas, diag=None, agg=False,
                  whole=False):
    """One hierarchy level: face-lite split weights on the kernel path,
    face weights otherwise. `diag=None` = unit-diagonal level; `agg`: the
    first level a rank process holds whole; `whole`: that level or one
    below it."""
    d = {}
    if agg:
        d["agg"] = True
    if whole:
        d["whole"] = True
    if diag is not None:
        d["diag"] = diag
    if use_pallas:
        d["split"] = sp.split_weights(wx, wy, wz)
    else:
        d["faces"] = (wx, wy, wz)
    return d


def make_bundle(pack, use_pallas=False, knobs: SolverKnobs = SolverKnobs(),
                spmd=None):
    """The bf16 V-cycle preconditioner state: scaled top level + physical
    Galerkin coarse hierarchy coarsened directly in bf16 (f32 with
    `knobs.precond_f32`). Reusing a stale bundle is physics-exact (it is
    only the preconditioner). Under `spmd` the coarse levels keep face
    weights (the plain path), as in the JAX package; under `spmd.ranks`
    the hierarchy is the global one (module docstring), and a batched
    block's coarse levels keep the batch kernels of the one-process
    sweep (on extended blocks, and whole from the gathered level on), so
    every level's arithmetic is the unfarmed batch's."""
    lp = knobs.precond_dtype
    top = _bundle_entry(pack["hwx"].to(lp), pack["hwy"].to(lp),
                        pack["hwz"].to(lp), use_pallas)
    ranks = None if spmd is None else spmd.ranks
    kernels = use_pallas and (spmd is None or (
        ranks is not None and pack["wx"].dim() == 4))
    coarse, whole = [], False
    for lev in _build_coarse_levels(
            pack["wx"].to(lp), pack["wy"].to(lp), pack["wz"].to(lp),
            pack["extra"].to(lp), ranks=ranks):
        whole = whole or lev.agg is not None
        coarse.append(_bundle_entry(lev.wx, lev.wy, lev.wz, kernels,
                                    diag=lev.diag, agg=lev.agg is not None,
                                    whole=whole))
    return {"top": top, "coarse": coarse, "inv_s": pack["inv_s"].to(lp)}


def _level_from_entry(d, unit_diag, spmd=None):
    """A _Level from a bundle entry; `spmd` runs a split level's kernel
    passes as islands (not on a level a rank holds whole) and carries a
    rank process's gathered level."""
    agg = (spmd.ranks if d.get("agg") and spmd is not None else None)
    split = d.get("split")
    if split is not None:
        return _Level(wx=None, wy=None, wz=None, diag=d.get("diag"),
                      shape=tuple(split[0].shape[:3]), split=split,
                      unit_diag=unit_diag,
                      spmd=None if d.get("whole") else spmd, agg=agg)
    wx, wy, wz = d["faces"]
    shape = (wx.shape[0] - 1,) + tuple(wx.shape[1:3])
    return _Level(wx=wx, wy=wy, wz=wz, diag=d.get("diag"), shape=shape,
                  unit_diag=unit_diag, agg=agg)


def attach_precond(problem: PoissonProblem, bundle,
                   knobs: SolverKnobs = SolverKnobs(),
                   spmd=None) -> PoissonProblem:
    """Wire a make_bundle dict into the problem's precond closures; with
    `spmd` the top level's kernel passes run as per-shard islands."""
    top16 = _level_from_entry(bundle["top"], unit_diag=True, spmd=spmd)
    coarse16 = [_level_from_entry(d, unit_diag=False, spmd=spmd)
                for d in bundle["coarse"]]
    inv_s16 = bundle["inv_s"]
    lp = inv_s16.dtype
    s = problem.scale

    def precond_hat(r):
        return _vcycle_hybrid(top16, inv_s16, coarse16, r.to(lp), knobs,
                              out_dtype=r.dtype)

    precond_rz_hat = None
    if knobs.fused_rz:
        def precond_rz_hat(r):
            # rz is None when the fused exit kernel does not serve the
            # top level: the caller then takes the plain f32 dot.
            return _vcycle_hybrid(top16, inv_s16, coarse16, r.to(lp), knobs,
                                  out_dtype=r.dtype, with_dot=True)

    def precond(r):
        return s * precond_hat(s * r)

    return dataclasses.replace(problem, precond=precond,
                               precond_hat=precond_hat,
                               precond_rz_hat=precond_rz_hat,
                               spmd=problem.spmd if spmd is None else spmd)


def build_poisson(geom_arrays, spacing, rho, top_open, use_pallas=False,
                  knobs: SolverKnobs | None = None, spmd=None):
    """Operator + MG preconditioner for the current density in one call.
    `knobs=None` reads the OFTPP_* variables now."""
    if knobs is None:
        knobs = SolverKnobs.from_env()
    problem, pack = build_operator(geom_arrays, spacing, rho, top_open,
                                   use_pallas=use_pallas, spmd=spmd)
    bundle = make_bundle(pack, use_pallas=use_pallas, knobs=knobs, spmd=spmd)
    return attach_precond(problem, bundle, knobs, spmd=spmd)


def _dot(a, b):
    """f32 dot over the cells: 0-d, or per case (B,) on a batched grid."""
    return st.sum_cells(a.float() * b.float())


def _project_out(x, v, fluid, vv, out=None):
    """Remove the component of x along nullspace vector v (fluid support);
    `out`: the tensor that takes the result (x itself: in place)."""
    coef = _dot(torch.where(fluid, x, 0.0), v) / vv
    return torch.where(fluid, x - coef * v, x, out=out)


# Per device: the one graph memory pool every capture of the process
# draws on, the side stream captures run on, and the last graph captured.
# A pool whose graphs are all gone is freed and cannot be shared again, so
# the last graph is held (never replayed) until the next capture takes the
# pool: no step pays cudaMalloc or cudaFree for its graph. The price: the
# pool's blocks (one iteration's temporaries) stay reserved through the
# rest of the step, where the default pool cannot use them, and
# `torch.cuda.max_memory_allocated()` does not count them after the
# capture; `torch.cuda.max_memory_reserved()` does.
_GRAPH_POOLS: dict = {}


class _IterGraph:
    """`body()`, one CG iteration that writes the loop's carry in place,
    captured as a CUDA graph to `replay()` in its place. It holds `body`,
    and with it every tensor the graph reads or writes, for as long as it
    can be replayed. Captures and replays are counted under `site`; a
    replay credits each kernel entry with the launches its capture
    recorded (utils/profiling.py)."""

    def __init__(self, body, site, device):
        pool, stream, _ = _GRAPH_POOLS.get(device) or (
            torch.cuda.graph_pool_handle(), torch.cuda.Stream(device), None)
        before = entry_launches()
        graph = torch.cuda.CUDAGraph()
        # No synchronize or empty_cache (torch.cuda.graph's entry does
        # both): the capture allocates from its own pool only.
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                body()
            finally:
                graph.capture_end()
        _GRAPH_POOLS[device] = (pool, stream, graph)
        self.launches = {fn: n - before.get(fn, 0)
                         for fn, n in entry_launches().items()
                         if n != before.get(fn, 0)}
        self._graph, self._body, self._site = graph, body, site
        graph_captured(site, self.launches)

    def replay(self):
        self._graph.replay()
        graph_replayed(self._site, self.launches)


def _graphs_engage(b) -> bool:
    """Whether a CG iteration on `b` runs as a CUDA graph: CUDA operands,
    no rank block open (its exchanges are host work) and no NaN hook (it
    reads the host). The caller rules out islands (`PoissonProblem.spmd`)."""
    return b.is_cuda and st.block_ranks() is None and _build.nan_hook is None


def _iterate(body, test, graphs, site, device):
    """Run `body()` while `test(iterations so far)` is true; the number of
    iterations. With `graphs` the first iteration runs eagerly and the
    later ones replay one capture of `body`. That first iteration builds
    every kernel and makes or grows the scratch a kernel entry keeps
    across calls (`_build.ticket`), so none of it is born in the graph's
    pool, and a solve that stops after it pays no capture."""
    n, graph = 0, None
    while test(n):
        if graph is None and graphs and n:
            graph = _IterGraph(body, site, device)
        if graph is None:
            body()
        else:
            graph.replay()
        n += 1
    return n


def _cg_core(apply_h, precond_h, fluid, b, tol, max_iters, nullv, nullvv,
             apply_dot_h=None, precond_rz_h=None, _graphs=True):
    """Plain preconditioned CG from a zero guess in the scaled space.
    Returns (x, iterations). `b` is the loop's residual, overwritten. One
    host sync per iteration: the convergence test `rr > tol2` is read on
    the host (`host_read`, site "poisson.cg"; the loop ends on a false
    test, so a call reads iterations + 1 times below the cap).
    `precond_rz_h` returns z with r·z from the V-cycle's exit kernel
    (against the cycle's low-precision copy of r).

    The loop's carry is written in place, so that on a card its later
    iterations replay one CUDA graph (`_iterate`, `_graphs_engage`);
    `_graphs=False` runs them all eagerly, bit for bit the same.

    On a batched grid the dots and `tol` are per case: the loop runs
    while any case has `rr > tol2` (still one host read per iteration)
    and every case whose own test is false keeps its x, r, p, rz, rr and
    count, so iterations come back as a (B,) int32 tensor."""

    def precond_rz(r):
        if precond_rz_h is not None:
            z, rz = precond_rz_h(r)
            return z, (_dot(r, z) if rz is None else rz)
        z = precond_h(r)
        return z, _dot(r, z)

    r = b
    z, rz = precond_rz(r)
    x = torch.zeros_like(b)
    p = z
    rr = _dot(r, r)
    tol2 = tol * tol
    graphs = _graphs and _graphs_engage(b)
    if b.dim() == 4:
        return _cg_lanes(apply_h, precond_rz, fluid, nullv, nullvv,
                         apply_dot_h, max_iters, tol2, x, r, p, rz, rr,
                         graphs)

    def body():
        if apply_dot_h is not None:
            ap, denom = apply_dot_h(p)
        else:
            ap = apply_h(p)
            denom = _dot(p, ap)
        alpha = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        x.add_(alpha * p)
        r.sub_(alpha * ap)
        if nullv is not None:
            _project_out(r, nullv, fluid, nullvv, out=r)
        z, rz_new = precond_rz(r)
        beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        torch.add(z, beta * p, out=p)
        rz.copy_(rz_new)
        rr.copy_(_dot(r, r))

    k = _iterate(body, lambda k: (k < max_iters
                                  and host_read(rr > tol2, "poisson.cg")),
                 graphs, "poisson.cg", b.device)
    return x, k


def _cg_lanes(apply_h, precond_rz, fluid, nullv, nullvv, apply_dot_h,
              max_iters, tol2, x, r, p, rz, rr, graphs):
    """`_cg_core`'s loop over a batch of cases: the same body for all,
    then each case whose own `k < max_iters and rr > tol2` is false keeps
    its carry (selected into the carry's own tensors)."""
    k = torch.zeros_like(rr, dtype=torch.int32)
    active = rr > tol2

    def body():
        if apply_dot_h is not None:
            ap, denom = apply_dot_h(p)
        else:
            ap = apply_h(p)
            denom = _dot(p, ap)
        alpha = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        if nullv is not None:
            r_new = _project_out(r_new, nullv, fluid, nullvv)
        z, rz_new = precond_rz(r_new)
        beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p_new = z + beta * p
        torch.where(active, x_new, x, out=x)
        torch.where(active, r_new, r, out=r)
        torch.where(active, p_new, p, out=p)
        torch.where(active, rz_new, rz, out=rz)
        torch.where(active, _dot(r_new, r_new), rr, out=rr)
        k.add_(active.to(torch.int32))
        torch.bitwise_and(k < max_iters, rr > tol2, out=active)

    _iterate(body, lambda _: host_read(active.any(), "poisson.cg_lanes"),
             graphs, "poisson.cg_lanes", x.device)
    return x, k


def solve_pcg(problem: PoissonProblem, b, x0, precond: Callable | None = None,
              tol_rel: float = 1e-4, tol_abs: float = 0.0,
              tol_rel_b: float = 0.0, max_iters: int = 60, n_refine: int = 3):
    """MG-preconditioned CG with outer iterative refinement in the scaled
    space. Stops at max(tol_rel·‖r0‖, tol_abs, tol_rel_b·‖b̂‖) (scaled
    norms). Returns (x, scaled-residual norm, total iterations as a 0-d
    int32 tensor); on a batched grid the norm and the iterations are per
    case, shape (B,)."""
    fluid = problem.fluid
    s = problem.scale
    inv_s = problem.inv_scale
    apply_h = problem.apply_hat

    if precond is not None:
        def precond_h(r):
            return inv_s * torch.where(fluid, precond(inv_s * r), 0.0)
    else:
        precond_h = problem.precond_hat

    nullv = inv_s if problem.singular else None
    nullvv = _dot(inv_s, inv_s) if problem.singular else None

    bh = s * b
    if problem.singular:
        bh = _project_out(bh, nullv, fluid, nullvv)
    xh = inv_s * x0

    def true_residual(xh):
        r = bh - apply_h(xh)
        if problem.singular:
            r = _project_out(r, nullv, fluid, nullvv)
        return r

    r = true_residual(xh)
    tol = torch.clamp(tol_rel * torch.sqrt(_dot(r, r)), min=tol_abs)
    tol_rel_b = min(tol_rel_b, tol_rel)
    if tol_rel_b > 0.0:
        tol = torch.maximum(tol, tol_rel_b * torch.sqrt(_dot(bh, bh)))
    if tol_rel >= 10.0 * _F32_CG_FLOOR:
        n_refine = 1   # the f32 recurrence floor never binds

    total = 0
    for _ in range(n_refine):
        inner_tol = torch.maximum(_F32_CG_FLOOR * torch.sqrt(_dot(r, r)), tol)
        with span("pressure.cg"):
            dx, iters = _cg_core(apply_h, precond_h, fluid, r, inner_tol,
                                 max_iters, nullv, nullvv,
                                 apply_dot_h=problem.apply_dot_hat,
                                 precond_rz_h=(problem.precond_rz_hat
                                               if precond is None else None),
                                 _graphs=problem.spmd is None)
        xh = xh + dx
        total += iters
        r = true_residual(xh)
    x = s * xh
    if problem.singular:
        n_fluid = torch.clamp(st.sum_cells(fluid.float()), min=1.0)
        mean = st.sum_cells(torch.where(fluid, x, 0.0)) / n_fluid
        x = torch.where(fluid, x - mean, x)
    if not isinstance(total, torch.Tensor):
        # a fill: a host-to-device copy of the count would wait for the
        # device
        total = torch.full((), total, dtype=torch.int32, device=b.device)
    return x, torch.sqrt(_dot(r, r)), total
