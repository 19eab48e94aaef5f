"""What the rank processes of tests/test_torch_ranks*.py run.

parallel/ranks.py `launch` pickles each job by its import path and runs
it in spawned processes, one a rank; they import torch and the port
only, never JAX (this module imports neither the JAX package nor the
test file, which does). Each job returns numpy arrays and counts.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import unittest.mock as mock

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.motion import motion_from_numpy
from openfoam_tpp_tpu_torch.core.state import (mixture_density,
                                               params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_box_geometry, build_tank_geometry
from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import halo7
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import poisson
from openfoam_tpp_tpu_torch.solver.timestep import geometry_arrays, make_step

CONTROLS = SolverControls(use_pallas=True, p_max_iters=30)
MOTION_FIELDS = ("times", "accel", "omega", "domega", "rot")
# The kernel entry points a step may reach: the islands' halo ones and
# the single-grid ones, which the sharded step must not.
ENTRY = {f"{m.__name__.rsplit('.', 1)[1]}.{n}": (m, n) for m, ns in (
    (halo7, ("apply_7pt_hs", "resid_scaled_7pt_hs", "apply_dot_7pt_h")),
    (mfx, ("flux_all_h", "flux_all")), (mf, ("fct_iter_h", "fct_iter")),
    (mrk, ("momentum_rhs_h", "momentum_rhs")),
    (ck, ("correct_divmax_h", "correct_divmax")),
    (sp, ("apply_7pt", "resid_scaled_7pt", "apply_dot_7pt"))) for n in ns}


def _counted():
    """Patches counting the calls of every ENTRY point (on the CPU the
    kernels' launch counters stay 0: their plain versions run)."""
    calls = collections.Counter()
    patches = []
    for name, (mod, attr) in ENTRY.items():
        fn = getattr(mod, attr)

        def run(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        patches.append(mock.patch.object(mod, attr, run))
    return calls, patches


def _steps(step, state, params, n_steps):
    """`n_steps` steps; the state after the first and the last, and every
    step's p_iters."""
    iters, first = [], None
    for i in range(n_steps):
        state, diag = step(state, params)
        iters.append(int(diag.p_iters))
        if i == 0:
            first = state
    return first, state, iters


def geometry(spec):
    """A tank from build_tank_geometry's keywords or, under a "box" key,
    the closed box from build_box_geometry's."""
    if "box" in spec:
        return build_box_geometry(**spec["box"], open_top=False)
    return build_tank_geometry(**spec)


def on_grid(ctx, grid):
    """The ranks of `ctx` laid on another (N, M) or (C, N, M) grid of the
    same world, with fresh stats (None: `ctx` itself); every rank makes
    the new grid's case groups."""
    if grid is None:
        return ctx
    return dataclasses.replace(ctx, grid=tuple(grid), cases=1, group=None,
                               stats=rk.ExchangeStats()).make_groups()


def steps(ctx, log, tank, init, params, n_steps, with_single=False,
          table=None, controls=CONTROLS, grid=None, props=None, env=None):
    """`n_steps` of the sharded step over the ranks (on the rank grid
    `grid`, default the launch's) from the numpy state `init` (rank 0
    scatters it), on `geometry(tank)`, under the motion `table` (numpy
    arrays named as TableMotion's fields) where given. Every rank returns
    its entry-point call counts, exchange stats and its motion's digest;
    rank 0 also the gathered states after the first and the last step
    and the p_iters. `with_single`: rank 0 also runs the one-process
    `SpmdCtx(N)` (N the grid's x ranks) from the same state. `props`:
    PhysicalProperties' keywords; `env`: OFTPP_* variables set while the
    steps are built."""
    ctx = on_grid(ctx, grid)
    geom = geometry(tank)
    props = PhysicalProperties(**(props or {}))
    motion = (None if table is None else
              motion_from_numpy(*(table[k] for k in MOTION_FIELDS),
                                device=ctx.device))
    with mock.patch.dict("os.environ", env or {}):
        step = make_step(geom, props, controls, motion=motion,
                         spmd=SpmdCtx(*ctx.grid, ranks=ctx),
                         device=ctx.device)
        one = (make_step(geom, props, controls, motion=motion,
                         spmd=SpmdCtx(ctx.grid[0]), device=ctx.device)
               if with_single and ctx.rank == 0 else None)
    par = params_from_numpy(params, device=ctx.device)
    whole = state_from_numpy(init, device=ctx.device)
    state = rk.scatter_state(whole if ctx.rank == 0 else None, geom.shape,
                             ctx)
    calls, patches = _counted()
    for p in patches:
        p.start()
    try:
        first, last, iters = _steps(step, state, par, n_steps)
    finally:
        for p in patches:
            p.stop()
    first, last = (state_to_numpy(rk.gather_state(s, ctx))
                   for s in (first, last))
    out = {"calls": dict(calls), "stats": ctx.stats.as_dict(),
           "motion": None if motion is None else motion.sha256(),
           "jax_loaded": sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "jaxlib", "openfoam_tpp_tpu"))}
    if ctx.rank == 0:
        out.update(first=first, last=last, iters=iters)
        if with_single:
            f1, l1, i1 = _steps(one, whole, par, n_steps)
            out["single"] = {"first": state_to_numpy(f1),
                             "last": state_to_numpy(l1), "iters": i1}
    return out


BOX = (0.096, 0.064, 0.04, 0.004)   # 24×16×10 at 4 mm, open top


def vcycle_operands(seed, box=BOX):
    """The agglomeration test's whole-grid operands: the box's geometry
    arrays, a two-layer density and a seeded residual on the fluid."""
    geom = build_box_geometry(*box, open_top=True)
    ga = geometry_arrays(geom, device="cpu")
    nz = geom.shape[2]
    zc = (torch.arange(nz) + 0.5) / nz
    alpha = torch.where(zc < 0.5, 1.0, 0.0).expand(geom.shape).contiguous()
    rng = np.random.default_rng(seed)
    r = torch.from_numpy(rng.standard_normal(geom.shape).astype(np.float32))
    r = torch.where(ga["vfrac"] > 0.0, r, 0.0)
    return geom, ga, mixture_density(alpha, PhysicalProperties()), r


def vcycle(geom, ga, rho, r, spmd):
    """One preconditioner application M̂⁻¹r of the step's bundle (its
    V-cycle), on whole arrays or, in a rank, on its blocks."""
    spacing = tuple(float(h) for h in geom.spacing)
    problem, pack = poisson.build_operator(ga, spacing, rho, ga["top_open"],
                                           use_pallas=True, spmd=spmd)
    knobs = poisson.SolverKnobs()
    bundle = poisson.make_bundle(pack, use_pallas=True, knobs=knobs,
                                 spmd=spmd)
    problem = poisson.attach_precond(problem, bundle, knobs, spmd=spmd)
    return problem.precond_hat(r), bundle


def vcycle_ranks(ctx, log, seed, box=BOX, grid=None):
    """`vcycle` over the ranks (on the rank grid `grid`, default the
    launch's) on each rank's block of `vcycle_operands`; every rank
    returns the gathered result, the local x and y extents of the coarse
    levels and which level was gathered."""
    from openfoam_tpp_tpu_torch.ops import stencil as st

    ctx = on_grid(ctx, grid)
    geom, ga, rho, r = vcycle_operands(seed, box)
    shape = geom.shape
    cut = lambda t: ctx.block(t, shape).contiguous()
    local = {k: cut(v) for k, v in ga.items()}
    with st.rank_block(ctx, shape[0] // ctx.grid[0], shape[1] // ctx.grid[1]):
        z, bundle = vcycle(geom, local, cut(rho), cut(r),
                           SpmdCtx(*ctx.grid, ranks=ctx))
    levels = [(e["faces"][0].shape[0] - 1, bool(e.get("agg")))
              for e in bundle["coarse"]]
    y_levels = [e["faces"][1].shape[1] - 1 for e in bundle["coarse"]]
    return {"z": ctx.gather_block(z).numpy(), "levels": levels,
            "y_levels": y_levels}


def many(ctx, log, tasks):
    """Several jobs of this module in one launch, in order: `tasks` is a
    list of (job name, args, keyword args); returns their results, a
    list, on every rank."""
    return [globals()[name](ctx, log, *args, **kwargs)
            for name, args, kwargs in tasks]


ISLAND_SHAPE = (16, 12, 16)   # 2x2 ranks: blocks of 8 × 6 cells
ISLAND_SPACING = (0.002, 0.0021, 0.0019)


def island_operands(seed, shape=ISLAND_SHAPE):
    """Seeded whole-grid operands of every island (numpy, f32), with the
    zero wall faces the step gives them (tests/test_torch_spmd_kernels.py's
    recipe)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    f = lambda lo=None, hi=None, s=shape: (
        rng.standard_normal(s) if lo is None
        else rng.uniform(lo, hi, s)).astype(np.float32)

    def faces(lo=-1.0, hi=1.0, walls=True):
        out = [f(lo, hi, s) for s in ((nx + 1, ny, nz), (nx, ny + 1, nz),
                                      (nx, ny, nz + 1))]
        if walls:
            out[0][0] = out[0][-1] = 0
            out[1][:, 0] = out[1][:, -1] = 0
            out[2][:, :, 0] = 0
        return out

    w = [f(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    al = f(0, 1)
    antis = [1e-3 * f() for _ in range(3)]
    antis[0][0], antis[1][:, 0], antis[2][:, :, 0] = 0, 0, 0
    aps = faces(0, 1)
    for a in aps:
        a[a < 0.2] = 0
    vfrac = f(0, 1)
    vfrac[vfrac < 0.1] = 0
    return {
        "p": f(), "b": f(), "diag": f(1.5, 2.5), "w": w,
        "alpha": np.clip(f(-0.3, 1.3), 0, 1),
        "phis": [1e-3 * f() for _ in range(3)],
        "ucs": [1e-3 * f() for _ in range(3)],
        "lams": [f(0, 1) for _ in range(3)], "antis": antis,
        "cells": [al, np.minimum(al + f(0, 0.2), 1).astype(np.float32),
                  np.maximum(al - f(0, 0.2), 0).astype(np.float32),
                  f(1e-4, 2e-4)],
        "vel": faces(), "rp": faces(), "mu": f(1e-5, 2e-3),
        "div_u": 0.1 * f(-1, 1), "dp": f(-50, 50),
        "beta": faces(8e-4, 1e-3, walls=False), "aps": aps, "vfrac": vfrac,
        "topo": (rng.uniform(0, 1, (nx, ny)) > 0.3).astype(np.float32),
        "rho": f(1, 998)}


def _as_torch(ops, dtype, cut=lambda t: t):
    """The operands as CPU tensors cut by `cut`: the 7-point and MULES
    stream operands (p, b, diag, w, ucs, lams, antis) in `dtype`, the rest
    in f32."""
    low = {"p", "b", "diag", "w", "ucs", "lams", "antis"}
    out = {}
    for k, v in ops.items():
        dt = dtype if k in low else torch.float32
        conv = lambda a: cut(torch.from_numpy(np.asarray(a))).to(
            dt).contiguous()
        out[k] = [conv(a) for a in v] if isinstance(v, list) else conv(v)
    return out


def run_islands(t, spmd, dtype):
    """Every island on the operands `t` (whole arrays with `spmd=None`:
    the single-grid entry points): {name: output tensor or 0-d scalar}."""
    from openfoam_tpp_tpu_torch.parallel import spmd as sm

    h = ISLAND_SPACING
    w, out = tuple(t["w"]), {}
    anti = dtype if dtype != torch.float32 else None
    if spmd is None:
        out["apply"] = sp.apply_7pt(t["p"], w)
        out["apply_diag"] = sp.apply_7pt(t["p"], w, t["diag"])
        out["resid"] = sp.resid_scaled_7pt(t["p"], w, None, t["b"])
        out["resid_diag"] = sp.resid_scaled_7pt(t["p"], w, t["diag"], t["b"])
        out["apply_dot"], out["dot"] = sp.apply_dot_7pt(t["p"], w)
        lows, antis = mfx.flux_all(t["alpha"], t["phis"], t["ucs"], anti)
        lams = tuple(t["lams"])
        for _ in range(3):
            lams = mf.fct_iter(lams, t["antis"], *t["cells"], h)
    else:
        out["apply"] = sm.apply_7pt(t["p"], w, spmd)
        out["apply_diag"] = sm.apply_7pt(t["p"], w, spmd, diag=t["diag"])
        out["resid"] = sm.resid_scaled_7pt(t["p"], w, spmd, t["b"])
        out["resid_diag"] = sm.resid_scaled_7pt(t["p"], w, spmd, t["b"],
                                                diag=t["diag"])
        out["apply_dot"], out["dot"] = sm.apply_dot_7pt(t["p"], w, spmd)
        lows, antis = sm.flux_all(t["alpha"], t["phis"], t["ucs"], spmd,
                                  anti_dtype=anti)
        lams = sm.fct_iters(t["lams"], t["antis"], *t["cells"], h, 3, spmd)
    out.update({f"low{a}": lows[a] for a in range(3)})
    out.update({f"anti{a}": antis[a] for a in range(3)})
    out.update({f"lam{a}": lams[a] for a in range(3)})
    if dtype != torch.float32:
        return out
    for dev2 in (True, False):
        args = (*t["vel"], t["rp"], t["mu"], t["div_u"], h)
        res = (mrk.momentum_rhs(*args, dev2=dev2) if spmd is None
               else sm.momentum_rhs(*args, spmd, dev2=dev2))
        out.update({f"mom{a}_dev2_{dev2}": res[a] for a in range(3)})
    for top in (True, False):
        args = (t["dp"], *t["vel"], t["beta"], *t["aps"], t["vfrac"],
                t["topo"], t["rho"], torch.tensor(3.7e-3))
        res = (ck.correct_divmax(*args, h, open_top=top) if spmd is None
               else sm.correct_divmax(*args, h, spmd, open_top=top))
        out.update({f"corr{a}_top_{top}": res[a] for a in range(3)})
        out[f"divmax_top_{top}"] = res[3]
    return out


def islands(ctx, log, seed, grid=None):
    """Every island over the ranks (on the rank grid `grid`) on each
    rank's block of `island_operands(seed)`, f32 and bf16; every rank
    returns the gathered outputs (numpy, by name and dtype) and its call
    counts of the entry points."""
    from openfoam_tpp_tpu_torch.ops import stencil as st

    ctx = on_grid(ctx, grid)
    ops, shape = island_operands(seed), ISLAND_SHAPE
    spmd = SpmdCtx(*ctx.grid, ranks=ctx)
    res, calls = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        t = _as_torch(ops, dtype, lambda a: ctx.block(a, shape))
        counted, patches = _counted()
        for p in patches:
            p.start()
        try:
            with st.rank_block(ctx, shape[0] // ctx.grid[0],
                               shape[1] // ctx.grid[1]):
                out = run_islands(t, spmd, dtype)
        finally:
            for p in patches:
                p.stop()
        calls = dict(counted) if calls is None else calls
        for k, v in out.items():
            if v.dim() == 0:
                res[f"{k} {dtype}"] = float(v)
                continue
            faces = (0 if v.shape[0] == shape[0] // ctx.grid[0] + 1
                     else 1 if v.shape[1] == shape[1] // ctx.grid[1] + 1
                     else None)
            res[f"{k} {dtype}"] = ctx.gather_block(v, faces).float().numpy()
    return {"out": res, "calls": calls}


def curvature(ctx, log, tank, alpha, grid=None):
    """solver/momentum.py `curvature` (the blend) of the whole-grid numpy
    `alpha` on every rank's block, gathered (numpy)."""
    from openfoam_tpp_tpu_torch.ops import stencil as st
    from openfoam_tpp_tpu_torch.solver import momentum as mom

    ctx = on_grid(ctx, grid)
    geom = geometry(tank)
    cut = lambda a: ctx.block(torch.as_tensor(np.asarray(a)),
                              geom.shape).contiguous()
    spacing = tuple(float(h) for h in geom.spacing)
    with st.rank_block(ctx, geom.shape[0] // ctx.grid[0],
                       geom.shape[1] // ctx.grid[1]):
        kappa = mom.curvature(cut(alpha), spacing,
                              vfrac=cut(geom.vfrac.astype(np.float32)))
    return ctx.gather_block(kappa).numpy()


BATCH = ("apply_7pt_nb", "resid_scaled_7pt_nb", "apply_dot_7pt_nb")


def _counted_batch():
    """Patches counting the calls of the batch 7-point entry points (on
    the CPU their plain versions run, and their launch counters stay 0)."""
    calls = collections.Counter()
    patches = []
    for name in BATCH:
        fn = getattr(sp, name)

        def run(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        patches.append(mock.patch.object(sp, name, run))
    return calls, patches


def _swapped(pparts, par, ic):
    """The planted fault of `farm`: the first case of position 0 and the
    second of position 1 exchange their forcing (`par` the whole batch's
    CaseParams, `pparts` this rank's [part] of case position `ic`)."""
    mine, theirs = {0: (0, 3), 1: (1, 0)}.get(ic, (None, None))
    if mine is None:
        return pparts
    part = pparts[0]
    fields = {}
    for f in dataclasses.fields(part):
        a = getattr(part, f.name).clone()
        a[mine] = getattr(par, f.name)[theirs]
        fields[f.name] = a
    return [type(part)(**fields)]


def farm(ctx, log, tank, rows, n_steps, grid, route="auto", swap=False):
    """`make_sweep_step` over `rows` (one forcing each, the trailing case
    axis) farmed over the (C, N, M) rank `grid`: every rank holds the
    batch at rest (dt0 4e-4), keeps its case position's slice cut to its
    x·y block (`shard_state(..., ranks=)`) and steps it `n_steps` times
    under OFTPP_SWEEP_PALLAS=`route` ("auto": plain on the CPU;
    "interpret": the 7-point passes through the batch kernels' entry
    points on extended blocks). `swap` (4 rows over 2 case positions): a
    planted fault, the first case of position 0 and the second of
    position 1 exchange their forcing. Every rank returns its t and
    p_iters per step, its batch entry-point call counts, exchange stats
    and block shape; rank 0 also the gathered batch after the first and
    the last step (numpy)."""
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel import sweep as sw

    ctx = on_grid(ctx, grid)
    geom = geometry(tank)
    mesh = sh.make_mesh(ctx.world, case_axis=ctx.cases, y_axis=ctx.grid[1],
                        devices=[ctx.device] * ctx.world)
    with mock.patch.dict("os.environ", {"OFTPP_SWEEP_PALLAS": route}):
        step = sw.make_sweep_step(geom, device=ctx.device,
                                  spmd=SpmdCtx(*ctx.grid, ranks=ctx))
    run = sh.sharded_step(step, mesh, batched=True, ranks=ctx)
    sharding = sh.state_sharding(mesh, batched=True, ranks=ctx)
    states = sw.batch_states(geom, len(rows), dt0=4e-4, device=ctx.device)
    par = sw.batch_params(rows, device=ctx.device)
    parts = sh.shard_state(states, mesh, batched=True, ranks=ctx)
    pparts = sh.params_sharding(mesh, batched=True, ranks=ctx).put(par)
    if swap:
        pparts = _swapped(pparts, par, ctx.ic)
    calls, patches = _counted_batch()
    out = {"t": [], "iters": []}
    for p in patches:
        p.start()
    try:
        for i in range(n_steps):
            parts, diags = run(parts, pparts)
            out["t"].append(parts[0].t.numpy().copy())
            out["iters"].append(diags[0].p_iters.numpy().copy())
            if i in (0, n_steps - 1):
                whole = sharding.gather(parts)
                out["first" if i == 0 else "last"] = (
                    None if whole is None else state_to_numpy(whole))
    finally:
        for p in patches:
            p.stop()
    out.update(calls=dict(calls), stats=ctx.stats.as_dict(),
               block=tuple(parts[0].alpha.shape))
    return out


def _gathered(sharding, parts):
    whole = sharding.gather(parts)
    return None if whole is None else state_to_numpy(whole)


def tiled(ctx, log, tank, rows, n_steps, grid=None, controls=CONTROLS,
          with_single=False):
    """`make_tiled_sweep_step` of `rows` (one case each, merged along x)
    over the ranks (on the (N, M) rank grid `grid`), through the sharding
    API's unbatched `ranks=` form: every rank holds the merged state at
    rest, keeps its x·y block (`shard_state(..., ranks=)`, the params
    whole) and steps it `n_steps` times. Every rank returns its
    entry-point call counts, exchange stats and block shape; rank 0 also
    the gathered states after the first and the last step and the
    p_iters, and with `with_single` the one-process `SpmdCtx(N)` tiled
    step's from the same state."""
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel import sweep as sw
    from openfoam_tpp_tpu_torch.parallel import tiled_sweep as ts

    ctx = on_grid(ctx, grid)
    geom, n = geometry(tank), len(rows)
    mesh = sh.make_mesh(ctx.world, y_axis=ctx.grid[1],
                        devices=[ctx.device] * ctx.world)
    step = ts.make_tiled_sweep_step(geom, n, controls=controls,
                                    device=ctx.device,
                                    spmd=SpmdCtx(*ctx.grid, ranks=ctx))
    run = sh.sharded_step(step, mesh, ranks=ctx)
    whole = ts.tile_state(geom, n, device=ctx.device)
    par = sw.batch_params(rows, device=ctx.device)
    parts = sh.shard_state(whole, mesh, ranks=ctx)
    pparts = sh.params_sharding(mesh, ranks=ctx).put(par)
    calls, patches = _counted()
    out = {"iters": []}
    for p in patches:
        p.start()
    try:
        for i in range(n_steps):
            parts, diags = run(parts, pparts)
            out["iters"].append(int(diags[0].p_iters))
            if i in (0, n_steps - 1):
                out["first" if i == 0 else "last"] = _gathered(run.sharding,
                                                               parts)
    finally:
        for p in patches:
            p.stop()
    out.update(calls=dict(calls), stats=ctx.stats.as_dict(),
               block=tuple(parts[0].alpha.shape))
    if with_single and ctx.rank == 0:
        one = ts.make_tiled_sweep_step(geom, n, controls=controls,
                                       device=ctx.device,
                                       spmd=SpmdCtx(ctx.grid[0]))
        f1, l1, i1 = _steps(one, whole, par, n_steps)
        out["single"] = {"first": state_to_numpy(f1),
                         "last": state_to_numpy(l1), "iters": i1}
    return out


def geom_farm(ctx, log, rows, prows, n_steps, grid=None, lockstep=True,
              route="auto", t_stop=None):
    """`make_geom_sweep_step` of the geometry rows `rows` (their forcing
    `prows`) farmed over the (C, N, M) rank `grid`: every rank builds the
    whole BatchedGeometry (round_to=4) and the batch at rest (dt0 4e-4),
    keeps its part (`shard_batched_geometry` / `shard_state(...,
    ranks=)`) and steps it `n_steps` times (to `t_stop`) under
    OFTPP_SWEEP_PALLAS=`route`. Every rank returns its t and p_iters per
    step, its batch entry-point call counts, exchange stats and block;
    rank 0 also the gathered batch after the first, the last but one
    ("held": the step before the last) and the last step."""
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel import sweep as sw

    ctx = on_grid(ctx, grid)
    bgeom = sw.build_batched_geometry(rows, round_to=4, device=ctx.device)
    mesh = sh.make_mesh(ctx.world, case_axis=ctx.cases, y_axis=ctx.grid[1],
                        devices=[ctx.device] * ctx.world)
    part = sh.shard_batched_geometry(bgeom, mesh, ranks=ctx)[0]
    with mock.patch.dict("os.environ", {"OFTPP_SWEEP_PALLAS": route}):
        step = sw.make_geom_sweep_step(part, lockstep=lockstep,
                                       spmd=SpmdCtx(*ctx.grid, ranks=ctx))
    run = sh.sharded_step(step, mesh, batched=True, ranks=ctx)
    parts = sh.shard_state(sw.batch_states_geom(bgeom, dt0=4e-4), mesh,
                           batched=True, ranks=ctx)
    pparts = sh.params_sharding(mesh, batched=True, ranks=ctx).put(
        sw.batch_params(prows, device=ctx.device))
    calls, patches = _counted_batch()
    out = {"t": [], "iters": []}
    for p in patches:
        p.start()
    try:
        for i in range(n_steps):
            parts, diags = run(parts, pparts, t_stop=t_stop)
            out["t"].append(parts[0].t.numpy().copy())
            out["iters"].append(diags[0].p_iters.numpy().copy())
            for name, at in (("first", 0), ("held", n_steps - 2),
                             ("last", n_steps - 1)):
                if i == at:
                    out[name] = _gathered(run.sharding, parts)
    finally:
        for p in patches:
            p.stop()
    out.update(calls=dict(calls), stats=ctx.stats.as_dict(),
               block=tuple(parts[0].alpha.shape),
               spacing=part.spacing.numpy())
    return out
