"""What the rank processes of tests/test_torch_ranks.py run.

parallel/ranks.py `launch` pickles each job by its import path and runs
it in spawned processes, one a rank; they import torch and the port
only, never JAX (this module imports neither the JAX package nor the
test file, which does). Each job returns numpy arrays and counts.
"""

from __future__ import annotations

import collections
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


def steps(ctx, log, tank, init, params, n_steps, with_single=False,
          table=None, controls=CONTROLS):
    """`n_steps` of the x-sharded step over the ranks from the numpy state
    `init` (rank 0 scatters it), on `geometry(tank)`, under the motion
    `table` (numpy arrays named as TableMotion's fields) where given.
    Every rank returns its entry-point call counts, exchange stats and
    its motion's digest; rank 0 also the gathered states after the first
    and the last step and the p_iters. `with_single`: rank 0 also runs
    `SpmdCtx(world)` in this process from the same state."""
    geom = geometry(tank)
    motion = (None if table is None else
              motion_from_numpy(*(table[k] for k in MOTION_FIELDS),
                                device=ctx.device))
    step = make_step(geom, PhysicalProperties(), controls, motion=motion,
                     spmd=SpmdCtx(ctx.world, ranks=ctx), device=ctx.device)
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
            one = make_step(geom, PhysicalProperties(), controls,
                            motion=motion, spmd=SpmdCtx(ctx.world),
                            device=ctx.device)
            f1, l1, i1 = _steps(one, whole, par, n_steps)
            out["single"] = {"first": state_to_numpy(f1),
                             "last": state_to_numpy(l1), "iters": i1}
    return out


BOX = (0.096, 0.064, 0.04, 0.004)   # 24×16×10 at 4 mm, open top


def vcycle_operands(seed):
    """The agglomeration test's whole-grid operands: the box's geometry
    arrays, a two-layer density and a seeded residual on the fluid."""
    geom = build_box_geometry(*BOX, open_top=True)
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
    V-cycle), on whole arrays or, in a rank, on its slabs."""
    spacing = tuple(float(h) for h in geom.spacing)
    problem, pack = poisson.build_operator(ga, spacing, rho, ga["top_open"],
                                           use_pallas=True, spmd=spmd)
    knobs = poisson.SolverKnobs()
    bundle = poisson.make_bundle(pack, use_pallas=True, knobs=knobs,
                                 spmd=spmd)
    problem = poisson.attach_precond(problem, bundle, knobs, spmd=spmd)
    return problem.precond_hat(r), bundle


def vcycle_ranks(ctx, log, seed):
    """`vcycle` over the ranks on each rank's slab of `vcycle_operands`;
    every rank returns the gathered result, the local x extents of the
    coarse levels and which level was gathered."""
    from openfoam_tpp_tpu_torch.ops import stencil as st

    geom, ga, rho, r = vcycle_operands(seed)
    nx = geom.shape[0]
    local = {k: ctx.slab(v, nx).contiguous() for k, v in ga.items()}
    with st.x_slabs(ctx, nx // ctx.world):
        z, bundle = vcycle(geom, local, ctx.slab(rho, nx).contiguous(),
                           ctx.slab(r, nx).contiguous(),
                           SpmdCtx(ctx.world, ranks=ctx))
    levels = [(e["faces"][0].shape[0] - 1, bool(e.get("agg")))
              for e in bundle["coarse"]]
    return {"z": ctx.gather_x(z).numpy(), "levels": levels}
