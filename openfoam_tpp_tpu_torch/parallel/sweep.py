"""Batched parameter sweeps — port of openfoam_tpp_tpu/parallel/sweep.py:
many orbital-tank cases advanced as ONE batch on one card, the
in-process replacement for farming one job per case.

Two batching modes, as in the JAX package:

  * `make_sweep_step(geom, ...)` — all cases share one geometry
    (H, D, mesh, geo fixed) and vary the forcing (R, freq, ramp);
  * `make_geom_sweep_step(...)` + `build_batched_geometry(rows)` — full
    (f, R, H, D, geo) sweeps: every case's cut-cell apertures and spacing
    are stacked on a shared padded grid. Cases share hx = hy = mesh;
    per-case hz = H/nz puts every tank's open top at layer nz−1.

The JAX package gets its batch from `jax.vmap` of the single-case step.
Here the step itself is rank-polymorphic (solver/timestep.py): the case
axis trails every grid array, (nx, ny, nz, B), per-case scalars are (B,)
tensors, and reductions are per case. With B innermost a stencil shift
never touches it, a row of B cases is contiguous, and tiny per-case grids
fill the card. The leading layout (`axis=0`, (B, nx, ny, nz)) is taken
too: its step moves the case axis to the back on the way in and to the
front on the way out, and runs plain PyTorch (the batch-native kernels
need the trailing case axis), as the JAX package routes a leading axis
to its jnp path.

Lockstep sweeps share one adaptive dt (the batch minimum); with
`lockstep=False` every case keeps its own dt and cases that have reached
`t_stop` are held while the others catch up. Each sweep step carries its
`Lockstep` (the step cut where its batch minima fall): `lockstep_step`
runs it over one batch or over the parts of a batch farmed over a device
mesh (parallel/sharding.py), taking each minimum over every part. A
batch farmed over ranks (a (C, N, M) rank grid, one process a position)
runs `make_sweep_step` or `make_geom_sweep_step(..., spmd=SpmdCtx(N, M,
ranks=ctx))` on each rank's block, and the minima reduce over every
rank; `run_sweep_ranks` takes either sweep, as `run_sweep` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.state import CaseParams, SimState, init_state
from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import (TankGeometry,
                                                  build_tank_geometry,
                                                  natural_shape)
from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.solver.timestep import (Cfl, geometry_arrays,
                                                    make_step_core)
from openfoam_tpp_tpu_torch.utils import profiling as prof

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(CaseParams))


def _trailing(axis) -> bool:
    """True for the trailing case axis, False for the leading one."""
    if axis not in (0, -1, 3):
        raise ValueError(f"axis={axis}: the case axis leads (0) or trails "
                         "(-1) the grid axes")
    return axis != 0


def _stack_states(states: list, axis: int = -1) -> SimState:
    """Per-case SimStates → one batched SimState: grid leaves stacked on a
    new case axis (`axis`), scalar leaves into (B,)."""
    return SimState(**{
        k: torch.stack([getattr(s, k) for s in states],
                       0 if getattr(states[0], k).dim() == 0 else axis)
        for k in _STATE_FIELDS})


def _move_case_axis(states: SimState, src: int, dst: int) -> SimState:
    """The grid leaves' case axis moved from `src` to `dst` (contiguous);
    the (B,) leaves as they are."""
    move = lambda a: a if a.dim() <= 1 else a.movedim(src, dst).contiguous()
    return SimState(**{k: move(getattr(states, k)) for k in _STATE_FIELDS})


def batch_params(param_rows: list[dict], device="cuda") -> CaseParams:
    """Stack per-case (R, freq, duration, ramp) dicts into one CaseParams
    of (B,) tensors."""
    built = [CaseParams.make(R=row["R"], freq=row["freq"],
                             duration=row["duration"],
                             ramp=row.get("ramp", -1.0), device=device)
             for row in param_rows]
    return CaseParams(**{k: torch.stack([getattr(b, k) for b in built])
                         for k in _PARAM_FIELDS})


def batch_states(geom: TankGeometry, n: int, dt0: float = 1e-3,
                 axis: int = -1, device="cuda") -> SimState:
    """n identical quiescent initial states, the case axis trailing (or
    leading: axis=0)."""
    trailing = _trailing(axis)
    s = init_state(geom, dt0=dt0, device=device)

    def rep(a):
        if a.dim() == 0:
            return a.expand(n).clone()
        if trailing:
            return a.unsqueeze(-1).expand(*a.shape, n).contiguous()
        return a.unsqueeze(0).expand(n, *a.shape).contiguous()

    return SimState(**{k: rep(getattr(s, k)) for k in _STATE_FIELDS})


class Lockstep(NamedTuple):
    """A sweep step (trailing layout) cut where its batch minima fall."""

    sync_dt: bool      # the step starts from the batch minimum of states.dt
    # states -> timestep.Cfl before the batch minimum of its dt; None:
    # every case keeps its own CFL dt.
    cfl: Callable | None
    finish: Callable   # (states, params, cfl, t_stop) -> (states', diag)


def _min_over(values):
    """The minimum of 0-d tensors that may lie on several devices, on the
    first one's device; a single value as it is."""
    out = values[0]
    for v in values[1:]:
        out = torch.minimum(out, v.to(out.device))
    return out


def lockstep_step(locks: list, states: list, params: list, t_stop=None,
                  ranks=None):
    """One step of every part of a batch: `locks`, `states` and `params`
    hold one Lockstep, trailing-layout SimState and CaseParams per part
    (per mesh position). The batch minima are taken over all parts: that
    of states.dt before the step and that of the CFL dt within it, which
    a farm's positions thus share as the cases of one batch do. `ranks`
    (a parallel.ranks.RankCtx): the part is this rank's block of a batch
    farmed over ranks, and each minimum is taken over every rank (the
    whole world: every case position's). Returns (states', diags), a
    list each; with one part, the ops are those of the unsplit step.
    The whole is one `step` span (utils/profiling.py), the minima and
    the parts' CFL dt `step.cfl` spans within it."""
    with prof.step_span():
        lock = locks[0]

        def batch_min(values):
            out = _min_over(values)
            return out if ranks is None else ranks.all_reduce(out, op="min",
                                                               world=True)

        if lock.sync_dt:
            with prof.span("step.cfl"):
                dt0 = batch_min([s.dt.min() for s in states])
                states = [dataclasses.replace(s, dt=dt0.to(s.dt.device)
                                              .expand_as(s.dt).clone())
                          for s in states]
        cfls = [None] * len(states)
        if lock.cfl is not None:
            with prof.span("step.cfl"):
                cfls = []
                for lk, s in zip(locks, states):
                    with on_device(s.t.device):
                        cfls.append(lk.cfl(s))
                dt_min = batch_min([c.dt.min() for c in cfls])
                cfls = [c.synced(dt_min.to(c.dt.device)) for c in cfls]
        out = []
        for lk, s, p, c in zip(locks, states, params, cfls):
            with on_device(s.t.device):
                out.append(lk.finish(s, p, c, t_stop))
        return [o[0] for o in out], [o[1] for o in out]


def on_device(dev):
    """The CUDA device of a part current while its step runs: the
    hand-written kernels launch on the current device's context."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _sweep_step_of(lock: Lockstep, trailing: bool, takes_t_stop: bool,
                   ranks=None):
    """The sweep step over one whole batch, in its layout; `lockstep`
    holds its parts for a farm. `ranks`: the batch is this rank's block
    of a batch farmed over ranks (the minima over every rank)."""
    if trailing:
        def run(states, params, t_stop=None):
            new, diag = lockstep_step([lock], [states], [params], t_stop,
                                      ranks=ranks)
            return new[0], diag[0]
    else:
        def run(states, params, t_stop=None):
            new, diag = lockstep_step([lock], [_move_case_axis(states, 0, -1)],
                                      [params], t_stop)
            return _move_case_axis(new[0], -1, 0), diag[0]

    if takes_t_stop:
        sweep_step = run
    else:
        def sweep_step(states: SimState, params: CaseParams):
            return run(states, params)
    sweep_step.lockstep = lock
    sweep_step.ranks = ranks
    return sweep_step


def _sweep_kernel_policy(axis, device) -> dict:
    """SolverControls overrides for a sweep step (OFTPP_SWEEP_PALLAS):
      unset ("auto") — the batch-native 7-point pressure kernels
        (ops/kernels/seven_point.py `*_nb`) when the case axis trails and
        the device is CUDA; everything plain PyTorch on the CPU. The
        single-grid MULES, momentum and correction kernels stay off
        (`batch_lanes`, `mom_pallas=False`): they have no batch-native
        form, and the plain path vectorizes over the case axis.
      =interpret — the same routing on any device (on CPU tensors the
        entry points run their plain versions, as everywhere in the port).
      =0 — everything plain PyTorch.
      =1 — the JAX package's legacy mode (all kernels through the Pallas
        batching rule) has no counterpart here."""
    env = os.environ.get("OFTPP_SWEEP_PALLAS", "auto")
    trailing = _trailing(axis)
    if env == "1":
        raise NotImplementedError(
            "OFTPP_SWEEP_PALLAS=1 (every single-grid kernel once per case) "
            "is not ported: unset it for the batch-native 7-point kernels, "
            "or set 0 for plain PyTorch")
    if trailing and (env == "interpret"
                     or (env == "auto" and device.type == "cuda")):
        return dict(use_pallas=True, batch_lanes=True, mom_pallas=False)
    return dict(use_pallas=False, mom_pallas=False)


def make_sweep_step(geom: TankGeometry,
                    props: PhysicalProperties = PhysicalProperties(),
                    controls: SolverControls = SolverControls(),
                    axis: int = -1, device="cuda", spmd=None):
    """Batched step over forcing params, one shared geometry:
    (batched SimState, batched CaseParams) -> (same, per-case diagnostics).

    `spmd=SpmdCtx(n, m, ranks=ctx)` (parallel/spmd.py, ctx on a (C, n, m)
    rank grid; trailing layout): the step of one rank of a batch farmed
    over ranks, on the rank's (nxl, nyl, nz, B/C) block of its case
    position's cases (parallel/sharding.py `shard_state(..., ranks=)`):
    the step over ranks on a batched block, every minimum of the
    lockstep over every rank.

    The per-case adaptive dt is synchronized to the batch minimum before
    stepping, keeping all cases on a common time axis (each case then
    grows its own dt from there, as in the JAX package). The operator
    weights depend on each case's alpha, so the pressure passes are
    batched operands and run the batch-native kernels even though the
    geometry is shared; the geometry arrays are repeated along the case
    axis once per batch width and device the step meets (a farm's
    positions may lie on several devices)."""
    trailing = _trailing(axis)
    ranks = None if spmd is None else spmd.ranks
    if ranks is None and spmd is not None:
        raise NotImplementedError(
            "make_sweep_step(spmd=) in one process: a sweep is sharded over "
            "ranks only (SpmdCtx(n, m, ranks=ctx))")
    if ranks is not None and not trailing:
        raise ValueError("a sweep over ranks takes the trailing case axis")
    dev = resolve_device(device)
    controls = dataclasses.replace(controls,
                                   **_sweep_kernel_policy(axis, dev))
    if ranks is not None:
        farm_block(geom.shape, ranks.cases, (ranks.cases, *ranks.grid))
    ga1 = geometry_arrays(geom, device=dev, ranks=ranks)
    spacing = tuple(float(s) for s in geom.spacing)
    core = make_step_core(props, controls,
                          open_top=bool(np.any(geom.top_open > 0)),
                          sealed_x=bool(np.all(geom.ax[-1] == 0.0)),
                          spmd=spmd)
    ga_by_n: dict[tuple, dict] = {}

    def finish(states, params, cfl, t_stop):
        key = (states.t.shape[0], states.t.device)
        if key not in ga_by_n:
            ga_by_n[key] = {k: a.to(key[1]).unsqueeze(-1)
                            .expand(*a.shape, key[0]).contiguous()
                            for k, a in ga1.items()}
        return core(states, params, ga_by_n[key], spacing, t_stop=t_stop)

    return _sweep_step_of(Lockstep(True, None, finish), trailing,
                          takes_t_stop=False, ranks=ranks)


def farm_block(shape, n_cases: int, grid):
    """(nxl, nyl, nz, B/C): the block each rank steps of a batch of
    `n_cases` cases on a grid of `shape` cells farmed over a (C, N, M)
    rank `grid`. ValueError where the cases do not divide over C, or nx
    (ny, with M > 1) into N (M) even blocks of at least MAX_HALO cells
    (the multigrid's 2:1 pairs start within a rank): callers check it
    before any process is spawned."""
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx

    c, n, m = grid
    block = SpmdCtx(n, m, cases=c).local_shape((*shape[:3], n_cases))
    for axis, k in ((0, n), (1, m)):
        if k > 1 and block[axis] % 2:
            raise ValueError(
                f"grid {'xy'[axis]}-extent {shape[axis]} over {k} ranks: "
                f"blocks of {block[axis]} cells, an odd number (the "
                "multigrid's 2:1 pairs start within a rank)")
    return block


def _sweep_rank(ctx, log, geom, param_rows, t_end, props, controls,
                max_steps):
    """One rank of `run_sweep_ranks`: its block of the batch stepped to
    t_end (the loop's test over every rank), the gathered batch on rank
    0, and each rank's exchange stats, kernel launches and p_iters."""
    from openfoam_tpp_tpu_torch.parallel import ranks as rk
    from openfoam_tpp_tpu_torch.parallel import sharding as sh
    from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx

    dev = ctx.device
    mesh = sh.make_mesh(ctx.world, case_axis=ctx.cases, y_axis=ctx.grid[1],
                        devices=[dev] * ctx.world)
    spmd = SpmdCtx(*ctx.grid, ranks=ctx)
    if isinstance(geom, BatchedGeometry):
        geom = geom.to(dev)
        step = make_geom_sweep_step(geom, props, controls, spmd=spmd)
        states = batch_states_geom(geom)
    else:
        step = make_sweep_step(geom, props, controls, device=dev, spmd=spmd)
        states = batch_states(geom, len(param_rows), device=dev)
    farm = sh.sharded_step(step, mesh, batched=True, ranks=ctx)
    parts = sh.shard_state(states, mesh, batched=True, ranks=ctx)
    pparts = sh.params_sharding(mesh, batched=True, ranks=ctx).put(
        batch_params(param_rows, device=dev))
    n, iters = 0, []
    t_min = lambda: ctx.all_reduce(parts[0].t.min(), op="min", world=True)
    while n < max_steps and prof.host_read(t_min() < t_end, "sweep.loop"):
        parts, diags = farm(parts, pparts)
        iters.append(prof.host_read(diags[0].p_iters, "sweep.p_iters"))
        n += 1
    from openfoam_tpp_tpu_torch.core.state import state_to_numpy

    # numpy crosses to the parent: a tensor's storage would be shared
    # with a process that is about to end.
    states = farm.sharding.gather(parts)
    return {"states": None if states is None else state_to_numpy(states),
            "n_steps": n,
            "ranks": {**ctx.stats.as_dict(), "launches": rk.launch_counts(),
                      "p_iters": iters}}


def run_sweep_ranks(geom, param_rows: list[dict], t_end: float,
                    grid, positions,
                    props: PhysicalProperties = PhysicalProperties(),
                    controls: SolverControls = SolverControls(),
                    max_steps: int = 100_000, log=print):
    """`run_sweep` farmed over a (C, N, M) grid of ranks, one spawned
    process a position in `positions` (parallel/ranks.py; gloo where
    positions share a device). `geom`: a TankGeometry (a shared-geometry
    forcing sweep: each rank steps its case position's B/C cases on its
    x·y block with `make_sweep_step(..., spmd=SpmdCtx(N, M, ranks=ctx))`)
    or a BatchedGeometry (a geometry sweep, lockstep, as `run_sweep`
    runs it: `make_geom_sweep_step` on the rank's part of it); the
    minima over every rank. Returns (states on the CPU, n_steps, each
    rank's {exchange stats, "launches", "p_iters"}). The grid is checked
    before any process is spawned (`farm_block`)."""
    from openfoam_tpp_tpu_torch.parallel import ranks as rk

    grid = tuple(int(g) for g in grid)
    what = "cases"
    if isinstance(geom, BatchedGeometry):
        if geom.n_cases != len(param_rows) or geom.ranks is not None:
            raise ValueError(
                f"a BatchedGeometry of {geom.n_cases} cases"
                f"{' (a rank part)' if geom.ranks is not None else ''} for "
                f"{len(param_rows)} rows: the whole batch's, one a row")
        _trailing_geometry(geom)
        geom, what = geom.to("cpu"), "cases of their own geometry"
    block = farm_block(geom.shape, len(param_rows), grid)
    log(f"  sweep of {len(param_rows)} {what} over "
        f"{'x'.join(map(str, grid))} ranks (case, x, y): blocks of "
        f"{' x '.join(map(str, block))}")
    from openfoam_tpp_tpu_torch.core.state import state_from_numpy

    res = rk.launch(_sweep_rank, positions, log=log, grid=grid,
                    args=(geom, param_rows, t_end, props, controls,
                          max_steps))
    return (state_from_numpy(res[0]["states"], device="cpu"),
            res[0]["n_steps"], [r["ranks"] for r in res])


# ------------------------------------------------- geometry-batched sweeps

@dataclasses.dataclass
class BatchedGeometry:
    """Per-case geometries embedded in one shared padded grid.

    `ga` is the stacked geometry_arrays dict (the step takes it as an
    operand); `spacing` is (n, 3)."""

    geoms: list                  # per-case TankGeometry (host post-processing)
    ga: dict                     # stacked device arrays, case axis at `axis`
    spacing: torch.Tensor        # (n_cases, 3)
    shape: tuple                 # shared (nx, ny, nz)
    axis: int
    # The RankCtx whose part this is (`rank_geometry`: its case
    # position's cases on its x·y block of `shape`), None for a batch.
    ranks: object = None

    @property
    def n_cases(self) -> int:
        return len(self.geoms)

    def to(self, device) -> "BatchedGeometry":
        """The same geometry with its tensors on `device`."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, ga={k: a.to(dev) for k, a in self.ga.items()},
            spacing=self.spacing.to(dev))


def _trailing_geometry(bgeom: BatchedGeometry):
    if bgeom.axis == 0:
        raise ValueError("a geometry sweep over ranks takes the trailing "
                         "case axis (build_batched_geometry(axis=-1))")


def rank_geometry(bgeom: BatchedGeometry, ranks) -> BatchedGeometry:
    """This rank's part of a whole BatchedGeometry (trailing case axis) on
    the rank's device: its case position's cases (parallel/sharding.py's
    slices), their cut-cell arrays cut to the rank's x·y block of the
    shared grid (face arrays keep their shared plane or row), their
    spacing rows. The grid is checked first (`farm_block`)."""
    _trailing_geometry(bgeom)
    if bgeom.ranks is not None:
        raise ValueError("rank_geometry of a rank's part: pass the whole "
                         "batch's BatchedGeometry")
    n, k = bgeom.n_cases, ranks.cases
    farm_block(bgeom.shape, n, (k, *ranks.grid))
    sl = slice(ranks.ic * n // k, (ranks.ic + 1) * n // k)
    dev = ranks.device
    ga = {key: ranks.block(a[..., sl], bgeom.shape).contiguous().to(dev)
          for key, a in bgeom.ga.items()}
    return dataclasses.replace(
        bgeom, geoms=bgeom.geoms[sl], ga=ga,
        spacing=bgeom.spacing[sl].contiguous().to(dev), ranks=ranks)


def build_batched_geometry(rows: list[dict], round_to: int = 8,
                           axis: int = -1, device="cuda") -> BatchedGeometry:
    """Build the shared-grid batched geometry for sweep rows with
    (possibly) different H, D, geo. All rows must share `mesh` (group
    cases at different resolutions into separate batches). The case axis
    of `ga` trails the grid axes, or leads them with axis=0."""
    trailing = _trailing(axis)
    dev = resolve_device(device)
    meshes = {float(r["mesh"]) for r in rows}
    if len(meshes) > 1:
        raise ValueError(
            f"geometry batch mixes mesh sizes {sorted(meshes)}; group rows "
            "by mesh and run one batch per resolution")
    shapes = [natural_shape(r["H"], r["D"], r["mesh"], r.get("geo", "flat"),
                            round_to=round_to) for r in rows]
    shared = tuple(max(s[d] for s in shapes) for d in range(3))
    # Identical (H, D, geo) rows share one TankGeometry: a forcing sweep
    # of many cases builds its cut cells once.
    built: dict = {}
    geoms = []
    for r in rows:
        key = (r["H"], r["D"], r.get("geo", "flat"))
        if key not in built:
            built[key] = build_tank_geometry(
                H=r["H"], D=r["D"], mesh=r["mesh"], geo=r.get("geo", "flat"),
                force_shape=shared)
        geoms.append(built[key])
    per_geom = {id(g): geometry_arrays(g, device=dev) for g in built.values()}
    ga = {k: torch.stack([per_geom[id(g)][k] for g in geoms],
                         -1 if trailing else 0)
          for k in ("vfrac", "ax", "ay", "az", "top_open")}
    spacing = torch.as_tensor(np.asarray([g.spacing for g in geoms],
                                         np.float32), device=dev)
    return BatchedGeometry(geoms=geoms, ga=ga, spacing=spacing, shape=shared,
                           axis=-1 if trailing else 0)


def batch_states_geom(bgeom: BatchedGeometry, dt0: float = 1e-3) -> SimState:
    """Per-case quiescent initial states (each filled to its own H/2), on
    the device of `bgeom`."""
    dev = bgeom.spacing.device
    per_geom = {id(g): init_state(g, dt0=dt0, device=dev)
                for g in {id(g): g for g in bgeom.geoms}.values()}
    return _stack_states([per_geom[id(g)] for g in bgeom.geoms], bgeom.axis)


def make_geom_sweep_step(bgeom: BatchedGeometry,
                         props: PhysicalProperties = PhysicalProperties(),
                         controls: SolverControls = SolverControls(),
                         lockstep: bool = True, spmd=None):
    """Geometry-batched step: every case carries its own cut-cell arrays
    and spacing as batched operands; one step serves the whole
    (f, R, H, D, geo) sweep: `sweep_step(states, params, t_stop=None)`.

    `lockstep=True` (default) syncs the CFL dt across cases, so all case
    times stay bitwise identical and land on write targets together;
    `lockstep=False` gives every case its OWN adaptive dt: cases still
    land exactly on each write target, and cases that have already
    reached `t_stop` are HELD (their state kept) while stiffer cases
    catch up — a lax case takes its solo step count, not the
    batch-stiffest one.

    `spmd=SpmdCtx(n, m, ranks=ctx)` (ctx on a (C, n, m) rank grid;
    trailing layout): the step of one rank of the geometry sweep farmed
    over ranks, on `rank_geometry(bgeom, ctx)` (a whole batch's
    geometry is cut here; parallel/sharding.py `shard_batched_geometry(
    ..., ranks=)` gives the part) and on the rank's block of its case
    position's states (`shard_state(..., ranks=)`): the step over ranks
    on a batched block, each case's CFL dt and, with `lockstep=False`,
    its held/done mask over its case group's ranks, the lockstep minimum
    over every rank."""
    ranks = None if spmd is None else spmd.ranks
    if spmd is not None and ranks is None:
        raise NotImplementedError(
            "make_geom_sweep_step(spmd=) in one process: a sweep is sharded "
            "over ranks only (SpmdCtx(n, m, ranks=ctx))")
    if ranks is not None:
        if bgeom.ranks is None:
            bgeom = rank_geometry(bgeom, ranks)
        elif bgeom.ranks is not ranks:
            raise ValueError("a BatchedGeometry part of another rank")
    dev = bgeom.spacing.device
    trailing = _trailing(bgeom.axis)
    controls = dataclasses.replace(
        controls, **_sweep_kernel_policy(bgeom.axis, dev))
    core = make_step_core(props, controls, open_top=True, spmd=spmd)
    spacing = tuple(bgeom.spacing[:, d].contiguous() for d in range(3))
    # The step runs in the trailing layout: a leading ga is moved once.
    ga = (bgeom.ga if trailing else
          {k: a.movedim(0, -1).contiguous() for k, a in bgeom.ga.items()})

    def _hold_done(old: SimState, new: SimState, done):
        """Keep the old (held) state of the cases where `done`; the mask
        broadcasts against the trailing case axis of every leaf."""
        return SimState(**{k: torch.where(done, getattr(old, k),
                                          getattr(new, k))
                           for k in _STATE_FIELDS})

    def cfl(states: SimState) -> Cfl:
        block = (contextlib.nullcontext() if ranks is None else
                 st.rank_block(ranks, *states.alpha.shape[:2]))
        with block:
            return core.cfl_dt(states, ga, spacing)

    def finish(states, params, cfl, t_stop):
        new_states, diag = core(states, params, ga, spacing, t_stop=t_stop,
                                cfl=cfl)
        if lockstep or t_stop is None:
            return new_states, diag
        done = states.t >= torch.as_tensor(t_stop, dtype=states.t.dtype,
                                           device=states.t.device)
        return _hold_done(states, new_states, done), diag

    lock = (Lockstep(True, cfl, finish) if lockstep
            else Lockstep(False, None, finish))
    return _sweep_step_of(lock, trailing, takes_t_stop=True, ranks=ranks)


def run_sweep(geom, param_rows: list[dict], t_end: float,
              props: PhysicalProperties = PhysicalProperties(),
              controls: SolverControls = SolverControls(),
              max_steps: int = 100_000, axis: int = -1, device="cuda"):
    """Advance a whole sweep batch to t_end. Returns (states, n_steps).

    `geom`: a TankGeometry (shared-geometry forcing sweep) or a
    BatchedGeometry (full geometry sweep, already on its device). The
    loop reads `min(t) < t_end` on the host once per step."""
    if isinstance(geom, BatchedGeometry):
        device = geom.spacing.device
        states = batch_states_geom(geom)
        sweep_step = make_geom_sweep_step(geom, props, controls)
    else:
        states = batch_states(geom, len(param_rows), axis=axis, device=device)
        sweep_step = make_sweep_step(geom, props, controls, axis=axis,
                                     device=device)
    params = batch_params(param_rows, device=device)
    n = 0
    while n < max_steps and prof.host_read(states.t.min() < t_end,
                                           "sweep.loop"):
        states, _ = sweep_step(states, params)
        n += 1
    return states, n
