"""The device mesh — port of openfoam_tpp_tpu/parallel/sharding.py.

The JAX package lays its arrays over a `jax.sharding.Mesh` with axes
(case, x, y) and lets GSPMD partition one program: the x (and y) axes
cut the grid (stencil shifts become collective-permutes, reductions
psums), the case axis farms a sweep's batch (the only collective left is
the lockstep dt's minimum). JAX is single-controller, and so is this
port: one process holds a `DeviceMesh` of `torch.device`s, one per mesh
position, and drives every position itself.

  * The case axis is a farm. `state_sharding` / `params_sharding` give
    each case position its slice of the batch's case axis (trailing, as
    every batched tensor of the port), `shard_state` puts the slices on
    their positions' devices, and `sharded_step` steps every position's
    part on its own device, with the lockstep minima taken over all of
    them (parallel/sweep.py `lockstep_step`). Nothing else crosses
    positions, so this is multi-card code that runs as it is on one
    card whose positions repeat.
  * The x and y axes cut the grid. Positions that share one device
    compute the global step, which is what GSPMD computes: the 1-D x
    islands of parallel/spmd.py (`SpmdCtx`) or the global step
    (manager/runner.py `step_choice`). Spatial positions on distinct
    devices are not this process's to drive: `run_case` runs them as
    ranks, one process a position (parallel/ranks.py), and here they
    raise NotImplementedError.

  * Over ranks (the JAX package's multi-controller form, every process
    running the same program): with `ranks=` (a parallel.ranks.RankCtx
    on a (C, N, M) rank grid, one process a mesh position, from
    `ranks.launch(fn, positions, grid=(C, N, M))`) every rank holds the
    whole batch as its input and `shard_state` keeps its case
    position's slice of the case axis cut to its x·y block; the step,
    `make_sweep_step` or `make_geom_sweep_step(..., spmd=SpmdCtx(N, M,
    ranks=ctx))` (the latter on `shard_batched_geometry(..., ranks=)`),
    steps that block with the minima over every rank, and `gather`
    brings the whole batch back to rank 0. A case axis beside spatial
    positions on distinct cards runs this way. Unbatched (`batched=False`
    on a (1, N, M) grid, as JAX's `sharded_step(step, mesh)` cuts one
    state over x·y): `shard_state` keeps the rank's x·y block of the one
    state, the params stay whole on every rank, and the step is
    `make_step` or `make_tiled_sweep_step(..., spmd=SpmdCtx(N, M,
    ranks=ctx))`.

Several positions share one card only through an explicit device list
that repeats it, as JAX's virtual CPU devices share the host. The parts
are SimStates: the JAX package packs its state (parallel/packed.py) only
to cross its sharded jit, a boundary this port does not have.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.parallel.sweep import lockstep_step, on_device

AXIS_NAMES = ("case", "x", "y")


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """`devices`: an object array of torch.device, shape (case, x, y)."""

    devices: np.ndarray
    axis_names: tuple = AXIS_NAMES

    @property
    def shape(self) -> dict:
        """Axis name → extent."""
        return dict(zip(self.axis_names, self.devices.shape))


def make_mesh(n_devices: int | None = None, case_axis: int = 1,
              y_axis: int = 1, devices=None) -> DeviceMesh:
    """Device mesh with axes (case, x, y).

    case_axis=1, y_axis=1 → purely x-spatial (1-D decomposition, the
    default); y_axis>1 adds the second spatial axis. The x extent is
    whatever remains: n_devices / (case_axis · y_axis). `devices`
    (torch.devices or their names) defaults to the visible CUDA cards; a
    list may repeat a device, to put several positions on it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(
            f"make_mesh: asked for {n_devices} devices but only "
            f"{len(devices)} available ({[str(d) for d in devices]}); to "
            "put several positions on one card, pass an explicit list that "
            "repeats it (devices=['cuda:0'] * N)")
    if n_devices % (case_axis * y_axis):
        raise ValueError(
            f"make_mesh: case_axis={case_axis} * y_axis={y_axis} does not "
            f"divide n_devices={n_devices}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    x_axis = n_devices // (case_axis * y_axis)
    return DeviceMesh(grid.reshape(case_axis, x_axis, y_axis))


def parse_devices(spec) -> tuple[int, int]:
    """(x_shards, y_shards) from a --devices spec: an int N (x-only, the
    1-D default) or a string 'NxM' for a 2-D (x, y) spatial decomposition
    (decomposeParDict hierarchical-n analog)."""
    if spec is None:
        return 1, 1
    if isinstance(spec, int):
        return max(spec, 1), 1
    s = str(spec).lower().replace("×", "x")
    if "x" in s:
        dx, dy = s.split("x", 1)
        return max(int(dx), 1), max(int(dy), 1)
    return max(int(s), 1), 1


def case_devices(mesh: DeviceMesh) -> list[torch.device]:
    """The device of each case position: the one device its x and y
    positions share. Distinct devices along x or y raise: one process
    drives them only as ranks."""
    out = []
    for block in mesh.devices:
        devs = list(dict.fromkeys(block.ravel()))
        if len(devs) > 1:
            raise NotImplementedError(
                f"a mesh whose x/y positions lie on distinct devices "
                f"({[str(d) for d in devs]}) in one process: spatial "
                "positions on distinct cards run as ranks, one process a "
                "position (run_case(devices=N or 'NxM'), parallel/ranks.py; "
                "a case axis beside them through ranks.launch(fn, "
                "positions, grid=(C, N, M)) and this module's ranks= form); "
                "repeat one device along x and y (devices=['cuda:0'] * N) "
                "to run them in one process")
        out.append(devs[0])
    return out


@dataclasses.dataclass(frozen=True)
class CaseSharding:
    """Which slice of the case axis each case position holds, and on which
    device. With `batched`, grid leaves (dim > 1) split on their trailing
    case axis and (B,) leaves on dim 0; unbatched, the one position holds
    the whole tree. With `ranks` (a RankCtx): this rank's part alone, its
    case position's slice cut to its x·y block of a grid of `shape`
    cells."""

    devices: tuple
    batched: bool
    ranks: object = None
    shape: tuple = None

    def slices(self, n: int) -> list[slice]:
        """Each position's cases out of a batch of n."""
        k = len(self.devices) if self.ranks is None else self.ranks.cases
        if n % k:
            raise ValueError(f"{n} cases do not divide over {k} case "
                             "positions")
        return [slice(i * n // k, (i + 1) * n // k) for i in range(k)]

    def put(self, tree) -> list:
        """One part of `tree` (a dataclass of tensors) per position, each
        contiguous on its position's device; over ranks a list of this
        rank's part alone."""
        if self.ranks is not None:
            return [self._rank_part(tree)]
        if not self.batched:
            return [_tree_map(lambda a: a.to(self.devices[0]), tree)]
        # The case count: a state's t, or a CaseParams' first (B,) leaf.
        first = getattr(tree, dataclasses.fields(tree)[0].name)
        n = getattr(tree, "t", first).shape[0]

        def part(sl, dev):
            return _tree_map(
                lambda a: (a[sl] if a.dim() <= 1 else a[..., sl])
                .contiguous().to(dev), tree)

        return [part(sl, dev) for sl, dev in zip(self.slices(n),
                                                  self.devices)]

    def _rank_part(self, tree):
        """This rank's case slice of `tree` (unbatched: all of it), its
        grid leaves cut to the rank's x·y block (face leaves keep their
        shared plane or row); the other leaves whole."""
        r = self.ranks
        if self.batched:
            first = getattr(tree, dataclasses.fields(tree)[0].name)
            sl = self.slices(getattr(tree, "t", first).shape[0])[r.ic]

        def part(a):
            if self.batched:
                a = a[sl] if a.dim() <= 1 else a[..., sl]
            if a.dim() > 1:
                a = r.block(a, self.shape)
            return a.contiguous().to(r.device)

        return _tree_map(part, tree)

    def gather(self, parts, device="cpu"):
        """The inverse of `put`: one tree on `device`. Over ranks every
        rank takes part and rank 0 gets the whole batch (the others
        None)."""
        if self.ranks is not None:
            return self._rank_gather(parts[0], device)
        if not self.batched:
            return _tree_map(lambda a: a.to(device), parts[0])
        fields = [f.name for f in dataclasses.fields(parts[0])]
        return type(parts[0])(**{
            k: torch.cat([getattr(p, k).to(device) for p in parts],
                         0 if getattr(parts[0], k).dim() <= 1 else -1)
            for k in fields})


    def _rank_gather(self, part, device):
        r = self.ranks
        shape = getattr(part, "alpha", None)
        shape = None if shape is None else tuple(shape.shape)

        def faces(a):
            if shape is None or a.dim() <= 1:
                return None
            return (0 if a.shape[0] == shape[0] + 1
                    else 1 if a.shape[1] == shape[1] + 1 else None)

        whole = {}
        for f in dataclasses.fields(part):
            a = getattr(part, f.name)
            if a.dim() > 1:
                a = r.gather_block(a, faces(a))
            if not self.batched:
                whole[f.name] = a.to(device) if r.rank == 0 else None
                continue
            # Every case position's slice, in case order, on every rank.
            cuts = r.all_gather(a, world=True)
            whole[f.name] = (torch.cat(
                [c.to(device) for c in cuts[::r.group_size]],
                0 if a.dim() <= 1 else -1) if r.rank == 0 else None)
        return type(part)(**whole) if r.rank == 0 else None


def _tree_map(fn, tree):
    return type(tree)(**{f.name: fn(getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def _rank_mesh(mesh: DeviceMesh, ranks):
    """Check that `mesh` is the rank grid of `ranks`: (C, N, M)."""
    want = (ranks.cases, *ranks.grid)
    if tuple(mesh.devices.shape) != want:
        raise ValueError(f"a {mesh.devices.shape} mesh over ranks on a "
                         f"{want} rank grid: one rank a mesh position")


def state_sharding(mesh: DeviceMesh, batched: bool = False, ranks=None,
                   shape=None) -> CaseSharding:
    """The sharding of a state (or, as `params_sharding`, of CaseParams):
    with `batched`, the case axis over the `case` mesh axis. The x and y
    axes are computed whole on their one device (module docstring).
    `ranks` (a RankCtx whose (C, N, M) grid is the mesh's, one process a
    position): this rank's case slice of a batch on a grid of `shape`
    cells (nx, ny, nz), cut to its x·y block; unbatched (C = 1), the
    rank's x·y block of the one state, its other leaves whole (params
    replicated)."""
    if ranks is not None:
        _rank_mesh(mesh, ranks)
        if not batched and ranks.cases > 1:
            raise ValueError(
                f"an unbatched state on a rank grid with {ranks.cases} case "
                "positions: it has no case axis to spread (a (1, N, M) "
                "grid)")
        return CaseSharding(devices=(ranks.device,), batched=batched,
                            ranks=ranks, shape=shape)
    devs = case_devices(mesh)
    if not batched and len(devs) > 1:
        raise ValueError(
            f"an unbatched state on a mesh with {len(devs)} case positions: "
            "it has no case axis to spread (make_mesh(case_axis=1))")
    return CaseSharding(devices=tuple(devs), batched=batched)


params_sharding = state_sharding


def shard_state(state, mesh: DeviceMesh, batched: bool = False,
                ranks=None) -> list:
    """A SimState split over the mesh's case positions, each part on its
    position's device: the form `sharded_step` takes and returns. With
    `ranks`: [this rank's part], its case slice cut to its x·y block."""
    shape = None if ranks is None else tuple(state.alpha.shape[:3])
    return state_sharding(mesh, batched, ranks, shape).put(state)


def shard_batched_geometry(bgeom, mesh: DeviceMesh, ranks=None) -> list:
    """Each case position's part of a BatchedGeometry (trailing layout) on
    its device, on the shared grid of the whole batch: the operand of a
    geometry sweep step built per position. With `ranks` (a RankCtx
    whose (C, N, M) grid is the mesh's): [this rank's part], its case
    position's cases cut to its x·y block (parallel/sweep.py
    `rank_geometry`), for `make_geom_sweep_step(part, spmd=SpmdCtx(N, M,
    ranks=ctx))`."""
    if ranks is not None:
        from openfoam_tpp_tpu_torch.parallel.sweep import rank_geometry

        _rank_mesh(mesh, ranks)
        return [rank_geometry(bgeom, ranks)]
    sharding = state_sharding(mesh, batched=True)
    return [dataclasses.replace(
        bgeom, geoms=bgeom.geoms[sl],
        ga={k: a[..., sl].contiguous().to(dev) for k, a in bgeom.ga.items()},
        spacing=bgeom.spacing[sl].contiguous().to(dev))
        for sl, dev in zip(sharding.slices(bgeom.n_cases), sharding.devices)]


class ShardedStep:
    """A step over the mesh: `step(parts, params_parts, t_stop=None)`
    steps one (trailing-layout) SimState per case position on its device
    and returns (parts', diags), a list each. The parts stay on their
    devices from step to step; `sharding.gather` joins them."""

    def __init__(self, steps: list, mesh: DeviceMesh, batched: bool,
                 ranks=None):
        self.steps, self.mesh, self.batched = steps, mesh, batched
        self.ranks = ranks
        self.sharding = state_sharding(mesh, batched, ranks)

    def __call__(self, parts: list, params_parts: list, t_stop=None):
        locks = [getattr(s, "lockstep", None) for s in self.steps]
        if self.ranks is not None and not self.batched:
            # The step opens the rank's block itself.
            args = (parts[0], params_parts[0])
            new, diag = (self.steps[0](*args) if t_stop is None
                         else self.steps[0](*args, t_stop=t_stop))
            return [new], [diag]
        if self.ranks is not None:
            block = parts[0].alpha.shape
            with st.rank_block(self.ranks, block[0], block[1]):
                return lockstep_step(locks, parts, params_parts, t_stop,
                                     ranks=self.ranks)
        if None in locks:
            out = []
            for s, p, q in zip(self.steps, parts, params_parts):
                with on_device(p.t.device):
                    out.append(s(p, q) if t_stop is None
                               else s(p, q, t_stop=t_stop))
            return [o[0] for o in out], [o[1] for o in out]
        return lockstep_step(locks, parts, params_parts, t_stop)


def sharded_step(step_fn, mesh: DeviceMesh, batched: bool = False,
                 ranks=None) -> ShardedStep:
    """The step over the mesh: every case position's part stepped on its
    device. `step_fn`: one step (a sweep step takes parts on any device
    when it was built by `make_sweep_step`), or one per case position (a
    geometry sweep's, each built on its part's BatchedGeometry). Sweep
    steps keep lockstep across positions: the batch minima of dt are
    taken over every part, as GSPMD's global minimum does.

    `ranks` (the RankCtx of a (C, N, M) rank grid that is the mesh's):
    this rank's part, from `shard_state(..., ranks=)`, stepped under the
    stencil's rank block by `step_fn` built for that block with
    `spmd=SpmdCtx(N, M, ranks=ctx)`: batched, `make_sweep_step` or
    `make_geom_sweep_step` (the lockstep minima over every rank);
    unbatched, on a (1, N, M) grid, `make_step` or
    `make_tiled_sweep_step`."""
    if ranks is not None:
        _rank_mesh(mesh, ranks)
        if getattr(step_fn, "ranks", None) is not ranks or (
                batched and getattr(step_fn, "lockstep", None) is None):
            raise NotImplementedError(
                "sharded_step(ranks=) takes the step built for this rank's "
                "block with spmd=SpmdCtx(N, M, ranks=ctx): batched, "
                "make_sweep_step or make_geom_sweep_step; unbatched, "
                "make_step or make_tiled_sweep_step")
        return ShardedStep([step_fn], mesh, batched, ranks)
    n = len(case_devices(mesh))
    steps = list(step_fn) if isinstance(step_fn, (list, tuple)) \
        else [step_fn] * n
    if len(steps) != n:
        raise ValueError(f"{len(steps)} steps for {n} case positions")
    return ShardedStep(steps, mesh, batched)
