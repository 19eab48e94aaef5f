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

Several positions share one card only through an explicit device list
that repeats it, as JAX's virtual CPU devices share the host. The parts
are SimStates: the JAX package packs its state (parallel/packed.py) only
to cross its sharded jit, a boundary this port does not have.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
                "position (run_case(devices=N), parallel/ranks.py; the 1-D "
                "x decomposition only, 'NxM' is the next slice of ROADMAP.md "
                "§1 item 2); repeat one device along x and y "
                "(devices=['cuda:0'] * N) to run them in one process")
        out.append(devs[0])
    return out


@dataclasses.dataclass(frozen=True)
class CaseSharding:
    """Which slice of the case axis each case position holds, and on which
    device. With `batched`, grid leaves (dim > 1) split on their trailing
    case axis and (B,) leaves on dim 0; unbatched, the one position holds
    the whole tree."""

    devices: tuple
    batched: bool

    def slices(self, n: int) -> list[slice]:
        """Each position's cases out of a batch of n."""
        k = len(self.devices)
        if n % k:
            raise ValueError(f"{n} cases do not divide over {k} case "
                             "positions")
        return [slice(i * n // k, (i + 1) * n // k) for i in range(k)]

    def put(self, tree) -> list:
        """One part of `tree` (a dataclass of tensors) per position, each
        contiguous on its position's device."""
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

    def gather(self, parts, device="cpu"):
        """The inverse of `put`: one tree on `device`."""
        if not self.batched:
            return _tree_map(lambda a: a.to(device), parts[0])
        fields = [f.name for f in dataclasses.fields(parts[0])]
        return type(parts[0])(**{
            k: torch.cat([getattr(p, k).to(device) for p in parts],
                         0 if getattr(parts[0], k).dim() <= 1 else -1)
            for k in fields})


def _tree_map(fn, tree):
    return type(tree)(**{f.name: fn(getattr(tree, f.name))
                         for f in dataclasses.fields(tree)})


def state_sharding(mesh: DeviceMesh, batched: bool = False) -> CaseSharding:
    """The sharding of a state (or, as `params_sharding`, of CaseParams):
    with `batched`, the case axis over the `case` mesh axis. The x and y
    axes are computed whole on their one device (module docstring)."""
    devs = case_devices(mesh)
    if not batched and len(devs) > 1:
        raise ValueError(
            f"an unbatched state on a mesh with {len(devs)} case positions: "
            "it has no case axis to spread (make_mesh(case_axis=1))")
    return CaseSharding(devices=tuple(devs), batched=batched)


params_sharding = state_sharding


def shard_state(state, mesh: DeviceMesh, batched: bool = False) -> list:
    """A SimState split over the mesh's case positions, each part on its
    position's device: the form `sharded_step` takes and returns."""
    return state_sharding(mesh, batched).put(state)


def shard_batched_geometry(bgeom, mesh: DeviceMesh) -> list:
    """Each case position's part of a BatchedGeometry (trailing layout) on
    its device, on the shared grid of the whole batch: the operand of a
    geometry sweep step built per position."""
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

    def __init__(self, steps: list, mesh: DeviceMesh, batched: bool):
        self.steps, self.mesh, self.batched = steps, mesh, batched
        self.sharding = state_sharding(mesh, batched)

    def __call__(self, parts: list, params_parts: list, t_stop=None):
        locks = [getattr(s, "lockstep", None) for s in self.steps]
        if None in locks:
            out = []
            for s, p, q in zip(self.steps, parts, params_parts):
                with on_device(p.t.device):
                    out.append(s(p, q) if t_stop is None
                               else s(p, q, t_stop=t_stop))
            return [o[0] for o in out], [o[1] for o in out]
        return lockstep_step(locks, parts, params_parts, t_stop)


def sharded_step(step_fn, mesh: DeviceMesh, batched: bool = False
                 ) -> ShardedStep:
    """The step over the mesh: every case position's part stepped on its
    device. `step_fn`: one step (a sweep step takes parts on any device
    when it was built by `make_sweep_step`), or one per case position (a
    geometry sweep's, each built on its part's BatchedGeometry). Sweep
    steps keep lockstep across positions: the batch minima of dt are
    taken over every part, as GSPMD's global minimum does."""
    n = len(case_devices(mesh))
    steps = list(step_fn) if isinstance(step_fn, (list, tuple)) \
        else [step_fn] * n
    if len(steps) != n:
        raise ValueError(f"{len(steps)} steps for {n} case positions")
    return ShardedStep(steps, mesh, batched)
