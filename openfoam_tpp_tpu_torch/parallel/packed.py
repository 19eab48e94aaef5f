"""Uniform-shape state packing — port of openfoam_tpp_tpu/parallel/packed.py.

MAC face arrays are (n+1)-sized along their normal. PackedState stores
every field with the *cell* shape (nx, ny, nz):

  * u, v, w keep faces 0..n-1 (the "lower" face of each cell); the dropped
    upper-boundary face is identically zero for u/v (walls, aperture 0 —
    mesh/geometry.py `_finalize`) and is carried separately for w as the
    (nx, ny) `w_top` atmosphere-face plane.

The JAX package needs this layout at the boundary of a sharded jit, whose
array dimensions must divide over the mesh. The port's mesh runs carry
global SimStates and cross no such boundary (parallel/sharding.py), so
nothing on their path packs; the layout is kept, with `packed_fn`, for
code that exchanges packed states with the JAX package's conventions.
pack/unpack are O(boundary) slice/concat ops; a batched state (case axis
trailing) packs the same way.
"""

from __future__ import annotations

import dataclasses

import torch

from openfoam_tpp_tpu_torch.core.state import SimState


@dataclasses.dataclass
class PackedState:
    """SimState with uniform (nx, ny, nz) field shapes."""

    alpha: torch.Tensor   # (nx, ny, nz)
    u: torch.Tensor       # (nx, ny, nz)  x-faces 0..nx-1 (face nx == 0, wall)
    v: torch.Tensor       # (nx, ny, nz)  y-faces 0..ny-1 (face ny == 0, wall)
    w: torch.Tensor       # (nx, ny, nz)  z-faces 0..nz-1
    w_top: torch.Tensor   # (nx, ny)      z-face nz (open atmosphere patch)
    p: torch.Tensor       # (nx, ny, nz)
    t: torch.Tensor
    dt: torch.Tensor
    step: torch.Tensor


def _grid_dim(state, axis: int) -> int:
    """Grid axis `axis` (0, 1, 2) of a single or batched state's fields."""
    return axis - 3 if state.alpha.dim() == 3 else axis - 4


def pack(state: SimState) -> PackedState:
    dx, dy, dz = (_grid_dim(state, a) for a in range(3))
    return PackedState(
        alpha=state.alpha,
        u=state.u.narrow(dx, 0, state.u.shape[dx] - 1),
        v=state.v.narrow(dy, 0, state.v.shape[dy] - 1),
        w=state.w.narrow(dz, 0, state.w.shape[dz] - 1),
        w_top=state.w.select(dz, state.w.shape[dz] - 1),
        p=state.p,
        t=state.t,
        dt=state.dt,
        step=state.step,
    )


def unpack(ps: PackedState) -> SimState:
    dx, dy, dz = (_grid_dim(ps, a) for a in range(3))
    zx = torch.zeros_like(ps.u.narrow(dx, 0, 1))
    zy = torch.zeros_like(ps.v.narrow(dy, 0, 1))
    return SimState(
        alpha=ps.alpha,
        u=torch.cat([ps.u, zx], dim=dx),
        v=torch.cat([ps.v, zy], dim=dy),
        w=torch.cat([ps.w, ps.w_top.unsqueeze(dz)], dim=dz),
        p=ps.p,
        t=ps.t,
        dt=ps.dt,
        step=ps.step,
    )


def packed_fn(step_fn):
    """Wrap a step(state, params) -> (state, diag) to take and return
    PackedState."""

    def fn(ps: PackedState, params, *args, **kwargs):
        new_state, *rest = step_fn(unpack(ps), params, *args, **kwargs)
        return (pack(new_state), *rest)

    return fn
