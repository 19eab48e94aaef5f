"""Field probes — functionObject parity.

Port of openfoam_tpp_tpu/post/probes.py. The reference samples `p` at
fixed points every timestep (the OpenFOAM `probes` functionObject) into
`postProcessing/probes/0/p`. Here probes sample on the device (trilinear
interpolation of cell-centered fields, no host sync) and `ProbeWriter`
writes the same text layout: the file format is the contract, so the
writer is numpy and file I/O exactly as in the JAX package.

In a rank process of the sharded step (parallel/ranks.py) a probe's
cells, or a wave column, may lie on any rank: `make_rank_sampler` gives
each rank a raw row from its own x·y block (every trilinear corner value and
every η it holds, zeros elsewhere), and rank 0 picks each entry from its
owner once per write interval and blends the corners as `sample_row`
does, so the rows are the whole grid's, bit for bit, with no host sync
added per step.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import TankGeometry


def default_probe_points(geom: TankGeometry) -> np.ndarray:
    """Two probes on the axis: mid-fill and near the top."""
    return np.array([
        [0.0, 0.0, geom.H * 0.25],
        [0.0, 0.0, geom.H * 0.75],
    ])


def default_wave_columns(geom: TankGeometry) -> np.ndarray:
    """(x, y) wave-gauge columns: surface elevation η is recorded at these
    azimuths every timestep. For cylinders: r = 0.85 R at θ = 0°/90°/180°
    (the potential-flow dashboard's wave-probe stations); for boxes:
    center + x-quarter point."""
    if geom.geo == "box":
        x0, y0, _ = geom.origin
        Lx = geom.shape[0] * geom.spacing[0]
        Ly = geom.shape[1] * geom.spacing[1]
        cx, cy = x0 + Lx / 2.0, y0 + Ly / 2.0
        return np.array([[cx, cy], [cx + Lx / 4.0, cy]])
    r = 0.85 * geom.D / 2.0
    return np.array([[r, 0.0], [0.0, r], [-r, 0.0]])


def probe_pack(geom: TankGeometry, points, columns, device="cuda") -> dict:
    """Geometry-derived probe constants as a dict of small tensors on
    `device`, which `sample_row` takes as operands."""
    dev = resolve_device(device)
    hx, hy, hz = geom.spacing
    x0, y0, z0 = geom.origin
    cols = np.asarray(columns, np.float64)
    ci = np.clip(((cols[:, 0] - x0) / hx - 0.5).round().astype(np.int32),
                 0, geom.shape[0] - 1)
    cj = np.clip(((cols[:, 1] - y0) / hy - 0.5).round().astype(np.int32),
                 0, geom.shape[1] - 1)
    # Snap gauges landing in solid/cut-away columns (coarse grids put
    # 0.85 R inside the wall's cut cells) to the nearest fluid column on
    # the straight path toward the tank axis.
    vfrac = np.asarray(geom.vfrac)
    icen = int(np.clip(round(-x0 / hx - 0.5), 0, geom.shape[0] - 1))
    jcen = int(np.clip(round(-y0 / hy - 0.5), 0, geom.shape[1] - 1))
    for k in range(len(cols)):
        for _ in range(max(geom.shape[0], geom.shape[1])):
            if vfrac[ci[k], cj[k], :].max() > 0.5:
                break
            ci[k] += np.sign(icen - ci[k])
            cj[k] += np.sign(jcen - cj[k])
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return {
        "ci": torch.as_tensor(ci.astype(np.int64), device=dev),
        "cj": torch.as_tensor(cj.astype(np.int64), device=dev),
        "vcol": f32(vfrac[ci, cj, :]),
        "pts": f32(points).reshape(-1, 3),
        "origin": f32([x0, y0, z0]),
        "spacing": f32([hx, hy, hz]),
    }


def sample_row(state, pack: dict):
    """row = [t, p@points..., η@columns...] from a probe_pack, as a 1-D
    f32 tensor on the state's device."""
    z0 = pack["origin"][2]
    hz = pack["spacing"][2]
    p_vals = _trilinear(state.p, pack["pts"], pack["origin"],
                        pack["spacing"])
    vnorm = torch.clamp(pack["vcol"].max(dim=-1).values, min=1e-6)
    acol = state.alpha[pack["ci"], pack["cj"], :] * pack["vcol"]
    eta = z0 + hz * acol.sum(dim=-1) / vnorm
    return torch.cat([state.t.reshape(1).float(), p_vals.float(),
                      eta.float()])


def stack_packs(packs: list) -> dict:
    """Per-case probe packs → one pack with a leading case axis, which
    `sample_rows_batched` takes."""
    return {k: torch.stack([p[k] for p in packs], 0) for k in packs[0]}


def sample_rows_batched(states, bpack: dict):
    """`sample_row` of every case of a batched state (grid arrays
    (nx, ny, nz, B), t (B,)) with its own pack out of `stack_packs`:
    (B, row_width) f32. Case b's row holds the values `sample_row` gives
    for that case alone (the JAX package vmaps `sample_row`)."""
    n = states.t.shape[0]
    lane = torch.arange(n, device=states.t.device)
    z0 = bpack["origin"][:, 2:3]
    hz = bpack["spacing"][:, 2:3]
    p_vals = _trilinear(states.p, bpack["pts"], bpack["origin"],
                        bpack["spacing"], lane=lane)
    vnorm = torch.clamp(bpack["vcol"].max(dim=-1).values, min=1e-6)
    acol = states.alpha[bpack["ci"], bpack["cj"], :, lane[:, None]] \
        * bpack["vcol"]
    eta = z0 + hz * acol.sum(dim=-1) / vnorm
    return torch.cat([states.t.reshape(n, 1).float(), p_vals.float(),
                      eta.float()], dim=1)


def make_probe_sampler(geom: TankGeometry, points, columns, device="cuda"):
    """`sampler(state) -> row` with row = [t, p@points..., η@columns...],
    and the row's width: a closure over `probe_pack`/`sample_row`."""
    pack = probe_pack(geom, points, columns, device=device)

    def sampler(state):
        return sample_row(state, pack)

    return sampler, 1 + len(np.asarray(points).reshape(-1, 3)) + len(
        np.asarray(columns, np.float64))


def sample_cell_field(field, points, geom: TankGeometry):
    """Trilinear sample of a cell-centered field (a tensor) at world
    points, on the field's device."""
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=field.device)
    return _trilinear(field, f32(points).reshape(-1, 3), f32(geom.origin),
                      f32(geom.spacing))


def _trilinear(field, pts, origin, spacing, lane=None):
    """Trilinear sample with origin/spacing as (3,) tensor operands. With
    `lane` (the case indices, (B,)): `field` is (nx, ny, nz, B), `pts`
    (B, n, 3), origin and spacing (B, 3), and the result (B, n)."""
    corners, weights = _corners(pts, origin, spacing, field.shape[:3], lane)

    def g(i, j, k):
        if lane is not None:
            return field[i, j, k, lane[:, None]]
        return field[i, j, k]

    return _blend([g(*c) for c in corners], *weights)


def _corners(pts, origin, spacing, shape, lane=None):
    """The trilinear stencil of `pts`: its 8 corner cells (i, j, k) in
    `_blend`'s order and the weights (tx, ty, tz)."""
    if lane is not None:
        origin, spacing = origin[:, None, :], spacing[:, None, :]
    fx = (pts[..., 0] - origin[..., 0]) / spacing[..., 0] - 0.5
    fy = (pts[..., 1] - origin[..., 1]) / spacing[..., 1] - 0.5
    fz = (pts[..., 2] - origin[..., 2]) / spacing[..., 2] - 0.5
    nx, ny, nz = shape

    def clamp(i, n):
        return torch.clamp(i, 0, n - 1)

    i0 = clamp(torch.floor(fx).long(), nx)
    j0 = clamp(torch.floor(fy).long(), ny)
    k0 = clamp(torch.floor(fz).long(), nz)
    i1, j1, k1 = clamp(i0 + 1, nx), clamp(j0 + 1, ny), clamp(k0 + 1, nz)
    tx = torch.clamp(fx - i0, 0.0, 1.0)
    ty = torch.clamp(fy - j0, 0.0, 1.0)
    tz = torch.clamp(fz - k0, 0.0, 1.0)
    corners = [(i, j, k) for j in (j0, j1) for k in (k0, k1)
               for i in (i0, i1)]
    return corners, (tx, ty, tz)


def _blend(v, tx, ty, tz):
    """Trilinear blend of the 8 corner values of `_corners`."""
    c00 = v[0] * (1 - tx) + v[1] * tx
    c01 = v[2] * (1 - tx) + v[3] * tx
    c10 = v[4] * (1 - tx) + v[5] * tx
    c11 = v[6] * (1 - tx) + v[7] * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def make_rank_sampler(geom: TankGeometry, points, columns, ranks,
                      device="cuda"):
    """The probe sampler of one rank of the sharded step (`ranks` a
    parallel.ranks.RankCtx): (sampler, raw width, rows). `sampler(state)`
    on the rank's block state gives its raw row, [t, the 8 corner values
    of each point, η of each column], with 0 for what other ranks hold;
    `rows(parts)`, on the raw rows (n, raw width) of every rank in rank
    order, gives the n rows `sample_row` gives on the whole grid."""
    dev = resolve_device(device)
    pack = probe_pack(geom, points, columns, device=dev)
    n_x, n_y = ranks.grid
    nxl, nyl = geom.shape[0] // n_x, geom.shape[1] // n_y
    xo, yo = ranks.ix * nxl, ranks.iy * nyl
    corners, weights = _corners(pack["pts"], pack["origin"], pack["spacing"],
                                geom.shape)
    gi, gj, gk = (torch.stack([c[a] for c in corners], -1) for a in range(3))

    def local(i, j):
        """(mine, local i, local j) of global cells (i, j)."""
        mine = (i >= xo) & (i < xo + nxl) & (j >= yo) & (j < yo + nyl)
        return (mine, torch.clamp(i - xo, 0, nxl - 1),
                torch.clamp(j - yo, 0, nyl - 1))

    mine, li, lj = local(gi, gj)
    ci, cj = pack["ci"], pack["cj"]
    col_mine, lci, lcj = local(ci, cj)
    z0, hz = pack["origin"][2], pack["spacing"][2]
    vnorm = torch.clamp(pack["vcol"].max(dim=-1).values, min=1e-6)
    # Each raw entry's rank: t from rank 0, a corner or a column from the
    # rank holding its (x, y), r = ix·M + iy.
    owner = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                       (gi.reshape(-1) // nxl) * n_y + gj.reshape(-1) // nyl,
                       (ci // nxl) * n_y + cj // nyl])
    n_pts = gi.shape[0]

    def sampler(state):
        vals = torch.where(mine, state.p[li, lj, gk], 0.0)
        acol = state.alpha[lci, lcj, :] * pack["vcol"]
        eta = torch.where(col_mine, z0 + hz * acol.sum(dim=-1) / vnorm, 0.0)
        return torch.cat([state.t.reshape(1).float(),
                          vals.reshape(-1).float(), eta.float()])

    def rows(parts):
        raw = torch.stack(parts)                        # (world, n, width)
        cols = torch.arange(raw.shape[-1], device=raw.device)
        picked = raw[owner.to(raw.device), :, cols].T   # (n, width)
        v = picked[:, 1:1 + 8 * n_pts].reshape(-1, n_pts, 8)
        p_vals = _blend([v[..., c] for c in range(8)],
                        *(w.to(raw.device) for w in weights))
        return torch.cat([picked[:, :1], p_vals, picked[:, 1 + 8 * n_pts:]],
                         dim=1)

    return sampler, 1 + 8 * n_pts + len(ci), rows


class ProbeWriter:
    """Accumulates probe rows and writes the OpenFOAM probes text format."""

    def __init__(self, case_dir: str, points: np.ndarray, field_name="p",
                 start_time: float = 0.0):
        self.points = np.asarray(points)
        time_dir = f"{start_time:g}"
        self.dir = os.path.join(case_dir, "postProcessing", "probes", time_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, field_name)
        # Header only when the file does not exist — a re-run over already
        # written intervals must not truncate history.
        if not os.path.exists(self.path):
            with open(self.path, "w") as f:
                for i, p in enumerate(self.points):
                    f.write(f"# Probe {i} ({p[0]:g} {p[1]:g} {p[2]:g})\n")
                header = "".join(f"{i:>14d}" for i in range(len(self.points)))
                f.write(f"#{'Probe':>13s}{header}\n")
                f.write(f"#{'Time':>13s}\n")
            self._last_t = -np.inf
        else:
            self._last_t = self._read_last_time()

    def _read_last_time(self) -> float:
        """Last recorded time in the file (so re-runs skip duplicate rows)."""
        last = -np.inf
        with open(self.path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                try:
                    last = float(line.split()[0])
                except ValueError:
                    pass
        return last

    def append(self, t: float, values):
        if t <= self._last_t + 1e-9:
            return  # already recorded (resume over written interval)
        self._last_t = t
        vals = np.asarray(values).reshape(-1)
        with open(self.path, "a") as f:
            f.write(f"{t:>14.8g}" + "".join(f"{v:>14.6g}" for v in vals) + "\n")

    def append_rows(self, times, rows):
        """Bulk append (one file open) of per-timestep samples: `times`
        (n,), `rows` (n, n_probes). Rows at or before the last recorded
        time are skipped (resume dedup), as are non-advancing rows WITHIN
        the call — a state held at a write target repeats its time."""
        times = np.asarray(times).reshape(-1)
        rows = np.asarray(rows)
        prev = np.concatenate([[self._last_t], times[:-1]])
        keep = times > np.maximum.accumulate(prev) + 1e-9
        if not keep.any():
            return
        with open(self.path, "a") as f:
            for t, vals in zip(times[keep], rows[keep]):
                f.write(f"{t:>14.8g}"
                        + "".join(f"{v:>14.6g}" for v in vals) + "\n")
        self._last_t = float(times[keep][-1])
