"""Tank geometry on a uniform Cartesian MAC grid via cut-cell apertures.

The port's own numpy copy of ``openfoam_tpp_tpu/mesh/geometry.py``
(`TankGeometry`, `natural_shape`, the three builders and their helpers).
The arithmetic is the same line for line, so both packages build
bit-identical arrays for the same case.

Geometries: ``flat`` (cylinder radius D/2, z in [0, H]) and ``cap``
(cylinder union sphere(D/2) centred at z=0), whose top surface at z=H is
the open atmosphere patch; and the closed tanks of the 6DoF model,
``box`` (a rectangular tank) and ``chamfer`` (a prism with 45°-chamfered
bottom and top edges, the sloshingTank3D tutorial's shape class), walls
all round. Cells with volume fraction < 0.5 are solidified and their
faces closed.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np

VFRAC_SOLID_THRESHOLD = 0.5
_NQ = 4  # subsamples per axis for aperture quadrature


@dataclasses.dataclass(frozen=True)
class TankGeometry:
    """Static grid geometry. All arrays are numpy (uploaded once by
    solver.timestep.geometry_arrays)."""

    geo: str                 # 'flat' | 'cap' | 'box' | 'chamfer'
    H: float                 # tank height (top of domain) [m]
    D: float                 # tank diameter (or box x-width) [m]
    shape: tuple             # (nx, ny, nz) cell counts
    spacing: tuple           # (hx, hy, hz)
    origin: tuple            # (x0, y0, z0) of the grid corner
    vfrac: np.ndarray        # (nx, ny, nz)   cell fluid volume fraction
    ax: np.ndarray           # (nx+1, ny, nz) x-face apertures
    ay: np.ndarray           # (nx, ny+1, nz) y-face apertures
    az: np.ndarray           # (nx, ny, nz+1) z-face apertures
    top_open: np.ndarray     # (nx, ny)  aperture of the atmosphere patch
                             # (zeros for closed tanks)

    @property
    def fluid(self) -> np.ndarray:
        return self.vfrac > 0.0

    @property
    def n_fluid_cells(self) -> int:
        return int(np.count_nonzero(self.fluid))

    @property
    def cell_volume(self) -> float:
        hx, hy, hz = self.spacing
        return hx * hy * hz

    def cell_centers(self):
        """Return 1-D center coordinate arrays (x, y, z)."""
        nx, ny, nz = self.shape
        hx, hy, hz = self.spacing
        x0, y0, z0 = self.origin
        x = x0 + (np.arange(nx) + 0.5) * hx
        y = y0 + (np.arange(ny) + 0.5) * hy
        z = z0 + (np.arange(nz) + 0.5) * hz
        return x, y, z


def _inside_cylinder_flat(H, R):
    def inside(x, y, z):
        return (x * x + y * y <= R * R) & (z >= 0.0) & (z <= H)
    return inside


def _inside_cylinder_cap(H, R):
    def inside(x, y, z):
        in_cyl = (x * x + y * y <= R * R) & (z >= 0.0) & (z <= H)
        in_sph = x * x + y * y + z * z <= R * R
        return in_cyl | in_sph
    return inside


def _subsample_offsets(n):
    """Midpoint quadrature offsets in [0, 1)."""
    return (np.arange(n) + 0.5) / n


def _face_fraction(inside, axis, coords, spacing, shape, nq=_NQ):
    """Aperture array for faces normal to `axis`."""
    nx, ny, nz = shape
    hx, hy, hz = spacing
    x0, y0, z0 = coords
    fshape = [nx, ny, nz]
    fshape[axis] += 1
    offs = _subsample_offsets(nq)

    # Face-plane coordinates: along `axis` the coordinate is the face
    # position; in the two tangential axes we subsample.
    i = np.arange(fshape[0]).reshape(-1, 1, 1, 1, 1)
    j = np.arange(fshape[1]).reshape(1, -1, 1, 1, 1)
    k = np.arange(fshape[2]).reshape(1, 1, -1, 1, 1)
    o1 = offs.reshape(1, 1, 1, -1, 1)
    o2 = offs.reshape(1, 1, 1, 1, -1)

    if axis == 0:
        x = x0 + i * hx
        y = y0 + (j + o1) * hy
        z = z0 + (k + o2) * hz
    elif axis == 1:
        x = x0 + (i + o1) * hx
        y = y0 + j * hy
        z = z0 + (k + o2) * hz
    else:
        x = x0 + (i + o1) * hx
        y = y0 + (j + o2) * hy
        # The TOP face plane must sample at z = H exactly, but
        # z0 + nz·hz can land 1 ulp above H (e.g. cap grids where
        # hz = (H + R)/nz is non-dyadic), which flips the `z <= H`
        # inside-predicate and silently closes the atmosphere patch.
        # Nudge the last face a negligible 1e-9·hz inward.
        z = z0 + np.minimum(k, fshape[2] - 1 - 1e-9) * hz
    frac = inside(x, y, z).mean(axis=(3, 4))
    return frac.astype(np.float64)


def _volume_fraction(inside, coords, spacing, shape, nq=_NQ):
    nx, ny, nz = shape
    hx, hy, hz = spacing
    x0, y0, z0 = coords
    offs = _subsample_offsets(nq)
    i = np.arange(nx).reshape(-1, 1, 1, 1, 1, 1)
    j = np.arange(ny).reshape(1, -1, 1, 1, 1, 1)
    k = np.arange(nz).reshape(1, 1, -1, 1, 1, 1)
    o1 = offs.reshape(1, 1, 1, -1, 1, 1)
    o2 = offs.reshape(1, 1, 1, 1, -1, 1)
    o3 = offs.reshape(1, 1, 1, 1, 1, -1)
    # Chunk over k to bound peak memory on fine grids.
    out = np.empty((nx, ny, nz), dtype=np.float64)
    chunk = max(1, int(2e7 / (nx * ny * nq ** 3)))
    for k0 in range(0, nz, chunk):
        kk = k[:, :, : min(chunk, nz - k0)] + k0
        x = x0 + (i + o1) * hx
        y = y0 + (j + o2) * hy
        z = z0 + (kk + o3) * hz
        out[:, :, k0 : k0 + kk.shape[2]] = inside(x, y, z).mean(axis=(3, 4, 5))
    return out


def _finalize(geo, H, D, shape, spacing, origin, vfrac, ax, ay, az, open_top):
    """Apply small-cell solidification and boundary closure."""
    solid = vfrac < VFRAC_SOLID_THRESHOLD
    vfrac = np.where(solid, 0.0, vfrac)
    fluid = ~solid

    # A face is open only if both adjacent cells are fluid.
    ax[1:-1] = np.where(fluid[:-1] & fluid[1:], ax[1:-1], 0.0)
    ay[:, 1:-1] = np.where(fluid[:, :-1] & fluid[:, 1:], ay[:, 1:-1], 0.0)
    az[:, :, 1:-1] = np.where(fluid[:, :, :-1] & fluid[:, :, 1:], az[:, :, 1:-1], 0.0)

    # Domain-boundary faces are walls (velocity pinned to zero) except the
    # atmosphere at the top. Keep their aperture for the atmosphere patch;
    # close everything else.
    ax[0] = 0.0
    ax[-1] = 0.0
    ay[:, 0] = 0.0
    ay[:, -1] = 0.0
    az[:, :, 0] = 0.0
    if open_top:
        top = np.where(fluid[:, :, -1], az[:, :, -1], 0.0)
    else:
        top = np.zeros(shape[:2])
    az[:, :, -1] = top

    f32 = partial(np.asarray, dtype=np.float32)
    return TankGeometry(
        geo=geo, H=H, D=D, shape=shape, spacing=spacing, origin=origin,
        vfrac=f32(vfrac), ax=f32(ax), ay=f32(ay), az=f32(az),
        top_open=f32(top),
    )


def natural_shape(H, D, mesh, geo="flat", pad_cells=1, round_to=1):
    """The (nx, ny, nz) grid a case needs at spacing `mesh`."""
    h = float(mesh)
    nx = int(np.ceil(D / h)) + 2 * pad_cells
    nx = -(-nx // round_to) * round_to
    z_min = -D / 2.0 if geo == "cap" else 0.0
    nz = max(int(round((H - z_min) / h)), 1)
    return (nx, nx, nz)


def build_tank_geometry(
    H: float,
    D: float,
    mesh: float,
    geo: str = "flat",
    pad_cells: int = 1,
    nq: int = _NQ,
    round_to: int = 1,
    force_shape: tuple | None = None,
) -> TankGeometry:
    """Build the cylinder-tank geometry for a case parameter set.

    Matches generate_mesh.py's parameterization: R = D/2, characteristic
    length `mesh` (here the grid spacing; hz is snapped so the open top
    lands exactly on z=H). `round_to` rounds nx/ny up to a multiple —
    the extra cells lie outside the cylinder (solid, zero aperture) — so
    the grid divides evenly over a device-mesh axis or a kernel tile size.

    `force_shape` embeds the tank in a PRESCRIBED (nx, ny, nz) grid (must
    be at least the natural shape): extra x/y cells pad as solid outside
    the cylinder, and hz = (H − z_min)/nz refines vertically, so every
    case of a geometry-batched sweep shares one padded grid with its open
    top exactly at layer nz−1 (parallel/sweep.py batched geometry).
    """
    if geo not in ("flat", "cap"):
        raise ValueError(f"unknown geo {geo!r}")
    R = D / 2.0
    h = float(mesh)

    if force_shape is not None:
        nat = natural_shape(H, D, mesh, geo, pad_cells)
        nx, ny, nz = force_shape
        if nx < nat[0] or ny < nat[1] or nz < nat[2]:
            raise ValueError(
                f"force_shape {force_shape} smaller than the natural grid "
                f"{nat} for H={H}, D={D}, mesh={mesh}, geo={geo}"
            )
    else:
        nx = int(np.ceil(D / h)) + 2 * pad_cells
        nx = -(-nx // round_to) * round_to
        ny = nx
    x0 = -nx * h / 2.0
    y0 = -ny * h / 2.0

    z_min = -R if geo == "cap" else 0.0
    if force_shape is None:
        nz = max(int(round((H - z_min) / h)), 1)
    hz = (H - z_min) / nz

    shape = (nx, ny, nz)
    spacing = (h, h, hz)
    origin = (x0, y0, z_min)
    inside = _inside_cylinder_flat(H, R) if geo == "flat" else _inside_cylinder_cap(H, R)

    vfrac = _volume_fraction(inside, origin, spacing, shape, nq)
    ax = _face_fraction(inside, 0, origin, spacing, shape, nq)
    ay = _face_fraction(inside, 1, origin, spacing, shape, nq)
    az = _face_fraction(inside, 2, origin, spacing, shape, nq)
    return _finalize(geo, H, D, shape, spacing, origin, vfrac, ax, ay, az,
                     open_top=True)


def build_box_geometry(
    Lx: float,
    Ly: float,
    Lz: float,
    mesh: float,
    z0: float | None = None,
    open_top: bool = False,
) -> TankGeometry:
    """Closed rectangular tank (the sloshingTank3D6DoF class: one `wall`
    boundary, no atmosphere). Centred in x/y; z spans [z0, z0 + Lz]
    (default centred about z=0 like the tutorial tank)."""
    h = float(mesh)
    nx = max(int(round(Lx / h)), 1)
    ny = max(int(round(Ly / h)), 1)
    nz = max(int(round(Lz / h)), 1)
    spacing = (Lx / nx, Ly / ny, Lz / nz)
    if z0 is None:
        z0 = -Lz / 2.0
    origin = (-Lx / 2.0, -Ly / 2.0, z0)
    shape = (nx, ny, nz)
    vfrac = np.ones(shape)
    ax = np.ones((nx + 1, ny, nz))
    ay = np.ones((nx, ny + 1, nz))
    az = np.ones((nx, ny, nz + 1))
    return _finalize("box", z0 + Lz, Lx, shape, spacing, origin,
                     vfrac, ax, ay, az, open_top=open_top)


def chamfer_tank_volume(Lx: float, Ly: float, Lz: float,
                        chamfer: float) -> float:
    """Exact volume of the chamfered prism tank: the box minus the four
    corner wedges (each a right triangle c·c/2 extruded in x)."""
    c = float(chamfer) * Lz
    return Lx * (Ly * Lz - 2.0 * c * c)


def build_chamfer_tank_geometry(
    Lx: float,
    Ly: float,
    Lz: float,
    mesh: float,
    chamfer: float = 0.2,
    z0: float | None = None,
    nq: int = _NQ,
) -> TankGeometry:
    """Closed prism tank with 45°-chamfered bottom and top edges, the
    sloshingTank3D tutorial's shape class (the reference 6DoF variant's
    mesh). The four long edges (±y, ±z) are cut at 45° over a depth
    `chamfer`·Lz in both y and z, across the full x extent; `chamfer=0`
    is the plain box. Cross-section in (y, z): the hexagon {|y| ≤ Ly/2,
    |z| ≤ Lz/2, (|y|−yb) + (|z|−zb) ≤ c for |y|>yb, |z|>zb} with
    c = chamfer·Lz, yb = Ly/2 − c, zb = Lz/2 − c. Quadrature-sampled
    cut-cell apertures as for the cylinder tank."""
    if not 0.0 <= chamfer < 0.5:
        raise ValueError(f"chamfer fraction {chamfer} outside [0, 0.5)")
    h = float(mesh)
    nx = max(int(round(Lx / h)), 1)
    ny = max(int(round(Ly / h)), 1)
    nz = max(int(round(Lz / h)), 1)
    spacing = (Lx / nx, Ly / ny, Lz / nz)
    if z0 is None:
        z0 = -Lz / 2.0
    origin = (-Lx / 2.0, -Ly / 2.0, z0)
    shape = (nx, ny, nz)
    zc0 = z0 + Lz / 2.0  # cross-section centre height
    c = chamfer * Lz
    yb = Ly / 2.0 - c
    zb = Lz / 2.0 - c

    def inside(x, y, z):
        zz = np.abs(z - zc0)
        yy = np.abs(y)
        in_box = ((np.abs(x) <= Lx / 2.0) & (yy <= Ly / 2.0)
                  & (zz <= Lz / 2.0))
        if c <= 0.0:
            return in_box
        # 45° corner cut: active only in the corner quadrant.
        cut_ok = (yy - yb) + (zz - zb) <= c + 1e-12
        return in_box & (cut_ok | (yy <= yb) | (zz <= zb))

    vfrac = _volume_fraction(inside, origin, spacing, shape, nq)
    ax = _face_fraction(inside, 0, origin, spacing, shape, nq)
    ay = _face_fraction(inside, 1, origin, spacing, shape, nq)
    az = _face_fraction(inside, 2, origin, spacing, shape, nq)
    return _finalize("chamfer", z0 + Lz, Lx, shape, spacing, origin,
                     vfrac, ax, ay, az, open_top=False)
