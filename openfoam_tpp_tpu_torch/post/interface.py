"""On-device interface extraction.

Port of openfoam_tpp_tpu/post/interface.py: the free surface is computed
directly from the alpha field on the device and written to the reference
manager's artifacts:

  * ``interface_t{t:.6f}.vtp``  — triangulated free-surface mesh
  * ``interface_summary.csv``   — time,max_z,min_z,mean_z,num_points
  * ``wall_elevation.csv``      — time,theta,zeta_wall (64 θ-bins at the wall)

Surface representation: per-column liquid height η(x, y) = z_floor +
Σ_k α hz (exact for a monotone column; the graph of η is the α = 0.5
iso-surface for non-breaking sloshing waves). The wall profile uses the
ring of fluid columns adjacent to the tank wall — the structured-grid
analog of the reference's r > 0.98 R point filter.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from openfoam_tpp_tpu_torch.device import resolve_device
from openfoam_tpp_tpu_torch.mesh.geometry import TankGeometry
from openfoam_tpp_tpu_torch.post import isosurface as iso
from openfoam_tpp_tpu_torch.utils.io import write_vtp

N_THETA_BINS = 64


def column_masks(geom: TankGeometry):
    """Static per-column data: wetted mask, floor elevation, wall-ring mask.

    Returns (wet, z_floor, wall_ring) numpy arrays of shape (nx, ny)."""
    fluid = geom.fluid
    wet = fluid.any(axis=2)
    hz = geom.spacing[2]
    z0 = geom.origin[2]
    # First fluid cell per column (columns with no fluid get 0).
    first = np.argmax(fluid, axis=2)
    z_floor = z0 + first * hz
    z_floor = np.where(wet, z_floor, 0.0)

    # Wall ring: wetted columns with a non-wetted 4-neighbor (or domain edge).
    pad = np.pad(wet, 1, constant_values=False)
    nb = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    wall_ring = wet & ~nb
    return wet, z_floor, wall_ring


def _on(alpha, a, dtype=None):
    """A numpy array as a tensor on alpha's device."""
    return torch.as_tensor(np.asarray(a), device=alpha.device).to(
        dtype or alpha.dtype)


def liquid_height(alpha, geom: TankGeometry, z_floor=None):
    """η(x, y): column liquid surface elevation, on alpha's device."""
    hz = geom.spacing[2]
    if z_floor is None:
        _, z_floor, _ = column_masks(geom)
    return _on(alpha, z_floor) + alpha.sum(dim=-1) * hz


def surface_stats(alpha, geom: TankGeometry, wet=None, z_floor=None):
    """(max_z, min_z, mean_z, n_points) over wetted columns — the
    interface_summary.csv row, as 0-d tensors."""
    if wet is None:
        wet, z_floor, _ = column_masks(geom)
    eta = liquid_height(alpha, geom, z_floor)
    wet = _on(alpha, wet, torch.bool)
    n = torch.clamp(wet.sum(), min=1)
    big = torch.tensor(1e30, dtype=eta.dtype, device=eta.device)
    zmax = torch.where(wet, eta, -big).max()
    zmin = torch.where(wet, eta, big).min()
    zmean = torch.where(wet, eta, 0.0).sum() / n
    return zmax, zmin, zmean, n


def wall_elevation_bins(alpha, geom: TankGeometry, n_bins: int = N_THETA_BINS):
    """Mean surface elevation per θ-bin over the wall ring.

    Returns (theta_centers, zeta, valid) with θ bins spanning [−π, π).
    `valid` marks bins containing wall columns."""
    wet, z_floor, ring = column_masks(geom)
    eta = liquid_height(alpha, geom, z_floor)
    x, y, _ = geom.cell_centers()
    theta = np.arctan2(y[None, :], x[:, None])
    edges = np.linspace(-np.pi, np.pi, n_bins + 1)
    which = np.clip(np.digitize(theta, edges) - 1, 0, n_bins - 1)

    onehot = _on(alpha, (which[:, :, None] == np.arange(n_bins)[None, None, :])
                 & ring[:, :, None], torch.bool)
    counts = onehot.sum(dim=(0, 1))
    sums = torch.where(onehot, eta[:, :, None], 0.0).sum(dim=(0, 1))
    zeta = sums / torch.clamp(counts, min=1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, zeta, counts > 0


def surface_mesh(alpha, geom: TankGeometry):
    """Triangulated free-surface mesh (host-side, for VTP export).

    Points at wetted column centers lifted to η; triangles over each 2×2
    block of wetted columns."""
    wet, z_floor, _ = column_masks(geom)
    eta = liquid_height(alpha, geom, z_floor).cpu().numpy()
    x, y, _ = geom.cell_centers()
    nx, ny = wet.shape

    idx = -np.ones((nx, ny), np.int64)
    ii, jj = np.nonzero(wet)
    idx[ii, jj] = np.arange(len(ii))
    points = np.stack([x[ii], y[jj], eta[ii, jj]], axis=-1)

    quad = wet[:-1, :-1] & wet[1:, :-1] & wet[:-1, 1:] & wet[1:, 1:]
    qi, qj = np.nonzero(quad)
    a = idx[qi, qj]
    b = idx[qi + 1, qj]
    c = idx[qi + 1, qj + 1]
    d = idx[qi, qj + 1]
    tris = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0
    )
    return points, tris


def extract_interface(case_dir: str, geom: TankGeometry, snapshots,
                      write_vtp_files: bool = True, mode: str = "auto",
                      device="cuda") -> str:
    """Reference-parity extraction over (time, alpha) snapshots.

    `snapshots` yields (t, alpha ndarray); each alpha is uploaded to
    `device`. Writes the three artifacts into
    case_dir/postProcessing/interface/ with the reference's schemas.

    `mode`: 'column' = fast column-height surface (exact for non-breaking
    waves); 'mc' = true α=0.5 marching-cubes iso-surface (valid for
    overturning waves); 'auto' = column heights, falling back to marching
    cubes per snapshot whenever any fluid column is non-monotone."""
    dev = resolve_device(device)
    out_dir = os.path.join(case_dir, "postProcessing", "interface")
    os.makedirs(out_dir, exist_ok=True)

    wet, z_floor, ring = column_masks(geom)
    active_cubes = iso._cube_active_mask(geom.fluid)
    summary = ["time,max_z,min_z,mean_z,num_points"]
    wall = ["time,theta,zeta_wall"]

    for t, alpha_np in snapshots:
        alpha_np = np.asarray(alpha_np)
        alpha = torch.as_tensor(alpha_np, device=dev)
        use_mc = mode == "mc" or (
            mode == "auto"
            and not iso.columns_monotone(alpha_np, geom.fluid)
        )
        if use_mc:
            zmax, zmin, zmean, n = iso.surface_stats_mc(
                alpha, geom, active_cubes
            )
        else:
            zmax, zmin, zmean, n = surface_stats(alpha, geom, wet, z_floor)
        summary.append(
            f"{t},{float(zmax)},{float(zmin)},{float(zmean)},{int(n)}"
        )
        # Wall runup profile stays column-based in both modes: the wall
        # ring is the structured analog of the r > 0.98 R point filter and
        # a single-valued ζ(θ) is what wall_elevation.csv's schema means.
        centers, zeta, valid = wall_elevation_bins(alpha, geom)
        zeta = zeta.cpu().numpy()
        valid = valid.cpu().numpy()
        for b in range(len(centers)):
            if valid[b]:
                wall.append(f"{t},{centers[b]},{zeta[b]}")
        if write_vtp_files:
            if use_mc:
                pts, tris = iso.triangulate(alpha_np, geom, active_cubes)
            else:
                pts, tris = surface_mesh(alpha, geom)
            write_vtp(
                os.path.join(out_dir, f"interface_t{t:.6f}.vtp"), pts, tris
            )

    with open(os.path.join(out_dir, "interface_summary.csv"), "w") as f:
        f.write("\n".join(summary))
    with open(os.path.join(out_dir, "wall_elevation.csv"), "w") as f:
        f.write("\n".join(wall))
    return out_dir
