"""Video rendering of the free surface (host-side).

The port's own copy of openfoam_tpp_tpu/post/video.py (it imports
nothing of that package), reading the port's checkpoints through its
`runner.iterate_snapshots` and triangulating with its
`post/isosurface.triangulate` (numpy): each frame renders the true
α=0.5 iso-surface as a 3-D triangulated surface with the tank outline and
floor (the reference's generate_video scene, main.py:612-725, without
its pyvista dependency), encoded as MP4, else MJPEG AVI, else PNG frames
(post/avi.py). For orbital cylinder cases the potential-flow dashboard
animation follows (utils/potential_flow.py). Everything here runs on the
host: the case's fields are read from its checkpoint files.
"""

from __future__ import annotations

import os

import numpy as np


def _have(mod: str) -> bool:
    try:
        __import__(mod)
        return True
    except ImportError:
        return False


def _tank_outline(geom, params):
    """Wireframe segments for the tank: wall circles/edges + floor.

    Returns (lines, floor_polys): lists of (N, 3) polylines and floor
    polygons, matching the reference's tank outline + floor actors
    (the reference's main.py:676-698)."""
    lines = []
    floors = []
    if geom.geo in ("flat", "cap"):
        R = geom.D / 2.0
        th = np.linspace(0.0, 2 * np.pi, 65)
        cx, cy = np.cos(th) * R, np.sin(th) * R
        for z in (0.0, geom.H):
            lines.append(np.stack([cx, cy, np.full_like(cx, z)], axis=-1))
        for ang in np.linspace(0, 2 * np.pi, 9)[:-1]:
            x, y = R * np.cos(ang), R * np.sin(ang)
            lines.append(np.array([[x, y, 0.0], [x, y, geom.H]]))
        floors.append(np.stack([cx, cy, np.zeros_like(cx)], axis=-1))
    else:  # box tank
        x0, y0, z0 = geom.origin
        x1 = x0 + geom.shape[0] * geom.spacing[0]
        y1 = y0 + geom.shape[1] * geom.spacing[1]
        z1 = z0 + geom.shape[2] * geom.spacing[2]
        corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
        for z in (z0, z1):
            ring = np.array([(cx, cy, z) for cx, cy in corners + corners[:1]])
            lines.append(ring)
        for cx, cy in corners:
            lines.append(np.array([[cx, cy, z0], [cx, cy, z1]]))
        floors.append(np.array([(cx, cy, z0) for cx, cy in corners]))
    return lines, floors


def generate_video(case_dir: str, fps: int = 30, fname: str = "animation.mp4") -> bool:
    if not _have("matplotlib"):
        print("  ❌ matplotlib not available — cannot render video")
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mpl_toolkits.mplot3d.art3d import Line3DCollection, Poly3DCollection

    from openfoam_tpp_tpu_torch.manager.cases import load_case_params
    from openfoam_tpp_tpu_torch.manager.runner import (
        _case_shape_hint,
        build_case_geometry,
        iterate_snapshots,
    )
    from openfoam_tpp_tpu_torch.post import isosurface as iso

    params = load_case_params(case_dir)
    geom = build_case_geometry(params, _case_shape_hint(case_dir))
    active_cubes = iso._cube_active_mask(geom.fluid)
    outline, floors = _tank_outline(geom, params)

    out_dir = os.path.join(case_dir, "postProcessing", "video")
    os.makedirs(out_dir, exist_ok=True)

    frames = []
    snaps = list(iterate_snapshots(case_dir))
    if not snaps:
        print("  ❌ No checkpoints to render — run the case first")
        return False
    print(f"  🎬 Rendering {len(snaps)} frames (marching-cubes surface)...")

    # Frame the waterline band (works for both model families: cylinder
    # tanks fill to H/2, the 6DoF box to z=0 mid-tank).
    z_lo, z_hi = geom.origin[2], geom.H
    z_fill = params["H"] / 2.0 if "H" in params else 0.0
    zmin = z_fill - 0.25 * (z_hi - z_lo)
    zmax = z_fill + 0.25 * (z_hi - z_lo)
    cmap = plt.get_cmap("viridis")
    for t, alpha in snaps:
        pts, tris = iso.triangulate(np.asarray(alpha), geom, active_cubes)
        fig = plt.figure(figsize=(6, 5), dpi=110)
        ax = fig.add_subplot(111, projection="3d")
        if len(tris):
            polys = pts[tris]                      # (M, 3, 3)
            zc = polys[:, :, 2].mean(axis=1)
            colors = cmap(np.clip((zc - zmin) / max(zmax - zmin, 1e-9),
                                  0.0, 1.0))
            ax.add_collection3d(
                Poly3DCollection(polys, facecolors=colors, edgecolor="none"),
                autolim=False,
            )
        # Tank outline + floor (main.py:676-698 scene parity).
        ax.add_collection3d(
            Line3DCollection(outline, colors="0.45", linewidths=0.7),
            autolim=False,
        )
        ax.add_collection3d(
            Poly3DCollection(floors, facecolors=(0.7, 0.7, 0.7, 0.3),
                             edgecolor="none"),
            autolim=False,
        )
        half = max(geom.D / 2.0,
                   geom.shape[0] * geom.spacing[0] / 2.0)
        ax.set_xlim(-half, half)
        ax.set_ylim(-half, half)
        ax.set_zlim(zmin, zmax)
        ax.set_box_aspect((1, 1, 0.6))
        ax.set_title(f"t = {t:.2f} s")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frames.append(buf.copy())
        plt.close(fig)

    out_path = os.path.join(out_dir, fname)
    try:
        from openfoam_tpp_tpu_torch.post.avi import save_video

        out_path = save_video(out_path, frames, fps=fps)
        print(f"  ✅ Video saved: {out_path}")
    except Exception as e:  # even Pillow missing — fall back to PNGs
        print(f"  ⚠ video encode failed ({e}); writing PNG frames")
        import matplotlib.pyplot as plt

        for i, fr in enumerate(frames):
            plt.imsave(os.path.join(out_dir, f"frame_{i:04d}.png"), fr)
        print(f"  ✅ Frames saved under: {out_dir}")

    # Reference parity: the video action chains a potential-flow dashboard
    # animation for orbital cylinder cases (main.py:700-723).
    if "H" in params and "R" in params:
        try:
            from openfoam_tpp_tpu_torch.utils.potential_flow import (
                generate_dashboard_animation,
            )

            dash, _ = generate_dashboard_animation(
                os.path.join(out_dir, "dashboard.mp4"),
                R=params["D"] / 2.0, a=params["R"], freq=params["freq"],
                d=params["H"] / 2.0,
            )
            print(f"  ✅ Dashboard animation: {dash}")
        except Exception as e:
            print(f"  ⚠ dashboard animation failed: {e}")
    return True
