"""Case I/O: checkpoints, VTP export, 6DoF motion-table writer.

Port of openfoam_tpp_tpu/utils/io.py. Each snapshot is one
``chk_t{t:.6f}.npz`` of the SimState fields, written through a temporary
file and an atomic rename; resume picks the latest by encoded time. File
names, keys and value types are the JAX package's, so a checkpoint
written by either package loads in the other.

6DoF.dat is the OpenFOAM `List<Tuple3<scalar,vector,vector>>` text
    N
    (
    (t (x y z) (rx ry rz))
    ...
    )
that `setup_case` writes for every case and `read_6dof_table` reads
back; `generate_sine_motion_table` writes the reference gen6DoF table of
the closed 6DoF tank (`setup_case_6dof`).
"""

from __future__ import annotations

import os
import re

import numpy as np

from openfoam_tpp_tpu_torch.core.state import state_from_numpy, state_to_numpy

CHECKPOINT_RE = re.compile(r"chk_t([0-9.e+-]+)\.npz$")


# ---------------------------------------------------------------- checkpoints

def save_checkpoint(case_dir: str, state, extra: dict | None = None) -> str:
    """Write a SimState snapshot keyed by simulated time."""
    payload = state_to_numpy(state)
    t = float(payload["t"])
    path = os.path.join(case_dir, f"chk_t{t:.6f}.npz")
    payload.update(t=t, dt=float(payload["dt"]), step=int(payload["step"]))
    for k, val in (extra or {}).items():
        payload[f"extra_{k}"] = val
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)
    return path


def list_checkpoints(case_dir: str) -> list[tuple[float, str]]:
    """Sorted (time, path) checkpoint list."""
    out = []
    if not os.path.isdir(case_dir):
        return out
    for name in os.listdir(case_dir):
        m = CHECKPOINT_RE.match(name)
        if m:
            out.append((float(m.group(1)), os.path.join(case_dir, name)))
    return sorted(out)


def latest_checkpoint(case_dir: str):
    chks = list_checkpoints(case_dir)
    return chks[-1] if chks else None


def load_checkpoint(path: str):
    """Returns a dict of arrays (convert to SimState with `to_state`)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def to_state(payload: dict, device="cuda"):
    """SimState on `device` from a `load_checkpoint` payload."""
    return state_from_numpy(payload, device=device)


# ------------------------------------------------------------------ VTP files

def write_vtp(path: str, points: np.ndarray, triangles: np.ndarray,
              point_data: dict | None = None):
    """Minimal VTK XML PolyData (ASCII) writer."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles, np.int64).reshape(-1, 3)
    n_pts, n_tri = len(points), len(triangles)

    def arr_to_text(a, per_line=9):
        flat = np.asarray(a).reshape(-1)
        return "\n".join(
            " ".join(repr(x) if isinstance(x, float) else str(x)
                     for x in flat[i : i + per_line])
            for i in range(0, len(flat), per_line)
        )

    pd_blocks = []
    for name, data in (point_data or {}).items():
        pd_blocks.append(
            f'<DataArray type="Float32" Name="{name}" format="ascii">\n'
            f"{arr_to_text(np.asarray(data, np.float32))}\n</DataArray>"
        )
    point_data_xml = (
        "<PointData>\n" + "\n".join(pd_blocks) + "\n</PointData>"
        if pd_blocks
        else "<PointData/>"
    )

    xml = f"""<?xml version="1.0"?>
<VTKFile type="PolyData" version="0.1" byte_order="LittleEndian">
  <PolyData>
    <Piece NumberOfPoints="{n_pts}" NumberOfVerts="0" NumberOfLines="0" NumberOfStrips="0" NumberOfPolys="{n_tri}">
      {point_data_xml}
      <Points>
        <DataArray type="Float32" NumberOfComponents="3" format="ascii">
{arr_to_text(points)}
        </DataArray>
      </Points>
      <Polys>
        <DataArray type="Int64" Name="connectivity" format="ascii">
{arr_to_text(triangles)}
        </DataArray>
        <DataArray type="Int64" Name="offsets" format="ascii">
{arr_to_text(np.arange(3, 3 * n_tri + 1, 3))}
        </DataArray>
      </Polys>
    </Piece>
  </PolyData>
</VTKFile>
"""
    with open(path, "w") as f:
        f.write(xml)


# --------------------------------------------------------------- 6DoF tables

_ROW_RE = re.compile(
    r"\(\s*([0-9.eE+-]+)\s*"
    r"\(\s*([0-9.eE+-]+)\s+([0-9.eE+-]+)\s+([0-9.eE+-]+)\s*\)\s*"
    r"\(\s*([0-9.eE+-]+)\s+([0-9.eE+-]+)\s+([0-9.eE+-]+)\s*\)\s*\)"
)


def read_6dof_table(path: str):
    """Parse an OpenFOAM 6DoF table. Returns (times, trans(n,3), rot(n,3)),
    float64, rotations in degrees as written."""
    with open(path) as f:
        rows = _ROW_RE.findall(f.read())
    if not rows:
        raise ValueError(f"no motion rows found in {path}")
    data = np.asarray(rows, np.float64)
    return data[:, 0], data[:, 1:4], data[:, 4:7]


def write_6dof_table(path: str, times, trans, rot):
    """Write the `List<Tuple3>` format exactly as generate_motion.py does
    (count, parenthesized rows, %.6g floats)."""
    times = np.asarray(times)
    trans = np.asarray(trans)
    rot = np.asarray(rot)
    g = lambda x: f"{x:.6g}"
    with open(path, "w") as f:
        f.write(f"{len(times)}\n(\n")
        for t, xyz, r in zip(times, trans, rot):
            f.write(
                f"({g(t)} ({g(xyz[0])} {g(xyz[1])} {g(xyz[2])}) "
                f"({g(r[0])} {g(r[1])} {g(r[2])}))\n"
            )
        f.write(")\n")


def generate_sine_motion_table(
    path: str,
    n: int = 100,
    duration: float = 40.0,
    trans_amp=(2.0, 3.0, 2.0),
    trans_omega=(0.5, 0.8, 0.4),
    rot_amp_deg=(30.0, 10.0, 10.0),
    rot_omega=(0.4, 0.7, 0.5),
):
    """The reference gen6DoF table: sinusoidal translation and rotation,
    `n` samples over `duration` s (the math of native/gen6dof.cpp's
    `sine` mode)."""
    t = np.arange(n) * (duration / (n - 1))
    trans = np.stack(
        [a * np.sin(w * t) for a, w in zip(trans_amp, trans_omega)], -1
    )
    rot = np.stack(
        [a * np.sin(w * t) for a, w in zip(rot_amp_deg, rot_omega)], -1
    )
    write_6dof_table(path, t, trans, rot)
    return path


def generate_orbital_motion_table(
    path: str, r_max: float, freq: float, duration: float, dt: float,
    ramp_duration: float,
):
    """The reference manager's motion table: circular orbit with a
    smootherstep-ramped radius, zero rotation."""
    n = int(duration / dt) + 1
    t = np.arange(n) * dt
    tau = np.clip(np.divide(t, ramp_duration, out=np.full_like(t, np.inf),
                            where=ramp_duration > 0), 0.0, 1.0)
    s = tau * tau * tau * (tau * (tau * 6 - 15) + 10)
    r = r_max * np.where(t < ramp_duration, s, 1.0)
    th = 2 * np.pi * freq * t
    trans = np.stack([r * np.cos(th), r * np.sin(th), np.zeros_like(t)], -1)
    write_6dof_table(path, t, trans, np.zeros_like(trans))
    return path
