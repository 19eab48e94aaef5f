"""Case lifecycle: build, completion checks, resume.

Port of openfoam_tpp_tpu/manager/cases.py. Geometry and motion are built
in-process, so "building" a case writes its metadata and the
reference-format motion table; the solver state is made on demand from
the encoded parameters. Two model families: the orbital cylinder
(`setup_case`) and the closed 6DoF tank (`setup_case_6dof`).
"""

from __future__ import annotations

import json
import os
import shutil

from openfoam_tpp_tpu_torch.config import DEFAULTS
from openfoam_tpp_tpu_torch.utils import naming
from openfoam_tpp_tpu_torch.utils.io import (generate_orbital_motion_table,
                                             generate_sine_motion_table,
                                             latest_checkpoint)

# Closed rectangular 6DoF tank defaults: the OpenFOAM tutorial
# `sloshingTank3D` block (20 m × 20 m × 40 m, waterline z=0). `chamfer` > 0
# builds the tutorial's true shape class, the prism with 45°-chamfered
# bottom and top edges (mesh/geometry.build_chamfer_tank_geometry), as a
# fraction of Lz; 0 keeps the plain box.
DEFAULTS_6DOF = {
    "model": "tank6dof",
    "Lx": 20.0,
    "Ly": 20.0,
    "Lz": 40.0,
    "mesh": 1.0,
    "chamfer": 0.0,
    "duration": 40.0,   # sloshingTank3D6DoF/system/controlDict endTime
    "dt": 0.01,         # controlDict deltaT
}


def setup_case(params: dict, base_dir: str = ".") -> str:
    """Create the case directory for a parameter set.

    Artifacts:
      * case.json            — authoritative parameter store
      * constant/6DoF.dat    — reference-format orbital motion table
      * postProcessing/      — output root
    The folder name itself is the reference's parameter codec.
    """
    params = {**DEFAULTS, **params}
    case_dir = os.path.join(base_dir, naming.get_case_name(params))
    os.makedirs(os.path.join(case_dir, "constant"), exist_ok=True)
    os.makedirs(os.path.join(case_dir, "postProcessing"), exist_ok=True)

    ramp = params["ramp"]
    ramp_t = params["duration"] * 0.1 if ramp < 0 else ramp
    generate_orbital_motion_table(
        os.path.join(case_dir, "constant", "6DoF.dat"),
        r_max=params["R"], freq=params["freq"],
        duration=params["duration"], dt=params["dt"], ramp_duration=ramp_t,
    )
    with open(os.path.join(case_dir, "case.json"), "w") as f:
        json.dump(params, f, indent=2, sort_keys=True)
    return case_dir


def setup_case_6dof(params: dict | None = None, base_dir: str = ".",
                    motion_table: str | None = None) -> str:
    """Create a closed-tank 6DoF case (sloshingTank3D6DoF parity): the
    JAX package's folder name, case.json, postProcessing/ and
    constant/6DoF.dat, the gen6DoF sine table unless `motion_table` names
    a 6DoF.dat to copy (e.g. from native/gen6dof)."""
    params = {**DEFAULTS_6DOF, **(params or {})}
    name = (
        f"case_6dof_L{params['Lx']:g}x{params['Ly']:g}x{params['Lz']:g}"
        f"_m{params['mesh']:g}_d{params['duration']:g}"
    )
    if float(params.get("chamfer", 0.0)) > 0.0:
        name += f"_c{params['chamfer']:g}"
    case_dir = os.path.join(base_dir, name)
    os.makedirs(os.path.join(case_dir, "constant"), exist_ok=True)
    os.makedirs(os.path.join(case_dir, "postProcessing"), exist_ok=True)
    table = os.path.join(case_dir, "constant", "6DoF.dat")
    if motion_table:
        shutil.copyfile(motion_table, table)
    else:
        generate_sine_motion_table(table, duration=params["duration"])
    with open(os.path.join(case_dir, "case.json"), "w") as f:
        json.dump(params, f, indent=2, sort_keys=True)
    return case_dir


def load_case_params(case_dir: str) -> dict:
    """case.json if present (over the defaults of its model), else decode
    the folder name (reference codec)."""
    path = os.path.join(case_dir, "case.json")
    if os.path.exists(path):
        with open(path) as f:
            params = json.load(f)
        base = DEFAULTS_6DOF if params.get("model") == "tank6dof" else DEFAULTS
        return {**base, **params}
    return naming.parse_case_params(os.path.basename(os.path.normpath(case_dir)))


def list_cases(base_dir: str = ".") -> list[str]:
    """All case_* directories under base_dir."""
    if not os.path.isdir(base_dir):
        return []
    return [d for d in sorted(os.listdir(base_dir))
            if d.startswith("case_") and os.path.isdir(os.path.join(base_dir, d))]


def case_progress(case_dir: str) -> float:
    """Latest checkpointed simulation time (0.0 if none)."""
    chk = latest_checkpoint(case_dir)
    return chk[0] if chk else 0.0


def is_case_done(case_dir: str, duration: float | None = None) -> bool:
    """Completion check against the case's own duration."""
    if duration is None:
        duration = load_case_params(case_dir)["duration"]
    return case_progress(case_dir) >= duration - 1e-6


def expand_sweep(sweep_params: dict[str, list], confirm_cartesian=None):
    """Combine per-parameter sweep lists into case parameter sets.

    Reference semantics: if every swept list has equal length > 1, zip
    them ("paired" mode); otherwise take the Cartesian product
    (optionally gated by `confirm_cartesian(n_rows)` returning bool).
    Returns (rows, mode) with mode 'zip', 'cartesian' or 'cancelled'.
    """
    import itertools

    keys = list(sweep_params)
    lists = [
        v if isinstance(v, (list, tuple)) else [v] for v in sweep_params.values()
    ]
    multi = [len(v) for v in lists if len(v) > 1]
    if multi and all(n == multi[0] for n in multi) and len(multi) > 1:
        # zip mode: broadcast singletons
        n = multi[0]
        rows = []
        for i in range(n):
            rows.append({
                k: (v[i] if len(v) > 1 else v[0])
                for k, v in zip(keys, lists)
            })
        return rows, "zip"
    combos = itertools.product(*lists)
    rows = [dict(zip(keys, c)) for c in combos]
    if len(rows) > 1 and confirm_cartesian is not None:
        if not confirm_cartesian(len(rows)):
            return [], "cancelled"
    return rows, "cartesian"
