"""Case lifecycle: build, completion checks, resume.

Port of the orbital-cylinder part of openfoam_tpp_tpu/manager/cases.py.
Geometry and motion are built in-process, so "building" a case writes its
metadata and the reference-format motion table; the solver state is made
on demand from the encoded parameters. The closed 6DoF tank
(`setup_case_6dof`) is not ported yet.
"""

from __future__ import annotations

import json
import os

from openfoam_tpp_tpu_torch.config import DEFAULTS
from openfoam_tpp_tpu_torch.utils import naming
from openfoam_tpp_tpu_torch.utils.io import (generate_orbital_motion_table,
                                             latest_checkpoint)


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


def load_case_params(case_dir: str) -> dict:
    """case.json if present, else decode the folder name (reference
    codec). A `tank6dof` case keeps its own keys: the run raises for it."""
    path = os.path.join(case_dir, "case.json")
    if os.path.exists(path):
        with open(path) as f:
            params = json.load(f)
        if params.get("model") == "tank6dof":
            return params
        return {**DEFAULTS, **params}
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
