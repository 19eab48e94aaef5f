"""Package rules of the PyTorch port: it imports no JAX and nothing of the
JAX package, and its entry points run on the card unless the caller asks
for the CPU."""

import os
import subprocess
import sys

import pytest
import torch

from openfoam_tpp_tpu_torch.config import SolverControls
from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
from openfoam_tpp_tpu_torch.solver import timestep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import sys
sys.modules["jax"] = None
sys.modules["openfoam_tpp_tpu"] = None
import openfoam_tpp_tpu_torch
import openfoam_tpp_tpu_torch.solver.timestep
import openfoam_tpp_tpu_torch.ops.kernels._build
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "openfoam_tpp_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
    for call in (lambda: init_state(geom),
                 lambda: CaseParams.make(0.004, 1.88, 1.0),
                 lambda: timestep.geometry_arrays(geom),
                 lambda: timestep.make_step(geom),
                 lambda: timestep.make_step_ga(geom.spacing)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    init_state(geom, device="cpu")   # asked for explicitly: runs


def test_out_of_slice_arguments_raise():
    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
    with pytest.raises(NotImplementedError, match="mom_pallas"):
        timestep.make_step(geom, controls=SolverControls(use_pallas=True),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="batch_lanes"):
        timestep.make_step(geom, controls=SolverControls(batch_lanes=True),
                           device="cpu")
    with pytest.raises(NotImplementedError, match="motion"):
        timestep.make_step(geom, motion=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="spmd"):
        timestep.make_step(geom, spmd=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="forcing"):
        timestep.make_step_core(forcing=lambda t, p: None)
    with pytest.raises(NotImplementedError, match="sync_axis"):
        timestep.make_step_core(sync_axis="case")
