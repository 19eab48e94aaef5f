"""Package rules of the PyTorch port: it imports no JAX and nothing of the
JAX package, its entry points run on the card unless the caller asks for
the CPU, and its kernel gates take the JAX step's branches."""

import os
import subprocess
import sys
import unittest.mock as mock

import pytest
import torch

from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu.solver import timestep as jtimestep
from openfoam_tpp_tpu_torch.config import SolverControls
from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
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


def _run_default_steps(geom, n):
    step = timestep.make_step(geom, controls=SolverControls(use_pallas=True),
                              device="cpu")
    state = init_state(geom, device="cpu")
    params = CaseParams.make(0.004, 1.88, 0.5, device="cpu")
    for _ in range(n):
        state, diag = step(state, params)
    return state, diag


def test_out_of_slice_arguments_raise():
    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
    # The default kernel configuration is in the slice: it builds and runs.
    state, diag = _run_default_steps(geom, 1)
    assert int(state.step) == 1 and bool(torch.isfinite(state.w).all())
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


GATE_VARS = ("OFTPP_MOM_PALLAS", "OFTPP_FINISH_PALLAS", "OFTPP_CORR_PALLAS",
             "OFTPP_FCT_BF16")
GATES = ("_mom_pallas_enabled", "_finish_pallas_enabled",
         "_corr_pallas_enabled", "_fct_bf16_enabled")
CONTROLS = ({}, {"use_pallas": True}, {"use_pallas": True, "mom_pallas": False},
            {"use_pallas": True, "mom_pallas": True},
            {"use_pallas": False, "mom_pallas": True}, {"fct_bf16": False})


@pytest.mark.parametrize("value", [None, "0", "1"])
@pytest.mark.parametrize("var", GATE_VARS)
def test_gates_take_the_jax_branches(var, value, monkeypatch):
    for v in GATE_VARS:
        monkeypatch.delenv(v, raising=False)
    if value is not None:
        monkeypatch.setenv(var, value)
    for kw in CONTROLS:
        for gate in GATES:
            got = getattr(timestep, gate)(SolverControls(**kw))
            want = getattr(jtimestep, gate)(JControls(**kw))
            assert got == want, (gate, kw)


@pytest.mark.parametrize("var", GATE_VARS[:3])
def test_forced_kernel_on_unsealed_x_raises(var, monkeypatch):
    monkeypatch.setenv(var, "1")
    with pytest.raises(ValueError, match="not sealed"):
        jtimestep.make_step_core(sealed_x=False)
    with pytest.raises(ValueError, match="not sealed"):
        timestep.make_step_core(sealed_x=False)
    monkeypatch.setenv(var, "0")   # unforced: the unsealed step builds
    timestep.make_step_core(sealed_x=False)


@pytest.mark.parametrize("round_to", [4, 1])
def test_default_step_calls_the_fused_kernels_once_per_step(round_to):
    """Through their module attributes (which chip_smoke.py swaps for the
    plain versions), with the contiguous operands the kernels take. The
    gates alone decide: on the 14×14×10 grid (round_to=1) the JAX
    kernels' TPU slab check sends the JAX step to its jnp path, and the
    port still runs its kernels, which take any grid."""
    calls = {"momentum_rhs": 0, "correct_divmax": 0}

    def spy(module, name):
        fn = getattr(module, name)

        def run(*a, **k):
            flat = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
            assert all(t.is_contiguous() for t in flat
                       if isinstance(t, torch.Tensor))
            calls[name] += 1
            return fn(*a, **k)

        return mock.patch.object(module, name, run)

    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=round_to)
    assert jmrk.supported(geom.shape) == (round_to == 4)
    with spy(tmrk, "momentum_rhs"), spy(tck, "correct_divmax"):
        _run_default_steps(geom, 2)
    assert calls == {"momentum_rhs": 2, "correct_divmax": 2}
