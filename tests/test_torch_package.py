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
from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.motion import TableMotion
from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import timestep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = """
import sys
sys.modules["jax"] = None
sys.modules["openfoam_tpp_tpu"] = None
import openfoam_tpp_tpu_torch
import openfoam_tpp_tpu_torch.solver.timestep
import openfoam_tpp_tpu_torch.solver.frame
import openfoam_tpp_tpu_torch.core.motion
import openfoam_tpp_tpu_torch.ops.kernels._build
import openfoam_tpp_tpu_torch.manager.cases
import openfoam_tpp_tpu_torch.manager.cli
import openfoam_tpp_tpu_torch.manager.runner
import openfoam_tpp_tpu_torch.manager.submit
import openfoam_tpp_tpu_torch.manager.sweeprun
import openfoam_tpp_tpu_torch.parallel.sweep
import openfoam_tpp_tpu_torch.parallel.spmd
import openfoam_tpp_tpu_torch.parallel.packed
import openfoam_tpp_tpu_torch.parallel.sharding
import openfoam_tpp_tpu_torch.parallel.ranks
import openfoam_tpp_tpu_torch.parallel.tiled_sweep
import openfoam_tpp_tpu_torch.ops.kernels.halo7
import openfoam_tpp_tpu_torch.post.interface
import openfoam_tpp_tpu_torch.post.isosurface
import openfoam_tpp_tpu_torch.post.probes
import openfoam_tpp_tpu_torch.post.avi
import openfoam_tpp_tpu_torch.post.video
import openfoam_tpp_tpu_torch.utils.bootstrap
import openfoam_tpp_tpu_torch.utils.io
import openfoam_tpp_tpu_torch.utils.nan_trap
import openfoam_tpp_tpu_torch.utils.naming
import openfoam_tpp_tpu_torch.utils.potential_flow
import openfoam_tpp_tpu_torch.utils.profiling
import openfoam_tpp_tpu_torch.utils.resources
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


def test_no_module_of_the_port_names_jax():
    """No source of the port, nor chip_smoke.py, nor what the rank
    processes of tests/test_torch_ranks.py import (parallel/ranks.py and
    tests/torch_rank_jobs.py), imports jax or the JAX package (the
    blocked-import run above loads them all without)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|openfoam_tpp_tpu)\b",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_rank_jobs.py")]
    for root, _, names in os.walk(os.path.join(REPO, "openfoam_tpp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 25
    assert os.path.join(REPO, "openfoam_tpp_tpu_torch", "parallel",
                        "ranks.py") in files
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad


def test_command_line_runs_without_jax(tmp_path):
    """`python -m openfoam_tpp_tpu_torch` with jax blocked: the host verbs
    `flow` and `video` run, `--devices 2 --device cpu` (refused until the
    device mesh was ported) runs a case over two x positions of the host,
    and the card is the default device (absent here, so `run` fails
    naming `--device cpu`'s counterpart)."""
    from openfoam_tpp_tpu_torch.manager.cases import setup_case

    case = setup_case(dict(H=0.04, D=0.02, mesh=0.004, R=0.002, freq=3.0,
                           duration=0.05, dt=0.0005), str(tmp_path))
    sharded = setup_case(dict(H=0.04, D=0.02, mesh=0.004, R=0.001, freq=3.0,
                              duration=0.05, dt=0.0005), str(tmp_path))
    boot = ("import sys, runpy; sys.modules['jax'] = None; "
            "sys.modules['openfoam_tpp_tpu'] = None; "
            "runpy.run_module('openfoam_tpp_tpu_torch', run_name='__main__')")

    def run(*args, case=case):
        return subprocess.run(
            [sys.executable, "-c", boot, "--headless", "--base-dir",
             str(tmp_path), "--case", os.path.basename(case), *args],
            cwd=REPO, capture_output=True, text=True, timeout=300)

    out = run("--action", "flow")
    assert out.returncode == 0, out.stderr
    assert os.path.exists(os.path.join(case, "postProcessing",
                                       "potential_flow",
                                       "potential_flow_wall.csv"))
    out = run("--action", "run", "--devices", "2", "--device", "cpu",
              case=sharded)
    assert out.returncode == 0, out.stderr
    assert "2-device sharded" in out.stdout and "Done: " in out.stdout
    assert os.path.exists(os.path.join(sharded, "chk_t0.050000.npz"))
    out = run("--action", "run")
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    out = run("--action", "run", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "Done: " in out.stdout and os.path.exists(
        os.path.join(case, "chk_t0.050000.npz"))
    out = run("--action", "interface", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert os.path.exists(os.path.join(case, "postProcessing", "interface",
                                       "interface_summary.csv"))
    out = run("--action", "video")
    assert out.returncode == 0, out.stderr
    assert "Video saved" in out.stdout and "Dashboard animation" in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
    for call in (lambda: init_state(geom),
                 lambda: CaseParams.make(0.004, 1.88, 1.0),
                 lambda: timestep.geometry_arrays(geom),
                 lambda: timestep.make_step(geom),
                 lambda: timestep.make_step(geom, spmd=SpmdCtx(4)),
                 lambda: timestep.make_step_ga(geom.spacing),
                 lambda: timestep.make_step_ga(geom.spacing,
                                               spmd=SpmdCtx(4))):
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
    # The sweep slice: `batch_lanes` builds (only MULES reads it).
    step = timestep.make_step(geom, device="cpu", controls=SolverControls(
        use_pallas=True, batch_lanes=True, mom_pallas=False))
    s1, _ = step(init_state(geom, device="cpu"),
                 CaseParams.make(0.004, 1.88, 0.5, device="cpu"))
    assert int(s1.step) == 1
    # A table motion is in the slice (tests/test_torch_6dof.py), and so is
    # a rotating one with spmd= (the sharded 6DoF tank: the JAX package
    # builds the pair too; tests/test_torch_ranks_6dof.py holds it): it
    # builds and steps.
    rotating = TableMotion.from_table([0.0, 1.0], [[0, 0, 0]] * 2,
                                      [[0, 0, 0], [0, 0, 10]], device="cpu")
    step = timestep.make_step(geom, motion=rotating, spmd=SpmdCtx(4),
                              controls=SolverControls(use_pallas=True),
                              device="cpu")
    s2, _ = step(init_state(geom, device="cpu"),
                 CaseParams.make(0.0, 0.0, 0.5, device="cpu"))
    assert int(s2.step) == 1 and bool(torch.isfinite(s2.u).all())
    # spmd= is in the slice (tests/test_torch_spmd.py); with a sweep's
    # batch_lanes it raises, as the JAX package shards no sweep through it.
    with pytest.raises(NotImplementedError, match="spmd"):
        timestep.make_step(geom, controls=SolverControls(batch_lanes=True),
                           spmd=SpmdCtx(4), device="cpu")
    # forcing= (the tiled sweep's hook) and surface tension are in the
    # slice (tests/test_torch_tiled_sweep.py, tests/test_torch_csf.py).
    timestep.make_step_core(forcing=lambda t, p: None)
    timestep.make_step_core(PhysicalProperties(sigma=0.072))


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


def test_rank3_calls_reach_the_rank3_kernels_only():
    """The rank dispatch of the 7-point entry points: a single-grid step
    never enters a batch-native entry point, and a batched pressure pass
    never stays in a single-grid one."""
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp

    calls = {}

    def spy(name):
        fn = getattr(tsp, name)

        def run(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        return mock.patch.object(tsp, name, run)

    geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
    with spy("apply_7pt_nb"), spy("resid_scaled_7pt_nb"), \
            spy("apply_dot_7pt_nb"), spy("apply_7pt_plain"), \
            spy("apply_dot_7pt_plain"):
        _run_default_steps(geom, 1)
        assert calls.get("apply_7pt_plain", 0) > 0
        assert calls.get("apply_dot_7pt_plain", 0) > 0
        assert not any(k.endswith("_nb") for k in calls)
        calls.clear()
        p = torch.zeros(4, 3, 5, 2)
        w = (p + 0.1, p + 0.1, p + 0.1)
        tsp.apply_7pt(p, w)
        tsp.resid_scaled_7pt(p, w, None, p)
        tsp.apply_dot_7pt(p, w)
    assert {k: v for k, v in calls.items() if k.endswith("_nb")} == {
        "apply_7pt_nb": 1, "resid_scaled_7pt_nb": 1, "apply_dot_7pt_nb": 1}


@pytest.mark.parametrize("tiled", [False, True])
def test_chip_smoke_counts_a_steps_7pt_calls(tiled):
    """chip_smoke.py's `vcycle_calls`, with which it checks that its spies
    on a step's operands saw every apply_7pt and resid_scaled_7pt call:
    per step (p_iters + 1) V-cycles of its count, and two more applies
    for the CG's true residual, on a single grid and on a tiled one
    (long in x, 2 cells wide at its coarsest level)."""
    from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp
    from openfoam_tpp_tpu_torch.parallel import tiled_sweep as tts
    from openfoam_tpp_tpu_torch.parallel.sweep import batch_params
    from openfoam_tpp_tpu_torch.solver.poisson import SolverKnobs

    sys.path.insert(0, REPO)
    import chip_smoke

    if tiled:
        geom = build_tank_geometry(H=0.1, D=0.02, mesh=0.004, round_to=8)
        n = 8
        core = tts.make_tiled_sweep_step(
            geom, n, controls=SolverControls(use_pallas=True), device="cpu")
        state = tts.tile_state(geom, n, device="cpu")
        params = batch_params([{"R": 0.002 + 2e-5 * i, "freq": 1.5,
                                "duration": 1.0} for i in range(n)],
                              device="cpu")
    else:
        geom = build_tank_geometry(H=0.04, D=0.048, mesh=0.004, round_to=4)
        core = timestep.make_step(
            geom, controls=SolverControls(use_pallas=True), device="cpu")
        state = init_state(geom, device="cpu")
        params = CaseParams.make(0.004, 1.88, 0.5, device="cpu")
    calls = {"apply_7pt": 0, "resid_scaled_7pt": 0}

    def spy(name):
        fn = getattr(tsp, name)

        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)

        return mock.patch.object(tsp, name, run)

    n_apply, n_resid = chip_smoke.vcycle_calls(tuple(state.alpha.shape),
                                               SolverKnobs())
    with spy("apply_7pt"), spy("resid_scaled_7pt"):
        for _ in range(3):
            calls.update(apply_7pt=0, resid_scaled_7pt=0)
            state, diag = core(state, params)
            vcycles = int(diag.p_iters) + 1
            assert calls == {"apply_7pt": vcycles * n_apply + 2,
                             "resid_scaled_7pt": vcycles * n_resid}
