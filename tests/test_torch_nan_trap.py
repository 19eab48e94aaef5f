"""OFTPP_DEBUG_NANS=1 in the port (utils/nan_trap.py) against the JAX
package's jax_debug_nans, on the CPU.

The recipe: the tiny verification case (8×8×10) run to t = 0.05 by the
port, one interior `u` value of its checkpoint set to NaN, resumed in a
case of duration 0.1. With the variable set both packages raise
FloatingPointError and write nothing after the NaN; unset, both resume,
take one step and write `chk_tnan.npz`, whose fields agree with NaN taken
as equal (the one step from the same state: the tiny case's bounds of
tests/test_torch_case.py). A clean run with the trap on is bitwise equal
to the run without it (the trap only looks at outputs); with the variable
unset no dispatch mode is entered and the kernel hook is never set.

`jax_debug_nans`, once set by the JAX runner, holds for the process: the
`jax_nans` fixture restores it, since later tests of the same worker
would otherwise run with it.
"""

import os
import unittest.mock as mock

import jax
import numpy as np
import pytest

from openfoam_tpp_tpu.manager import runner as jrunner
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.manager.cases import setup_case
from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.utils import nan_trap
from openfoam_tpp_tpu_torch.utils.io import list_checkpoints, load_checkpoint

TINY = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", R=0.002, freq=3.0,
            dt=0.0005, ramp=-1)
FIELDS = ("alpha", "u", "v", "w", "p")
# The tiny case's bounds (tests/test_torch_case.py): alpha 6.5e-5,
# velocities 3.8e-5 and p 5.7e-6 of scale, measured over 31 steps, each
# held to ten times that.
TOLS = {"alpha": 6.5e-4, "u": 3.8e-4, "v": 3.8e-4, "w": 3.8e-4, "p": 5.7e-5}


@pytest.fixture(scope="module")
def half_way(tmp_path_factory):
    """The tiny case's t = 0.05 checkpoint, run by the port."""
    base = tmp_path_factory.mktemp("half")
    case = setup_case({**TINY, "duration": 0.05}, str(base))
    trunner.run_case(case, device="cpu", log=lambda *a: None)
    return load_checkpoint(os.path.join(case, "chk_t0.050000.npz"))


@pytest.fixture
def jax_nans():
    yield
    jax.config.update("jax_debug_nans", False)


def _resume_case(base, payload):
    case = setup_case({**TINY, "duration": 0.1}, str(base))
    np.savez(os.path.join(case, "chk_t0.050000.npz"), **payload)
    return case


def _with_nan(payload):
    bad = {k: np.array(v) for k, v in payload.items()}
    bad["u"][4, 4, 2] = np.nan
    return bad


def _rows(case, name):
    path = os.path.join(case, "postProcessing", "probes", "0", name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("#")]


def test_nan_checkpoint_raises_in_both_packages(half_way, tmp_path,
                                                monkeypatch, jax_nans):
    bad = _with_nan(half_way)
    monkeypatch.setenv("OFTPP_DEBUG_NANS", "1")
    jcase = _resume_case(tmp_path / "jax", bad)
    with pytest.raises(FloatingPointError, match="invalid value"):
        jrunner.run_case(jcase, log=lambda *a: None)
    tcase = _resume_case(tmp_path / "torch", bad)
    lines = []
    with pytest.raises(FloatingPointError,
                       match=r"invalid value \(nan\) encountered in aten\.\S+ "
                             r"at openfoam_tpp_tpu_torch/\S+\.py:\d+, step 1 "):
        trunner.run_case(tcase, device="cpu", log=lines.append)
    assert any("NaN trap on" in ln for ln in lines)
    for case in (jcase, tcase):
        assert [t for t, _ in list_checkpoints(case)] == [0.05]
        assert _rows(case, "p") == [] and _rows(case, "eta") == []
    assert _build.nan_hook is None and nan_trap.current() is None


def test_nan_checkpoint_unset_writes_alike(half_way, tmp_path, monkeypatch):
    bad = _with_nan(half_way)
    monkeypatch.delenv("OFTPP_DEBUG_NANS", raising=False)
    jcase = _resume_case(tmp_path / "jax", bad)
    jrunner.run_case(jcase, log=lambda *a: None)
    tcase = _resume_case(tmp_path / "torch", bad)
    with mock.patch.object(nan_trap, "NanTrap",
                           side_effect=AssertionError("trap entered")):
        trunner.run_case(tcase, device="cpu", log=lambda *a: None)
    got = {}
    for case in (jcase, tcase):
        assert os.path.exists(os.path.join(case, "chk_tnan.npz"))
        got[case] = load_checkpoint(os.path.join(case, "chk_tnan.npz"))
    j, t = got[jcase], got[tcase]
    assert int(j["step"]) == int(t["step"])
    for f in FIELDS:
        nan_j, nan_t = np.isnan(j[f]), np.isnan(t[f])
        assert np.array_equal(nan_j, nan_t), f
        fin = ~nan_j
        if fin.any():
            scale = max(float(np.abs(j[f][fin]).max()), 1e-30)
            err = float(np.abs(j[f][fin] - t[f][fin]).max())
            assert err <= TOLS[f] * scale, (f, err, scale)


def test_clean_run_is_bitwise_with_the_trap_on(half_way, tmp_path,
                                               monkeypatch):
    cases = {}
    for label, env in (("off", None), ("on", "1")):
        if env is None:
            monkeypatch.delenv("OFTPP_DEBUG_NANS", raising=False)
        else:
            monkeypatch.setenv("OFTPP_DEBUG_NANS", env)
        cases[label] = _resume_case(tmp_path / label, half_way)
        trunner.run_case(cases[label], device="cpu", log=lambda *a: None)
    off, on = (load_checkpoint(list_checkpoints(cases[k])[-1][1])
               for k in ("off", "on"))
    assert float(on["t"]) == float(np.float32(0.1))
    for f in (*FIELDS, "t", "dt", "step"):
        assert np.array_equal(on[f], off[f]), f
    assert _rows(cases["on"], "p") == _rows(cases["off"], "p")


def test_unset_enters_no_mode_and_sets_no_hook(monkeypatch):
    monkeypatch.delenv("OFTPP_DEBUG_NANS", raising=False)
    with mock.patch.object(nan_trap, "NanTrap",
                           side_effect=AssertionError("trap entered")):
        with nan_trap.trap_nans() as trap:
            assert trap is None and _build.nan_hook is None
    monkeypatch.setenv("OFTPP_DEBUG_NANS", "0")
    with nan_trap.trap_nans() as trap:
        assert trap is None and nan_trap.current() is None
    monkeypatch.setenv("OFTPP_DEBUG_NANS", "1")
    with nan_trap.trap_nans() as trap:
        assert nan_trap.current() is trap
        assert _build.nan_hook == trap.check_kernel
    assert _build.nan_hook is None and nan_trap.current() is None


def test_trap_skips_moves_and_views_and_names_the_op():
    import torch

    t = torch.tensor([1.0, float("nan"), 3.0])
    with nan_trap.trap_nans(True) as trap:
        moved = t.clone().to(torch.float64)[1:].view(2).detach()
        torch.empty(4)
        moved.copy_(moved)
        with pytest.raises(FloatingPointError,
                           match=r"aten\.mul\.Tensor at tests/"
                                 r"test_torch_nan_trap\.py:\d+, step 0 "):
            moved * 2.0
    assert trap.checked >= 1


def test_build_check_hands_launch_outputs_to_the_hook(monkeypatch):
    """`_build.check` (every kernel entry point calls it after its launch)
    passes the launch's outputs to the hook while one is set; the trap's
    hook raises on a NaN among them, naming the kernel and the caller."""
    import torch

    a, b = torch.zeros(2), torch.tensor([0.0, float("nan")])
    seen = []
    monkeypatch.setattr(_build, "nan_hook",
                        lambda what, outs: seen.append((what, outs)))
    _build.check(0, "mules_flux", a, b)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _build.check(700, "mules_flux", a)
    assert seen == [("mules_flux", (a, b))]
    monkeypatch.setattr(_build, "nan_hook", None)
    _build.check(0, "mules_flux", b)
    trap = nan_trap.NanTrap()
    trap.step = 7
    trap.check_kernel("mules_flux", (a, None))
    with pytest.raises(FloatingPointError,
                       match=r"CUDA kernel mules_flux \(mules_flux\) at "
                             r"tests/test_torch_nan_trap\.py:\d+, step 7 "):
        trap.check_kernel("mules_flux", (a, b))
    assert trap.checked == 3
