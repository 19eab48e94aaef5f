"""The port's slice end to end: 3 steps of `make_step` from the same state
against the JAX step, on the CPU, on the 16×16×10 flat tank.

(a) JAX `use_pallas=False` vs the port with `fct_bf16=False` (the f32 FCT
    jnp path on both sides);
(b) JAX `use_pallas=True, mom_pallas=False` (MULES kernels in interpret
    mode; the 7-point `_v` wrappers interpret by themselves off-TPU) vs
    the port in the same configuration, whose kernel entry points run
    their plain versions on CPU tensors;
(c) `SolverControls(use_pallas=True)` on both sides, the default kernel
    configuration: the fused momentum RHS and the projection epilogue
    too (JAX `momentum_rhs` and `correct_divmax` in interpret mode);
(d) (c) with OFTPP_FINISH_PALLAS=1, which adds the momentum finish.

Tolerances: alpha to 1e-5 (bounded advection, f32); velocities to 1e-3
of their largest magnitude and p to 1e-4 of its scale, because each step
ends in a CG solve stopped at a relative residual of 1e-3 whose bf16
preconditioner rounds at other places in PyTorch and XLA; p_iters within
±1 per step."""

import collections
import unittest.mock as mock

import jax
import numpy as np
import pytest

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.ops.pallas import correction as jck
from openfoam_tpp_tpu.ops.pallas import mom_finish as jfk
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu.ops.pallas import mules_fct as jmf
from openfoam_tpp_tpu.ops.pallas import mules_flux as jmfx
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.solver.timestep import make_step as tmake

TANK = dict(H=0.04, D=0.048, mesh=0.004, geo="flat", round_to=4)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
N_STEPS = 3


FUSED = ("momentum_rhs", "correct_divmax", "momentum_finish")
EXPECT_FUSED = {"a_plain": (), "b_kernels": (),
                "c_default": FUSED[:2], "d_finish": FUSED}


def _interpreted(module, name, calls):
    """Patch a JAX Pallas entry point to run in interpret mode, counting
    its calls (one per trace)."""
    fn = getattr(module, name)

    def run(*a, **k):
        calls[name] += 1
        return fn(*a, **{**k, "interpret": True})

    return mock.patch.object(module, name, run)


@pytest.mark.parametrize("path", ["a_plain", "b_kernels", "c_default",
                                  "d_finish"])
def test_three_steps_match_jax(path, monkeypatch):
    jg = jbuild(**TANK)
    js = jinit(jg)
    # A short ramp so the tank is already shaking in these 3 steps.
    jp = JParams.make(R=0.004, freq=1.88, duration=0.5)
    if path == "a_plain":
        jc, tc = JControls(), TControls(fct_bf16=False)
    elif path == "b_kernels":
        jc = JControls(use_pallas=True, mom_pallas=False)
        tc = TControls(use_pallas=True, mom_pallas=False)
    else:
        jc, tc = JControls(use_pallas=True), TControls(use_pallas=True)
    if path == "d_finish":
        monkeypatch.setenv("OFTPP_FINISH_PALLAS", "1")

    jcalls = collections.Counter()
    with _interpreted(jmf, "fct_iter", jcalls), \
            _interpreted(jmfx, "flux_all", jcalls), \
            _interpreted(jmrk, "momentum_rhs", jcalls), \
            _interpreted(jck, "correct_divmax", jcalls), \
            _interpreted(jfk, "momentum_finish", jcalls):
        jstep = jax.jit(jmake(jg, JProps(), jc))
        s, jdiags = js, []
        for _ in range(N_STEPS):
            s, d = jstep(s, jp)
            jdiags.append(d)
        jax.block_until_ready(s)
    ref = {k: np.asarray(getattr(s, k)) for k in FIELDS}

    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu")
    tp = params_from_numpy({k: np.asarray(getattr(jp, k))
                            for k in ("orbit_radius", "omega", "ramp_time")},
                           device="cpu")
    tstep = tmake(tbuild(**TANK), TProps(), tc, device="cpu")
    tdiags = []
    with mock.patch.object(tmrk, "momentum_rhs", wraps=tmrk.momentum_rhs) as m1, \
            mock.patch.object(tck, "correct_divmax",
                              wraps=tck.correct_divmax) as m2, \
            mock.patch.object(tfk, "momentum_finish",
                              wraps=tfk.momentum_finish) as m3:
        for _ in range(N_STEPS):
            ts, d = tstep(ts, tp)
            tdiags.append(d)
    got = state_to_numpy(ts)
    # Both packages took the same fused kernels (JAX: one call per trace).
    for name, spy in zip(FUSED, (m1, m2, m3)):
        on = name in EXPECT_FUSED[path]
        assert (jcalls[name] > 0) == on, name
        assert spy.call_count == (N_STEPS if on else 0), name

    assert float(np.abs(ref["w"]).max()) > 1e-3   # the fluid is moving
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=1e-6)
    assert np.abs(got["alpha"] - ref["alpha"]).max() <= 1e-5
    for k in ("u", "v", "w"):
        scale = np.abs(ref[k]).max()
        assert np.abs(got[k] - ref[k]).max() <= 1e-3 * scale, k
    assert np.abs(got["p"] - ref["p"]).max() <= 1e-4 * np.abs(ref["p"]).max()
    for dj, dt_ in zip(jdiags, tdiags):
        assert abs(int(dt_.p_iters) - int(dj.p_iters)) <= 1
        assert float(dt_.alpha_min) >= 0.0 and float(dt_.alpha_max) <= 1.0
        np.testing.assert_allclose(float(dt_.courant), float(dj.courant),
                                   rtol=1e-4, atol=1e-9)
