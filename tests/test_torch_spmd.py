"""The x-sharded step (`make_step(..., spmd=SpmdCtx(n))`) on the CPU, on the
JAX spmd test's H0.06/D0.06/mesh 0.002 `round_to=32` tank (32×32×30).

(d) The sharded pressure solve (kernel islands on the scaled top level,
    plain coarse levels) against the unsharded plain solve, with the JAX
    test's bounds (tests/test_spmd_kernels.py:149-187): x to 2e-4 of its
    scale, iterations at most 3 more.
(e) The port's sharded step (4 shards, and 1 shard: edge halos only)
    against the JAX `spmd` step on one shard (`make_step(spmd=...)` on a
    one-device mesh, the halo kernels in interpret mode; its 4-shard form
    takes over 45 s to compile on the CPU, and the JAX package's own test
    holds the two together), 3 steps from the same state: p_iters within
    2 per step, every field within 2e-3 of its scale with a 2e-6 floor
    (the JAX test's bounds: the CG tolerance, and reduction-order noise
    on the early transient's near-zero velocities).
The default configuration reaches only the islands: no single-grid
kernel entry point runs, and the momentum finish and the fused cheb2
smoothers stay off on the sharded step.
"""

import collections
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sharding as jsh
from openfoam_tpp_tpu.parallel import spmd as jsm
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import halo7 as th7
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as tfct
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as tflux
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as t7
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import poisson as tpoisson
from openfoam_tpp_tpu_torch.solver import timestep as ttimestep

TANK = dict(H=0.06, D=0.06, mesh=0.002, geo="flat", round_to=32)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
N_STEPS = 3
PARAMS = dict(R=0.002, freq=3.0, duration=1.0)

# name -> (module, attribute): the single-grid kernel entry points, which
# the sharded step must not reach, and the halo entry points it must.
SINGLE = {n: (m, n) for m, ns in (
    (t7, ("apply_7pt", "resid_scaled_7pt", "apply_dot_7pt", "cheb2_pre_7pt",
          "cheb2_post_7pt", "cheb2_post_dot_7pt")),
    (tflux, ("flux_all",)), (tfct, ("fct_iter",)), (tmrk, ("momentum_rhs",)),
    (tck, ("correct_divmax",)), (tfk, ("momentum_finish",))) for n in ns}
HALO = {n: (m, n) for m, ns in (
    (th7, ("apply_7pt_h", "resid_scaled_7pt_h", "apply_dot_7pt_h")),
    (tflux, ("flux_all_h",)), (tfct, ("fct_iter_h",)),
    (tmrk, ("momentum_rhs_h",)), (tck, ("correct_divmax_h",))) for n in ns}


def _spies(names):
    """Count calls of the entry points through their module attributes."""
    calls = collections.Counter()
    patches = []
    for name, (mod, attr) in names.items():
        fn = getattr(mod, attr)

        def run(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        patches.append(mock.patch.object(mod, attr, run))
    return calls, patches


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX `spmd` step's states and diagnostics, 3 steps from rest:
    one shard on a one-device mesh (the halo kernels with edge halos, in
    interpret mode). tests/test_spmd_kernels.py holds the JAX 4-shard
    step to this one."""
    jg = jbuild(**TANK)
    ctx = jsm.SpmdCtx(mesh=jsh.make_mesh(1), axis="x", interpret=True)
    jc = JControls(use_pallas=True, p_max_iters=30)
    step = jax.jit(jmake(jg, JProps(), jc, spmd=ctx))
    s0 = jinit(jg, dt0=5e-4)
    jp = JParams.make(**PARAMS)
    s, iters = s0, []
    for _ in range(N_STEPS):
        s, d = step(s, jp)
        iters.append(int(d.p_iters))
    return ({k: np.asarray(getattr(s0, k)) for k in FIELDS},
            {k: np.asarray(getattr(jp, k))
             for k in ("orbit_radius", "omega", "ramp_time")},
            {k: np.asarray(getattr(s, k)) for k in FIELDS}, iters)


def _port_steps(init, params, n_shards, env=None, monkeypatch=None):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    step = ttimestep.make_step(tbuild(**TANK), TProps(),
                               TControls(use_pallas=True, p_max_iters=30),
                               spmd=SpmdCtx(n_shards), device="cpu")
    s = state_from_numpy(init, device="cpu")
    p = params_from_numpy(params, device="cpu")
    iters = []
    single, p1 = _spies(SINGLE)
    halo, p2 = _spies(HALO)
    for patch in p1 + p2:
        patch.start()
    try:
        for _ in range(N_STEPS):
            s, d = step(s, p)
            iters.append(int(d.p_iters))
    finally:
        for patch in p1 + p2:
            patch.stop()
    return state_to_numpy(s), iters, single, halo


@pytest.mark.parametrize("n_shards", [4, 1])
def test_sharded_step_matches_jax_sharded_step(jax_sharded, n_shards):
    init, params, ref, jiters = jax_sharded
    got, iters, single, halo = _port_steps(init, params, n_shards)
    # Only the islands ran: every halo entry point, no single-grid one.
    assert not single, dict(single)
    assert set(halo) == set(HALO), dict(halo)
    # One fct_iter_h per limiter iteration and shard (3 × 3 per step).
    assert halo["fct_iter_h"] == 9 * n_shards * N_STEPS
    assert halo["momentum_rhs_h"] == halo["correct_divmax_h"] == (
        n_shards * N_STEPS)

    assert float(np.abs(ref["w"]).max()) > 1e-4   # the fluid is moving
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    assert all(abs(a - b) <= 2 for a, b in zip(iters, jiters)), (iters, jiters)
    for k in ("alpha", "u", "v", "w", "p"):
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= max(2e-3 * scale, 2e-6), (k, err, scale)


def test_sharded_step_two_sweeps_takes_the_generic_smoother(
        jax_sharded, monkeypatch):
    """OFTPP_SMOOTH_SWEEPS=2 on a sharded step: the fused cheb2 kernels
    stay off (no halo form); the top level smooths with two resid islands
    per pass. OFTPP_FINISH_PALLAS=1 is ignored under spmd."""
    init, params, _, _ = jax_sharded
    got, iters, single, halo = _port_steps(
        init, params, 4, env={"OFTPP_SMOOTH_SWEEPS": "2",
                              "OFTPP_FINISH_PALLAS": "1"},
        monkeypatch=monkeypatch)
    assert not single, dict(single)
    # Two sweeps: the entry pass takes one resid, its residual one, the
    # exit pass two; 4 islands per V-cycle, one V-cycle per CG iteration
    # plus one, 4 shards each.
    vcycles = sum(iters) + N_STEPS
    assert halo["resid_scaled_7pt_h"] == 4 * 4 * vcycles
    assert all(i < 30 for i in iters)
    assert np.isfinite(got["p"]).all()


def test_sharded_solve_matches_unsharded():
    geom = tbuild(**TANK)
    ga = ttimestep.geometry_arrays(geom, device="cpu")
    spacing = tuple(float(s) for s in geom.spacing)
    fluid = ga["vfrac"] > 0.0
    nz = geom.shape[2]
    zc = (torch.arange(nz) + 0.5) / nz
    rho = torch.where(zc < 0.5, 998.2, 1.0).expand(geom.shape).contiguous()
    rng = np.random.default_rng(7)
    b = torch.where(fluid, torch.from_numpy(
        rng.standard_normal(geom.shape).astype(np.float32)), 0.0)

    prob = tpoisson.build_poisson(ga, spacing, rho, ga["top_open"])
    x_ref, _, it_ref = tpoisson.solve_pcg(prob, b, torch.zeros_like(b),
                                          tol_rel=1e-5, max_iters=60)
    prob_s = tpoisson.build_poisson(ga, spacing, rho, ga["top_open"],
                                    use_pallas=True, spmd=SpmdCtx(4))
    halo, patches = _spies(HALO)
    single, p2 = _spies(SINGLE)
    for p in patches + p2:
        p.start()
    try:
        x_s, _, it_s = tpoisson.solve_pcg(prob_s, b, torch.zeros_like(b),
                                          tol_rel=1e-5, max_iters=60)
    finally:
        for p in patches + p2:
            p.stop()
    assert not single and halo["apply_dot_7pt_h"] > 0
    scale = float(x_ref.abs().max())
    assert float((x_s - x_ref).abs().max()) <= 2e-4 * scale
    assert int(it_s) <= int(it_ref) + 3, (int(it_s), int(it_ref))


def test_sharded_step_refuses_what_jax_does_not_shard():
    geom = tbuild(**TANK)
    with pytest.raises(ValueError, match="does not divide"):
        ttimestep.make_step(geom, spmd=SpmdCtx(5), device="cpu")
    with pytest.raises(NotImplementedError, match="batch_lanes"):
        ttimestep.make_step(geom, TProps(), TControls(batch_lanes=True),
                            spmd=SpmdCtx(4), device="cpu")
    with pytest.raises(TypeError, match="SpmdCtx"):
        ttimestep.make_step_core(spmd=4)
    # make_step_ga takes spmd too; a batched state raises at the step.
    step = ttimestep.make_step_ga(geom.spacing, controls=TControls(
        use_pallas=True), spmd=SpmdCtx(4), device="cpu")
    from openfoam_tpp_tpu_torch.parallel.sweep import batch_states

    ga = ttimestep.geometry_arrays(geom, device="cpu")
    with pytest.raises(NotImplementedError, match="batched state"):
        step(batch_states(geom, 2, device="cpu"), None, ga)
