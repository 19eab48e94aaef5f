"""The tiled sweep (parallel/tiled_sweep.py) and the step's `forcing=` hook
in the PyTorch port, on the CPU, against the JAX package from the same
numpy inputs, on tests/test_tiled_sweep.py's geometry (H 0.04, D 0.016,
mesh 0.004: 4×4 cells across, 12 layers) and three rows.

The tiling helpers (`tile_geometry`, `tile_state`, `untile`) bitwise
equal to JAX's; 5 tiled steps against the JAX tiled step (the jnp path,
`use_pallas=False`, against the port's plain path with the f32 FCT), and
against the port's own vmapped sweep (`make_sweep_step`, case axis
trailing); `run_tiled_sweep` to a t_end; and the finish kernel's gate on
the forcing's rank.

Tolerances. Against the JAX tiled step, tests/test_torch_step.py's
bounds (alpha 1e-5, velocities 1e-3 of scale, p 1e-4 of scale, p_iters
±1): both end every step in a CG solve stopped at 1e-3 (measured alpha
2.0e-6; u, v, w 4.2e-4, 8.0e-4, 2.3e-4 of scale; p 2.4e-5; p_iters
equal). Against the vmapped sweep, the JAX test's bounds
(tests/test_tiled_sweep.py:85-107): t 1e-6 and dt 1e-5 relative, alpha
5e-4 and w 5e-3 absolute, per-block mass 1e-3: the blocks are
decoupled, but the CG runs on the union system and so stops on another
iterate than the per-case solves (measured alpha 1.5e-6, w 2.4e-5, t
and dt equal).
"""

import collections
import dataclasses
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sweep as jsw
from openfoam_tpp_tpu.parallel import tiled_sweep as jts
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (CaseParams, init_state,
                                               params_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.parallel import tiled_sweep as tts
from openfoam_tpp_tpu_torch.solver import timestep as ttimestep

ROWS = [
    {"R": 0.0020, "freq": 2.5, "duration": 1.0, "ramp": 0.05},
    {"R": 0.0030, "freq": 3.0, "duration": 1.0, "ramp": 0.05},
    {"R": 0.0015, "freq": 3.5, "duration": 1.0, "ramp": 0.05},
]
TANK = dict(H=0.04, D=0.016, mesh=0.004, geo="flat")
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = ("orbit_radius", "omega", "ramp_time")
N = len(ROWS)
N_STEPS = 5


def _tparams():
    return params_from_numpy(
        {k: np.asarray(getattr(jsw.batch_params(ROWS), k)) for k in PARAMS},
        device="cpu")


def test_tile_geometry_bitwise():
    jg, tg = jbuild(**TANK), tbuild(**TANK)
    jt, tt = jts.tile_geometry(jg, N), tts.tile_geometry(tg, N)
    nx = tg.shape[0]
    assert tt.shape == jt.shape == (nx * N, tg.shape[1], tg.shape[2])
    for k in ("vfrac", "ax", "ay", "az", "top_open"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
    assert tt.ax.shape[0] == nx * N + 1
    for i in range(N + 1):   # every junction face is sealed
        assert np.all(tt.ax[i * nx if i < N else -1] == 0.0)
    assert tt.n_fluid_cells == N * tg.n_fluid_cells
    open_x = dataclasses.replace(tg, ax=np.ones_like(tg.ax))
    with pytest.raises(ValueError, match="sealed x-boundary"):
        tts.tile_geometry(open_x, N)
    with pytest.raises(ValueError, match="sealed x-boundary"):
        jts.tile_geometry(dataclasses.replace(jg, ax=np.ones_like(jg.ax)), N)


def test_tile_state_bitwise():
    js = jts.tile_state(jbuild(**TANK), N, dt0=4e-4)
    ts = tts.tile_state(tbuild(**TANK), N, dt0=4e-4, device="cpu")
    got = state_to_numpy(ts)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)), k)
        assert got[k].dtype == np.asarray(getattr(js, k)).dtype, k


@pytest.mark.parametrize("face_x", [False, True])
def test_untile_bitwise(face_x):
    tg = tbuild(**TANK)
    nx, ny, nz = tg.shape
    a = np.random.default_rng(5).standard_normal(
        (nx * N + face_x, ny, nz)).astype(np.float32)
    ref = jts.untile(jax.numpy.asarray(a), N, face_x=face_x)
    got = tts.untile(torch.as_tensor(a), N, face_x=face_x)
    assert got.shape == (N, nx + face_x, ny, nz)
    np.testing.assert_array_equal(got, ref)
    u = tts.untile(tts.tile_state(tg, N, device="cpu").u, N, face_x=True)
    assert u.shape == (N, nx + 1, ny, nz)


@pytest.fixture(scope="module")
def tiled_runs():
    """5 steps of the JAX tiled step, the port's tiled step and the port's
    vmapped sweep, from the same quiescent state."""
    jg, tg = jbuild(**TANK), tbuild(**TANK)
    jc = JControls(p_max_iters=15)
    tc = TControls(p_max_iters=15, fct_bf16=False)
    jpar = jsw.batch_params(ROWS)
    jstep = jax.jit(jts.make_tiled_sweep_step(jg, N, JProps(), jc))
    js, jdiags = jts.tile_state(jg, N), []
    for _ in range(N_STEPS):
        js, d = jstep(js, jpar)
        jdiags.append(d)
    jax.block_until_ready(js)

    tpar = _tparams()
    tstep = tts.make_tiled_sweep_step(tg, N, TProps(), tc, device="cpu")
    start = tts.tile_state(tg, N, device="cpu")
    ts, tdiags = start, []
    for _ in range(N_STEPS):
        ts, d = tstep(ts, tpar)
        tdiags.append(d)

    vstep = tsw.make_sweep_step(tg, TProps(), tc, device="cpu")
    vs = tsw.batch_states(tg, N, device="cpu")
    for _ in range(N_STEPS):
        vs, _ = vstep(vs, tpar)
    return dict(jax=({k: np.asarray(getattr(js, k)) for k in FIELDS},
                     jdiags),
                port=(state_to_numpy(ts), tdiags),
                start=state_to_numpy(start), vmapped=state_to_numpy(vs),
                vfrac=tg.vfrac, nx=tg.shape[0])


def test_tiled_steps_match_jax(tiled_runs):
    ref, jdiags = tiled_runs["jax"]
    got, tdiags = tiled_runs["port"]
    assert float(np.abs(ref["u"]).max()) > 1e-4   # the cases are shaking
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


def test_tiled_matches_vmapped_sweep(tiled_runs):
    got, _ = tiled_runs["port"]
    v = tiled_runs["vmapped"]
    np.testing.assert_allclose(float(got["t"]), v["t"], rtol=1e-6)
    np.testing.assert_allclose(float(got["dt"]), float(v["dt"].min()),
                               rtol=1e-5)
    a_blocks = tts.untile(got["alpha"], N)
    assert np.isfinite(a_blocks).all()
    np.testing.assert_allclose(a_blocks, np.moveaxis(v["alpha"], -1, 0),
                               atol=5e-4)
    np.testing.assert_allclose(tts.untile(got["w"], N),
                               np.moveaxis(v["w"], -1, 0), atol=5e-3)
    # The cases differ (each block has its own forcing).
    u_blocks = tts.untile(got["u"], N, face_x=True)
    assert np.abs(u_blocks[0] - u_blocks[1]).max() > 1e-5
    vfrac, nx = tiled_runs["vfrac"], tiled_runs["nx"]
    a0 = tiled_runs["start"]["alpha"]
    for i in range(N):
        m0 = (a0[i * nx:(i + 1) * nx] * vfrac).sum()
        m1 = (a_blocks[i] * vfrac).sum()
        assert abs(m1 - m0) < 1e-3 * m0


def test_run_tiled_sweep_reaches_t_end():
    tg = tbuild(**TANK)
    state, n = tts.run_tiled_sweep(tg, ROWS, t_end=0.004, device="cpu")
    assert n == int(state.step) and float(state.t) >= 0.004
    assert state.alpha.shape == (tg.shape[0] * N,) + tuple(tg.shape[1:])
    _, n_cut = tts.run_tiled_sweep(tg, ROWS, t_end=0.004, max_steps=2,
                                   device="cpu")
    assert n_cut == 2


@pytest.mark.parametrize("g_rank", ["tiled", "all_0d", "floats"])
def test_finish_kernel_only_for_0d_forcing(g_rank, monkeypatch):
    """Built with OFTPP_FINISH_PALLAS=1 and use_pallas=True, the tiled step
    (G_x, G_y vary along x) never calls the finish kernel and runs the
    momentum RHS every step; a forcing of three 0-d components, tensors
    or Python numbers, calls it every step, with the (3,) G the kernel
    takes."""
    monkeypatch.setenv("OFTPP_FINISH_PALLAS", "1")
    tg = tbuild(**TANK)
    controls = TControls(use_pallas=True)
    if g_rank == "tiled":
        step = tts.make_tiled_sweep_step(tg, N, TProps(), controls,
                                         device="cpu")
        state, params = tts.tile_state(tg, N, device="cpu"), _tparams()
    else:
        core = ttimestep.make_step_core(
            TProps(), controls, forcing=(
                (lambda t, p: (0.0 * t, 0.1 + 0.0 * t, -9.81 + 0.0 * t))
                if g_rank == "all_0d" else (lambda t, p: (0.0, 0.1, -9.81))))
        ga = ttimestep.geometry_arrays(tg, device="cpu")

        def step(s, p):
            return core(s, p, ga, tuple(float(h) for h in tg.spacing))
        state = init_state(tg, device="cpu")
        params = CaseParams.make(0.0, 0.0, 1.0, device="cpu")
    calls = collections.Counter()
    real_finish = tfk.momentum_finish

    def finish(*a, **k):
        calls["finish"] += 1
        assert a[-1].shape == (3,)
        return real_finish(*a, **k)

    with mock.patch.object(tfk, "momentum_finish", finish), \
            mock.patch.object(tmrk, "momentum_rhs",
                              wraps=tmrk.momentum_rhs) as rhs:
        for _ in range(2):
            state, _ = step(state, params)
    assert rhs.call_count == 2
    assert calls["finish"] == (0 if g_rank == "tiled" else 2)
    assert bool(torch.isfinite(state.u).all())
