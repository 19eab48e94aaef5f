"""Surface tension (CSF) in the PyTorch port, on the CPU, against the JAX
package from the same numpy inputs.

The five functions of solver/momentum.py (`csf_force`, `smooth_alpha`,
`curvature_vof`, `curvature_hf`, `curvature` with its three methods) on a
seeded wavy, noisy alpha in the 16×16×10 flat tank (cut-cell walls), on
a single grid and on a B = 2 batch (case axis trailing, per-case hz)
against `jax.vmap` of the JAX function; the oracles of tests/test_csf.py
on the port (the Laplace jump of a static column, the height-function
curvature of a sinusoid); 3 steps with σ = 0.072 N/m against the JAX step;
the capillary dt bound against the JAX step's where it binds; and the
step with σ ≠ 0 in every entry point.

Reference paths: the functions against the jitted JAX functions; the
steps against the JAX step with `use_pallas=False` (the jnp path) in (a),
and with `use_pallas=True` (its Pallas kernels in interpret mode) under
OFTPP_FINISH_PALLAS=1 in (c), where neither package runs the finish
kernel (κ is set) and both run the momentum RHS and the epilogue.

Tolerances. XLA contracts a product feeding a sum into one fused
multiply-add and divides by a spacing through its own sequence, and it
sums the height-function columns in another order than torch.sum, so
the functions are held to what that leaves, measured on these inputs:
`smooth_alpha` 2 f32 ulps of 1 (measured 1.8e-7); the curvatures, which
go as 1/h² of alpha's last bits, to 1e-4 of their scale (measured: VoF
1.4e-5, HF 5.8e-6, blend 5.0e-5; the JAX package's own eager and jitted
curvatures differ by 2.8e-5); `csf_force` 1e-4 of its scale. The blend
on the sinusoid equals HF to 1e-5 and the VoF fallback to 1e-6, the
JAX test's bounds. The 3 CSF steps: tests/test_torch_step.py's bounds
(alpha 1e-5, velocities 1e-3 of scale, p 1e-4 of scale, p_iters ±1),
because each step ends in a CG solve stopped at 1e-3 (measured in (a)
and (c): alpha 2.7e-6, velocities 1.2e-4 of scale, p 7.7e-6, p_iters
and dt equal). The capillary bound is formed in f32 on both sides: dt
bitwise equal.
"""

import collections
import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from openfoam_tpp_tpu.solver import momentum as jm
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (CaseParams, init_state,
                                               params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_box_geometry
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import momentum as tm
from openfoam_tpp_tpu_torch.solver import timestep as ttimestep

TANK = dict(H=0.04, D=0.048, mesh=0.004, geo="flat", round_to=4)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = ("orbit_radius", "omega", "ramp_time")
SIGMA = 0.072
HZ2 = 0.0036          # the second batch case's hz
ULP1 = 2.0 ** -23


def _wavy_alpha(geom, seed, noise=0.02):
    """A wavy free surface at mid-depth with seeded noise in [0, 1], zero
    in solid cells (f32)."""
    rng = np.random.default_rng(seed)
    x, y, zc = geom.cell_centers()
    hz = geom.spacing[2]
    L = geom.D
    eta = (geom.H / 2.0 + 0.003 * np.cos(2 * np.pi * x / L)[:, None]
           + 0.002 * np.sin(2 * np.pi * y / L)[None, :])
    frac = np.clip((eta[:, :, None] - (zc[None, None, :] - hz / 2)) / hz,
                   0.0, 1.0)
    a = np.clip(frac + noise * rng.standard_normal(geom.shape), 0.0, 1.0)
    return np.where(geom.vfrac > 0, a, 0.0).astype(np.float32)


@pytest.fixture(scope="module")
def fields():
    geom = jbuild(**TANK)
    alphas = [_wavy_alpha(geom, s) for s in (0, 1)]
    vfrac = geom.vfrac.astype(np.float32)
    rng = np.random.default_rng(2)
    beta = [(1.0 + rng.random(s)).astype(np.float32)
            for s in ((17, 16, 10), (16, 17, 10), (16, 16, 11))]
    return geom, alphas, vfrac, beta


# name -> (JAX function, port function) of (alpha, spacing, vfrac, beta)
FUNCTIONS = {
    "csf_force": (
        lambda a, sp, vf, b: tuple(
            jm.csf_force(a, jm.curvature(a, sp, vfrac=vf), SIGMA, ax, sp[ax],
                         b[ax]) for ax in range(3)),
        lambda a, sp, vf, b: tuple(
            tm.csf_force(a, tm.curvature(a, sp, vfrac=vf), SIGMA, ax, sp[ax],
                         b[ax]) for ax in range(3))),
    "smooth_alpha": (lambda a, sp, vf, b: jm.smooth_alpha(a),
                     lambda a, sp, vf, b: tm.smooth_alpha(a)),
    "curvature_vof": (lambda a, sp, vf, b: jm.curvature_vof(a, sp),
                      lambda a, sp, vf, b: tm.curvature_vof(a, sp)),
    "curvature_hf": (lambda a, sp, vf, b: jm.curvature_hf(a, sp, vf),
                     lambda a, sp, vf, b: tm.curvature_hf(a, sp, vf)),
    "curvature_blend": (
        lambda a, sp, vf, b: jm.curvature(a, sp, vfrac=vf, method="blend"),
        lambda a, sp, vf, b: tm.curvature(a, sp, vfrac=vf, method="blend")),
    "curvature_hf_method": (
        lambda a, sp, vf, b: jm.curvature(a, sp, vfrac=vf, method="hf"),
        lambda a, sp, vf, b: tm.curvature(a, sp, vfrac=vf, method="hf")),
    "curvature_vof_method": (
        lambda a, sp, vf, b: jm.curvature(a, sp, vfrac=vf, method="vof"),
        lambda a, sp, vf, b: tm.curvature(a, sp, vfrac=vf, method="vof")),
}


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


@pytest.mark.parametrize("layout", ["single", "batch"])
@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_csf_functions_match_jax(name, layout, fields):
    geom, alphas, vfrac, beta = fields
    jfn, tfn = FUNCTIONS[name]
    h = tuple(float(s) for s in geom.spacing)
    if layout == "single":
        ref = jax.jit(lambda a, vf, b: jfn(a, h, vf, b))(
            jnp.asarray(alphas[0]), jnp.asarray(vfrac),
            tuple(map(jnp.asarray, beta)))
        ref = [np.asarray(r) for r in _leaves(ref)]
        got = tfn(torch.as_tensor(alphas[0]), h, torch.as_tensor(vfrac),
                  tuple(map(torch.as_tensor, beta)))
        got = [g.numpy() for g in _leaves(got)]
    else:
        # B = 2: the second case has its own hz (a geometry sweep's
        # per-case spacing); JAX vmaps over a leading case axis.
        hz = np.asarray([h[2], HZ2], np.float32)

        def one(a, vf, b, hzc):
            return jfn(a, (h[0], h[1], hzc), vf, b)

        stack = lambda xs: jnp.asarray(np.stack(xs))
        ref = jax.jit(jax.vmap(one))(
            stack(alphas), stack([vfrac, vfrac]),
            tuple(stack([b, b]) for b in beta), jnp.asarray(hz))
        ref = [np.moveaxis(np.asarray(r), 0, -1) for r in _leaves(ref)]
        tl = lambda xs: torch.as_tensor(np.stack(xs, -1))
        got = tfn(tl(alphas), (h[0], h[1], torch.as_tensor(hz)),
                  tl([vfrac, vfrac]), tuple(tl([b, b]) for b in beta))
        got = [g.numpy() for g in _leaves(got)]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.shape == r.shape, (g.shape, r.shape)
        assert np.isfinite(g).all()
        scale = np.abs(r).max()
        assert scale > 0.0
        if name == "smooth_alpha":
            assert np.abs(g - r).max() <= 2 * ULP1
        else:
            assert np.abs(g - r).max() <= 1e-4 * scale, (
                np.abs(g - r).max() / scale)


def test_hf_without_vfrac_raises(fields):
    geom, alphas, _, _ = fields
    with pytest.raises(ValueError, match="requires vfrac"):
        jm.curvature(jnp.asarray(alphas[0]), geom.spacing, method="hf")
    with pytest.raises(ValueError, match="requires vfrac"):
        tm.curvature(torch.as_tensor(alphas[0]), geom.spacing, method="hf")


def test_laplace_pressure_jump_cylinder_column():
    """tests/test_csf.py:22 on the port: a static water column of radius
    R0 in zero gravity carries Δp = σ/R0 within 30%, parasitic currents
    below 0.1·√(σ/(ρ h)), mass to 1e-3."""
    mesh = 0.001
    L, Lz = 0.016, 0.006
    R0 = 0.004
    geom = build_box_geometry(L, L, Lz, mesh, z0=0.0, open_top=False)
    props = dataclasses.replace(TProps(), sigma=SIGMA, g=0.0)
    step = ttimestep.make_step(geom, props, TControls(p_max_iters=30),
                               device="cpu")
    params = CaseParams.make(R=0.0, freq=0.0, duration=1.0, device="cpu")
    state = init_state(geom, dt0=5e-5, device="cpu")
    nx, ny, nz = geom.shape
    x = (np.arange(nx) + 0.5) * mesh - L / 2.0
    y = (np.arange(ny) + 0.5) * mesh - L / 2.0
    r = np.sqrt(x[:, None] ** 2 + y[None, :] ** 2)
    prof = np.clip(0.5 - (r - R0) / mesh, 0.0, 1.0)
    alpha = np.broadcast_to(prof[:, :, None], geom.shape).copy()
    state = dataclasses.replace(
        state, alpha=torch.as_tensor(alpha.astype(np.float32)))
    for _ in range(5):
        state, _ = step(state, params)

    a = state.alpha.numpy()
    p = state.p.numpy()
    core = a > 0.99
    far = (a < 0.01) & (r[:, :, None] < L / 2.0 - 2 * mesh)
    assert core.any() and far.any()
    dp = p[core].mean() - p[far].mean()
    expected = SIGMA / R0
    assert abs(dp - expected) / expected < 0.3, (dp, expected)
    umax = max(float(v.abs().max()) for v in (state.u, state.v, state.w))
    u_cap = np.sqrt(SIGMA / (998.2 * mesh))
    assert umax < 0.1 * u_cap, (umax, u_cap)
    assert abs(a.sum() - alpha.sum()) < 1e-3 * alpha.sum()


def test_height_function_curvature_sinusoid():
    """tests/test_csf.py:68 on the port: HF within 2% of the exact graph
    curvature (slope fit), the blend equal to HF on the near-horizontal
    interface to 1e-5 and to the VoF estimator on a vertical one to
    1e-6."""
    mesh = 4e-4
    L, W, Hb = 0.008, 0.0024, 0.008
    geom = build_box_geometry(L, W, Hb, mesh, z0=0.0, open_top=True)
    x, _, zc = geom.cell_centers()
    hz = geom.spacing[2]
    k, A, depth = np.pi / L, 3e-4, 0.004
    eta = depth + A * np.cos(k * (x + L / 2))
    frac = np.clip((eta[:, None, None] - (zc[None, None, :] - hz / 2)) / hz,
                   0.0, 1.0)
    alpha = torch.as_tensor(
        np.where(geom.vfrac > 0, frac, 0.0).astype(np.float32))
    vfrac = torch.as_tensor(geom.vfrac.astype(np.float32))

    k2d = tm.curvature_hf(alpha, geom.spacing, vfrac).numpy()[:, :, 0]
    slope_h = A * k * np.sin(k * (x + L / 2))
    k_exact = A * k * k * np.cos(k * (x + L / 2)) / (1.0 + slope_h ** 2) ** 1.5
    mid = geom.shape[1] // 2
    slope = np.polyfit(k_exact[2:-2], k2d[2:-2, mid], 1)[0]
    assert abs(slope - 1.0) < 0.02, slope

    kb = tm.curvature(alpha, geom.spacing, vfrac=vfrac,
                      method="blend").numpy()
    iz = int(depth / hz)
    np.testing.assert_allclose(kb[2:-2, mid, iz], k2d[2:-2, mid], rtol=1e-5)
    slab = torch.as_tensor(
        (np.where(x < 0.0, 1.0, 0.0)[:, None, None]
         * np.ones(geom.shape) * (geom.vfrac > 0)).astype(np.float32))
    kv, _ = tm.curvature_vof(slab, geom.spacing)
    kb2 = tm.curvature(slab, geom.spacing, vfrac=vfrac, method="blend")
    np.testing.assert_allclose(kb2.numpy(), kv.numpy(), atol=1e-6)


FUSED = ("momentum_rhs", "correct_divmax", "momentum_finish")


def _interpreted(module, name, calls):
    """A JAX Pallas entry point in interpret mode, counting its calls."""
    fn = getattr(module, name)

    def run(*a, **k):
        calls[name] += 1
        return fn(*a, **{**k, "interpret": True})

    return mock.patch.object(module, name, run)


def _csf_start():
    """The JAX initial state of the tank with a wavy, noisy surface."""
    jg = jbuild(**TANK)
    js = jinit(jg)
    return jg, dataclasses.replace(js, alpha=jnp.asarray(_wavy_alpha(jg, 3)))


@pytest.mark.parametrize("path", ["a_plain", "c_default_finish_asked"])
def test_three_csf_steps_match_jax(path, monkeypatch):
    jg, js = _csf_start()
    jp = JParams.make(R=0.004, freq=1.88, duration=0.5)
    jprops, tprops = JProps(sigma=SIGMA), TProps(sigma=SIGMA)
    if path == "a_plain":
        jc, tc = JControls(), TControls(fct_bf16=False)
    else:
        jc, tc = JControls(use_pallas=True), TControls(use_pallas=True)
        monkeypatch.setenv("OFTPP_FINISH_PALLAS", "1")

    jcalls = collections.Counter()
    with _interpreted(jmf, "fct_iter", jcalls), \
            _interpreted(jmfx, "flux_all", jcalls), \
            _interpreted(jmrk, "momentum_rhs", jcalls), \
            _interpreted(jck, "correct_divmax", jcalls), \
            _interpreted(jfk, "momentum_finish", jcalls):
        jstep = jax.jit(jmake(jg, jprops, jc))
        s, jdiags = js, []
        for _ in range(3):
            s, d = jstep(s, jp)
            jdiags.append(d)
        jax.block_until_ready(s)
    ref = {k: np.asarray(getattr(s, k)) for k in FIELDS}

    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu")
    tp = params_from_numpy({k: np.asarray(getattr(jp, k)) for k in PARAMS},
                           device="cpu")
    tstep = ttimestep.make_step(tbuild(**TANK), tprops, tc, device="cpu")
    tdiags = []
    spies = [mock.patch.object(m, n, wraps=getattr(m, n)) for m, n in
             ((tmrk, "momentum_rhs"), (tck, "correct_divmax"),
              (tfk, "momentum_finish"))]
    with spies[0] as m1, spies[1] as m2, spies[2] as m3:
        for _ in range(3):
            ts, d = tstep(ts, tp)
            tdiags.append(d)
    got = state_to_numpy(ts)
    on = path != "a_plain"
    for fname, spy in zip(FUSED, (m1, m2, m3)):
        want = on and fname != "momentum_finish"
        assert (jcalls[fname] > 0) == want, fname
        assert spy.call_count == (3 if want else 0), fname

    for k in ("u", "v", "w"):
        assert float(np.abs(ref[k]).max()) > 1e-4, k   # CSF moves the fluid
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


def test_capillary_bound_matches_jax_when_it_binds():
    """With `max_capillary_co=0.05` the capillary bound binds from the
    first step: dt_cfl (the state's dt) equals it, in f32, bitwise equal
    to the JAX step's, and the step lands on t = dt."""
    jg, js = _csf_start()
    jp = JParams.make(R=0.004, freq=1.88, duration=0.5)
    kw = dict(max_capillary_co=0.05)
    jstep = jax.jit(jmake(jg, JProps(sigma=SIGMA), JControls(**kw)))
    jout, _ = jstep(js, jp)
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu")
    tp = params_from_numpy({k: np.asarray(getattr(jp, k)) for k in PARAMS},
                           device="cpu")
    tstep = ttimestep.make_step(tbuild(**TANK), TProps(sigma=SIGMA),
                                TControls(fct_bf16=False, **kw), device="cpu")
    tout, _ = tstep(ts, tp)
    h = np.float32(min(jg.spacing))
    cap = np.float32(0.05) * np.sqrt(
        np.float32(998.2 + 1.0) * (h * h * h)
        / np.float32(4.0 * np.pi * SIGMA))
    assert cap < float(js.dt)   # the bound binds
    assert float(np.asarray(jout.dt)) == float(cap)
    assert float(tout.dt) == float(np.asarray(jout.dt))
    assert float(tout.t) == float(np.asarray(jout.t))


def test_surface_tension_is_in_the_slice():
    """σ ≠ 0 builds in every entry point and steps; under spmd κ and the
    CSF source are global tensors, so 2 shards match the unsharded step
    after 2 steps to the x-sharded step's bounds (tests/test_torch_spmd.py:
    2e-3 of each field's scale, a 2e-6 floor)."""
    geom = tbuild(**TANK)
    props = TProps(sigma=SIGMA)
    ttimestep.make_step_core(props)
    ttimestep.make_step_ga(geom.spacing, props, device="cpu")
    params = CaseParams.make(0.004, 1.88, 0.5, device="cpu")
    start = init_state(geom, device="cpu")
    start = dataclasses.replace(
        start, alpha=torch.as_tensor(_wavy_alpha(geom, 4)))
    out = {}
    for n in (None, 2):
        step = ttimestep.make_step(
            geom, props, TControls(use_pallas=True),
            spmd=None if n is None else SpmdCtx(n), device="cpu")
        s = start
        for _ in range(2):
            s, d = step(s, params)
        out[n] = s
        assert bool(torch.isfinite(s.w).all()) and int(s.step) == 2
    assert float(out[None].w.abs().max()) > 0.0
    for k in ("alpha", "u", "v", "w", "p"):
        a, b = getattr(out[None], k), getattr(out[2], k)
        lim = max(2e-3 * float(a.abs().max()), 2e-6)
        assert float((a - b).abs().max()) <= lim, k
