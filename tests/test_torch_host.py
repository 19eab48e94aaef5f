"""Port host modules against the JAX package on the CPU: geometry, state,
motion, stencils, MULES advection (both branches), momentum terms and the
pressure solve. Identical numpy inputs go through both; the port runs
with device="cpu", where its kernel entry points take their plain
versions.

Tolerances, with their reasons:
* geometry, state init, edge clamps and shifts: bitwise (same numpy or
  data-movement operations);
* f32 stencil arithmetic: 1e-6 relative to the field's scale (same
  operations; XLA may contract or reorder a multiply-add);
* the pressure solve: CG stops at a relative residual of 1e-3, so two
  solves whose preconditioners round bf16 at other places differ at that
  level; held to 1e-3 of the solution's scale and p_iters within ±1."""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.core import motion as jmo
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.ops import mules as jmules
from openfoam_tpp_tpu.ops import stencil as jst
from openfoam_tpp_tpu.ops.pallas import mules_fct as jmf
from openfoam_tpp_tpu.ops.pallas import mules_flux as jmfx
from openfoam_tpp_tpu.solver import momentum as jmom
from openfoam_tpp_tpu.solver import poisson as jpois
from openfoam_tpp_tpu.solver.timestep import geometry_arrays as jga
from openfoam_tpp_tpu_torch.core import motion as tmo
from openfoam_tpp_tpu_torch.core.state import (init_state as tinit,
                                               params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops import mules as tmules
from openfoam_tpp_tpu_torch.ops import stencil as tst
from openfoam_tpp_tpu_torch.solver import momentum as tmom
from openfoam_tpp_tpu_torch.solver import poisson as tpois

TANK = dict(H=0.04, D=0.048, mesh=0.004, geo="flat", round_to=4)  # 16x16x10
F32_RTOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (what, err, rtol * scale)


@pytest.fixture(scope="module")
def case():
    """JAX geometry/state, the port's counterparts, and a random MAC
    velocity (seeded numpy) zeroed on closed faces."""
    jg = jbuild(**TANK)
    tg = tbuild(**TANK)
    rng = np.random.default_rng(0)
    ga_np = {k: np.asarray(v) for k, v in jga(jg).items()}
    vel = [0.05 * rng.standard_normal(ga_np[k].shape).astype(np.float32)
           * (ga_np[k] > 0) for k in ("ax", "ay", "az")]
    return jg, tg, ga_np, vel


@pytest.mark.parametrize("geo", ["flat", "cap"])
def test_geometry_bit_identical(geo):
    kw = dict(TANK, geo=geo)
    jg, tg = jbuild(**kw), tbuild(**kw)
    assert (tg.shape, tg.spacing, tg.origin) == (jg.shape, jg.spacing, jg.origin)
    for k in ("vfrac", "ax", "ay", "az", "top_open"):
        a, b = getattr(jg, k), getattr(tg, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_init_state_and_carry_across(case):
    jg, tg, _, _ = case
    js = jinit(jg)
    ts = tinit(tg, device="cpu")
    for k in ("alpha", "u", "v", "w", "p", "t", "dt", "step"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    d = {k: np.asarray(getattr(js, k)) for k in ("alpha", "u", "v", "w", "p",
                                                   "t", "dt", "step")}
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype


def test_orbital_motion_matches():
    jp = JParams.make(R=0.004, freq=1.88, duration=0.5)
    tp = params_from_numpy({k: np.asarray(getattr(jp, k))
                            for k in ("orbit_radius", "omega", "ramp_time")},
                           device="cpu")
    for t in (0.0, 0.013, 0.05, 0.31):
        tj, tt = jnp.float32(t), torch.tensor(t, dtype=torch.float32)
        _close(tmo.orbital_position(tt, tp), jmo.orbital_position(tj, jp),
               F32_RTOL, "position")
        _close(tmo.effective_gravity(tt, tp, 9.81),
               jmo.effective_gravity(tj, jp, 9.81), F32_RTOL, "gravity")


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_stencil_primitives_match(axis):
    rng = np.random.default_rng(axis)
    c = rng.standard_normal((6, 7, 5)).astype(np.float32)
    f_shape = list(c.shape)
    f_shape[axis] += 1
    flux = rng.standard_normal(f_shape).astype(np.float32)
    cj, ct = jnp.asarray(c), _t(c)
    exact = (("shift_down", (axis,)), ("shift_up", (axis,)))
    for name, args in exact:
        np.testing.assert_array_equal(getattr(tst, name)(ct, *args).numpy(),
                                      np.asarray(getattr(jst, name)(cj, *args)))
    for a, b in zip(tst.face_lr(ct, axis), jst.face_lr(cj, axis)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cases = [
        (tst.cells_to_faces_avg(ct, axis), jst.cells_to_faces_avg(cj, axis)),
        (tst.cells_to_faces_harmonic(ct.abs(), axis),
         jst.cells_to_faces_harmonic(jnp.abs(cj), axis)),
        (tst.gradient_at_faces(ct, axis, 0.004),
         jst.gradient_at_faces(cj, axis, 0.004)),
        (tst.faces_to_cells_avg(_t(flux), axis),
         jst.faces_to_cells_avg(jnp.asarray(flux), axis)),
        (tst.upwind_faces(ct, _t(flux), axis),
         jst.upwind_faces(cj, jnp.asarray(flux), axis)),
        (tst.vanleer_faces(ct, _t(flux), axis),
         jst.vanleer_faces(cj, jnp.asarray(flux), axis)),
        (tst.max27(ct), jst.max27(cj)),
        (tst.min27(ct), jst.min27(cj)),
    ]
    for got, ref in cases:
        _close(got, ref, F32_RTOL)
    fx = rng.standard_normal((7, 7, 5)).astype(np.float32)
    fy = rng.standard_normal((6, 8, 5)).astype(np.float32)
    fz = rng.standard_normal((6, 7, 6)).astype(np.float32)
    sp = (0.004, 0.005, 0.003)
    _close(tst.divergence(_t(fx), _t(fy), _t(fz), sp),
           jst.divergence(jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(fz), sp),
           F32_RTOL)


def test_momentum_terms_match(case):
    jg, _, ga_np, vel = case
    rng = np.random.default_rng(4)
    sp = tuple(float(s) for s in jg.spacing)
    mu = (1e-3 * rng.uniform(0.01, 1, jg.shape)).astype(np.float32)
    rp = [1e3 * v for v in vel]
    div_u = rng.standard_normal(jg.shape).astype(np.float32) * 1e-3
    vj, vt = tuple(jnp.asarray(v) for v in vel), tuple(_t(v) for v in vel)
    rpj, rpt = tuple(jnp.asarray(r) for r in rp), tuple(_t(r) for r in rp)
    ej, et = jmom.edge_viscosities(jnp.asarray(mu)), tmom.edge_viscosities(_t(mu))
    for k in ej:
        _close(et[k], ej[k], F32_RTOL)

    @jax.jit
    def jterms(vj, rpj, mu, div_u):
        ej = jmom.edge_viscosities(mu)
        return [(jmom.convect_face_field(vj[ax], ax, rpj, sp),
                 jmom.viscous_face_field(vj[ax], ax, mu, sp, ej),
                 jmom.transpose_viscous_face_field(vj, ax, mu, sp, ej, div_u))
                for ax in range(3)]

    ref = jterms(vj, rpj, jnp.asarray(mu), jnp.asarray(div_u))
    for ax in range(3):
        conv, visc, dev2 = ref[ax]
        _close(tmom.convect_face_field(vt[ax], ax, rpt, sp), conv, 1e-5, "conv")
        _close(tmom.viscous_face_field(vt[ax], ax, _t(mu), sp, et), visc,
               1e-5, "visc")
        _close(tmom.transpose_viscous_face_field(vt, ax, _t(mu), sp, et,
                                                 _t(div_u)), dev2, 1e-5, "dev2")


def _interp_kernels():
    """The JAX MULES kernels in interpret mode (the CPU has no Mosaic)."""
    of, ox = jmf.fct_iter, jmfx.flux_all
    return (mock.patch.object(jmf, "fct_iter",
                              lambda *a, **k: of(*a, **{**k, "interpret": True})),
            mock.patch.object(jmfx, "flux_all",
                              lambda *a, **k: ox(*a, **{**k, "interpret": True})))


@pytest.mark.parametrize("kernels", [False, True])
def test_advect_alpha_matches(case, kernels):
    """Both branches: the jnp/plain path (f32 FCT) and the kernel path
    (bf16 λ/anti streams). The kernel path's bf16 streams round the same
    way on both sides, so the step differs only in f32 ulps."""
    jg, _, ga_np, vel = case
    props = JProps()
    sp = tuple(float(s) for s in jg.spacing)
    alpha = np.asarray(jinit(jg).alpha)
    phi = [ga_np[k] * v for k, v in zip(("ax", "ay", "az"), vel)]
    dt = np.float32(5e-3)
    ga_j = {k: jnp.asarray(v) for k, v in ga_np.items()}
    ga_t = {k: _t(v) for k, v in ga_np.items()}
    p1, p2 = _interp_kernels()
    with p1, p2:
        a_j, rp_j, _ = jmules.advect_alpha(
            jnp.asarray(alpha), tuple(jnp.asarray(f) for f in phi), ga_j, sp,
            jnp.asarray(dt), props.rho1, props.rho2, use_pallas=kernels,
            fct_bf16=kernels)
    a_t, rp_t, _ = tmules.advect_alpha(
        _t(alpha), tuple(_t(f) for f in phi), ga_t, sp, torch.tensor(dt),
        props.rho1, props.rho2, use_pallas=kernels, fct_bf16=kernels)
    assert float(np.abs(np.asarray(a_j) - alpha).max()) > 1e-3  # alpha moved
    _close(a_t, a_j, 1e-5, "alpha")
    for ax in range(3):
        _close(rp_t[ax], rp_j[ax], 1e-4, "rho_phi")
    fluid = ga_np["vfrac"] > 0
    at = a_t.numpy()
    assert at[fluid].min() >= 0.0 and at[fluid].max() <= 1.0


@pytest.mark.parametrize("kernels", [False, True])
def test_solve_pcg_matches(case, kernels):
    jg, tg, ga_np, vel = case
    props = JProps()
    sp = tuple(float(s) for s in jg.spacing)
    alpha = np.asarray(jinit(jg).alpha)
    rho = (alpha * props.rho1 + (1 - alpha) * props.rho2).astype(np.float32)
    div = np.asarray(jst.divergence(*(jnp.asarray(ga_np[k] * v) for k, v in
                                      zip(("ax", "ay", "az"), vel)), sp))
    b = np.where(ga_np["vfrac"] > 0, -div / 1e-3, 0).astype(np.float32)
    ga_j = {k: jnp.asarray(v) for k, v in ga_np.items()}
    ga_t = {k: _t(v) for k, v in ga_np.items()}
    kw = dict(tol_rel=1e-3, tol_abs=1e-8, tol_rel_b=3e-4, max_iters=50)

    @jax.jit
    def jsolve(ga, rho, b):
        prob = jpois.build_poisson(ga, sp, rho, ga["top_open"],
                                   use_pallas=kernels)
        return jpois.solve_pcg(prob, b, jnp.zeros_like(b), **kw)

    x_j, res_j, it_j = jsolve(ga_j, jnp.asarray(rho), jnp.asarray(b))
    tprob = tpois.build_poisson(ga_t, sp, _t(rho), ga_t["top_open"],
                                use_pallas=kernels)
    x_t, res_t, it_t = tpois.solve_pcg(tprob, _t(b), torch.zeros_like(_t(b)),
                                       **kw)
    assert int(it_j) > 3
    assert abs(int(it_t) - int(it_j)) <= 1
    _close(x_t, x_j, 1e-3, "dp")
    # Both meet the tolerance on the same problem.
    apply = tprob.apply
    r = _t(b) - apply(x_t)
    r0 = float(torch.linalg.vector_norm(tprob.scale * _t(b)))
    assert float(torch.linalg.vector_norm(tprob.scale * r)) <= 1e-3 * r0 * 1.01
