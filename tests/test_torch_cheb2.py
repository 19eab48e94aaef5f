"""The fused degree-2 Chebyshev smoothers of the port (`cheb2_pre_7pt`,
`cheb2_post_7pt`, `cheb2_post_dot_7pt`) and the pressure solver's knobs.

On the CPU the entry points run their plain versions, which repeat the
CUDA kernels' arithmetic (f32 throughout, one rounding on the store). They
are held against the JAX Pallas kernels in interpret mode on a real
level's weights: the scaled top level of a 16×16×20 flat tank, whose
domain-boundary faces carry zero weight. That invariant matters: the
Pallas kernels read clamped planes at the domain ends and the port chains
two of its own neighbour sums, and the two agree only because every
boundary weight is zero.

Tolerances. f32: 1e-5 of the output's scale and 1e-5 relative for the
dot, the JAX package's own bounds for these kernels (measured 4e-7 and
6e-7). bf16: the Pallas body rounds after every operation and applies θ,
c_pp, c_pd as bf16; the port widens on load and rounds once. Measured at
most 6.0 bf16 ulps of the largest output (pre's residual, lmin 0.25; 3.9
at 0.10) and 8.6e-4 relative on the dot; held to 8 ulps and 5e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties
from openfoam_tpp_tpu.core.state import init_state, mixture_density
from openfoam_tpp_tpu.mesh import build_tank_geometry
from openfoam_tpp_tpu.ops.pallas import seven_point as jsp
from openfoam_tpp_tpu.solver import poisson as jpo
from openfoam_tpp_tpu.solver.timestep import geometry_arrays
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp
from openfoam_tpp_tpu_torch.solver import poisson as tpo

LMAX = 2.0
BF16_ULPS = 8.0
TYPES = {"f32": (jnp.float32, torch.float32),
         "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def level():
    """(pack of the JAX operator as numpy, grid shape): the scaled top
    level of a half-filled flat tank."""
    geom = build_tank_geometry(H=0.05, D=0.02, mesh=0.0025, geo="flat",
                               round_to=jsp.SLAB)
    ga = geometry_arrays(geom)
    rho = mixture_density(init_state(geom).alpha, PhysicalProperties())
    spacing = tuple(float(s) for s in geom.spacing)
    _, pack = jpo.build_operator(ga, spacing, rho, ga["top_open"])
    pack = {k: np.asarray(v) for k, v in pack.items()}
    # Domain-boundary faces carry zero weight.
    assert not pack["hwx"][0].any() and not pack["hwx"][-1].any()
    assert not pack["hwy"][:, 0].any() and not pack["hwy"][:, -1].any()
    assert not pack["hwz"][:, :, 0].any() and not pack["hwz"][:, :, -1].any()
    return pack, geom.shape


def _operands(level, tag, seed):
    pack, shape = level
    jdt, tdt = TYPES[tag]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    faces = (pack["hwx"], pack["hwy"], pack["hwz"])
    jsplit = tuple(w.astype(jdt)
                   for w in jsp.split_weights(*map(jnp.asarray, faces)))
    tsplit = tsp.split_weights(*(_t(w, tdt) for w in faces))
    return ((jnp.asarray(x).astype(jdt), jnp.asarray(b).astype(jdt), jsplit),
            (_t(x, tdt), _t(b, tdt), tsplit))


def _close(got, ref, tag):
    ref = np.asarray(ref, np.float32)
    got = got.float().numpy()
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    if tag == "f32":
        assert err <= 1e-5 * scale, (err, scale)
    else:
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert err <= BF16_ULPS * ulp, (err / ulp, scale)


@pytest.mark.parametrize("lmin", [0.10, 0.25])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_plain_versions_match_pallas(level, tag, lmin):
    (jx, jb, jsplit), (tx, tb, tsplit) = _operands(level, tag, 7)
    ref_x, ref_r = jsp.cheb2_pre_7pt(jb, jsplit, LMAX, lmin, interpret=True)
    got_x, got_r = tsp.cheb2_pre_7pt(tb, tsplit, LMAX, lmin)
    assert got_x.dtype == got_r.dtype == tb.dtype
    _close(got_x, ref_x, tag)
    _close(got_r, ref_r, tag)

    # The production cycle stores f32 from bf16 operands; also the
    # operands' own type.
    for jout, tout in ((jnp.float32, torch.float32), (None, None)):
        ref_z = jsp.cheb2_post_7pt(jx, jb, jsplit, LMAX, lmin, out_dtype=jout,
                                   interpret=True)
        got_z = tsp.cheb2_post_7pt(tx, tb, tsplit, LMAX, lmin, out_dtype=tout)
        assert got_z.dtype == (tout or tb.dtype)
        _close(got_z, ref_z, tag)

    ref_z, ref_dot = jsp.cheb2_post_dot_7pt(jx, jb, jsplit, LMAX, lmin,
                                            out_dtype=jnp.float32,
                                            interpret=True)
    got_z, got_dot = tsp.cheb2_post_dot_7pt(tx, tb, tsplit, LMAX, lmin,
                                            out_dtype=torch.float32)
    _close(got_z, ref_z, tag)
    assert got_dot.dtype == torch.float32 and got_dot.dim() == 0
    tol = 1e-5 if tag == "f32" else 5e-3
    assert abs(float(got_dot) - float(ref_dot)) <= tol * abs(float(ref_dot))


@pytest.mark.parametrize("out", [None, torch.float32])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_post_dot_z_is_post_bitwise(level, tag, out):
    _, (tx, tb, tsplit) = _operands(level, tag, 11)
    z = tsp.cheb2_post_7pt(tx, tb, tsplit, LMAX, 0.1, out_dtype=out)
    z2, dot = tsp.cheb2_post_dot_7pt(tx, tb, tsplit, LMAX, 0.1, out_dtype=out)
    assert z2.dtype == z.dtype and torch.equal(z, z2)
    # The dot is against z as stored, with b widened to f32.
    want = float((tb.double() * z.double()).sum())
    assert abs(float(dot) - want) <= 1e-5 * abs(want)


def test_cheb2_rejects_what_the_kernel_does_not_take(level):
    _, (tx, tb, tsplit) = _operands(level, "f32", 3)
    with pytest.raises(ValueError, match="CUDA .* or CPU"):
        tsp.cheb2_pre_7pt(tb.to("meta"), tsplit, LMAX, 0.1)
    with pytest.raises(ValueError, match="stores"):
        tsp._cheb_out_dtype(tb, torch.bfloat16)
    assert tsp._cheb_out_dtype(tb.bfloat16(), torch.float32) == torch.float32
    assert tsp._cheb_out_dtype(tb.bfloat16(), None) == torch.bfloat16
    with pytest.raises(ValueError, match="share p's shape"):
        tsp._check(tb, tsplit, tx.bfloat16())


def _precond(level, knobs, use_pallas=True):
    """The port's V-cycle M̂⁻¹ for the level, with and without r·z."""
    pack, _ = level
    tpack = {k: _t(v) for k, v in pack.items()}
    bundle = tpo.make_bundle(tpack, use_pallas=use_pallas, knobs=knobs)
    fluid = tpack["inv_s"] > 0
    prob = tpo.PoissonProblem(
        apply=None, precond=None, diag=None, fluid=fluid, singular=False,
        beta_faces=None, c_top=None, scale=torch.where(fluid, 1.0, 0.0))
    return tpo.attach_precond(prob, bundle, knobs)


def test_fused_vcycle_matches_unfused_chain_f32(level):
    """Sweeps 2 in an f32 cycle: the fused route (the three cheb2 entry
    points) against the port's own degree-2 chain of `resid_scaled_7pt`
    passes, to 1e-5 of scale (measured 3e-7); and it took the fused entry
    points where the unfused one took none."""
    pack, shape = level
    r = _t(np.random.default_rng(5).standard_normal(shape)) * _t(
        pack["inv_s"] > 0)
    calls = []
    real = {n: getattr(tsp, n) for n in ("cheb2_pre_7pt", "cheb2_post_7pt",
                                         "cheb2_post_dot_7pt")}

    def spy(name):
        def run(*a, **k):
            calls.append(name)
            return real[name](*a, **k)
        return run

    mp = pytest.MonkeyPatch()
    for n in real:
        mp.setattr(tsp, n, spy(n))
    try:
        fused = _precond(level, tpo.SolverKnobs(smooth_sweeps=2,
                                                precond_f32=True))
        z_f = fused.precond_hat(r)
        z_fd, rz = fused.precond_rz_hat(r)
        assert calls == ["cheb2_pre_7pt", "cheb2_post_7pt", "cheb2_pre_7pt",
                         "cheb2_post_dot_7pt"]
        calls.clear()
        unfused = _precond(level, tpo.SolverKnobs(
            smooth_sweeps=2, precond_f32=True, fused_cheb=False))
        z_u = unfused.precond_hat(r)
        z_ud, rz_u = unfused.precond_rz_hat(r)
        assert calls == [] and rz_u is None
    finally:
        mp.undo()
    scale = float(z_u.abs().max())
    assert float((z_f - z_u).abs().max()) <= 1e-5 * scale
    assert torch.equal(z_f, z_fd) and torch.equal(z_u, z_ud)
    want = float((r * z_f).sum())
    assert abs(float(rz) - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("knobs,fused,rz", [
    (tpo.SolverKnobs(), False, False),                       # one sweep
    (tpo.SolverKnobs(smooth_sweeps=2), True, True),
    (tpo.SolverKnobs(smooth_sweeps=2, fused_rz=False), True, False),
    (tpo.SolverKnobs(smooth_sweeps=2, fused_cheb=False), False, False),
    (tpo.SolverKnobs(smooth_sweeps=2, smoother="jacobi"), False, False),
    (tpo.SolverKnobs(smooth_sweeps=3), False, False),
])
def test_route_follows_the_knobs(level, knobs, fused, rz):
    """`_fused_cheb2` on the kernel top level, and where CG's r·z comes
    from; without `use_pallas` no level takes a kernel route."""
    prob = _precond(level, knobs)
    pack, shape = level
    r = _t(np.random.default_rng(1).standard_normal(shape)) * _t(
        pack["inv_s"] > 0)
    top = tpo._level_from_entry(
        tpo.make_bundle({k: _t(v) for k, v in pack.items()}, use_pallas=True,
                        knobs=knobs)["top"], unit_diag=True)
    assert tpo._fused_cheb2(top, knobs) == fused
    assert (prob.precond_rz_hat is not None) == knobs.fused_rz
    if knobs.fused_rz:
        z, dot = prob.precond_rz_hat(r)
        assert (dot is not None) == rz
        assert z.dtype == torch.float32
    plain = _precond(level, knobs, use_pallas=False)
    if knobs.fused_rz:
        assert plain.precond_rz_hat(r)[1] is None


ENV = ("OFTPP_COARSEST_SWEEPS", "OFTPP_SMOOTH_SWEEPS", "OFTPP_SMOOTHER",
       "OFTPP_CHEB_LMAX", "OFTPP_CHEB_LMIN", "OFTPP_FUSED_CHEB",
       "OFTPP_MG_L1_GAMMA", "OFTPP_MG_DEEP_GAMMA", "OFTPP_FUSED_RZ",
       "OFTPP_PRECOND_F32")


@pytest.mark.parametrize("env,want", [
    ({}, tpo.SolverKnobs()),
    ({"OFTPP_SMOOTH_SWEEPS": "1"}, tpo.SolverKnobs(smooth_sweeps=1)),
    ({"OFTPP_SMOOTH_SWEEPS": "2"}, tpo.SolverKnobs(smooth_sweeps=2)),
    ({"OFTPP_FUSED_CHEB": "0"}, tpo.SolverKnobs(fused_cheb=False)),
    ({"OFTPP_FUSED_RZ": "0"}, tpo.SolverKnobs(fused_rz=False)),
    ({"OFTPP_SMOOTHER": "jacobi"}, tpo.SolverKnobs(smoother="jacobi")),
    ({"OFTPP_PRECOND_F32": "1", "OFTPP_CHEB_LMIN": "0.25",
      "OFTPP_CHEB_LMAX": "1.8", "OFTPP_COARSEST_SWEEPS": "12",
      "OFTPP_MG_L1_GAMMA": "1", "OFTPP_MG_DEEP_GAMMA": "2"},
     tpo.SolverKnobs(precond_f32=True, cheb_lmin_frac=0.25, cheb_lmax=1.8,
                     coarsest_sweeps=12, mg_l1_gamma=1, mg_deep_gamma=2)),
])
def test_knobs_from_env(env, want, monkeypatch):
    for v in ENV:
        monkeypatch.delenv(v, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tpo.SolverKnobs.from_env() == want


def test_knob_defaults_are_the_jax_package_s():
    """The JAX module read the same variables at import; with none of
    them set in this process its globals are the record's defaults."""
    d = tpo.SolverKnobs()
    assert (d.coarsest_sweeps, d.smoother, d.cheb_lmax, d.cheb_lmin_frac,
            d.mg_l1_gamma, d.mg_deep_gamma) == (24, "chebyshev", 2.0, 0.10,
                                                2, 1)
    assert d.smooth_sweeps == 1 and d.fused_cheb and d.fused_rz
    assert d.precond_dtype == torch.bfloat16
    assert tpo.SolverKnobs(precond_f32=True).precond_dtype == torch.float32
    assert tpo._JACOBI_OMEGA == jpo._JACOBI_OMEGA
    assert tpo._F32_CG_FLOOR == jpo._F32_CG_FLOOR
    theta_inv, c_pp, c_pd = tsp.cheb_coefs(2.0, 0.25)
    theta, j_pp, j_pd = jsp._cheb_coefs(2.0, 0.25)
    assert (theta_inv, c_pp, c_pd) == (1.0 / theta, j_pp, j_pd)
