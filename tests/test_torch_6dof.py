"""The closed 6DoF tank in the PyTorch port, on the CPU, against the JAX
package from the same numpy inputs.

The oracles of tests/test_6dof.py on the port (case artifacts; the
command line's build6dof, config and a bounded run; the steady-rotation
paraboloid; the Euler-rate coupling; the chamfer volume; the bounded
chamfer run), then the host code held to the JAX package bitwise (the
motion table's arrays and its interpolation, the geometry arrays, the
table reader), the closed tank's singular pressure solve, 3 steps of
`make_step(motion=...)` against the JAX step, and the CG iterations of 20
steps on the chamfered tutorial tank at a coarse mesh.

Tolerances. The 3-step parity: alpha 1e-5; p 1e-4 of its scale after
each field's fluid mean is removed (a closed tank's p is defined up to a
constant, which the two null-space projections may set apart); p_iters
±1; the velocities 1e-3 of the velocity field's scale (the largest |u|,
|v|, |w|), for test_torch_step.py's reason: the CG solves stop on other
iterates, and in the air (β = 1/ρ_air, a thousand times the water's) the
pressure's last bits become velocity noise of ~3e-5 m/s. One component
(v here, small at these times because the table tilts the tank mostly
about y) would hold that noise to its own scale only at 3e-2. The
rotation matrix: its product is held bitwise, and the whole matrix from
angles to 2 f32 ulps of 1, because XLA's sin and cos and PyTorch's differ
in the last bit on some 6% of f32 arguments. The singular solve: x to
1e-4 of its scale, both fluid means to 1e-6 of it, the iteration counts
equal.
"""

import collections
import os
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core import motion as jmo
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.manager import cases as jcases
from openfoam_tpp_tpu.mesh import build_box_geometry as jbox
from openfoam_tpp_tpu.mesh import build_chamfer_tank_geometry as jchamfer
from openfoam_tpp_tpu.ops.pallas import correction as jck
from openfoam_tpp_tpu.ops.pallas import mom_finish as jfk
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu.ops.pallas import mules_fct as jmf
from openfoam_tpp_tpu.ops.pallas import mules_flux as jmfx
from openfoam_tpp_tpu.solver import poisson as jpois
from openfoam_tpp_tpu.solver.timestep import geometry_arrays as jga
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu.utils import io as jio
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core import motion as tmo
from openfoam_tpp_tpu_torch.core.state import (CaseParams, init_state,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.mesh import (build_box_geometry,
                                         build_chamfer_tank_geometry,
                                         chamfer_tank_volume)
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.post.interface import liquid_height
from openfoam_tpp_tpu_torch.solver import frame as tfr
from openfoam_tpp_tpu_torch.solver import poisson as tpois
from openfoam_tpp_tpu_torch.solver.timestep import geometry_arrays
from openfoam_tpp_tpu_torch.solver.timestep import make_step as tmake
from openfoam_tpp_tpu_torch.utils import io as tio

FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
MOTION_FIELDS = ("times", "accel", "omega", "domega", "rot")
SMALL = {"Lx": 0.2, "Ly": 0.2, "Lz": 0.2, "mesh": 0.05, "duration": 0.1,
         "dt": 0.002}
QUIET = dict(log=lambda *a, **k: None, device="cpu")


def _angles(t):
    """Euler angles with large rates (test_6dof.py's coupling motion)."""
    return np.stack([0.5 * np.sin(3.0 * t), 0.4 * np.cos(2.0 * t),
                     0.6 * np.sin(4.0 * t)], -1)


def _tables():
    """A large-rate translation + rotation table (t, trans, rot_deg)."""
    tt = np.linspace(0.0, 2.0, 201)
    trans = np.stack([0.01 * np.sin(2 * tt), 0.02 * np.sin(3 * tt),
                      0.005 * np.sin(tt)], -1)
    return tt, trans, np.rad2deg(_angles(tt))


def _port_motion(jm):
    return tmo.motion_from_numpy(
        *(np.asarray(getattr(jm, k)) for k in MOTION_FIELDS), device="cpu")


# ------------------------------------------- the oracles of test_6dof.py

def test_setup_case_6dof_artifacts(tmp_path):
    """The JAX package's folder name, case.json and 6DoF.dat, byte for
    byte; the chamfer suffix and a copied table too."""
    d = tcases.setup_case_6dof(SMALL, str(tmp_path / "t"))
    dj = jcases.setup_case_6dof(SMALL, str(tmp_path / "j"))
    assert os.path.basename(d) == os.path.basename(dj)
    assert os.path.basename(d).startswith("case_6dof_")
    for rel in ("case.json", os.path.join("constant", "6DoF.dat")):
        with open(os.path.join(d, rel)) as f, open(os.path.join(dj, rel)) as g:
            assert f.read() == g.read(), rel
    assert os.path.isdir(os.path.join(d, "postProcessing"))
    t, _, _ = tio.read_6dof_table(os.path.join(d, "constant", "6DoF.dat"))
    assert len(t) == 100
    params = tcases.load_case_params(d)
    assert params == jcases.load_case_params(dj)
    assert params["model"] == "tank6dof" and params["Lz"] == 0.2
    assert d in [os.path.join(str(tmp_path / "t"), c)
                 for c in tcases.list_cases(str(tmp_path / "t"))]
    table = os.path.join(d, "constant", "6DoF.dat")
    c = tcases.setup_case_6dof({**SMALL, "chamfer": 0.2}, str(tmp_path / "c"),
                               motion_table=table)
    cj = jcases.setup_case_6dof({**SMALL, "chamfer": 0.2},
                                str(tmp_path / "cj"), motion_table=table)
    assert os.path.basename(c) == os.path.basename(cj)
    assert os.path.basename(c).endswith("_c0.2")


def test_cli_build6dof_config_and_bounded_run(tmp_path, capsys):
    """build6dof from a table scaled to the tank, config lists the case,
    and a bounded run_case keeps alpha in [0, 1] and finishes the case."""
    table = str(tmp_path / "scaled_6dof.dat")
    tio.generate_sine_motion_table(table, duration=0.1)
    t, trans, rot = tio.read_6dof_table(table)
    tio.write_6dof_table(table, t, trans * 0.01, rot * 0.5)
    base = str(tmp_path / "cases")
    assert tcli.main([
        "--headless", "--action", "build6dof", "--base-dir", base,
        "--params", "Lx=0.2,Ly=0.2,Lz=0.2,mesh=0.05,duration=0.1,dt=0.002",
        "--motion-table", table]) == 0
    cases = tcases.list_cases(base)
    assert len(cases) == 1 and cases[0].startswith("case_6dof_")
    d = os.path.join(base, cases[0])
    _, trans2, _ = tio.read_6dof_table(os.path.join(d, "constant", "6DoF.dat"))
    np.testing.assert_allclose(trans2, trans * 0.01, atol=1e-8)

    assert tcli.main(["--headless", "--action", "config",
                      "--base-dir", base]) == 0
    out = capsys.readouterr().out
    assert cases[0] in out and "6DoF closed-tank defaults" in out
    assert "[new]" in out

    stats = trunner.run_case(d, controls=TControls(p_max_iters=10), **QUIET)
    assert stats["steps"] > 0
    a = tio.load_checkpoint(tio.list_checkpoints(d)[-1][1])["alpha"]
    assert np.isfinite(a).all()
    assert a.min() >= -1e-5 and a.max() <= 1 + 1e-5
    assert tcases.is_case_done(d)
    assert tcli.main(["--headless", "--action", "config",
                      "--base-dir", base]) == 0
    assert f"{cases[0]}  [done]" in capsys.readouterr().out


def test_build6dof_native_table_falls_back_to_the_sine_table(tmp_path,
                                                             capsys):
    """--native-table without a built native/gen6dof writes the Python
    sine table, as the JAX package does."""
    with mock.patch.object(tcli, "_default_6dof_table", lambda: None):
        assert tcli.main(["--headless", "--action", "build6dof",
                          "--base-dir", str(tmp_path), "--params",
                          "Lx=0.2,Ly=0.2,Lz=0.2,mesh=0.05,duration=0.1",
                          "--native-table"]) == 0
    assert "not built" in capsys.readouterr().out
    (name,) = tcases.list_cases(str(tmp_path))
    t, _, _ = tio.read_6dof_table(
        os.path.join(str(tmp_path), name, "constant", "6DoF.dat"))
    assert len(t) == 100 and t[-1] == 0.1


def test_steady_rotation_paraboloid():
    """Constant Ω about z: the time-averaged surface's curvature within
    0.5–2× of Ω²/(2g) on a coarse grid (the centrifugal force)."""
    omega = 6.0  # rad/s
    L, depth = 0.1, 0.05
    tt = np.linspace(0.0, 10.0, 201)
    rot_deg = np.stack([np.zeros_like(tt), np.zeros_like(tt),
                        np.rad2deg(omega * tt)], -1)
    motion = tmo.TableMotion.from_table(tt, np.zeros((len(tt), 3)), rot_deg,
                                        device="cpu")
    np.testing.assert_allclose(motion.angular_velocity(0.5).numpy(),
                               [0, 0, omega], atol=1e-3)
    geom = build_box_geometry(L, L, 0.1, mesh=0.0125, open_top=False)
    step = tmake(geom, TProps(), TControls(p_max_iters=15), motion=motion,
                 device="cpu")
    state = init_state(geom, fill_height=-0.05 + depth, dt0=1e-3,
                       device="cpu")
    params = CaseParams.make(R=0.0, freq=0.0, duration=1.0, device="cpu")

    def advance(s):
        for _ in range(60):
            s, _ = step(s, params)
        return s

    # The (essentially undamped) surface sloshes about the paraboloid:
    # fit the curvature of the time-averaged surface.
    state = advance(state)   # initial transient
    n_snap = 8
    eta = 0.0
    for _ in range(n_snap):
        state = advance(state)
        eta = eta + liquid_height(state.alpha, geom).numpy()
    eta = eta / n_snap
    x, y, _ = geom.cell_centers()
    r2 = x[:, None] ** 2 + y[None, :] ** 2
    A = np.stack([np.ones_like(r2).ravel(), r2.ravel()], -1)
    c, *_ = np.linalg.lstsq(A, eta.ravel(), rcond=None)
    c1_theory = omega ** 2 / (2 * 9.81)
    assert 0.5 * c1_theory < c[1] < 2.0 * c1_theory, (c[1], c1_theory)


class _AnalyticMotion:
    """Euler angles a(t), b(t), c(t) with exact rates (TableMotion's
    orientation / angular_* surface)."""

    def orientation(self, t):
        return torch.stack([0.5 * torch.sin(3.0 * t), 0.4 * torch.cos(2.0 * t),
                            0.6 * torch.sin(4.0 * t)])

    def angular_velocity(self, t):
        return torch.stack([1.5 * torch.cos(3.0 * t), -0.8 * torch.sin(2.0 * t),
                            2.4 * torch.cos(4.0 * t)])

    def angular_acceleration(self, t):
        return torch.stack([-4.5 * torch.sin(3.0 * t),
                            -1.6 * torch.cos(2.0 * t),
                            -9.6 * torch.sin(4.0 * t)])


def test_angular_rates_coupling():
    """dω of frame.angular_rates against a central difference of ω_body(t)
    on rates up to 2.4 rad/s: the Euler-rate coupling term (dropping it
    fails by ~30% on x and y)."""
    m = _AnalyticMotion()
    h = 1e-3
    for t0 in (0.2, 0.7, 1.3):
        t0 = torch.tensor(np.float32(t0))
        _, dom = tfr.angular_rates(m, t0)
        fd = (tfr.angular_rates(m, t0 + h)[0]
              - tfr.angular_rates(m, t0 - h)[0]) / (2.0 * h)
        np.testing.assert_allclose(dom.numpy(), fd.numpy(), rtol=0.02,
                                   atol=2e-3)


def test_chamfer_tank_volume():
    """The chamfered prism's cut-cell volume to <1% of the exact one,
    apertures in [0, 1], the boundary sealed, and chamfer=0 the plain box
    bitwise."""
    Lx, Ly, Lz, c = 20.0, 20.0, 40.0, 0.2
    g = build_chamfer_tank_geometry(Lx, Ly, Lz, mesh=1.0, chamfer=c)
    vol = float(np.sum(g.vfrac)) * g.cell_volume
    exact = chamfer_tank_volume(Lx, Ly, Lz, c)
    assert abs(vol - exact) / exact < 0.01, (vol, exact)
    for a in (g.ax, g.ay, g.az):
        assert a.min() >= 0.0 and a.max() <= 1.0
    assert np.all(g.ax[0] == 0) and np.all(g.ax[-1] == 0)
    assert np.all(g.az[:, :, -1] == 0)  # closed top
    g0 = build_chamfer_tank_geometry(Lx, Ly, Lz, mesh=2.0, chamfer=0.0)
    gb = build_box_geometry(Lx, Ly, Lz, mesh=2.0)
    np.testing.assert_array_equal(g0.vfrac, gb.vfrac)
    np.testing.assert_array_equal(g0.az, gb.az)


def test_run_6dof_chamfer_bounded(tmp_path):
    """A short run on the chamfered tank under the rotating-frame forces
    stays bounded and writes its checkpoints."""
    d = tcases.setup_case_6dof(
        {"Lx": 0.2, "Ly": 0.2, "Lz": 0.4, "mesh": 0.025, "chamfer": 0.2,
         "duration": 0.1, "dt": 0.002}, str(tmp_path))
    trunner.run_case(d, **QUIET)
    chks = tio.list_checkpoints(d)
    assert len(chks) >= 2
    a = tio.load_checkpoint(chks[-1][1])["alpha"]
    assert np.isfinite(a).all()
    assert a.min() >= -1e-5 and a.max() <= 1 + 1e-5


# ---------------------------------------------- host code, bitwise to JAX

def test_motion_table_and_interpolation_bitwise(tmp_path):
    """The gen6DoF table file, its reader, `TableMotion.from_table`'s
    arrays (resampled as build_case_motion does, and not) and the four
    interpolations at knots, between knots and beyond both ends."""
    tj, tt = str(tmp_path / "j.dat"), str(tmp_path / "t.dat")
    jio.generate_sine_motion_table(tj)
    tio.generate_sine_motion_table(tt)
    with open(tj) as f, open(tt) as g:
        assert f.read() == g.read()
    rows = tio.read_6dof_table(tt)
    for a, b in zip(rows, jio.read_6dof_table(tt)):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    for resample in (None, 0.05):
        jm = jmo.TableMotion.from_table(*rows, resample_dt=resample)
        tm = tmo.TableMotion.from_table(*rows, resample_dt=resample,
                                        device="cpu")
        for k in MOTION_FIELDS:
            got = getattr(tm, k)
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy(), np.asarray(getattr(jm, k))), k
        assert tm.has_rotation == jm.has_rotation is True
        knots = np.asarray(jm.times)
        ts = np.concatenate([knots[[0, 1, len(knots) // 2, -2, -1]],
                             [-1.0, 0.013, 3.3337, 17.77, 39.99, 40.5]])
        for t in ts.astype(np.float32):
            for fn in ("acceleration", "angular_velocity",
                       "angular_acceleration", "orientation"):
                want = np.asarray(getattr(jm, fn)(jnp.float32(t)))
                got = getattr(tm, fn)(torch.tensor(t)).numpy()
                assert np.array_equal(got, want), (resample, fn, t)
    still = tmo.TableMotion.from_table(rows[0], rows[1], 0 * rows[2],
                                       device="cpu")
    assert still.has_rotation is False


def test_rotation_matrix():
    """The product Rz·Ry·Rx bitwise on the same factors (both sum with
    fused multiply-adds); from the angles to 2 ulps (sin and cos differ
    in the last bit between XLA and PyTorch)."""
    rng = np.random.default_rng(11)
    for a in rng.uniform(-1.2, 1.2, (40, 3)).astype(np.float32):
        want = np.asarray(jmo.rotation_matrix(jnp.asarray(a)))
        got = tmo.rotation_matrix(torch.from_numpy(a)).numpy()
        assert np.abs(got - want).max() <= 2 * np.finfo(np.float32).eps
        f = [rng.uniform(-1, 1, (3, 3)).astype(np.float32) for _ in range(3)]
        want = np.asarray(jnp.asarray(f[0]) @ jnp.asarray(f[1])
                          @ jnp.asarray(f[2]))
        got = tmo.matmul3(tmo.matmul3(*map(torch.from_numpy, f[:2])),
                          torch.from_numpy(f[2])).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["box", "chamfer"])
def test_geometry_arrays_bitwise(kind):
    args = (0.2, 0.24, 0.4, 0.025)
    if kind == "box":
        pairs = [(jbox(*args), build_box_geometry(*args)),
                 (jbox(*args, z0=0.0, open_top=True),
                  build_box_geometry(*args, z0=0.0, open_top=True))]
    else:
        pairs = [(jchamfer(*args, chamfer=c), build_chamfer_tank_geometry(
            *args, chamfer=c)) for c in (0.0, 0.2, 0.3)]
    for jg, tg in pairs:
        for k in ("vfrac", "ax", "ay", "az", "top_open"):
            a, b = getattr(tg, k), getattr(jg, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for k in ("geo", "H", "D", "shape", "spacing", "origin"):
            assert getattr(tg, k) == getattr(jg, k), k
    assert np.all(pairs[-1][1].ax[-1] == 0)   # sealed +x: the kernels run


def test_face_coordinates_and_frame_terms():
    """Face coordinates bitwise (broadcastable 1-D tensors); the angular
    rates and the rotating-frame acceleration to f32 rounding."""
    jg = jbox(0.08, 0.08, 0.12, 0.01)
    tg = build_box_geometry(0.08, 0.08, 0.12, 0.01)
    from openfoam_tpp_tpu.solver import frame as jfr

    rng = np.random.default_rng(5)
    tt, trans, rot = _tables()
    jm = jmo.TableMotion.from_table(tt, trans, rot)
    tm = _port_motion(jm)
    t = np.float32(0.731)
    oj, dj = jfr.angular_rates(jm, jnp.float32(t))
    ot, dt_ = tfr.angular_rates(tm, torch.tensor(t))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dt_.numpy(), np.asarray(dj), rtol=1e-5,
                               atol=1e-5)
    for ax in range(3):
        jc = jfr.face_coordinates(jg, ax)
        tc = tfr.face_coordinates(tg, ax, device="cpu")
        for a, b in zip(tc, jc):
            assert a.dim() == 3 and sorted(a.shape)[:2] == [1, 1]
            assert np.array_equal(a.numpy(), np.asarray(b))
        shape = [n + (d == ax) for d, n in enumerate(tg.shape)]
        vel = [rng.standard_normal(shape).astype(np.float32)
               for _ in range(3)]
        want = np.asarray(jfr.rotational_acceleration(
            ax, jc, oj, dj, *map(jnp.asarray, vel)))
        got = tfr.rotational_acceleration(
            ax, tc, torch.tensor(np.array(oj)), torch.tensor(np.array(dj)),
            *map(torch.from_numpy, vel)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------ the closed-tank solve

def test_singular_solve_matches_jax():
    """`solve_pcg` on a closed box's operator (top_open None: the constant
    null space projected out) against the JAX solve from the same b, which
    has a nonzero mean."""
    jg = jbox(0.08, 0.08, 0.12, 0.01)
    props = JProps()
    alpha = np.asarray(jinit(jg, fill_height=0.0).alpha)
    rho = (alpha * props.rho1 + (1 - alpha) * props.rho2).astype(np.float32)
    rng = np.random.default_rng(7)
    fluid = jg.vfrac > 0
    b = np.where(fluid, rng.standard_normal(jg.shape) + 0.3, 0.0)
    b = b.astype(np.float32)
    sp = tuple(float(s) for s in jg.spacing)
    ga_j = jga(jg)
    kw = dict(tol_rel=1e-3, tol_abs=1e-8, tol_rel_b=3e-4, max_iters=50)

    @jax.jit
    def jsolve(rho, b):
        prob = jpois.build_poisson(ga_j, sp, rho, None)
        return jpois.solve_pcg(prob, b, jnp.zeros_like(b), **kw)

    x_j, _, it_j = jsolve(jnp.asarray(rho), jnp.asarray(b))
    ga_t = geometry_arrays(build_box_geometry(0.08, 0.08, 0.12, 0.01),
                           device="cpu")
    tprob = tpois.build_poisson(ga_t, sp, torch.from_numpy(rho), None)
    assert tprob.singular
    x_t, _, it_t = tpois.solve_pcg(tprob, torch.from_numpy(b),
                                   torch.zeros_like(torch.from_numpy(b)), **kw)
    x_j, x_t = np.asarray(x_j), x_t.numpy()
    assert int(it_j) > 3 and int(it_t) == int(it_j)
    scale = np.abs(x_j).max()
    for x in (x_j, x_t):
        assert abs(x[fluid].mean()) <= 1e-6 * scale
    assert np.abs(x_t - x_j).max() <= 1e-4 * scale


# ---------------------------------------------------- the step, 3 steps

FUSED = ("momentum_rhs", "correct_divmax", "momentum_finish")


def _interpreted(module, name, calls):
    """A JAX Pallas entry point in interpret mode, counting its calls."""
    fn = getattr(module, name)

    def run(*a, **k):
        calls[name] += 1
        return fn(*a, **{**k, "interpret": True})

    return mock.patch.object(module, name, run)


@pytest.mark.parametrize("path", ["a_plain", "c_default"])
def test_three_steps_match_jax(path, monkeypatch):
    """make_step(motion=...) on an 8×8×12 closed box driven by a large-rate
    table, from rest, against the JAX step: (a) the plain paths (f32 FCT),
    (c) SolverControls(use_pallas=True), the JAX kernels in interpret
    mode. In (c) the momentum RHS and the closed-top projection epilogue
    run on both sides, and the finish kernel on neither, even asked for:
    the rotating frame's sources come before the wall mask."""
    kw = dict(Lx=0.08, Ly=0.08, Lz=0.12, mesh=0.01)
    jg = jbox(**kw)
    js = jinit(jg, fill_height=0.0, dt0=2e-3)
    jm = jmo.TableMotion.from_table(*_tables())
    jp = JParams.make(R=0.0, freq=0.0, duration=1.0)
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
        jstep = jax.jit(jmake(jg, JProps(), jc, motion=jm))
        s, jdiags = js, []
        for _ in range(3):
            s, d = jstep(s, jp)
            jdiags.append(d)
        jax.block_until_ready(s)
    ref = {k: np.asarray(getattr(s, k)) for k in FIELDS}

    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu")
    tstep = tmake(build_box_geometry(**kw), TProps(), tc,
                  motion=_port_motion(jm), device="cpu")
    tp = CaseParams.make(R=0.0, freq=0.0, duration=1.0, device="cpu")
    tdiags = []
    spies = [mock.patch.object(m, n, wraps=getattr(m, n)) for m, n in
             ((tmrk, "momentum_rhs"), (tck, "correct_divmax"),
              (tfk, "momentum_finish"))]
    with spies[0] as m1, spies[1] as m2, spies[2] as m3:
        for _ in range(3):
            ts, d = tstep(ts, tp)
            tdiags.append(d)
    got = state_to_numpy(ts)
    on = path == "c_default"
    for name, spy in zip(FUSED, (m1, m2, m3)):
        want = on and name != "momentum_finish"
        assert (jcalls[name] > 0) == want, name
        assert spy.call_count == (3 if want else 0), name
    if on:
        assert all(c.kwargs["open_top"] is False for c in m2.call_args_list)

    vscale = max(np.abs(ref[k]).max() for k in ("u", "v", "w"))
    assert vscale > 1e-2   # the frame forces set the fluid moving
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=1e-6)
    assert np.abs(got["alpha"] - ref["alpha"]).max() <= 1e-5
    for k in ("u", "v", "w"):
        assert np.abs(got[k] - ref[k]).max() <= 1e-3 * vscale, k
    fluid = jg.vfrac > 0
    pj = ref["p"] - ref["p"][fluid].mean()
    pt = got["p"] - got["p"][fluid].mean()
    assert np.abs(pt - pj).max() <= 1e-4 * np.abs(pj).max()
    for dj, dt_ in zip(jdiags, tdiags):
        assert abs(int(dt_.p_iters) - int(dj.p_iters)) <= 1
        assert float(dt_.alpha_min) >= 0.0 and float(dt_.alpha_max) <= 1.0


def test_rotating_motion_with_spmd_raises():
    """A rotating table shards (it raised before the rank form ran the
    6DoF tank; the JAX package builds that pair too): the 8×8×12 closed
    box filled to z = 0, 3 steps from rest of `SpmdCtx(4)` (x-slabs of 2
    planes) against `SpmdCtx(1)`, with the closed-top epilogue island:
    the first step's alpha and dt bitwise, p_iters equal, and after 3
    steps the 3-step bounds above (on the CPU the islands' plain versions
    sum the curvature dot slab by slab, so the CG iterates differ in
    their last bits; on the card the 4-shard step is bitwise the
    1-shard one, chip_smoke.py phase 3b). A translating table shards as
    before."""
    tg = build_box_geometry(0.08, 0.08, 0.12, 0.01)
    tt, trans, rot = _tables()
    moving = tmo.TableMotion.from_table(tt, trans, 0 * rot, device="cpu")
    tmake(tg, motion=moving, spmd=SpmdCtx(4), device="cpu")
    rotating = tmo.TableMotion.from_table(tt, trans, rot, device="cpu")
    tp = CaseParams.make(R=0.0, freq=0.0, duration=1.0, device="cpu")
    got = {}
    for n in (4, 1):
        step = tmake(tg, TProps(), TControls(use_pallas=True),
                     motion=rotating, spmd=SpmdCtx(n), device="cpu")
        s = init_state(tg, fill_height=0.0, dt0=2e-3, device="cpu")
        iters, first = [], None
        with mock.patch.object(tck, "correct_divmax_h",
                               wraps=tck.correct_divmax_h) as corr:
            for _ in range(3):
                s, d = step(s, tp)
                iters.append(int(d.p_iters))
                first = first or state_to_numpy(s)
        assert corr.call_count == 3 * n
        assert all(c.kwargs["open_top"] is False
                   for c in corr.call_args_list)
        got[n] = (first, state_to_numpy(s), iters)
    (f4, s4, it4), (f1, s1, it1) = got[4], got[1]
    assert it4 == it1
    for k in ("alpha", "dt", "t"):
        np.testing.assert_array_equal(f4[k], f1[k], err_msg=k)
    vscale = max(np.abs(s1[k]).max() for k in ("u", "v", "w"))
    assert vscale > 1e-2   # the frame forces set the fluid moving
    np.testing.assert_array_equal(s4["step"], s1["step"])
    assert np.abs(s4["alpha"] - s1["alpha"]).max() <= 1e-5
    for k in ("u", "v", "w"):
        assert np.abs(s4[k] - s1[k]).max() <= 1e-3 * vscale, k
    fluid = tg.vfrac > 0
    p4, p1 = (x["p"] - x["p"][fluid].mean() for x in (s4, s1))
    assert np.abs(p4 - p1).max() <= 1e-4 * np.abs(p1).max()


def test_tutorial_tank_p_iters_track_jax(tmp_path):
    """The chamfered tutorial tank at mesh 1.0 (20×20×40, the shape class
    chip_smoke.py phase 8 runs at 80×80×160) under the gen6DoF table, 20
    steps from rest on the plain paths: the CG iterations per step, which
    climb from 6 to ~15 as the closed tank sloshes, within 1 of the JAX
    step's at every step."""
    tank = dict(Lx=20.0, Ly=20.0, Lz=40.0, mesh=1.0, chamfer=0.2, z0=-20.0)
    rows = tio.read_6dof_table(tio.generate_sine_motion_table(
        str(tmp_path / "6DoF.dat")))
    jm = jmo.TableMotion.from_table(*rows, resample_dt=0.05)
    jg = jchamfer(**tank)
    js = jinit(jg, fill_height=0.0, dt0=0.01)
    jstep = jax.jit(jmake(jg, JProps(), JControls(), motion=jm))
    jp = JParams.make(R=0.0, freq=0.0, duration=40.0)
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in FIELDS},
                          device="cpu")
    tstep = tmake(build_chamfer_tank_geometry(**tank), TProps(),
                  TControls(fct_bf16=False), motion=_port_motion(jm),
                  device="cpu")
    tp = CaseParams.make(R=0.0, freq=0.0, duration=40.0, device="cpu")
    j_it, t_it = [], []
    for _ in range(20):
        js, dj = jstep(js, jp)
        ts, dt_ = tstep(ts, tp)
        j_it.append(int(dj.p_iters))
        t_it.append(int(dt_.p_iters))
    assert max(j_it[10:]) >= 14, j_it   # the sloshing tank's solves
    assert all(abs(a - b) <= 1 for a, b in zip(j_it, t_it)), (j_it, t_it)
