"""The port's case path against the JAX package's, on the CPU: the step
with two Chebyshev sweeps (the fused cheb2 route in both packages),
probes, checkpoints across the packages, `run_case`, resume and interface
extraction on the tiny verification case.

The JAX package reads OFTPP_SMOOTH_SWEEPS into a module global at import;
the `jax_sweeps2` fixture sets that attribute for one test (it is read
when `jit` traces) and clears the JAX runner's advance cache, which is
not keyed by it. The port reads the variable when its step is built.

Tolerances. The step: the one-sweep step's bounds (alpha 1e-5; u, v, w 1e-3 and p 1e-4
of scale; p_iters ±1), for the reasons given in test_torch_step.py. The
tiny case (31 steps, both packages on their plain paths with the bf16
V-cycle, whose rounding differs between XLA and PyTorch): measured alpha
6.5e-5, velocities 3.8e-5 and p 5.7e-6 of scale, dt 1.1e-5 relative,
probe p 2.5e-4 of scale (sampled every step, transient included), η and
the interface files 3e-7; each held to at most ten times that.
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
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import SimState as JState
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.manager import cases as jcases
from openfoam_tpp_tpu.manager import cli as jcli
from openfoam_tpp_tpu.manager import runner as jrunner
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.ops.pallas import correction as jck
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu.ops.pallas import mules_fct as jmf
from openfoam_tpp_tpu.ops.pallas import mules_flux as jmfx
from openfoam_tpp_tpu.ops.pallas import seven_point as jsp
from openfoam_tpp_tpu.post import probes as jprobes
from openfoam_tpp_tpu.solver import poisson as jpo
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu.utils import io as jio
from openfoam_tpp_tpu.utils import naming as jnaming
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp
from openfoam_tpp_tpu_torch.post import interface as tinterface
from openfoam_tpp_tpu_torch.post import isosurface as tiso
from openfoam_tpp_tpu_torch.post import probes as tprobes
from openfoam_tpp_tpu_torch.solver.timestep import make_step as tmake
from openfoam_tpp_tpu_torch.utils import io as tio
from openfoam_tpp_tpu_torch.utils import naming as tnaming

TANK = dict(H=0.04, D=0.048, mesh=0.004, geo="flat", round_to=4)
# The verification case of the repository's verify recipe.
TINY = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", R=0.002, freq=3.0,
            duration=0.1, dt=0.0005, ramp=-1)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")


@pytest.fixture
def jax_sweeps2(monkeypatch):
    monkeypatch.setattr(jpo, "_SMOOTH_SWEEPS", 2)
    jrunner._ADVANCE_CACHE.clear()
    yield
    jrunner._ADVANCE_CACHE.clear()


def _counted(module, name, calls, **extra):
    fn = getattr(module, name)

    def run(*a, **k):
        calls[name] += 1
        return fn(*a, **{**k, **extra})

    return mock.patch.object(module, name, run)


def _jax_numpy(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def test_step_with_two_sweeps_matches_jax(jax_sweeps2, monkeypatch):
    """`use_pallas=True` and OFTPP_SMOOTH_SWEEPS=2 on the 16×16×10 tank,
    3 steps: both packages take the fused cheb2 entry and exit smoothers
    (JAX in interpret mode), once per V-cycle."""
    n_steps = 3
    jg = jbuild(**TANK)
    assert jsp.supported(jg.shape, jnp.bfloat16)
    js = jinit(jg)
    jp = JParams.make(R=0.004, freq=1.88, duration=0.5)
    jcalls = collections.Counter()
    with _counted(jmf, "fct_iter", jcalls, interpret=True), \
            _counted(jmfx, "flux_all", jcalls, interpret=True), \
            _counted(jmrk, "momentum_rhs", jcalls, interpret=True), \
            _counted(jck, "correct_divmax", jcalls, interpret=True), \
            _counted(jsp, "cheb2_pre_7pt", jcalls), \
            _counted(jsp, "cheb2_post_7pt", jcalls), \
            _counted(jsp, "cheb2_post_dot_7pt", jcalls):
        jstep = jax.jit(jmake(jg, JProps(), JControls(use_pallas=True)))
        s, jdiags = js, []
        for _ in range(n_steps):
            s, d = jstep(s, jp)
            jdiags.append(d)
        jax.block_until_ready(s)
    ref = _jax_numpy(s)
    # Traced once each: the first V-cycle and the one in the CG loop.
    assert jcalls["cheb2_pre_7pt"] > 0 and jcalls["cheb2_post_dot_7pt"] > 0
    assert jcalls["cheb2_post_7pt"] == 0

    monkeypatch.setenv("OFTPP_SMOOTH_SWEEPS", "2")
    tstep = tmake(tbuild(**TANK), TProps(), TControls(use_pallas=True),
                  device="cpu")
    monkeypatch.delenv("OFTPP_SMOOTH_SWEEPS")   # read when the step was built
    ts = state_from_numpy(_jax_numpy(js), device="cpu")
    tp = params_from_numpy({k: np.asarray(getattr(jp, k))
                            for k in ("orbit_radius", "omega", "ramp_time")},
                           device="cpu")
    tcalls = collections.Counter()
    tdiags = []
    with _counted(tsp, "cheb2_pre_7pt", tcalls), \
            _counted(tsp, "cheb2_post_7pt", tcalls), \
            _counted(tsp, "cheb2_post_dot_7pt", tcalls):
        for _ in range(n_steps):
            ts, d = tstep(ts, tp)
            tdiags.append(d)
    got = state_to_numpy(ts)
    vcycles = sum(int(d.p_iters) + 1 for d in tdiags)
    assert tcalls == {"cheb2_pre_7pt": vcycles, "cheb2_post_dot_7pt": vcycles}

    assert float(np.abs(ref["w"]).max()) > 1e-3   # the fluid is moving
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=1e-6)
    assert np.abs(got["alpha"] - ref["alpha"]).max() <= 1e-5
    for k in ("u", "v", "w"):
        assert np.abs(got[k] - ref[k]).max() <= 1e-3 * np.abs(ref[k]).max(), k
    assert np.abs(got["p"] - ref["p"]).max() <= 1e-4 * np.abs(ref["p"]).max()
    for dj, dt_ in zip(jdiags, tdiags):
        assert abs(int(dt_.p_iters) - int(dj.p_iters)) <= 1


def _random_state(shape, seed=0):
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"alpha": rng.uniform(0, 1, shape).astype(np.float32),
            "u": f(nx + 1, ny, nz), "v": f(nx, ny + 1, nz),
            "w": f(nx, ny, nz + 1), "p": 100.0 * f(*shape),
            "t": np.float32(0.1375), "dt": np.float32(2.5e-3),
            "step": np.int32(41)}


def _jax_state(d):
    return JState(**{k: jnp.asarray(v) for k, v in d.items()})


def test_sample_row_matches_jax():
    """One state through both samplers, to 1e-6 of each value's scale;
    the probe constants are equal."""
    jg, tg = jbuild(**TANK), tbuild(**TANK)
    d = _random_state(jg.shape)
    pts, cols = jprobes.default_probe_points(jg), jprobes.default_wave_columns(jg)
    np.testing.assert_array_equal(pts, tprobes.default_probe_points(tg))
    np.testing.assert_array_equal(cols, tprobes.default_wave_columns(tg))
    # An off-centre point too: every trilinear weight is then non-trivial.
    pts = np.vstack([pts, [[0.0031, -0.0047, 0.0213]]])
    jpack = jprobes.probe_pack(jg, pts, cols)
    tpack = tprobes.probe_pack(tg, pts, cols, device="cpu")
    for k in jpack:
        np.testing.assert_array_equal(np.asarray(jpack[k]), tpack[k].numpy())
    ref = np.asarray(jprobes.sample_row(_jax_state(d), jpack))
    ts = state_from_numpy(d, device="cpu")
    got = tprobes.sample_row(ts, tpack)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6 * 100.0)
    sampler, width = tprobes.make_probe_sampler(tg, pts, cols, device="cpu")
    assert width == len(ref) and torch.equal(sampler(ts), got)
    np.testing.assert_allclose(
        tprobes.sample_cell_field(ts.p, pts, tg).numpy(),
        np.asarray(jprobes.sample_cell_field(jnp.asarray(d["p"]), pts, jg)),
        rtol=1e-6, atol=1e-4)


def test_probe_writer_files_byte_equal(tmp_path):
    """Equal rows give equal files, resume dedup included."""
    rng = np.random.default_rng(2)
    pts = np.array([[0.0, 0.0, 0.01], [0.0, 0.0, 0.03]])
    times = np.cumsum(rng.uniform(1e-4, 3e-3, 12)).astype(np.float32)
    rows = (rng.standard_normal((12, 2)) * [100.0, 0.1]).astype(np.float32)
    paths = []
    for mod, name in ((jprobes, "j"), (tprobes, "t")):
        case = str(tmp_path / name)
        w = mod.ProbeWriter(case, pts, "p", start_time=0.0)
        w.append_rows(times[:7], rows[:7])
        w.append(float(times[7]), rows[7])
        # A second writer over the same file skips what is recorded.
        w2 = mod.ProbeWriter(case, pts, "p", start_time=0.0)
        w2.append_rows(times[5:], rows[5:])
        paths.append(w2.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and a.count(b"\n") == 4 + 12


def test_checkpoint_crosses_the_packages(tmp_path):
    """JAX → port → JAX with equal arrays, same file name and keys."""
    d = _random_state((6, 5, 4), seed=3)
    os.makedirs(tmp_path / "j")
    jpath = jio.save_checkpoint(str(tmp_path / "j"), _jax_state(d))
    payload = tio.load_checkpoint(jpath)
    tstate = tio.to_state(payload, device="cpu")
    assert tstate.t.dtype == torch.float32 and tstate.step.dtype == torch.int32
    os.makedirs(tmp_path / "t")
    tpath = tio.save_checkpoint(str(tmp_path / "t"), tstate,
                                extra={"note": np.arange(3)})
    assert os.path.basename(tpath) == os.path.basename(jpath) \
        == "chk_t0.137500.npz"
    assert not [f for f in os.listdir(tmp_path / "t") if "tmp" in f]
    back = jio.to_state(jio.load_checkpoint(tpath))
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), d[k])
        assert np.asarray(getattr(back, k)).dtype == d[k].dtype
    with np.load(jpath) as zj, np.load(tpath) as zt:
        assert set(zt.files) == set(zj.files) | {"extra_note"}
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype and zt[k].shape == zj[k].shape
    assert tio.list_checkpoints(str(tmp_path / "t")) == \
        jio.list_checkpoints(str(tmp_path / "t"))
    assert tio.latest_checkpoint(str(tmp_path / "none")) is None


def _table(path):
    lines = open(path).read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    return head, np.array([[float(v) for v in ln.split()]
                           for ln in lines if not ln.startswith("#")])


def _csv(path):
    lines = open(path).read().splitlines()
    return lines[0], np.array([ln.split(",") for ln in lines[1:]], float)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The tiny case through both packages' `setup_case`, `run_case`
    (default controls, so both run their plain paths on the CPU), a second
    `run_case` of the port, and both interface extractions."""
    base = tmp_path_factory.mktemp("cases")
    jdir = jcases.setup_case(TINY, str(base / "jax"))
    tdir = tcases.setup_case(TINY, str(base / "torch"))
    jrunner._ADVANCE_CACHE.clear()
    jlog, tlog, tlog2 = [], [], []
    jstats = jrunner.run_case(jdir, log=jlog.append)
    jrunner._ADVANCE_CACHE.clear()
    tstats = trunner.run_case(tdir, log=tlog.append, device="cpu")
    tstats2 = trunner.run_case(tdir, log=tlog2.append, device="cpu")
    with mock.patch("builtins.print"):
        jcli.action_interface(jdir)
        assert tcli.main(["--headless", "--base-dir", str(base / "torch"),
                          "--case", os.path.basename(tdir), "--action",
                          "interface", "--device", "cpu"]) == 0
    return dict(jdir=jdir, tdir=tdir, jstats=jstats, tstats=tstats,
                tstats2=tstats2, jlog=jlog, tlog=tlog, tlog2=tlog2)


def test_run_case_writes_what_jax_writes(tiny_runs):
    r = tiny_runs
    jdir, tdir = r["jdir"], r["tdir"]
    assert os.path.basename(jdir) == os.path.basename(tdir)
    for rel in ("case.json", os.path.join("constant", "6DoF.dat")):
        assert open(os.path.join(jdir, rel), "rb").read() == \
            open(os.path.join(tdir, rel), "rb").read(), rel
    for k in ("n_cells", "steps", "sim_seconds"):
        assert r["tstats"][k] == r["jstats"][k], k
    assert r["tstats"]["steps"] == sum(i["steps"]
                                       for i in r["tstats"]["intervals"])
    assert 0.0 < r["tstats"]["io_seconds"] < r["tstats"]["wall_seconds"]
    # Same log lines: mesh, one per write, done.
    assert len(r["tlog"]) == len(r["jlog"]) == 4
    assert r["tlog"][0] == r["jlog"][0]
    assert [ln.split("dt =")[0] for ln in r["tlog"][1:3]] == \
        [ln.split("dt =")[0] for ln in r["jlog"][1:3]] == \
        ["Time = 0.05 s  ", "Time = 0.1 s  "]

    # Checkpoints: same names; every write time is the f32 target bitwise.
    jchk, tchk = jio.list_checkpoints(jdir), tio.list_checkpoints(tdir)
    names = [os.path.basename(p) for _, p in tchk]
    assert names == [os.path.basename(p) for _, p in jchk] == [
        "chk_t0.000000.npz", "chk_t0.050000.npz", "chk_t0.100000.npz"]
    w32 = np.float32(0.05)
    for k, ((_, jp), (_, tp)) in enumerate(zip(jchk, tchk)):
        a, b = jio.load_checkpoint(jp), tio.load_checkpoint(tp)
        assert float(b["t"]) == float(a["t"]) == float(np.float32(k) * w32)
        assert int(b["step"]) == int(a["step"])
        np.testing.assert_allclose(b["dt"], a["dt"], rtol=1e-4)
        assert np.abs(b["alpha"] - a["alpha"]).max() <= 5e-4
        assert b["alpha"].min() >= 0.0 and b["alpha"].max() <= 1.0
        for f in ("u", "v", "w"):
            assert np.abs(b[f] - a[f]).max() <= 2e-4 * max(
                np.abs(a[f]).max(), 1e-30), f
        assert np.abs(b["p"] - a["p"]).max() <= 5e-5 * max(
            np.abs(a["p"]).max(), 1e-30)

    # Probe files: same header, one row per solver step, same times.
    for name, tol in (("p", 2e-3), ("eta", None)):
        jh, ja = _table(os.path.join(jdir, "postProcessing", "probes", "0", name))
        th, ta = _table(os.path.join(tdir, "postProcessing", "probes", "0", name))
        assert th == jh and ta.shape == ja.shape
        assert len(ta) == r["tstats"]["steps"] == 31
        np.testing.assert_allclose(ta[:, 0], ja[:, 0], rtol=1e-5)
        if tol is None:
            assert np.abs(ta[:, 1:] - ja[:, 1:]).max() <= 2e-6
        else:
            assert np.abs(ta[:, 1:] - ja[:, 1:]).max() <= tol * np.abs(
                ja[:, 1:]).max()
    # The water probe reads ρ_w·g·depth (z = 0.01 under a 0.02 m surface).
    _, p_rows = _table(os.path.join(tdir, "postProcessing", "probes", "0", "p"))
    assert abs(p_rows[0, 1] - 998.2 * 9.81 * 0.01) < 0.05 * 98.0

    # Interface artifacts.
    jout = os.path.join(jdir, "postProcessing", "interface")
    tout = os.path.join(tdir, "postProcessing", "interface")
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    for name in ("interface_summary.csv", "wall_elevation.csv"):
        jh, ja = _csv(os.path.join(jout, name))
        th, ta = _csv(os.path.join(tout, name))
        assert th == jh and ta.shape == ja.shape
        assert np.abs(ta - ja).max() <= 2e-6, name
    _, summary = _csv(os.path.join(tout, "interface_summary.csv"))
    assert abs(summary[0, 1] - TINY["H"] / 2) < 1e-6   # starts at H/2


def test_resume_takes_no_steps(tiny_runs):
    r = tiny_runs
    assert r["tstats2"]["steps"] == 0 and r["tstats2"]["sim_seconds"] == 0.0
    assert any(ln.startswith("  Resuming from t=0.1000 s") for ln in r["tlog2"])
    assert tcases.is_case_done(r["tdir"]) and jcases.is_case_done(r["tdir"])
    assert tcases.case_progress(r["tdir"]) == pytest.approx(0.1)
    assert tcases.list_cases(os.path.dirname(r["tdir"])) == [
        os.path.basename(r["tdir"])]
    # Rows already recorded are not written twice.
    _, rows = _table(os.path.join(r["tdir"], "postProcessing", "probes", "0",
                                  "p"))
    assert len(rows) == 31
    # The JAX package resumes the port's case too: nothing left to do.
    jrunner._ADVANCE_CACHE.clear()
    out = []
    assert jrunner.run_case(r["tdir"], log=out.append)["steps"] == 0
    jrunner._ADVANCE_CACHE.clear()


def test_resume_mid_run_reaches_the_same_end(tiny_runs, tmp_path):
    """A case stopped after its first write (the later checkpoint removed)
    resumes from t = 0.05 and lands on t = 0.1 with the same step count."""
    import shutil

    src = tiny_runs["tdir"]
    case = str(tmp_path / os.path.basename(src))
    shutil.copytree(src, case)
    os.remove(os.path.join(case, "chk_t0.100000.npz"))
    log = []
    stats = trunner.run_case(case, log=log.append, device="cpu")
    assert any("Resuming from t=0.0500" in ln for ln in log)
    end = tio.load_checkpoint(tio.latest_checkpoint(case)[1])
    full = tio.load_checkpoint(tio.latest_checkpoint(src)[1])
    assert float(end["t"]) == float(full["t"]) == float(np.float32(2) * np.float32(0.05))
    assert int(end["step"]) == int(full["step"]) and stats["steps"] == 13
    # A fresh preconditioner bundle at the restart moves p by the CG
    # tolerance's order, alpha far less.
    assert np.abs(end["alpha"] - full["alpha"]).max() <= 5e-4


def test_interface_modes_match_jax(tiny_runs):
    """Column heights, marching cubes and the wall bins on the last
    snapshot, against the JAX functions (f32 sums: 2e-6)."""
    from openfoam_tpp_tpu.post import interface as jinterface
    from openfoam_tpp_tpu.post import isosurface as jiso

    tdir = tiny_runs["tdir"]
    params = tcases.load_case_params(tdir)
    assert params == jcases.load_case_params(tdir)
    tg = trunner.build_case_geometry(params, trunner._case_shape_hint(tdir))
    jg = jrunner.build_case_geometry(params, jrunner._case_shape_hint(tdir))
    assert tg.shape == jg.shape == (8, 8, 10)
    snaps = list(trunner.iterate_snapshots(tdir))
    assert [t for t, _ in snaps] == [t for t, _ in jrunner.iterate_snapshots(tdir)]
    alpha = snaps[-1][1]
    ta = torch.from_numpy(alpha)
    for got, ref in zip(tinterface.surface_stats(ta, tg),
                        jinterface.surface_stats(jnp.asarray(alpha), jg)):
        assert abs(float(got) - float(ref)) <= 2e-6
    for got, ref in zip(tiso.surface_stats_mc(ta, tg),
                        jiso.surface_stats_mc(jnp.asarray(alpha), jg)):
        assert abs(float(got) - float(ref)) <= 2e-6
    assert tiso.columns_monotone(alpha, tg.fluid) == \
        jiso.columns_monotone(alpha, jg.fluid)
    np.testing.assert_array_equal(tiso.TRI_TABLE, jiso.TRI_TABLE)
    tp, tt = tiso.triangulate(alpha, tg)
    jp, jt = jiso.triangulate(alpha, jg)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
    tpts, ttri = tinterface.surface_mesh(ta, tg)
    jpts, jtri = jinterface.surface_mesh(jnp.asarray(alpha), jg)
    np.testing.assert_array_equal(ttri, jtri)
    np.testing.assert_allclose(tpts, jpts, atol=2e-6)
    # mode="mc" end to end writes the same three kinds of artifact.
    out = tinterface.extract_interface(tdir, tg, snaps[-1:], mode="mc",
                                       device="cpu")
    head, rows = _csv(os.path.join(out, "interface_summary.csv"))
    assert rows.shape == (1, 5) and rows[0, 4] > 0


def test_unported_case_arguments_raise(tiny_runs, tmp_path, monkeypatch):
    """`devices=`, refused until the device mesh was ported, runs on mesh
    positions that share one device: 2 x-positions of the tiny case take
    the plain global step on the JAX package's grid (the CPU wants no
    kernel islands), bitwise the unsharded run's, as the same step on the
    same operands; 'NxM' builds JAX's grid; a 6DoF case runs sharded as
    it runs alone. What raises: a missing card (x positions on distinct
    cards run as ranks and need theirs, whatever the grid), 'NxM' on
    distinct cards, a foreign checkpoint grid."""
    case = tcases.setup_case(TINY, str(tmp_path))
    stats = trunner.run_case(case, devices=2, device="cpu",
                             log=lambda *a: None)
    assert stats["steps"] == tiny_runs["tstats"]["steps"]
    for (t, path), (t0, ref) in zip(tio.list_checkpoints(case),
                                    tio.list_checkpoints(tiny_runs["tdir"])):
        got, want = tio.load_checkpoint(path), tio.load_checkpoint(ref)
        assert t == t0
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    geom, _ = trunner.get_compiled_advance(TINY, TProps(), TControls(),
                                           devices="2x2", device="cpu")
    assert geom.shape == jrunner.build_case_geometry(TINY,
                                                     devices="2x2").shape
    # A 6DoF case runs sharded as it runs alone.
    small = {"Lx": 0.2, "Ly": 0.2, "Lz": 0.2, "mesh": 0.05, "duration": 0.1}
    six = tcases.setup_case_6dof(small, str(tmp_path))
    alone = tcases.setup_case_6dof(small, str(tmp_path / "alone"))
    trunner.run_case(six, devices=2, device="cpu", log=lambda *a: None)
    trunner.run_case(alone, device="cpu", log=lambda *a: None)
    got, want = (tio.load_checkpoint(tio.latest_checkpoint(d)[1])
                 for d in (six, alone))
    assert float(got["t"]) == float(np.float32(0.1))
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # x positions on distinct cards run as ranks, one process a card:
    # without a card the launch refuses before any process starts, for a
    # fresh case and for this case's grid too (its checkpoints are the
    # 8×8×10 of the run above, not a multiple of 8·2: the rank form runs
    # it as x-slabs of 4 planes). The next slice's case raises there:
    # 'NxM'. torch.device objects: no card is touched.
    cards = [torch.device(f"cuda:{i}") for i in range(4)]
    fresh = tcases.setup_case(TINY, str(tmp_path / "fresh"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_case(fresh, devices=2, device=cards[:2])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_case(case, devices=2, device=cards[:2])
    with pytest.raises(NotImplementedError, match="'NxM' over ranks"):
        trunner.run_case(fresh, devices="2x2", device=cards)
    # The card is the default device, and its absence raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_case(case)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trunner.run_case(case, devices=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinterface.extract_interface(case, tbuild(**TANK), [])
    # A checkpoint of another grid than the case's parameters give.
    with pytest.raises(ValueError, match="matches checkpoint grid"):
        trunner.build_case_geometry(TINY, shape_hint=(9, 9, 9))


@pytest.mark.parametrize("argv,rc", [
    (["--headless", "--action", "runsweep", "--devices", "2", "--device",
      "cpu"], 0),
    (["--headless", "--action", "config", "--devices", "2"], 0),
    (["--headless", "--case", "{case}", "--action", "run", "--devices", "2",
      "--device", "cpu"], 0),
    (["--headless", "--case", "no_such_case", "--action", "run"], 1),
])
def test_cli_refuses_what_is_not_ported(argv, rc, tmp_path, capsys):
    """`--devices 2`, refused until the device mesh was ported, runs on
    `--device cpu` and exits 0 (runsweep farms the two cases over two
    positions, run shards the case's x axis); a missing case exits 1."""
    short = dict(TINY, duration=0.05)
    names = [os.path.basename(tcases.setup_case(dict(short, R=r),
                                                str(tmp_path)))
             for r in (0.002, 0.001)]
    argv = [a.replace("{case}", names[0]) for a in argv]
    assert tcli.main(["--base-dir", str(tmp_path)] + argv) == rc
    out = capsys.readouterr().out
    if "runsweep" in argv:
        assert "2 cases in one batch over 2 devices" in out
    if "run" in argv and rc == 0:
        assert "2-device sharded" in out
    ran = [n for n in names if tcases.is_case_done(os.path.join(tmp_path, n))]
    assert ran == (names if "runsweep" in argv
                   else names[:1] if "run" in argv and rc == 0 else [])


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The tiny case run by the port (checkpoints at 0, 0.05 and 0.1)."""
    base = tmp_path_factory.mktemp("cli")
    case = tcases.setup_case(TINY, str(base))
    trunner.run_case(case, device="cpu", log=lambda *a: None)
    return case


@pytest.mark.parametrize("verb", ["flow", "video", "profile --submit",
                                  "build6dof --submit", "run --submit",
                                  "menu"])
def test_cli_runs_the_verbs_it_once_refused(verb, tiny_run, monkeypatch,
                                            capsys):
    """What the command line refused until the top layer was ported: the
    `flow` and `video` verbs, `--submit` (the Slurm script written, exit
    1 without sbatch, as in the JAX package; build6dof builds and ignores
    it) and the interactive menu (EOF on stdin: Exit at once)."""
    import shutil

    from openfoam_tpp_tpu_torch.utils import potential_flow as tpf

    base, name = os.path.dirname(tiny_run), os.path.basename(tiny_run)
    monkeypatch.setattr(shutil, "which", lambda cmd: None)
    # The 80-frame dashboard is held against JAX's in tests/test_torch_post.py.
    monkeypatch.setattr(tpf, "generate_dashboard_animation",
                        lambda path, **k: (path, {}))
    head = ["--base-dir", base]
    action, *flags = verb.split()
    if verb == "menu":
        monkeypatch.setattr("sys.stdin", __import__("io").StringIO(""))
        argv, rc = head, 0
    elif action == "build6dof":
        argv, rc = head + ["--headless", "--action", action,
                           "--params", "mesh=0.05,duration=0.1", *flags], 0
    else:
        argv = head + ["--headless", "--case", name, "--action", action,
                       *flags]
        rc = 1 if flags else 0
    assert tcli.main(argv) == rc
    out = capsys.readouterr()
    assert "not ported yet" not in out.err
    post = os.path.join(tiny_run, "postProcessing")
    if verb == "flow":
        assert os.path.getsize(os.path.join(
            post, "potential_flow", "potential_flow_wall.csv"))
    elif verb == "video":
        assert any(f.startswith("animation.")
                   for f in os.listdir(os.path.join(post, "video")))
    elif verb == "build6dof --submit":
        assert any(c.startswith("case_6dof") for c in tcases.list_cases(base))
    elif verb == "menu":
        assert out.out.count("Choice: ") == 1
    else:
        script = ("run_simulation.slurm" if action == "run"
                  else f"postprocess_{action}.slurm")
        text = open(os.path.join(tiny_run, script)).read()
        assert f"--action {action}" in text and "--gres=gpu:1" in text
        assert "sbatch not found" in out.out


def test_get_compiled_advance_controls(monkeypatch):
    """On the CPU the caller's controls stand; OFTPP_PRECOND_REFRESH
    overrides the refresh interval; the bundle is carried and rebuilt
    every `precond_refresh` steps."""
    from openfoam_tpp_tpu_torch.solver import poisson as tpo
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state

    built = []
    real = tpo.make_bundle
    monkeypatch.setattr(tpo, "make_bundle",
                        lambda *a, **k: built.append(k) or real(*a, **k))
    monkeypatch.setenv("OFTPP_PRECOND_REFRESH", "4")
    geom, advance = trunner.get_compiled_advance(
        TINY, TProps(), TControls(), device="cpu")
    state = init_state(geom, dt0=TINY["dt"], device="cpu")
    params = CaseParams.make(TINY["R"], TINY["freq"], TINY["duration"],
                             device="cpu")
    state, diag, n, buf = advance(state, params, 0.05)
    assert n == 18 and float(state.t) == float(np.float32(0.05))
    assert buf.shape == (4000, 6) and bool((buf[n:] == 0).all())
    np.testing.assert_array_equal(buf[:n, 0].numpy()[-1], np.float32(0.05))
    # One fresh bundle per advance call, then one at steps 0, 4, 8, 12, 16.
    assert len(built) == 1 + 5
    assert all(k["use_pallas"] is False for k in built)


@pytest.mark.parametrize("name", ["case_H0.04_D0.02_flat_R0.002_f3.0_d0.1_m0.004",
                                  "case_H0.208_D0.2_cap_R0.004_f1.88_d20.0_m0.00185",
                                  "not_a_case"])
def test_naming_matches_jax(name):
    assert tnaming.parse_case_params(name) == jnaming.parse_case_params(name)
    p = tnaming.parse_case_params(name)
    assert tnaming.get_case_name(p) == jnaming.get_case_name(p)
