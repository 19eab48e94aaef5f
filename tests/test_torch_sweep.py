"""The port's sweep path against the JAX package's, on the CPU: batched
geometry, states and parameters, `make_geom_sweep_step` and
`make_sweep_step` with the case axis trailing, `run_cases_batched` with
its checkpoints, probes and resume, `--action runsweep [--percase-dt]`,
`expand_sweep`, and what is left out.

The JAX sweep is `jax.vmap` of the single-case step; the port's step is
rank-polymorphic. Both get the same numpy state. OFTPP_SWEEP_PALLAS:
`interpret` routes the pressure passes to the batch-native kernels (JAX:
Pallas in interpret mode; the port: the `*_nb` entry points, which run
their plain versions on CPU tensors), `0` keeps everything plain.

Tolerances. The sweep steps (4 steps, 8×8×10 × 2 or 3 cases): t 1e-6 and
dt 1e-4 relative (bitwise until a case's Courant limit binds, then dt
follows the velocities: measured 2.6e-6); alpha 5e-5 and p rtol 8e-3 /
atol 5e-3 are the JAX test's own bounds between its two paths
(tests/test_batch_kernels.py). Between the packages measured alpha
1.5e-5, p 4.3e-5 of scale, velocities 7.9e-4 of scale (v, the weakest
component; u and w 1.2e-4), per-case p_iters equal: held to alpha 5e-5,
p 2e-4 and velocities 1e-3 of scale (tests/test_torch_step.py's bounds
for a step that ends in a CG solve stopped at 1e-3), p_iters ±1. The
batched run (3 cases, 0.1 s, 48 steps): tests/test_torch_case.py's run
bounds (alpha 5e-4, velocities 2e-4 and p 5e-5 of scale, dt 1e-4, probe p
2e-3 of scale, η 2e-6); measured alpha 1.0e-5, velocities 7.1e-5, p
8.1e-6, dt 3.1e-6, probe p 1.4e-4, η 1.0e-7."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.manager import cases as jcases
from openfoam_tpp_tpu.manager import sweeprun as jsweeprun
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sweep as jsw
from openfoam_tpp_tpu.utils import io as jio
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (SimState, params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import cli as tcli
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.manager import sweeprun as tsweeprun
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.post import probes as tprobes
from openfoam_tpp_tpu_torch.solver import timestep as ttimestep
from openfoam_tpp_tpu_torch.utils import io as tio

FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = ("orbit_radius", "omega", "ramp_time")
# The two rows of tests/test_batch_kernels.py's sweep-step test.
GEOM_ROWS = [
    {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
     "freq": 3.0},
    {"H": 0.03, "D": 0.016, "mesh": 0.004, "geo": "flat", "R": 0.001,
     "freq": 2.0},
]
# tests/test_sweeprun.py's rows.
ROWS = [
    {"H": 0.04, "D": 0.016, "mesh": 0.004, "geo": "flat",
     "R": 0.002, "freq": 2.5, "duration": 0.1, "dt": 5e-4, "ramp": 0.02},
    {"H": 0.04, "D": 0.020, "mesh": 0.004, "geo": "flat",
     "R": 0.003, "freq": 3.0, "duration": 0.1, "dt": 5e-4, "ramp": 0.02},
    {"H": 0.06, "D": 0.016, "mesh": 0.004, "geo": "flat",
     "R": 0.002, "freq": 3.5, "duration": 0.1, "dt": 5e-4, "ramp": 0.02},
]
N_STEPS = 4
quiet = lambda *a: None


def _jnp_tree(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


def _spy_batch_entry_points(monkeypatch):
    """Count the calls of the batch-native and the single-grid 7-point
    entry points through their module attributes."""
    calls = {}
    for name in ("apply_7pt_nb", "resid_scaled_7pt_nb", "apply_dot_7pt_nb"):
        fn = getattr(tsp, name)

        def run(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            assert a[0].dim() == 4
            return _fn(*a, **k)

        monkeypatch.setattr(tsp, name, run)
    return calls


def _compare_states(got: SimState, ref, jdiags, tdiags):
    g = state_to_numpy(got)
    r = _jnp_tree(ref, FIELDS)
    np.testing.assert_array_equal(g["step"], r["step"])
    np.testing.assert_allclose(g["t"], r["t"], rtol=1e-6)
    np.testing.assert_allclose(g["dt"], r["dt"], rtol=1e-4)
    assert np.abs(g["alpha"] - r["alpha"]).max() <= 5e-5
    assert np.abs(g["p"] - r["p"]).max() <= 2e-4 * np.abs(r["p"]).max()
    np.testing.assert_allclose(g["p"], r["p"], rtol=8e-3, atol=5e-3)
    for k in ("u", "v", "w"):
        assert np.abs(g[k] - r[k]).max() <= 1e-3 * np.abs(r[k]).max(), k
    for dj, dt_ in zip(jdiags, tdiags):
        assert dt_.p_iters.shape == np.asarray(dj.p_iters).shape
        assert np.abs(dt_.p_iters.numpy() - np.asarray(dj.p_iters)).max() <= 1
        for f in ("courant", "alpha_min", "alpha_max"):
            np.testing.assert_allclose(getattr(dt_, f).numpy(),
                                       np.asarray(getattr(dj, f)),
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("env", ["0", "interpret"])
def test_geom_sweep_step_matches_jax(env, monkeypatch):
    """(c) Mixed geometry (per-case hz), lockstep, 4 steps from dt0=4e-4."""
    monkeypatch.setenv("OFTPP_SWEEP_PALLAS", env)
    prow = [{"R": r["R"], "freq": r["freq"], "duration": 0.05}
            for r in GEOM_ROWS]
    jbg = jsw.build_batched_geometry(GEOM_ROWS, round_to=4, axis=-1)
    tbg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    assert tbg.shape == jbg.shape == (8, 8, 10) and tbg.n_cases == 2
    for k, a in jbg.ga.items():
        np.testing.assert_array_equal(tbg.ga[k].numpy(), np.asarray(a))
    np.testing.assert_array_equal(tbg.spacing.numpy(), np.asarray(jbg.spacing))
    jpar = jsw.batch_params(prow)
    tpar = tsw.batch_params(prow, device="cpu")
    for k in PARAMS:
        np.testing.assert_array_equal(getattr(tpar, k).numpy(),
                                      np.asarray(getattr(jpar, k)))
    js = jsw.batch_states_geom(jbg, dt0=4e-4)
    ts0 = tsw.batch_states_geom(tbg, dt0=4e-4)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts0, k).numpy(),
                                      np.asarray(getattr(js, k)))
    # The JAX batched state and parameters, as numpy, drive the port.
    ts = state_from_numpy(_jnp_tree(js, FIELDS), device="cpu")
    tpar = params_from_numpy(_jnp_tree(jpar, PARAMS), device="cpu")

    jstep = jax.jit(jsw.make_geom_sweep_step(jbg, JProps(), JControls()))
    jdiags = []
    for _ in range(N_STEPS):
        js, d = jstep(js, jpar)
        jdiags.append(d)
    calls = _spy_batch_entry_points(monkeypatch)
    tstep = tsw.make_geom_sweep_step(tbg)
    tdiags = []
    for _ in range(N_STEPS):
        ts, d = tstep(ts, tpar)
        tdiags.append(d)
    # The routing: the batch entry points serve every pressure pass with
    # `interpret`, none with `0`.
    assert (len(calls) == 3) == (env == "interpret")
    assert float(ts.t[0]) == float(ts.t[1]) and float(ts.w.abs().max()) > 1e-2
    _compare_states(ts, js, jdiags, tdiags)


def test_sweep_step_shared_geometry_matches_jax(monkeypatch):
    """(d) One geometry, three forcing rows, the batch-native routing."""
    monkeypatch.setenv("OFTPP_SWEEP_PALLAS", "interpret")
    tank = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=4)
    prow = [{"R": 0.002 + 5e-4 * i, "freq": 2.0 + 0.5 * i, "duration": 0.05}
            for i in range(3)]
    jg, tg = jbuild(**tank), tbuild(**tank)
    jpar = jsw.batch_params(prow)
    js = jsw.batch_states(jg, 3, dt0=4e-4, axis=-1)
    ts = tsw.batch_states(tg, 3, dt0=4e-4, device="cpu")
    assert ts.alpha.shape == (8, 8, 10, 3) and ts.t.shape == (3,)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)))
    tpar = params_from_numpy(_jnp_tree(jpar, PARAMS), device="cpu")
    jstep = jax.jit(jsw.make_sweep_step(jg, JProps(), JControls(), axis=-1))
    calls = _spy_batch_entry_points(monkeypatch)
    tstep = tsw.make_sweep_step(tg, device="cpu")
    jdiags, tdiags = [], []
    for _ in range(N_STEPS):
        js, dj = jstep(js, jpar)
        ts, dt_ = tstep(ts, tpar)
        jdiags.append(dj)
        tdiags.append(dt_)
    assert len(calls) == 3
    # The cases differ: each has its own forcing.
    assert float((ts.u[..., 0] - ts.u[..., 2]).abs().max()) > 1e-3
    _compare_states(ts, js, jdiags, tdiags)


def test_run_sweep_reaches_t_end():
    tg = tbuild(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=4)
    prow = [{"R": 0.002, "freq": 3.0, "duration": 0.05},
            {"R": 0.001, "freq": 2.0, "duration": 0.05}]
    states, n = tsw.run_sweep(tg, prow, t_end=0.004, device="cpu")
    assert n == 4 and bool((states.t >= 0.004).all())
    assert states.step.tolist() == [4, 4]
    bg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    states, n = tsw.run_sweep(bg, prow, t_end=0.004)
    assert n == 4 and states.alpha.shape == (8, 8, 10, 2)
    states, n = tsw.run_sweep(bg, prow, t_end=0.004, max_steps=2)
    assert n == 2


def test_batched_sampler_equals_the_solo_sampler_per_case():
    """`sample_rows_batched` row i is `sample_row` on case i, bitwise."""
    bg = tsw.build_batched_geometry(ROWS, round_to=4, device="cpu")
    rng = np.random.default_rng(7)
    nx, ny, nz = bg.shape
    n = len(ROWS)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    states = SimState(
        alpha=torch.from_numpy(rng.uniform(0, 1, (nx, ny, nz, n))
                               .astype(np.float32)),
        u=f(nx + 1, ny, nz, n), v=f(nx, ny + 1, nz, n), w=f(nx, ny, nz + 1, n),
        p=100.0 * f(nx, ny, nz, n), t=torch.tensor([0.1, 0.2, 0.3]),
        dt=torch.full((n,), 1e-3), step=torch.arange(n, dtype=torch.int32))
    packs = [tprobes.probe_pack(g, tprobes.default_probe_points(g),
                                tprobes.default_wave_columns(g), device="cpu")
             for g in bg.geoms]
    rows = tprobes.sample_rows_batched(states, tprobes.stack_packs(packs))
    assert rows.shape == (n, 6) and rows.dtype == torch.float32
    for i in range(n):
        solo = tprobes.sample_row(tsweeprun._unpack_case(states, i), packs[i])
        assert torch.equal(rows[i], solo)


# ------------------------------------------------- (e) the batched run

def _table(path):
    lines = open(path).read().splitlines()
    head = [ln for ln in lines if ln.startswith("#")]
    return head, np.array([[float(v) for v in ln.split()]
                           for ln in lines if not ln.startswith("#")])


@pytest.fixture(scope="module")
def batched_runs(tmp_path_factory):
    """ROWS through both packages: `setup_case` each, the JAX
    `run_cases_batched`, the port's `--action runsweep` on the CPU, and a
    second `runsweep` of the port."""
    base = tmp_path_factory.mktemp("sweep")
    jdirs = [jcases.setup_case(r, str(base / "jax")) for r in ROWS]
    tdirs = [tcases.setup_case(r, str(base / "torch")) for r in ROWS]
    jstats = jsweeprun.run_cases_batched(jdirs, log=quiet)
    argv = ["--headless", "--action", "runsweep", "--case", "all",
            "--base-dir", str(base / "torch"), "--device", "cpu"]
    stats = []
    real = tsweeprun.run_cases_batched

    def run(*a, **k):
        stats.append(real(*a, **k))
        return stats[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsweeprun, "run_cases_batched", run)
        rc = tcli.main(argv)
        rc2 = tcli.main(argv)       # everything is done: nothing to run
        again = real(tdirs, log=quiet, device="cpu")
    return dict(jdirs=jdirs, tdirs=tdirs, jstats=jstats, stats=stats, rc=rc,
                rc2=rc2, again=again)


def test_runsweep_writes_what_jax_writes(batched_runs):
    r = batched_runs
    assert r["rc"] == 0 and len(r["stats"]) == 1
    tstats, jstats = r["stats"][0], r["jstats"]
    assert tstats["n_cases"] == jstats["n_cases"] == 3
    assert tstats["steps"] == jstats["steps"]
    assert 0.0 < tstats["io_seconds"] < tstats["wall_seconds"]
    w32 = np.float32(0.05)
    for jd, td in zip(r["jdirs"], r["tdirs"]):
        assert os.path.basename(jd) == os.path.basename(td)
        assert tcases.is_case_done(td)
        jchk, tchk = jio.list_checkpoints(jd), tio.list_checkpoints(td)
        assert [os.path.basename(p) for _, p in tchk] == \
            [os.path.basename(p) for _, p in jchk] == [
                "chk_t0.000000.npz", "chk_t0.050000.npz", "chk_t0.100000.npz"]
        for k, ((_, jp), (_, tp)) in enumerate(zip(jchk, tchk)):
            a, b = jio.load_checkpoint(jp), tio.load_checkpoint(tp)
            assert set(b) == set(a)
            for f in FIELDS:
                assert b[f].shape == a[f].shape and b[f].dtype == a[f].dtype, f
            # Every write time is the f32 target, bitwise.
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
            jh, ja = _table(os.path.join(jd, "postProcessing", "probes", "0",
                                         name))
            th, ta = _table(os.path.join(td, "postProcessing", "probes", "0",
                                         name))
            assert th == jh and ta.shape == ja.shape
            assert len(ta) == tstats["steps"]
            np.testing.assert_allclose(ta[:, 0], ja[:, 0], rtol=1e-5)
            assert (np.diff(ta[:, 0]) > 0).all()
            if tol is None:
                assert np.abs(ta[:, 1:] - ja[:, 1:]).max() <= 2e-6
            else:
                assert np.abs(ta[:, 1:] - ja[:, 1:]).max() <= tol * np.abs(
                    ja[:, 1:]).max()


def test_runsweep_resume_takes_no_steps(batched_runs):
    r = batched_runs
    # The command line leaves finished cases out; the batch run resumes
    # from the last checkpoints and has nothing left to do.
    assert r["rc2"] == 0 and len(r["stats"]) == 1
    assert r["again"]["steps"] == 0
    for td in r["tdirs"]:
        assert len(tio.list_checkpoints(td)) == 3
        _, rows = _table(os.path.join(td, "postProcessing", "probes", "0", "p"))
        assert len(rows) == r["stats"][0]["steps"]


def test_group_cases_matches_jax(batched_runs, tmp_path):
    dirs = [tcases.setup_case(r, str(tmp_path)) for r in ROWS]
    other = tcases.setup_case({**ROWS[0], "mesh": 0.008, "R": 0.001},
                              str(tmp_path))
    six = tmp_path / "case_6dof"
    os.makedirs(six)
    with open(six / "case.json", "w") as f:
        json.dump({"model": "tank6dof", "Lx": 1.0, "duration": 1.0}, f)
    every = dirs + [other, str(six)] + batched_runs["tdirs"]
    groups = tsweeprun.group_cases(every)
    assert groups == jsweeprun.group_cases(every)
    assert sorted(len(g) for g in groups) == [1, 1, 3, 3]


# ------------------------------------------------- (f) per-case dt

def test_percase_dt_lane_equals_its_solo_run(tmp_path):
    """`--percase-dt`: the lax case takes its solo step count (fewer
    than the stiff one's) and its solo physics; in lockstep both take the
    stiff pace. tests/test_sweeprun.py's rows."""
    lax_row = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat",
               "R": 0.0005, "freq": 1.0, "duration": 0.1, "dt": 5e-4,
               "ramp": 0.02}
    stiff_row = {**lax_row, "R": 0.004, "freq": 6.0}
    batch = [tcases.setup_case(r, str(tmp_path / "batch"))
             for r in (lax_row, stiff_row)]
    names = ",".join(os.path.basename(d) for d in batch)
    assert tcli.main(["--headless", "--action", "runsweep", "--case", names,
                      "--base-dir", str(tmp_path / "batch"), "--percase-dt",
                      "--device", "cpu"]) == 0
    last = lambda d: tio.load_checkpoint(tio.latest_checkpoint(d)[1])
    ends = [last(d) for d in batch]
    for e in ends:
        assert float(e["t"]) == float(np.float32(2) * np.float32(0.05))
    lax_steps, stiff_steps = (int(e["step"]) for e in ends)
    assert lax_steps < stiff_steps

    solo = tcases.setup_case(lax_row, str(tmp_path / "solo"))
    trunner.run_case(solo, log=quiet, device="cpu")
    s = last(solo)
    assert int(s["step"]) == lax_steps
    assert np.abs(ends[0]["alpha"] - s["alpha"]).max() <= 2e-5
    # One probe row per step of the case's own, held rows dropped.
    for d, steps in zip(batch, (lax_steps, stiff_steps)):
        _, rows = _table(os.path.join(d, "postProcessing", "probes", "0", "p"))
        assert len(rows) == steps and (np.diff(rows[:, 0]) > 0).all()

    lock = [tcases.setup_case(r, str(tmp_path / "lock"))
            for r in (lax_row, stiff_row)]
    tsweeprun.run_cases_batched(lock, log=quiet, lockstep=True, device="cpu")
    lock_steps = [int(last(d)["step"]) for d in lock]
    assert lock_steps[0] == lock_steps[1] >= stiff_steps


# ------------------------------------------------- (g) expand_sweep

@pytest.mark.parametrize("sweep,mode,n", [
    ({"freq": [1.0, 2.0, 3.0], "R": [0.001, 0.002, 0.003], "H": 0.1}, "zip", 3),
    ({"freq": [1.0, 2.0], "R": [0.001, 0.002, 0.003], "H": [0.1], "geo": "cap"},
     "cartesian", 6),
    ({"freq": [1.0, 2.0], "R": [0.001, 0.002, 0.003]}, "cancelled", 0),
    ({"freq": [1.5], "R": 0.002}, "cartesian", 1),
])
def test_expand_sweep_matches_jax(sweep, mode, n):
    confirm = (lambda k: False) if mode == "cancelled" else (lambda k: True)
    got = tcases.expand_sweep(sweep, confirm_cartesian=confirm)
    assert got == jcases.expand_sweep(sweep, confirm_cartesian=confirm)
    assert got[1] == mode and len(got[0]) == n
    assert tcases.expand_sweep(sweep) == jcases.expand_sweep(sweep)


# ------------------------------------------------- (h) what is left out

def test_left_out_sweep_arguments_raise(tmp_path, monkeypatch, capsys):
    """What the sweep path still refuses; axis=0 and devices=2, which it
    refused until the device mesh was ported, run and are held against
    axis=-1 (bitwise: the leading step runs the trailing one's plain
    ops on a moved copy) and the unfarmed batch (the run bounds above:
    the farm's parts reduce over fewer cases a call, which moves the
    CPU's sum order)."""
    tg = tbuild(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=4)
    par = tsw.batch_params([{"R": 0.002, "freq": 3.0, "duration": 0.05},
                            {"R": 0.001, "freq": 2.0, "duration": 0.05}],
                           device="cpu")
    lead = tsw.batch_states(tg, 2, axis=0, device="cpu")
    trail = tsw.batch_states(tg, 2, device="cpu")
    assert lead.alpha.shape == (2, 8, 8, 10) and lead.t.shape == (2,)
    got, _ = tsw.make_sweep_step(tg, axis=0, device="cpu")(lead, par)
    want, _ = tsw.make_sweep_step(tg, device="cpu")(trail, par)
    for k in FIELDS:
        a = getattr(got, k)
        assert torch.equal(a if a.dim() <= 1 else a.movedim(0, -1),
                           getattr(want, k)), k
    bg0 = tsw.build_batched_geometry(GEOM_ROWS, axis=0, device="cpu")
    bg1 = tsw.build_batched_geometry(GEOM_ROWS, device="cpu")
    assert bg0.axis == 0 and bg0.ga["vfrac"].shape == (2, 8, 8, 10)
    got, _ = tsw.make_geom_sweep_step(bg0)(tsw.batch_states_geom(bg0), par)
    want, _ = tsw.make_geom_sweep_step(bg1)(tsw.batch_states_geom(bg1), par)
    for k in FIELDS:
        a = getattr(got, k)
        assert torch.equal(a if a.dim() <= 1 else a.movedim(0, -1),
                           getattr(want, k)), k
    short = [dict(r, duration=0.05) for r in ROWS[:2]]
    dirs = [tcases.setup_case(r, str(tmp_path / "farm")) for r in short]
    one = [tcases.setup_case(r, str(tmp_path / "one")) for r in short]
    assert tcli.main(["--headless", "--action", "runsweep", "--base-dir",
                      str(tmp_path / "farm"), "--devices", "2", "--device",
                      "cpu"]) == 0
    assert "over 2 devices" in capsys.readouterr().out
    tsweeprun.run_cases_batched(one, device="cpu", log=quiet)
    for d, e in zip(dirs, one):
        got = tio.load_checkpoint(tio.latest_checkpoint(d)[1])
        want = tio.load_checkpoint(tio.latest_checkpoint(e)[1])
        assert got["t"] == want["t"] == np.float32(0.05)
        assert got["step"] == want["step"]
        assert np.abs(got["alpha"] - want["alpha"]).max() <= 5e-4
        for k in ("u", "v", "w"):
            assert np.abs(got[k] - want[k]).max() \
                <= 2e-4 * np.abs(want[k]).max(), k
        assert np.abs(got["p"] - want["p"]).max() \
            <= 5e-5 * np.abs(want["p"]).max()
        for name in ("p", "eta"):
            path = os.path.join("postProcessing", "probes", "0", name)
            np.testing.assert_array_equal(_table(os.path.join(d, path))[1][:, 0],
                                          _table(os.path.join(e, path))[1][:, 0])
    with pytest.raises(ValueError, match="do not divide"):
        tsweeprun.run_cases_batched(dirs + one[:1], devices=2, device="cpu")
    six = tmp_path / "case_6dof"
    os.makedirs(six)
    with open(six / "case.json", "w") as f:
        json.dump({"model": "tank6dof", "Lx": 1.0, "duration": 1.0}, f)
    with pytest.raises(NotImplementedError, match="tank6dof"):
        tsweeprun.run_cases_batched([str(six), str(six)], device="cpu")
    monkeypatch.setenv("OFTPP_SWEEP_PALLAS", "1")
    with pytest.raises(NotImplementedError, match="OFTPP_SWEEP_PALLAS=1"):
        tsw.make_sweep_step(tg, device="cpu")
    monkeypatch.delenv("OFTPP_SWEEP_PALLAS")
    with pytest.raises(ValueError, match="mixes mesh sizes"):
        tsw.build_batched_geometry(
            [GEOM_ROWS[0], {**GEOM_ROWS[1], "mesh": 0.002}], device="cpu")
    # A carried preconditioner on a batched state is the one branch of
    # the step the sweeps do not take.
    core = ttimestep.make_step_core(
        controls=TControls(precond_refresh=4), carry_precond=True)
    bg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    s = tsw.batch_states_geom(bg)
    par = tsw.batch_params([{"R": 0.002, "freq": 3.0, "duration": 0.05}] * 2,
                           device="cpu")
    spacing = tuple(bg.spacing[:, d] for d in range(3))
    with pytest.raises(NotImplementedError, match="precond_refresh"):
        core(s, par, bg.ga, spacing, precond=core.init_precond(s, bg.ga,
                                                               spacing))
    # The card is the default device, and its absence raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tsw.make_sweep_step(tg),
                 lambda: tsw.batch_states(tg, 2),
                 lambda: tsw.batch_params([{"R": 1e-3, "freq": 1.0,
                                            "duration": 1.0}]),
                 lambda: tsw.build_batched_geometry(GEOM_ROWS),
                 lambda: tsw.run_sweep(tg, [], 0.1),
                 lambda: tsweeprun.run_cases_batched(dirs)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("env,device,kernels", [
    (None, "cpu", False), (None, "cuda", True), ("auto", "cuda", True),
    ("interpret", "cpu", True), ("0", "cuda", False)])
def test_sweep_kernel_policy(env, device, kernels, monkeypatch):
    """unset/auto: the batch-native kernels on a CUDA device, plain on the
    CPU; `interpret`: the kernel routing anywhere; `0`: plain."""
    monkeypatch.delenv("OFTPP_SWEEP_PALLAS", raising=False)
    if env is not None:
        monkeypatch.setenv("OFTPP_SWEEP_PALLAS", env)
    got = tsw._sweep_kernel_policy(-1, torch.device(device))
    want = (dict(use_pallas=True, batch_lanes=True, mom_pallas=False)
            if kernels else dict(use_pallas=False, mom_pallas=False))
    assert got == want
