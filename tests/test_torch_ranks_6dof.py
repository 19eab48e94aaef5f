"""The closed 6DoF tank and grids that are not a multiple of 8·N over ranks,
one process a shard (parallel/ranks.py), on the CPU: gloo between
spawned processes, the islands' kernels as their plain versions (what
OFTPP_SPMD_PALLAS=interpret runs). The rank processes run
tests/torch_rank_jobs.py, which imports torch and the port only.

(a) The 8×8×12 closed box of tests/test_torch_6dof.py under its
    large-rate rotating table, filled to z = 0, 3 steps from rest over 2
    and 4 ranks (x-slabs of 4 and 2 planes): against the JAX package's
    unsharded 6DoF step on its plain path (what GSPMD computes for a
    sharded 6DoF case), within that file's 3-step bounds (alpha 1e-5;
    the velocities 1e-3 of the velocity field's scale; p 1e-4 of its
    scale after each field's fluid mean is removed; t and dt to rtol
    1e-6; p_iters within 1), the port's FCT streams in f32 as on that
    path; against the port's one-process `SpmdCtx(N)` step with the same
    motion, the first step's alpha and dt bitwise and after 3 steps
    every field within tests/test_torch_ranks.py's bounds (2e-3 of its
    scale, a 2e-6 floor; the velocities of the velocity field's scale,
    for test_torch_6dof.py's reason: the CG solves stop on other
    iterates, here because the ranks add their dots in rank order, and
    the air's velocities take the pressure's last bits as noise of a few
    1e-5 m/s, which the small v at these times would hold to its own
    scale only at ~2e-2), p_iters within 1. One rank is bitwise the
    one-process `SpmdCtx(1)` step. Every rank runs the halo entry points
    alone, the closed-top epilogue island among them.
(b) A chamfered 6DoF case (Lx 0.2, mesh 0.05: 4×4×8) through
    `run_case(devices=2, device="cpu", ranks=True)`, killed after the
    first write interval and resumed (the resumed run bitwise the run
    that was not killed), against the same case run alone: write times
    bitwise, `6DoF.dat` and `case.json` byte-equal, alpha within the JAX
    sharded-run test's 5e-3, one probe row a step; the run's log names
    the x-slabs' nxl.
(c) An orbital case built alone, nx 8 (a multiple of 2, not of 16),
    resumed over 2 ranks from its first checkpoint: the checkpoint's
    grid is kept, write times bitwise the lone run's, alpha within 5e-3
    of the lone run continued.
(d) Every rank holds the motion table's bits: the digests of (b)'s ranks
    equal each other's and the lone run's table.
"""

import os
import shutil

import jax
import numpy as np
import pytest

import torch_rank_jobs as jobs
from test_torch_6dof import _tables
from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core import motion as jmo
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_box_geometry as jbox
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (CaseParams, state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver.timestep import make_step
from openfoam_tpp_tpu_torch.utils import io as tio

BOX = dict(Lx=0.08, Ly=0.08, Lz=0.12, mesh=0.01)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
N_STEPS = 3
# The JAX plain path's MULES streams are f32; the rank form runs the
# kernel islands, here on that path's f32 streams.
CONTROLS = TControls(use_pallas=True, fct_bf16=False, p_max_iters=30)
SIX = {"Lx": 0.2, "Ly": 0.2, "Lz": 0.4, "mesh": 0.05, "chamfer": 0.2,
       "duration": 0.1, "dt": 0.002}
ORBIT = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
         "freq": 3.0, "duration": 0.1, "dt": 5e-4, "ramp": -1.0}
HALO = {"halo7.apply_7pt_hs", "halo7.resid_scaled_7pt_hs",
        "halo7.apply_dot_7pt_h", "mules_flux.flux_all_h",
        "mules_fct.fct_iter_h", "momentum_rhs.momentum_rhs_h",
        "correction.correct_divmax_h"}
quiet = lambda *a: None


@pytest.fixture(scope="module")
def start():
    """The box at rest filled to z = 0 and the motion table as numpy, and
    the JAX plain 6DoF step's state after N_STEPS with its p_iters."""
    jm = jmo.TableMotion.from_table(*_tables())
    jg = jbox(**BOX)
    s0 = jinit(jg, fill_height=0.0, dt0=2e-3)
    step = jax.jit(jmake(jg, JProps(), JControls(), motion=jm))
    jp = JParams.make(R=0.0, freq=0.0, duration=1.0)
    s, iters = s0, []
    for _ in range(N_STEPS):
        s, d = step(s, jp)
        iters.append(int(d.p_iters))
    return ({k: np.asarray(getattr(s0, k)) for k in FIELDS},
            {k: np.asarray(getattr(jm, k)) for k in jobs.MOTION_FIELDS},
            {k: np.asarray(getattr(s, k)) for k in FIELDS}, iters,
            jg.vfrac > 0)


_RUNS = {}


def _ranks_run(start, world):
    """The rank job's results over `world` CPU ranks (run once a world)."""
    if world not in _RUNS:
        init, table = start[:2]
        _RUNS[world] = rk.launch(
            jobs.steps, ["cpu"] * world, log=quiet,
            args=({"box": BOX}, init, {"orbit_radius": 0.0, "omega": 0.0,
                                       "ramp_time": 0.0},
                  N_STEPS, True, table, CONTROLS))
    return _RUNS[world]


def _single(start, n_shards):
    """The port's one-process SpmdCtx(n_shards) 6DoF step from the start:
    the state after the first and the last step, and the p_iters."""
    init, table = start[:2]
    geom = jobs.geometry({"box": BOX})
    motion = jobs.motion_from_numpy(*(table[k] for k in jobs.MOTION_FIELDS),
                                    device="cpu")
    step = make_step(geom, TProps(), CONTROLS, motion=motion,
                     spmd=SpmdCtx(n_shards), device="cpu")
    s = state_from_numpy(init, device="cpu")
    p = CaseParams.make(R=0.0, freq=0.0, duration=1.0, device="cpu")
    first, last, iters = jobs._steps(step, s, p, N_STEPS)
    return state_to_numpy(first), state_to_numpy(last), iters


@pytest.mark.parametrize("world", [2, 4])
def test_6dof_ranks_match_the_jax_step(start, world):
    _, _, ref, jiters, fluid = start
    got = _ranks_run(start, world)[0]
    last = got["last"]
    vscale = max(np.abs(ref[k]).max() for k in ("u", "v", "w"))
    assert vscale > 1e-2   # the frame forces set the fluid moving
    np.testing.assert_array_equal(last["step"], ref["step"])
    np.testing.assert_allclose(last["t"], ref["t"], rtol=1e-6)
    np.testing.assert_allclose(last["dt"], ref["dt"], rtol=1e-6)
    assert np.abs(last["alpha"] - ref["alpha"]).max() <= 1e-5
    for k in ("u", "v", "w"):
        assert np.abs(last[k] - ref[k]).max() <= 1e-3 * vscale, k
    pj = ref["p"] - ref["p"][fluid].mean()
    pt = last["p"] - last["p"][fluid].mean()
    assert np.abs(pt - pj).max() <= 1e-4 * np.abs(pj).max()
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], jiters)), (
        got["iters"], jiters)


@pytest.mark.parametrize("world", [2, 4])
def test_6dof_ranks_match_the_single_process_sharded_step(start, world):
    res = _ranks_run(start, world)
    got = res[0]
    first, last, iters = _single(start, world)
    for k in ("alpha", "dt", "t"):
        np.testing.assert_array_equal(got["first"][k], first[k], err_msg=k)
    vscale = max(float(np.abs(last[k]).max()) for k in ("u", "v", "w"))
    for k in ("alpha", "u", "v", "w", "p"):
        scale = vscale if k in "uvw" else float(np.abs(last[k]).max())
        err = float(np.abs(got["last"][k] - last[k]).max())
        assert err <= max(2e-3 * scale, 2e-6), (k, err, scale)
    np.testing.assert_allclose(got["last"]["t"], last["t"], rtol=1e-6)
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], iters)), (
        got["iters"], iters)
    # Every rank ran the islands alone, the closed-top epilogue among
    # them, exchanged planes, took the same reductions and held the same
    # table; no rank loaded JAX.
    for r in res:
        assert set(r["calls"]) == HALO, r["calls"]
        assert r["calls"]["correction.correct_divmax_h"] == N_STEPS
        assert r["stats"]["exchanges"] > 0 and r["stats"]["bytes"] > 0
        assert r["stats"]["all_reduces"] == res[0]["stats"]["all_reduces"]
        assert r["motion"] == res[0]["motion"] is not None
        assert r["jax_loaded"] == []


def test_6dof_one_rank_is_bitwise_the_one_shard_step(start):
    res = _ranks_run(start, 1)
    got, single = res[0], res[0]["single"]
    assert res[0]["stats"]["exchanges"] == 0
    assert got["iters"] == single["iters"]
    for at in ("first", "last"):
        for k in FIELDS:
            np.testing.assert_array_equal(got[at][k], single[at][k],
                                          err_msg=f"{at} {k}")


@pytest.fixture(scope="module")
def six_runs(tmp_path_factory):
    """(b)'s case over 2 ranks, killed after the first interval and
    resumed, and the same case alone: each run's stats, log, checkpoints
    (time, fields) and case files."""
    base = tmp_path_factory.mktemp("six")
    mp = pytest.MonkeyPatch()
    mp.setenv("OFTPP_SPMD_PALLAS", "interpret")
    try:
        out = {}
        for name in ("ranks", "alone"):
            case = tcases.setup_case_6dof(SIX, str(base / name))
            lines = []
            kw = dict(devices=2, ranks=True) if name == "ranks" else {}
            stats = trunner.run_case(case, device="cpu", log=lines.append,
                                     **kw)
            run = {"stats": stats, "lines": lines, "case": case}
            if name == "ranks":
                chks = tio.list_checkpoints(case)
                run["unkilled"] = tio.load_checkpoint(chks[-1][1])
                for t, path in chks:
                    if t > 0.05 + 1e-9:
                        os.remove(path)
                run["again"] = trunner.run_case(case, device="cpu",
                                                log=quiet, **kw)
            run["chks"] = [(float(tio.load_checkpoint(p)["t"]),
                            tio.load_checkpoint(p))
                           for _, p in tio.list_checkpoints(case)]
            out[name] = run
        yield out
    finally:
        mp.undo()
        shutil.rmtree(base, ignore_errors=True)


def test_6dof_run_case_over_ranks_resumes_and_matches_the_lone_run(six_runs):
    ranks, alone = six_runs["ranks"], six_runs["alone"]
    assert any("backend gloo" in ln and "nxl = 2" in ln
               for ln in ranks["lines"]), ranks["lines"]
    times = [t for t, _ in ranks["chks"]]
    assert times == [t for t, _ in alone["chks"]]
    assert times == [0.0] + [float(np.float32(k) * np.float32(0.05))
                             for k in (1, 2)]
    for rel in ("case.json", os.path.join("constant", "6DoF.dat")):
        with open(os.path.join(ranks["case"], rel), "rb") as f, \
                open(os.path.join(alone["case"], rel), "rb") as g:
            assert f.read() == g.read(), rel
    assert 0 < ranks["again"]["steps"] < ranks["stats"]["steps"]
    final = ranks["chks"][-1][1]
    for k in FIELDS:
        np.testing.assert_array_equal(final[k], ranks["unkilled"][k],
                                      err_msg=k)
    lone = alone["chks"][-1][1]
    assert final["alpha"].shape == lone["alpha"].shape == (4, 4, 8)
    assert np.abs(final["alpha"] - lone["alpha"]).max() < 5e-3
    assert 0.0 <= final["alpha"].min() and final["alpha"].max() <= 1.0
    assert float(np.abs(final["w"]).max()) > 1e-3   # the tank sloshes
    per_rank = ranks["stats"]["ranks"]
    assert per_rank[0]["p_iters"] == per_rank[1]["p_iters"]
    assert len(per_rank[0]["p_iters"]) == ranks["stats"]["steps"]
    probe = np.loadtxt(os.path.join(ranks["case"], "postProcessing",
                                    "probes", "0", "p"))
    assert probe.shape[0] == int(final["step"])
    assert np.isfinite(probe).all()


def test_6dof_table_bits_are_equal_on_every_rank(six_runs):
    ranks, alone = six_runs["ranks"], six_runs["alone"]
    digests = [r["motion_sha256"] for r in ranks["stats"]["ranks"]]
    lone = trunner.build_case_motion(tcases.load_case_params(alone["case"]),
                                     alone["case"], device="cpu")
    assert digests == [lone.sha256()] * 2


def test_grid_not_a_multiple_of_8n_resumes_over_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")
    alone = tcases.setup_case(ORBIT, str(tmp_path / "alone"))
    trunner.run_case(alone, device="cpu", log=quiet)
    lone = tio.load_checkpoint(tio.list_checkpoints(alone)[-1][1])
    assert lone["alpha"].shape[0] == 8   # 2 ranks: not a multiple of 16
    case = tcases.setup_case(ORBIT, str(tmp_path / "ranks"))
    for t, path in tio.list_checkpoints(alone):
        if t < 0.05 + 1e-9:
            shutil.copy(path, case)
    lines = []
    stats = trunner.run_case(case, devices=2, device="cpu", ranks=True,
                             log=lines.append)
    assert any("nxl = 4" in ln for ln in lines), lines
    assert any("Resuming from t=0.0500" in ln for ln in lines), lines
    assert stats["steps"] > 0
    chks = [tio.load_checkpoint(p) for _, p in tio.list_checkpoints(case)]
    assert [float(c["t"]) for c in chks] == [
        float(tio.load_checkpoint(p)["t"])
        for _, p in tio.list_checkpoints(alone)]
    final = chks[-1]
    assert final["alpha"].shape == lone["alpha"].shape
    assert np.abs(final["alpha"] - lone["alpha"]).max() < 5e-3
