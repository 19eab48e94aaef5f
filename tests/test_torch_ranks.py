"""The x-sharded step over ranks, one process a shard (parallel/ranks.py),
on the CPU: gloo between spawned processes, the islands' kernels as their
plain versions (what OFTPP_SPMD_PALLAS=interpret runs). The rank
processes run tests/torch_rank_jobs.py, which imports torch and the port
only.

(a) 2 and 4 ranks, 3 steps of the 16×16×10 tank from rest (R 2 mm,
    3 Hz, a 5 ms ramp: the flow is under way within the 3 steps; on the
    JAX spmd test's 0.1 s ramp the velocities stay near 2e-4 m/s and the
    port's own single-process sharded step sits 3.1e-6 from JAX's, over
    that test's 2e-6 floor), against the port's single-process
    `SpmdCtx(S)` step and the JAX `spmd` step on one shard (interpret
    mode, as tests/test_torch_spmd.py builds it): the first step's alpha
    and dt bitwise the port's (the dt is a maximum, MULES has no global
    sum), and after 3 steps every field within test_torch_spmd.py's
    bounds (2e-3 of its scale, a 2e-6 floor) of either reference, t to
    rtol 1e-6, p_iters within 1 of the port's and 2 of JAX's (its bound);
    only the halo entry points run, on every rank.
(b) One rank: bitwise `SpmdCtx(1)` after 3 steps (every exchange is an
    edge fill, every reduction the identity).
(c) The 24×16×10 box over 4 ranks, local nx 6 → 3: the first coarse level
    is gathered on every rank, and one V-cycle on a seeded residual is
    bitwise the single-process `SpmdCtx(4)` V-cycle.
(d) `run_case(devices=2, device="cpu", ranks=True)` on the tiny verify
    case over 0.1 s: checkpoints at 0, 0.05, 0.1 with the f32 write times,
    killed after the first interval and resumed (the resumed run bitwise
    the run that was not killed); against the unsharded step on the same
    grid, the JAX sharded-run test's bounds (alpha 5e-3, t 1e-9); one
    probe row a step.
(e) 'NxM' on ranks raises NotImplementedError, and a grid that does not
    divide into even x-slabs raises ValueError, before any spawn, as on
    distinct cards (none is touched). The 6DoF tank and grids that are
    not a multiple of 8·N run over ranks: tests/test_torch_ranks_6dof.py.
"""

import os

import jax
import numpy as np
import pytest

import torch_rank_jobs as jobs
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
from openfoam_tpp_tpu_torch.core.state import CaseParams, params_from_numpy
from openfoam_tpp_tpu_torch.core.state import state_from_numpy, state_to_numpy
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.post.probes import make_probe_sampler
from openfoam_tpp_tpu_torch.solver.timestep import make_step
from openfoam_tpp_tpu_torch.utils import io as tio

TANK = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=16)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = dict(R=0.002, freq=3.0, duration=0.05)
N_STEPS = 3
# tests/test_sharded_run.py's case, at two write intervals.
RUN = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
       "freq": 3.0, "duration": 0.1, "dt": 5e-4, "ramp": -1.0}
HALO = {"halo7.apply_7pt_hs", "halo7.resid_scaled_7pt_hs",
        "halo7.apply_dot_7pt_h", "mules_flux.flux_all_h",
        "mules_fct.fct_iter_h", "momentum_rhs.momentum_rhs_h",
        "correction.correct_divmax_h"}
quiet = lambda *a: None


@pytest.fixture(scope="module")
def start():
    """The start on TANK: the state at rest and the forcing parameters as
    numpy, and the JAX `spmd` step's state after N_STEPS
    (one shard on a one-device mesh, the halo kernels in interpret mode)
    with its p_iters."""
    jg = jbuild(**TANK)
    ctx = jsm.SpmdCtx(mesh=jsh.make_mesh(1), axis="x", interpret=True)
    step = jax.jit(jmake(jg, JProps(), JControls(use_pallas=True,
                                                 p_max_iters=30), spmd=ctx))
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


_RUNS = {}


def _ranks_run(start, world):
    """The rank job's results over `world` CPU ranks (run once a world)."""
    if world not in _RUNS:
        init, params, _, _ = start
        _RUNS[world] = rk.launch(jobs.steps, ["cpu"] * world, log=quiet,
                                 args=(TANK, init, params, N_STEPS,
                                       world == 1))
    return _RUNS[world]


def _single(start, n_shards):
    """The port's single-process SpmdCtx(n_shards) step from the start:
    the state after the first and the last step, and the p_iters."""
    init, params, _, _ = start
    step = make_step(tbuild(**TANK), TProps(), jobs.CONTROLS,
                     spmd=SpmdCtx(n_shards), device="cpu")
    s = state_from_numpy(init, device="cpu")
    p = params_from_numpy(params, device="cpu")
    first, last, iters = jobs._steps(step, s, p, N_STEPS)
    return state_to_numpy(first), state_to_numpy(last), iters


def _held(got, ref, label):
    """tests/test_torch_spmd.py's bounds for the sharded step."""
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    for k in ("alpha", "u", "v", "w", "p"):
        scale = max(float(np.abs(ref[k]).max()), 1e-12)
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= max(2e-3 * scale, 2e-6), (label, k, err, scale)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_single_process_sharded_step(start, world):
    res = _ranks_run(start, world)
    got = res[0]
    first, last, iters = _single(start, world)
    for k in ("alpha", "dt", "t"):
        np.testing.assert_array_equal(got["first"][k], first[k], err_msg=k)
    assert float(np.abs(last["w"]).max()) > 1e-4   # the fluid is moving
    _held(got["last"], last, f"{world} ranks vs SpmdCtx({world})")
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], iters)), (
        got["iters"], iters)
    # Every rank ran the islands alone (one fct_iter_h a limiter iteration
    # of each subcycle), exchanged planes and took the same reductions;
    # no rank loaded JAX.
    for r in res:
        assert set(r["calls"]) == HALO, r["calls"]
        assert r["calls"]["mules_fct.fct_iter_h"] == 9 * N_STEPS
        assert r["calls"]["momentum_rhs.momentum_rhs_h"] == N_STEPS
        assert r["stats"]["exchanges"] > 0 and r["stats"]["bytes"] > 0
        assert r["stats"]["all_reduces"] == res[0]["stats"]["all_reduces"]
        assert r["jax_loaded"] == []


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_jax_sharded_step(start, world):
    _, _, ref, jiters = start
    got = _ranks_run(start, world)[0]
    _held(got["last"], ref, f"{world} ranks vs JAX")
    assert all(abs(a - b) <= 2 for a, b in zip(got["iters"], jiters)), (
        got["iters"], jiters)


def test_one_rank_is_bitwise_the_one_shard_step(start):
    res = _ranks_run(start, 1)
    got, single = res[0], res[0]["single"]
    assert res[0]["stats"]["exchanges"] == 0
    assert got["iters"] == single["iters"]
    for at in ("first", "last"):
        for k in FIELDS:
            np.testing.assert_array_equal(got[at][k], single[at][k],
                                          err_msg=f"{at} {k}")


def test_agglomerated_vcycle_is_bitwise():
    res = rk.launch(jobs.vcycle_ranks, ["cpu"] * 4, log=quiet, args=(3,))
    geom, ga, rho, r = jobs.vcycle_operands(3)
    z, bundle = jobs.vcycle(geom, ga, rho, r, SpmdCtx(4))
    # 24 → 12 cells along x: local 6 → 3, so the first coarse level (and
    # the one below it) is held whole on every rank, the first marked.
    assert res[0]["levels"] == [(12, True), (6, False)]
    assert [e["faces"][0].shape[0] - 1 for e in bundle["coarse"]] == [12, 6]
    assert float(np.abs(z.numpy()).max()) > 0.1
    for got in res:
        np.testing.assert_array_equal(got["z"], z.numpy())


def test_run_case_over_ranks_resumes_and_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")
    case = tcases.setup_case(RUN, str(tmp_path))
    lines = []
    stats = trunner.run_case(case, devices=2, device="cpu", ranks=True,
                             log=lines.append)
    assert any("backend gloo" in ln and "x-sharded step over 2 ranks" in ln
               for ln in lines), lines
    chks = tio.list_checkpoints(case)
    targets = [float(np.float32(k) * np.float32(0.05)) for k in (1, 2)]
    assert [t for t, _ in chks] == pytest.approx([0.0, 0.05, 0.1], abs=1e-6)
    assert [float(tio.load_checkpoint(p)["t"]) for _, p in chks] == (
        [0.0] + targets)
    assert [r["p_iters"] for r in stats["ranks"]][0] \
        == stats["ranks"][1]["p_iters"]
    assert len(stats["ranks"][0]["p_iters"]) == stats["steps"]
    once = tio.load_checkpoint(chks[-1][1])
    for t, path in chks:
        if t > 0.05 + 1e-9:
            os.remove(path)
    again = trunner.run_case(case, devices=2, device="cpu", ranks=True,
                             log=quiet)
    assert 0 < again["steps"] < stats["steps"]
    final = tio.load_checkpoint(tio.list_checkpoints(case)[-1][1])
    for k in FIELDS:
        np.testing.assert_array_equal(final[k], once[k], err_msg=k)

    # The unsharded step on the same rounded grid, through the runner's
    # advance to the same write targets.
    geom = trunner.build_case_geometry(RUN, devices=2, device="cpu")
    assert final["alpha"].shape == geom.shape == (16, 16, 10)
    step = make_step(geom, TProps(), TControls(use_pallas=True),
                     carry_precond=True, device="cpu")
    sampler, width = make_probe_sampler(
        geom, trunner.default_probe_points(geom),
        trunner.default_wave_columns(geom), device="cpu")
    adv = trunner.make_advance(step, sampler=sampler, sample_width=width)
    state = trunner.init_state(geom, dt0=RUN["dt"], device="cpu")
    params = CaseParams.make(RUN["R"], RUN["freq"], RUN["duration"],
                             device="cpu")
    for t in targets:
        state = adv(state, params, t)[0]
    assert np.abs(final["alpha"] - state.alpha.numpy()).max() < 5e-3
    assert abs(float(final["t"]) - float(state.t)) < 1e-9
    probe = np.loadtxt(os.path.join(case, "postProcessing", "probes", "0",
                                    "p"))
    assert probe.shape[0] == int(final["step"])
    assert np.isfinite(probe).all() and probe[-1, 1] > 50.0   # water probe


def test_ranks_refuse_what_the_next_slice_brings(tmp_path, monkeypatch):
    """'NxM' raises NotImplementedError on the rank path, and a grid that
    does not divide into even x-slabs of at least two planes raises
    ValueError naming nx, the ranks and the rule: nx % N != 0 (the 6DoF
    tank's 4 planes over 3 ranks) and an odd nxl (its 6 planes over 2).
    All before a process is spawned, on positions that share the host
    and on distinct cards (named only: none is touched here)."""
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")

    def no_spawn(*a, **k):
        raise AssertionError("a rank process was spawned")

    monkeypatch.setattr(rk, "launch", no_spawn)
    orbit = tcases.setup_case(RUN, str(tmp_path / "orbit"))
    six = {"Ly": 0.2, "Lz": 0.4, "mesh": 0.05, "chamfer": 0.2,
           "duration": 0.05, "dt": 0.002}
    four = tcases.setup_case_6dof({**six, "Lx": 0.2}, str(tmp_path / "c4"))
    odd = tcases.setup_case_6dof({**six, "Lx": 0.3}, str(tmp_path / "c6"))
    for case, devices, error, why in (
            (orbit, "2x2", NotImplementedError, "'NxM'"),
            (four, 3, ValueError, "nx=4 does not divide over 3 'x' "
                                  "shards"),
            (odd, 2, ValueError, "nx=6 over 2 ranks: x-slabs of nxl = 3 "
                                 "planes, an odd number")):
        n = 4 if devices == "2x2" else devices
        for device, ranks in (("cpu", True),
                              (",".join(f"cuda:{i}" for i in range(n)),
                               False)):
            with pytest.raises(error, match=why):
                trunner.run_case(case, devices=devices, device=device,
                                 ranks=ranks, log=quiet)
