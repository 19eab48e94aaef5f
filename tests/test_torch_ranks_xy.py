"""'NxM' over ranks: the 2-D x·y decomposition, one process a block
(parallel/ranks.py on an (N, M) rank grid, parallel/spmd.py's islands on
y-extended blocks), on the CPU: gloo between spawned processes, the
islands' kernels as their plain versions (what OFTPP_SPMD_PALLAS=interpret
runs). The rank processes run tests/torch_rank_jobs.py, which imports
torch and the port only. Four ranks are launched once for (a)–(c), (e)
and the islands; '1x2' once more.

(a) '2x2' and '1x2', 3 steps of the 16×16×10 tank from rest (the case of
    tests/test_torch_ranks.py): the first step's alpha and dt bitwise the
    port's one-process `SpmdCtx(1)` step; after 3 steps every field within
    test_torch_ranks.py's bounds (2e-3 of its scale, a 2e-6 floor) of the
    JAX unsharded step (one shard, the halo kernels in interpret mode)
    and of the port's one-process step, t to rtol 1e-6; p_iters within 1
    of the port's and 2 of JAX's; every rank runs the seven halo entry
    points alone and exchanges along both axes.
(b) '4x1' is the 1-D x decomposition: bitwise the ranks laid out by
    default (`devices=4`), with the same exchange counts and no y
    exchange.
(c) The gathered V-cycle on a 24×24×10 box over '2x2' (local 12 → 6 → 3):
    the first level of odd local nx and ny is gathered on every rank, and
    one V-cycle on a seeded residual is bitwise the single-process one.
(d) `run_case(case, devices="2x2", device="cpu", ranks=True)` on the tiny
    verify case over 0.1 s: killed after the first interval and resumed
    (bitwise the run that was not killed); within the JAX sharded-run
    test's bounds (alpha 5e-3, t 1e-9) of the unsharded run; one probe
    row a step; the log names the blocks (JAX's 'NxM' grid, 8×8×10:
    blocks of 4 × 4).
(e) The 8×8×12 closed 6DoF box of tests/test_torch_6dof.py over '2x2'
    (blocks of 4 × 4), 3 steps from rest, against the JAX unsharded plain
    step within tests/test_torch_ranks_6dof.py (a)'s bounds, and
    against the port's one-process `SpmdCtx(2)` step: first step's alpha
    and dt bitwise, fields within 2e-3 of scale, p_iters within 1.
(f) The row windows of `apply_dot_7pt_h_plain` and
    `correct_divmax_h_plain`: the windowed dot is the plain sum over the
    window's rows and the windowed div max the whole grid's maximum over
    them, the elementwise outputs unchanged; the full window is bitwise
    the call without one.
The islands: every island over '2x2' on y-extended blocks (16×12×16,
blocks of 8 × 6), f32 and bf16, gathered, bitwise the single-grid entry
points' elementwise outputs (the dot to 1e-6 relative, another order;
the div max exactly): the y reach of each island is within the rows it
adds, and the x halo planes carry the x·y corners.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from test_torch_6dof import _tables
from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core import motion as jmo
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_box_geometry as jbox
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sharding as jsh
from openfoam_tpp_tpu.parallel import spmd as jsm
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (CaseParams, params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import halo7
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel import spmd as sm
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.post.probes import make_probe_sampler
from openfoam_tpp_tpu_torch.solver.timestep import make_step
from openfoam_tpp_tpu_torch.utils import io as tio

TANK = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=16)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = dict(R=0.002, freq=3.0, duration=0.05)
N_STEPS = 3
BOX_XY = (0.096, 0.096, 0.04, 0.004)   # 24×24×10 at 4 mm, open top
BOX6 = dict(Lx=0.08, Ly=0.08, Lz=0.12, mesh=0.01)   # 8×8×12, closed
SIX_CONTROLS = TControls(use_pallas=True, fct_bf16=False, p_max_iters=30)
RUN = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
       "freq": 3.0, "duration": 0.1, "dt": 5e-4, "ramp": -1.0}
HALO = {"halo7.apply_7pt_hs", "halo7.resid_scaled_7pt_hs",
        "halo7.apply_dot_7pt_h", "mules_flux.flux_all_h",
        "mules_fct.fct_iter_h", "momentum_rhs.momentum_rhs_h",
        "correction.correct_divmax_h"}
SIX_PARAMS = {"orbit_radius": 0.0, "omega": 0.0, "ramp_time": 0.0}
quiet = lambda *a: None


@pytest.fixture(scope="module")
def start():
    """The orbital tank at rest and its forcing as numpy, and the JAX
    unsharded step's state after N_STEPS (one shard on a one-device mesh,
    the halo kernels in interpret mode) with its p_iters."""
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


@pytest.fixture(scope="module")
def start6():
    """The closed box at rest filled to z = 0 and the motion table as
    numpy, and the JAX plain 6DoF step's state after N_STEPS with its
    p_iters and the fluid mask."""
    jm = jmo.TableMotion.from_table(*_tables())
    jg = jbox(**BOX6)
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


def _four(start, start6):
    """The one launch of four CPU ranks: '2x2' steps of the tank, '4x1'
    and the default layout, the '2x2' V-cycle, the '2x2' 6DoF steps and
    the '2x2' islands, in that order."""
    if "four" not in _RUNS:
        init, params = start[:2]
        init6, table = start6[:2]
        tasks = [
            ("steps", (TANK, init, params, N_STEPS), {"grid": (2, 2)}),
            ("steps", (TANK, init, params, N_STEPS), {"grid": (4, 1)}),
            ("steps", (TANK, init, params, N_STEPS), {}),
            ("vcycle_ranks", (3, BOX_XY), {"grid": (2, 2)}),
            ("steps", ({"box": BOX6}, init6, SIX_PARAMS, N_STEPS),
             {"table": table, "controls": SIX_CONTROLS, "grid": (2, 2)}),
            ("islands", (7,), {"grid": (2, 2)})]
        _RUNS["four"] = rk.launch(jobs.many, ["cpu"] * 4, log=quiet,
                                  args=(tasks,))
    return _RUNS["four"]


def _grid_run(start, start6, grid):
    """Every rank's result of the tank's steps on the rank grid `grid`."""
    if grid == (2, 2):
        return [r[0] for r in _four(start, start6)]
    if grid not in _RUNS:
        init, params = start[:2]
        _RUNS[grid] = rk.launch(jobs.steps, ["cpu"] * (grid[0] * grid[1]),
                                log=quiet, grid=grid,
                                args=(TANK, init, params, N_STEPS))
    return _RUNS[grid]


def _one_process(start, n_shards, tank=TANK, table=None, controls=None):
    """The port's one-process SpmdCtx(n_shards) step from the start: the
    states after the first and the last step and the p_iters."""
    init, params = start[:2]
    geom = jobs.geometry(tank)
    motion = (None if table is None else jobs.motion_from_numpy(
        *(table[k] for k in jobs.MOTION_FIELDS), device="cpu"))
    step = make_step(geom, TProps(), controls or jobs.CONTROLS,
                     motion=motion, spmd=SpmdCtx(n_shards), device="cpu")
    s = state_from_numpy(init, device="cpu")
    p = params_from_numpy(params, device="cpu")
    first, last, iters = jobs._steps(step, s, p, N_STEPS)
    return state_to_numpy(first), state_to_numpy(last), iters


def _held(got, ref, label, vscale=False):
    """tests/test_torch_ranks.py's bounds for the sharded step (with
    `vscale`, the velocities of the velocity field's scale)."""
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    vs = max(float(np.abs(ref[k]).max()) for k in "uvw")
    for k in ("alpha", "u", "v", "w", "p"):
        scale = (vs if vscale and k in "uvw"
                 else max(float(np.abs(ref[k]).max()), 1e-12))
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= max(2e-3 * scale, 2e-6), (label, k, err, scale)


GRIDS = {"2x2": (2, 2), "1x2": (1, 2)}


# --------------------------------------------------------------------- (a)

@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_xy_ranks_match_the_one_process_step(start, start6, grid):
    res = _grid_run(start, start6, GRIDS[grid])
    got = res[0]
    first, last, iters = _one_process(start, 1)
    for k in ("alpha", "dt", "t"):
        np.testing.assert_array_equal(got["first"][k], first[k], err_msg=k)
    assert float(np.abs(last["w"]).max()) > 1e-4   # the fluid is moving
    _held(got["last"], last, f"{grid} ranks vs SpmdCtx(1)")
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], iters)), (
        got["iters"], iters)
    # Every rank ran the seven islands alone, exchanged rows along y (and
    # planes along x where the grid has two columns of ranks) and took
    # the same reductions; no rank loaded JAX.
    for r in res:
        assert set(r["calls"]) == HALO, r["calls"]
        assert r["calls"]["mules_fct.fct_iter_h"] == 9 * N_STEPS
        assert r["stats"]["y_exchanges"] > 0 and r["stats"]["y_bytes"] > 0
        assert r["stats"]["copy_bytes"] >= r["stats"]["y_bytes"]
        assert (r["stats"]["exchanges"] > 0) == (GRIDS[grid][0] > 1)
        assert r["stats"]["all_reduces"] == res[0]["stats"]["all_reduces"]
        assert r["jax_loaded"] == []


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_xy_ranks_match_the_jax_step(start, start6, grid):
    _, _, ref, jiters = start
    got = _grid_run(start, start6, GRIDS[grid])[0]
    _held(got["last"], ref, f"{grid} ranks vs JAX")
    assert all(abs(a - b) <= 2 for a, b in zip(got["iters"], jiters)), (
        got["iters"], jiters)


# --------------------------------------------------------------------- (b)

def test_4x1_is_bitwise_the_x_only_ranks(start, start6):
    res = _four(start, start6)
    for r in res:
        four_by_one, default = r[1], r[2]
        assert four_by_one["stats"]["y_exchanges"] == 0
        assert four_by_one["stats"]["copy_bytes"] == 0
        for k in ("exchanges", "bytes", "all_reduces", "gathers"):
            assert four_by_one["stats"][k] == default["stats"][k], k
        assert four_by_one["calls"] == default["calls"]
    got, ref = res[0][1], res[0][2]
    assert got["iters"] == ref["iters"]
    for at in ("first", "last"):
        for k in FIELDS:
            np.testing.assert_array_equal(got[at][k], ref[at][k],
                                          err_msg=f"{at} {k}")


# --------------------------------------------------------------------- (c)

def test_xy_agglomerated_vcycle_is_bitwise(start, start6):
    res = [r[3] for r in _four(start, start6)]
    geom, ga, rho, r = jobs.vcycle_operands(3, BOX_XY)
    z, bundle = jobs.vcycle(geom, ga, rho, r, SpmdCtx(4))
    # Local 12 → 6 → 3 along x and y: the second coarse level (global 6)
    # is the first of odd local nx and ny, held whole on every rank.
    assert res[0]["levels"] == [(6, False), (6, True)]
    assert res[0]["y_levels"] == [6, 6]
    assert float(np.abs(z.numpy()).max()) > 0.1
    for got in res:
        np.testing.assert_array_equal(got["z"], z.numpy())


# --------------------------------------------------------------------- (d)

def test_run_case_2x2_over_ranks_resumes_and_matches(tmp_path, monkeypatch):
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")
    case = tcases.setup_case(RUN, str(tmp_path))
    lines = []
    stats = trunner.run_case(case, devices="2x2", device="cpu", ranks=True,
                             log=lines.append)
    assert any("backend gloo" in ln and "over 2x2 ranks" in ln
               and "nxl x nyl = 4 x 4" in ln for ln in lines), lines
    chks = tio.list_checkpoints(case)
    targets = [float(np.float32(k) * np.float32(0.05)) for k in (1, 2)]
    assert [float(tio.load_checkpoint(p)["t"]) for _, p in chks] == (
        [0.0] + targets)
    per_rank = stats["ranks"]
    assert len(per_rank) == 4
    assert all(r["p_iters"] == per_rank[0]["p_iters"] for r in per_rank)
    assert len(per_rank[0]["p_iters"]) == stats["steps"]
    assert all(r["y_exchanges"] > 0 and r["exchanges"] > 0
               for r in per_rank)
    once = tio.load_checkpoint(chks[-1][1])
    for t, path in chks:
        if t > 0.05 + 1e-9:
            os.remove(path)
    again = trunner.run_case(case, devices="2x2", device="cpu", ranks=True,
                             log=quiet)
    assert 0 < again["steps"] < stats["steps"]
    final = tio.load_checkpoint(tio.list_checkpoints(case)[-1][1])
    for k in FIELDS:
        np.testing.assert_array_equal(final[k], once[k], err_msg=k)

    # The unsharded step on the same grid, through the runner's advance
    # to the same write targets.
    geom = trunner.build_case_geometry(RUN, devices="2x2", device="cpu")
    assert final["alpha"].shape == geom.shape == (8, 8, 10)
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


# --------------------------------------------------------------------- (e)

def test_6dof_2x2_ranks_match_the_jax_step(start, start6):
    _, _, ref, jiters, fluid = start6
    got = _four(start, start6)[0][4]
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


def test_6dof_2x2_ranks_match_the_one_process_step(start, start6):
    res = [r[4] for r in _four(start, start6)]
    got = res[0]
    first, last, iters = _one_process(
        (start6[0], SIX_PARAMS), 2, tank={"box": BOX6}, table=start6[1],
        controls=SIX_CONTROLS)
    for k in ("alpha", "dt", "t"):
        np.testing.assert_array_equal(got["first"][k], first[k], err_msg=k)
    _held(got["last"], last, "2x2 6DoF ranks vs SpmdCtx(2)", vscale=True)
    assert all(abs(a - b) <= 1 for a, b in zip(got["iters"], iters)), (
        got["iters"], iters)
    for r in res:
        assert set(r["calls"]) == HALO, r["calls"]
        assert r["calls"]["correction.correct_divmax_h"] == N_STEPS
        assert r["motion"] == res[0]["motion"] is not None


# ----------------------------------------------------------------- islands

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xy_islands_equal_single_grid(start, start6, dtype):
    res = [r[5] for r in _four(start, start6)]
    ref = jobs.run_islands(jobs._as_torch(jobs.island_operands(7), dtype),
                           None, dtype)
    got = res[0]["out"]
    for k, v in ref.items():
        g = got[f"{k} {dtype}"]
        if v.dim() == 0 and k == "dot":
            assert abs(g - float(v)) <= 1e-6 * abs(float(v)), (k, g, v)
        elif v.dim() == 0:
            assert g == float(v), (k, g, float(v))   # a maximum: exact
        else:
            np.testing.assert_array_equal(g, v.float().numpy(), err_msg=k)
    for r in res:
        assert set(r["calls"]) == HALO, r["calls"]
        np.testing.assert_equal(r["out"], got)   # every rank gathered it


# --------------------------------------------------------------------- (f)

def _seven_point_block(seed=11, shape=(6, 10, 8)):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, s=shape: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32))
    p = f(-1, 1)
    w = [f(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    plane = (1,) + shape[1:]
    return p, f(-1, 1, plane), f(-1, 1, plane), f(0.05, 0.3, plane), tuple(w)


@pytest.mark.parametrize("rows", [(0, 10), (1, 9), (2, 7)])
def test_windowed_apply_dot_plain(rows):
    args = _seven_point_block()
    ap0, dot0 = halo7.apply_dot_7pt_h_plain(*args)
    ap, dot = halo7.apply_dot_7pt_h_plain(*args, rows=rows)
    assert torch.equal(ap, ap0)
    y0, y1 = rows
    want = st.sum_cells((args[0].float() * ap0.float())[:, y0:y1])
    assert torch.equal(dot, want)
    if rows == (0, 10):
        assert torch.equal(dot, dot0)   # the full window: bitwise as before
    acc = torch.tensor(0.25)
    assert torch.equal(halo7.apply_dot_7pt_h(*args, acc=acc, rows=rows)[1],
                       acc + want)
    with pytest.raises(ValueError, match="row window"):
        halo7.apply_dot_7pt_h_plain(*args, rows=(3, 11))


def _corr_block(seed=12, shape=(6, 10, 8)):
    """One shard holding the whole grid: the slab, its halo planes at the
    global ends (dp clamped, the sealed wall's zero faces), the whole
    grid's operands."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    u = lambda lo, hi, s: torch.from_numpy(
        rng.uniform(lo, hi, s).astype(np.float32))
    fs = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    vel = [u(-1, 1, s) for s in fs]
    beta = [u(8e-4, 1e-3, s) for s in fs]
    aps = [u(0, 1, s) for s in fs]
    for f in (vel, aps):
        f[0][0] = f[0][-1] = 0
        f[1][:, 0] = f[1][:, -1] = 0
        f[2][:, :, 0] = 0
    for a in aps:
        a[a < 0.2] = 0
    vfrac = u(0, 1, shape)
    vfrac[vfrac < 0.1] = 0
    dp, rho = u(-50, 50, shape), u(1, 998, shape)
    topo = (u(0, 1, (nx, ny)) > 0.3).float()
    whole = (dp, *vel, tuple(beta), *aps, vfrac, topo, rho,
             torch.tensor(3.7e-3), (0.002, 0.0021, 0.0019))
    zero = torch.zeros((1, ny, nz))
    slab = (dp, dp[:1], dp[-1:], vel[0][:-1], zero, vel[1], vel[2],
            beta[0][:-1], zero, beta[1], beta[2], aps[0][:-1], zero, aps[1],
            aps[2], vfrac, topo, rho, torch.tensor(3.7e-3),
            (0.002, 0.0021, 0.0019))
    return whole, slab


@pytest.mark.parametrize("open_top", [True, False])
@pytest.mark.parametrize("rows", [(0, 10), (1, 9), (3, 4)])
def test_windowed_correct_divmax_plain(open_top, rows):
    whole, slab = _corr_block()
    got = ck.correct_divmax_h_plain(*slab, open_top=open_top, rows=rows)
    full = ck.correct_divmax_h_plain(*slab, open_top=open_top)
    for g, f in zip(got[:3], full[:3]):
        assert torch.equal(g, f)
    # The whole grid's |∇·(A·q_c)| over the fluid cells, its max over the
    # window's rows.
    dp, u, v, w, beta, ax, ay, az, vfrac, topo, rho, dt, h = whole
    qc = ck.correct_velocities_plain(dp, u, v, w, beta, ax, ay, az, topo,
                                     rho, dt, h, open_top)
    cells = (torch.abs(st.divergence(ax * qc[0], ay * qc[1], az * qc[2], h))
             * (vfrac > 0.0))
    y0, y1 = rows
    assert torch.equal(got[3], cells[:, y0:y1].max())
    if rows == (0, 10):
        assert torch.equal(got[3], full[3])
    assert torch.equal(ck.correct_divmax_h(*slab, open_top=open_top,
                                           rows=rows)[3], got[3])


# ------------------------------------------------------------ the rank grid

def test_rank_grid_neighbours_and_blocks():
    """r = ix·M + iy (y fastest): the x neighbours are r ± M, the y
    neighbours r ± 1, none past a global end; a block keeps its face
    arrays' shared plane or row; a grid that is not N·M of the world
    raises."""
    ctxs = [rk.RankCtx(rank=r, world=6, device=torch.device("cpu"),
                       backend="gloo", grid=(3, 2)) for r in range(6)]
    assert [(c.ix, c.iy) for c in ctxs] == [(i, j) for i in range(3)
                                            for j in range(2)]
    assert [c.neighbours(0) for c in ctxs] == [
        (None, 2), (None, 3), (0, 4), (1, 5), (2, None), (3, None)]
    assert [c.neighbours(1) for c in ctxs] == [
        (None, 1), (0, None), (None, 3), (2, None), (None, 5), (4, None)]
    assert ctxs[3].left == 1 and ctxs[3].right == 5
    g = np.arange(7 * 4 * 2).reshape(7, 4, 2)   # x faces of 6 × 4 cells
    blk = ctxs[3].block(g, (6, 4))
    assert blk.shape == (3, 2, 2)
    np.testing.assert_array_equal(blk, g[2:5, 2:4])
    yf = np.arange(6 * 5).reshape(6, 5)          # y faces of a 2-D plane
    np.testing.assert_array_equal(ctxs[3].block(yf, (6, 4)), yf[2:4, 2:5])
    assert rk.RankCtx(rank=0, world=4, device=torch.device("cpu"),
                      backend="gloo").grid == (4, 1)
    with pytest.raises(ValueError, match="N·M must be the world size"):
        rk.RankCtx(rank=0, world=4, device=torch.device("cpu"),
                   backend="gloo", grid=(3, 2))


def test_spmd_ctx_y_shards_and_y_blocks():
    """SpmdCtx(N, M): ny must divide into M blocks of at least MAX_HALO
    rows (the error names ny and nyl); one process holds x-slabs only;
    a y block adds rows only on its interior sides, and not at all with
    one row of ranks."""
    assert SpmdCtx(2, 2).local_shape((16, 12, 10)) == (8, 6, 10)
    assert SpmdCtx(2, 2).supports((16, 12, 10))
    assert not SpmdCtx(2, 8).supports((16, 12, 10))
    with pytest.raises(ValueError, match="ny=12 does not divide over 8 'y' "
                                         "shards.*nyl = 1.5"):
        SpmdCtx(2, 8).local_shape((16, 12, 10))
    with pytest.raises(NotImplementedError, match="x-slabs only"):
        make_step(tbuild(**TANK), spmd=SpmdCtx(2, 2), device="cpu")
    ctxs = [rk.RankCtx(rank=r, world=6, device=torch.device("cpu"),
                       backend="gloo", grid=(2, 3)) for r in range(6)]
    widths = [(b.lo, b.hi, b.rows) for b in (
        sm.YBlock(SpmdCtx(2, 3, ranks=c), 4, (2, 1)) for c in ctxs)]
    assert widths == [(0, 1, (0, 4)), (2, 1, (2, 6)), (2, 0, (2, 6))] * 2
    one_row = rk.RankCtx(rank=1, world=2, device=torch.device("cpu"),
                         backend="gloo")
    assert not sm.YBlock(SpmdCtx(2, ranks=one_row), 4, (2, 2)).on
    with pytest.raises(ValueError, match="rank grid"):
        SpmdCtx(2, 3, ranks=one_row)
