"""`forcing=` over ranks, the tiled sweep over x·y ranks and the geometry
sweep over (case, x, y) ranks, on the CPU: gloo between spawned processes
that run tests/torch_rank_jobs.py (torch and the port only), the islands'
kernels as their plain versions. One launch each of one, two and four
ranks serves (b) and (c); (d) launches its own.

(a) The forcing cut (solver/timestep.py `block_forcing`): on every block
    of a 2 x-rank and a '2x2' rank grid, a whole-grid forcing's 0-d and
    extent-1 components pass as they are, a component that varies along
    x or y is cut to the block's cells, and one that varies along its own
    axis is cut to the block's faces, bitwise the whole grid's face
    average; an extent that is neither 1 nor the grid's, or a 2-D
    component, raises ValueError. `explicit_update` takes a component
    already on its faces bitwise as it takes the cells.
(b) The tiled sweep (tests/test_tiled_sweep.py's tank at round_to=4,
    8×8×10 a case, so '2x2' blocks hold even rows; four cases merged
    into 32×8×10, 5 steps from rest) over 2 x-ranks and over '2x2',
    through the sharding API's unbatched `ranks=` form: against the JAX
    tiled step (jnp path) at tests/test_torch_tiled_sweep.py's bounds
    (alpha 1e-5; velocities 1e-3 and p 1e-4 of scale; p_iters within 1);
    against the port's one-process tiled step on x-slabs (`SpmdCtx(N)`):
    the first step's alpha and dt bitwise, after the last alpha 1e-5 and
    velocities 1e-3 of scale, p_iters equal; every block's liquid volume
    within 1e-3 of its start (the JAX test's bound); only the halo entry
    points called, on every rank, and the plane exchanges run at the rank
    boundary although it lies on a sealed junction there. Measured on
    both grids: from JAX alpha 2.7e-6, velocities 4.1e-4 and p 2.1e-5 of
    scale, p_iters equal; from the one-process step alpha 1.1e-6 and
    velocities 4.5e-4 of scale. One rank: bitwise the one-process
    `SpmdCtx(1)` tiled step.
(c) The geometry sweep (tests/test_torch_sweep.py's two geometry rows and
    two more, H and D varied; 8×8×10 at round_to=4) over (case=2, x=2,
    y=1) ranks and over (case=1, x=2, y=2) ranks (blocks extended in x
    and y), lockstep and not, 4 steps from dt0 4e-4: against the JAX
    geometry sweep at tests/test_torch_sweep.py's step bounds (alpha
    5e-5; p 2e-4 and velocities 1e-3 of scale; p_iters within 1); every
    case's t equal on the ranks of its case position; each rank's
    spacing its cases' rows; through the batch kernels' entry points
    (OFTPP_SWEEP_PALLAS=interpret) against the port's one-process
    geometry sweep on that route at the same bounds (measured from JAX
    alpha 9.2e-6, velocities 5.4e-4 and p 3.4e-5 of scale; on the
    kernels' route 3.4e-4 of v's scale). Not lockstep to a
    t_stop reached at the third step: the fourth holds every case
    bitwise, t and the step count are the one-process run's, p_iters
    within 1 of it, alpha within 5e-6 and the velocities within 1e-2 of
    their scale (chip_smoke.py phase 4's limit, which
    tests/test_torch_ranks_farm.py's `run_sweep_ranks` test takes: at the
    landing step one case's CG stops an iteration later over ranks,
    which leaves 6.3e-3 of v's scale; the port's one-process run is
    1.4e-3 of v's scale from JAX's there).
(d) `run_tiled_sweep_ranks` over (1, 2, 1) ranks against
    `run_tiled_sweep`, and `run_sweep_ranks` of a BatchedGeometry over
    (case=2, x=1, y=2) ranks against `run_sweep` of it: the same step
    count, t bitwise, alpha within 5e-6 and the velocities within 1e-2 of
    their scale (tests/test_torch_ranks_farm.py's `run_sweep_ranks`
    bounds).
(e) Refusals before any spawn: an unbatched state on a rank grid with two
    case positions, a tiled grid of odd blocks or with case positions,
    and a BatchedGeometry that is not the rows' whole batch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sweep as jsw
from openfoam_tpp_tpu.parallel import tiled_sweep as jts
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel import sharding as tsh
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.parallel import tiled_sweep as tts
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver import momentum as mom
from openfoam_tpp_tpu_torch.solver.timestep import block_forcing

# tests/test_tiled_sweep.py's tank and rows (a fourth added: 2 x-ranks
# hold two cases each) at round_to=4.
TANK = dict(H=0.04, D=0.016, mesh=0.004, geo="flat", round_to=4)
ROWS = [
    {"R": 0.0020, "freq": 2.5, "duration": 1.0, "ramp": 0.05},
    {"R": 0.0030, "freq": 3.0, "duration": 1.0, "ramp": 0.05},
    {"R": 0.0015, "freq": 3.5, "duration": 1.0, "ramp": 0.05},
    {"R": 0.0025, "freq": 2.0, "duration": 1.0, "ramp": 0.05},
]
N_STEPS = 5
CONTROLS = TControls(use_pallas=True, p_max_iters=15, fct_bf16=False)
TILED = {"1x1": (1, 1), "2x1": (2, 1), "2x2": (2, 2)}
# tests/test_torch_sweep.py's geometry rows, and the two other pairings
# of their H and D.
GEOM_ROWS = [dict(H=h, D=d, mesh=0.004, geo="flat", R=r, freq=f)
             for h, d, r, f in ((0.04, 0.02, 0.002, 3.0),
                                (0.03, 0.016, 0.001, 2.0),
                                (0.04, 0.016, 0.0015, 2.5),
                                (0.03, 0.02, 0.0025, 3.5))]
PROWS = [{"R": r["R"], "freq": r["freq"], "duration": 0.05}
         for r in GEOM_ROWS]
GEOM_GRID = (2, 2, 1)
# The geometry sweep over y-ranks too: one case position, '2x2' blocks of
# 4 x 4 x 10 x 4 (rows 10a-c on blocks extended in x and y).
GEOM_GRID_Y = (1, 2, 2)
# (lockstep, t_stop) of the geometry runs over ranks on the kernels'
# plain route; a third runs the batch kernels' entry points.
GEOM_RUNS = ((True, None), (False, None), (False, 1.5e-3))
N_GEOM = 4
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
quiet = lambda *a: None


def _np(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


@pytest.fixture(scope="module")
def refs():
    """The JAX tiled step (jnp path) over N_STEPS, and the JAX geometry
    sweep over N_GEOM, lockstep and not: the last states and
    every step's p_iters."""
    jg = jbuild(**TANK)
    jstep = jax.jit(jts.make_tiled_sweep_step(
        jg, len(ROWS), JProps(), JControls(p_max_iters=15)))
    js, iters = jts.tile_state(jg, len(ROWS)), []
    jpar = jsw.batch_params(ROWS)
    for _ in range(N_STEPS):
        js, d = jstep(js, jpar)
        iters.append(int(d.p_iters))
    out = {"tiled": (_np(js), iters)}
    jbg = jsw.build_batched_geometry(GEOM_ROWS, round_to=4, axis=-1)
    gpar = jsw.batch_params(PROWS)
    for lockstep in (True, False):
        step = jax.jit(jsw.make_geom_sweep_step(jbg, JProps(), JControls(),
                                                lockstep=lockstep))
        s, iters = jsw.batch_states_geom(jbg, dt0=4e-4), []
        for _ in range(N_GEOM):
            s, d = step(s, gpar)
            iters.append(np.asarray(d.p_iters))
        out[f"geom {lockstep}"] = (_np(s), iters)
    return out


_RUNS = {}


def _launch(world):
    """The one launch of `world` CPU ranks: the tiled runs on the grids of
    that many ranks and, on four, the geometry sweeps."""
    if world not in _RUNS:
        tasks = [("tiled", (TANK, ROWS, N_STEPS),
                  {"grid": g, "controls": CONTROLS, "with_single": True})
                 for g in TILED.values() if g[0] * g[1] == world]
        if world == 4:
            tasks += [("geom_farm", (GEOM_ROWS, PROWS, N_GEOM, GEOM_GRID),
                       {"lockstep": lock, "t_stop": t_stop})
                      for lock, t_stop in GEOM_RUNS]
            tasks += [("geom_farm", (GEOM_ROWS, PROWS, N_GEOM, GEOM_GRID),
                       {"route": "interpret"})]
            tasks += [("geom_farm", (GEOM_ROWS, PROWS, N_GEOM, GEOM_GRID_Y),
                       {"lockstep": lock}) for lock in (True, False)]
        _RUNS[world] = rk.launch(jobs.many, ["cpu"] * world, log=quiet,
                                 args=(tasks,))
    return _RUNS[world]


def _tiled(name):
    grid = TILED[name]
    return [r[0] for r in _launch(grid[0] * grid[1])]


def _held(got, ref, bounds, label, iters=None, ref_iters=None, d_iters=0):
    """Every field of `got` within `bounds` (alpha absolute, the rest
    relative to the reference's scale), t to rtol 1e-6, step equal;
    p_iters within `d_iters`."""
    np.testing.assert_array_equal(got["step"], ref["step"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    for k, bound in bounds.items():
        err = float(np.abs(got[k] - ref[k]).max())
        lim = bound if k == "alpha" else bound * float(np.abs(ref[k]).max())
        assert err <= lim, (label, k, err, lim)
    if iters is not None:
        d = np.abs(np.asarray(iters) - np.asarray(ref_iters)).max()
        assert d <= d_iters, (label, iters, ref_iters)


TILED_JAX = {"alpha": 1e-5, "u": 1e-3, "v": 1e-3, "w": 1e-3, "p": 1e-4}
TILED_ONE = {"alpha": 1e-5, "u": 1e-3, "v": 1e-3, "w": 1e-3}
GEOM_JAX = {"alpha": 5e-5, "u": 1e-3, "v": 1e-3, "w": 1e-3, "p": 2e-4}


# --------------------------------------------------------------------- (a)

def _whole_forcing(shape, seed=3):
    """Whole-grid components on `shape` (nx, ny, nz) cells, all kinds."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {"0d": torch.tensor(-9.81), "extent_1": f(1, 1, 1),
            "x_cells_of_y": f(nx, 1, 1), "y_cells_of_x": f(1, ny, 1),
            "x_faces": f(nx, 1, 1), "y_faces": f(1, ny, nz),
            "xy": f(nx, ny, 1)}


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)])
def test_forcing_cut_is_the_whole_grids_bitwise(grid):
    shape = (12, 8, 5)
    nxl, nyl = shape[0] // grid[0], shape[1] // grid[1]
    g = _whole_forcing(shape)
    faces_x = st.cells_to_faces_avg(g["x_faces"], 0)
    faces_y = st.cells_to_faces_avg(g["y_faces"], 1)
    xy_faces = st.cells_to_faces_avg(g["xy"], 0)
    for r in range(grid[0] * grid[1]):
        ctx = rk.RankCtx(rank=r, world=grid[0] * grid[1],
                         device=torch.device("cpu"), backend="gloo",
                         grid=grid)
        ix, iy = ctx.ix, ctx.iy
        xs, ys = slice(ix * nxl, (ix + 1) * nxl), slice(iy * nyl,
                                                        (iy + 1) * nyl)
        xf, yf = (slice(ix * nxl, (ix + 1) * nxl + 1),
                  slice(iy * nyl, (iy + 1) * nyl + 1))
        # (G_x, G_y, G_z) triples: each component cut by its own axis.
        gx, gy, gz = block_forcing((g["x_faces"], g["x_cells_of_y"],
                                    g["0d"]), ctx, nxl, nyl)
        assert torch.equal(gx, faces_x[xf]) and gx.shape[0] == nxl + 1
        assert torch.equal(gy, g["x_cells_of_y"][xs])
        assert gz is g["0d"]
        gx, gy, gz = block_forcing((g["y_cells_of_x"], g["y_faces"],
                                    g["extent_1"]), ctx, nxl, nyl)
        assert torch.equal(gx, g["y_cells_of_x"][:, ys])
        assert torch.equal(gy, faces_y[:, yf]) and gy.shape[1] == nyl + 1
        assert gz is g["extent_1"]
        gx, gy, gz = block_forcing((g["xy"], g["xy"], -9.81), ctx, nxl, nyl)
        assert torch.equal(gx, xy_faces[xf, ys])
        assert torch.equal(gy, st.cells_to_faces_avg(g["xy"], 1)[xs, yf])
        assert gz == -9.81


def test_forcing_cut_refuses_other_extents():
    ctx = rk.RankCtx(rank=1, world=2, device=torch.device("cpu"),
                     backend="gloo", grid=(2, 1))
    with pytest.raises(ValueError, match="x extent is neither 1 nor"):
        block_forcing((torch.zeros(5, 1, 1), 0.0, -9.81), ctx, 6, 8)
    with pytest.raises(ValueError, match="y extent is neither 1 nor"):
        block_forcing((0.0, torch.zeros(1, 9, 1), -9.81), ctx, 6, 8)
    with pytest.raises(ValueError, match="0-d, or 3-D"):
        block_forcing((torch.zeros(12, 1), 0.0, -9.81), ctx, 6, 8)


def test_explicit_update_takes_a_component_on_its_faces():
    rng = np.random.default_rng(4)
    shape = (6, 4, 5)
    f = lambda s: torch.from_numpy(rng.uniform(0.5, 1.5, s)
                                   .astype(np.float32))
    face_shapes = [(7, 4, 5), (6, 5, 5), (6, 4, 6)]
    vels = [f(s) for s in face_shapes]
    vcs = [f(s) for s in face_shapes]
    aps = [f(s) - 0.6 for s in face_shapes]
    rho0, rho1 = f(shape) * 998, f(shape) * 998
    gx = f((6, 1, 1))
    cells = mom.explicit_update(vels, vcs, rho0, rho1, aps, 1e-3,
                                (gx, 0.0, -9.81))
    faces = mom.explicit_update(vels, vcs, rho0, rho1, aps, 1e-3,
                                (st.cells_to_faces_avg(gx, 0), 0.0, -9.81))
    for a, b in zip(cells, faces):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- (b)

def _block_volumes(alpha):
    vfrac = tbuild(**TANK).vfrac.astype(np.float64)
    blocks = tts.untile(alpha, len(ROWS)).astype(np.float64)
    return (blocks * vfrac).sum(axis=(1, 2, 3))


@pytest.mark.parametrize("name", ["2x1", "2x2"])
def test_tiled_over_ranks_matches_jax(refs, name):
    res = _tiled(name)
    got = res[0]
    ref, ref_iters = refs["tiled"]
    assert float(np.abs(ref["u"]).max()) > 1e-4   # the cases are shaking
    _held(got["last"], ref, TILED_JAX, name, got["iters"], ref_iters, 1)
    v0 = _block_volumes(tts.tile_state(tbuild(**TANK), len(ROWS),
                                       device="cpu").alpha.numpy())
    v1 = _block_volumes(got["last"]["alpha"])
    assert float(np.abs(v1 - v0).max()) <= 1e-3 * float(v0.min())
    n, m = TILED[name]
    nx = 8 * len(ROWS)
    for out in res:
        assert out["block"] == (nx // n, 8 // m, 10)
        calls = out["calls"]
        assert calls.get("halo7.apply_dot_7pt_h", 0) > 0
        assert calls.get("momentum_rhs.momentum_rhs_h", 0) == N_STEPS
        assert calls.get("correction.correct_divmax_h", 0) == N_STEPS
        assert not any(calls.get(k, 0) for k in (
            "seven_point.apply_dot_7pt", "mules_flux.flux_all", "mules_fct.fct_iter",
            "momentum_rhs.momentum_rhs", "correction.correct_divmax"))
        # 2 cases a rank along x: the boundary is a sealed junction, and
        # the plane exchanges still run there.
        assert out["stats"]["exchanges"] > 0
        assert (out["stats"]["y_exchanges"] > 0) == (m > 1)


@pytest.mark.parametrize("name", ["2x1", "2x2"])
def test_tiled_over_ranks_matches_one_process(name):
    got = _tiled(name)[0]
    one = got["single"]
    for k in ("alpha", "dt"):
        np.testing.assert_array_equal(got["first"][k], one["first"][k],
                                      err_msg=k)
    _held(got["last"], one["last"], TILED_ONE, name, got["iters"],
          one["iters"])


def test_tiled_on_one_rank_is_bitwise_the_one_slab_step():
    got = _tiled("1x1")[0]
    one = got["single"]
    for when in ("first", "last"):
        for k in FIELDS:
            np.testing.assert_array_equal(got[when][k], one[when][k],
                                          err_msg=f"{when} {k}")
    assert got["iters"] == one["iters"]


# --------------------------------------------------------------------- (c)

def _geom_runs(i):
    return [r[len([g for g in TILED.values() if g[0] * g[1] == 4]) + i]
            for r in _launch(4)]


@pytest.mark.parametrize("lockstep,grid", [
    pytest.param(True, GEOM_GRID, id="True"),
    pytest.param(False, GEOM_GRID, id="False"),
    pytest.param(True, GEOM_GRID_Y, id="True-y"),
    pytest.param(False, GEOM_GRID_Y, id="False-y")])
def test_geometry_sweep_over_ranks_matches_jax(refs, lockstep, grid):
    res = _geom_runs((0 if lockstep else 1) if grid == GEOM_GRID
                     else (4 if lockstep else 5))
    ref, ref_iters = refs[f"geom {lockstep}"]
    got = res[0]["last"]
    assert float(np.abs(ref["w"]).max()) > 1e-3
    _held(got, ref, GEOM_JAX, f"lockstep {lockstep} over {grid}")
    np.testing.assert_allclose(got["dt"], ref["dt"], rtol=1e-4)
    c, n, m = grid
    group, k = n * m, len(GEOM_ROWS) // c
    assert np.abs(_case_iters(res, grid) - np.asarray(ref_iters)).max() <= 1
    spacing = tsw.build_batched_geometry(GEOM_ROWS, round_to=4,
                                         device="cpu").spacing.numpy()
    for r, out in enumerate(res):
        assert out["block"] == (8 // n, 8 // m, 10, k)
        np.testing.assert_array_equal(out["spacing"],
                                      spacing[(r // group) * k:][:k])
        lead = res[(r // group) * group]
        for t, t0 in zip(out["t"], lead["t"]):
            np.testing.assert_array_equal(t, t0)
        assert sum(out["calls"].values()) == 0
    if lockstep:
        assert len(set(got["t"].tolist())) == 1


def _one_process_geom(route="auto", lockstep=True, t_stop=None):
    """The port's one-process geometry sweep of GEOM_ROWS over N_GEOM:
    its last state and every step's p_iters."""
    bg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OFTPP_SWEEP_PALLAS", route)
        step = tsw.make_geom_sweep_step(bg, lockstep=lockstep)
    s = tsw.batch_states_geom(bg, dt0=4e-4)
    par = tsw.batch_params(PROWS, device="cpu")
    iters = []
    for _ in range(N_GEOM):
        s, d = step(s, par, t_stop=t_stop)
        iters.append(d.p_iters.numpy())
    return _np(s), iters


def _case_iters(res, grid=GEOM_GRID):
    group = grid[1] * grid[2]
    return np.concatenate([np.asarray(res[i * group]["iters"])
                           for i in range(grid[0])], axis=1)


def test_geometry_sweep_over_ranks_holds_done_cases():
    lockstep, t_stop = GEOM_RUNS[2]
    res = _geom_runs(2)
    want, iters = _one_process_geom(lockstep=lockstep, t_stop=t_stop)
    got = res[0]["last"]
    np.testing.assert_allclose(got["t"], t_stop, rtol=1e-6)
    assert np.all(got["step"] == N_GEOM - 1)
    for k in FIELDS:   # the last step held every case
        np.testing.assert_array_equal(got[k], res[0]["held"][k], err_msg=k)
    _held(got, want, {"alpha": 5e-6, "u": 1e-2, "v": 1e-2, "w": 1e-2},
          "held", _case_iters(res), iters, 1)
    np.testing.assert_array_equal(got["t"], want["t"])


def test_geometry_sweep_over_ranks_kernel_route():
    res = _geom_runs(3)
    want, iters = _one_process_geom(route="interpret")
    _held(res[0]["last"], want, GEOM_JAX, "interpret", _case_iters(res),
          iters, 1)
    for out in res:
        assert all(out["calls"].get(k, 0) > 0 for k in jobs.BATCH)


# --------------------------------------------------------------------- (d)

def _held_run(got, want, n_got, n_want, label):
    assert n_got == n_want, label
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    assert float((got.alpha - want.alpha).abs().max()) <= 5e-6, label
    for k in "uvw":
        g, r = getattr(got, k), getattr(want, k)
        assert float((g - r).abs().max()) <= 1e-2 * float(r.abs().max()), \
            (label, k)


def test_run_tiled_sweep_ranks_matches_run_tiled_sweep():
    geom = tbuild(**TANK)
    want, n = tts.run_tiled_sweep(geom, ROWS, 2e-3, controls=CONTROLS,
                                  device="cpu")
    got, n_got, ranks = tts.run_tiled_sweep_ranks(
        geom, ROWS, 2e-3, (1, 2, 1), ["cpu"] * 2, controls=CONTROLS,
        log=quiet)
    _held_run(got, want, n_got, n, "tiled")
    assert n >= 2 and [len(r["p_iters"]) for r in ranks] == [n] * 2
    assert ranks[0]["p_iters"] == ranks[1]["p_iters"]


def test_run_sweep_ranks_takes_a_batched_geometry():
    bg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    want, n = tsw.run_sweep(bg, PROWS, 1e-3)
    got, n_got, ranks = tsw.run_sweep_ranks(bg, PROWS, 1e-3, (2, 1, 2),
                                            ["cpu"] * 4, log=quiet)
    _held_run(got, want, n_got, n, "geometry")
    assert all(len(it) == 2 for r in ranks for it in r["p_iters"])


# --------------------------------------------------------------------- (e)

def test_refusals_before_any_spawn(monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("a rank process was spawned")

    monkeypatch.setattr(rk, "launch", no_spawn)
    ctx = rk.RankCtx(rank=0, world=4, device=torch.device("cpu"),
                     backend="gloo", grid=(2, 2, 1))
    mesh = tsh.make_mesh(4, case_axis=2, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="an unbatched state on a rank grid"):
        tsh.state_sharding(mesh, batched=False, ranks=ctx)
    geom = tbuild(**TANK)
    state = tts.tile_state(geom, 2, device="cpu")
    with pytest.raises(ValueError, match="an unbatched state on a rank grid"):
        tsh.shard_state(state, mesh, ranks=ctx)
    # 3 cases: 24 x-cells over 4 x-ranks are blocks of 6 (even), over 8
    # of 3 (odd); 8 y-rows over 3 do not divide.
    with pytest.raises(ValueError, match="an odd number"):
        tts.run_tiled_sweep_ranks(geom, ROWS[:3], 0.01, (1, 8, 1),
                                  ["cpu"] * 8, log=quiet)
    with pytest.raises(ValueError, match="does not divide"):
        tts.run_tiled_sweep_ranks(geom, ROWS[:3], 0.01, (1, 1, 3),
                                  ["cpu"] * 3, log=quiet)
    with pytest.raises(ValueError, match=r"the grid is \(1, N, M\)"):
        tts.run_tiled_sweep_ranks(geom, ROWS, 0.01, (2, 2, 1), ["cpu"] * 4,
                                  log=quiet)
    bg = tsw.build_batched_geometry(GEOM_ROWS, round_to=4, device="cpu")
    with pytest.raises(ValueError, match="one a row"):
        tsw.run_sweep_ranks(bg, PROWS[:2], 0.01, (2, 1, 1), ["cpu"] * 2,
                            log=quiet)
    lead = dataclasses.replace(bg, axis=0)
    with pytest.raises(ValueError, match="trailing case axis"):
        tsw.run_sweep_ranks(lead, PROWS, 0.01, (2, 1, 1), ["cpu"] * 2,
                            log=quiet)
    with pytest.raises(NotImplementedError, match="one process"):
        tsw.make_geom_sweep_step(bg, spmd=SpmdCtx(2))
