"""The last meshes over ranks, on the CPU: the plain step over ranks
(surface tension, the fused terms off their islands, OFTPP_SPMD_PALLAS=0)
and a sweep farmed over a (case, x, y) grid of ranks, one process a
position (parallel/ranks.py on a (C, N, M) rank grid), gloo between
spawned processes that run tests/torch_rank_jobs.py (torch and the port
only). Four ranks are launched once for (a), (b) and the (2, 2, 1)
farms, eight once for the (2, 2, 2) farms.

(a) tests/test_torch_step.py's tank and forcing, 3 steps (16×16×10 at
    round_to=8): with σ =
    0.072 N/m from a wavy, noisy surface over '2x2' (the islands on, the
    CSF terms plain between them) against the JAX unsharded plain CSF
    step at tests/test_torch_csf.py's step bounds (alpha 1e-5,
    velocities 1e-3 and p 1e-4 of scale, p_iters within 1), and the
    curvature of that surface on the '2x2' blocks against JAX's to 1e-4
    of scale; from rest, the fused terms off their islands
    (`mom_pallas=False` over 4 x-ranks, OFTPP_MOM_PALLAS=0 with
    OFTPP_CORR_PALLAS=0 over '2x2') and everything plain
    (`use_pallas=False`, OFTPP_SPMD_PALLAS=0's step) over both, against
    the JAX unsharded plain step at ROADMAP.md §3's bounds for the port's
    step against the JAX step (alpha 2.5e-6, velocities 4.8e-4 and p
    1.4e-5 of scale, p_iters equal) and against the port's one-process
    `SpmdCtx(N)` step: the first step's alpha and dt bitwise, p_iters
    equal.
(b) `run_case(devices="2x2", props=σ = 0.072)` and OFTPP_SPMD_PALLAS=0
    `run_case(devices=4)`, ranks on the CPU, on the tiny verify case
    (8×8×10) over 3 ms: they run, their log names the configuration,
    and the final checkpoint is within the JAX sharded-run test's bounds
    (alpha 5e-3, t 1e-9) of the unsharded run's.
(c) `make_sweep_step` of tests/test_torch_sharding.py's four forcing rows
    on the tank of tests/test_sharding.py at round_to=4 (8×8×10: nxl and
    nyl stay even) farmed over (case=2, x=2, y=2) and (case=2, x=2, y=1)
    rank grids, plain (the CPU's route) and through the batch kernels'
    entry points on extended blocks (OFTPP_SWEEP_PALLAS=interpret): after
    one step against the port's unfarmed sweep at the JAX sharded test's
    bounds (`tests/test_sharding.py:80-87`: t rtol 1e-6, alpha 5e-6, w
    5e-5), after N_FARM at test_torch_sharding.py's `_held_to_jax`
    bounds against the JAX sweep step (plain) or the port's unfarmed
    sweep on the kernels' route (the port's own gap to JAX there is 5.7e-4
    of v's scale, the farm's sum order adds CG-stop noise of the same
    size); on the 12×12×10 tank over (case=2, x=2, y=1) the V-cycle's
    first coarse level, 3 planes a rank, is gathered within each case
    group, the batch axis carried; `run_sweep_ranks` against `run_sweep`;
    every case's t equal
    on every rank of its case position at every step, p_iters (2,) per
    position; the batch entry points called on every rank on the kernel
    route, never on the plain one. A planted swap of two cases' forcing
    across the case positions is refused by those checks.
(d) The windowed plain apply-dot on a rank-4 grid: the full window is
    bitwise the call without one, and the per-case dots of four 2x2
    windows, added in window order, are within DOT_RTOL of the whole
    grid's.
(e) Refusals: a (case=2, x=2) farm with an odd nxl raises ValueError
    before any spawn; `case_devices` in one process still raises,
    naming the rank form; `forcing=` over ranks builds (its components
    are cut to the rank's block: tests/test_torch_ranks_tiled.py), and a
    whole-grid component of another extent raises ValueError.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_jobs as jobs
from test_torch_csf import _wavy_alpha
from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core.state import CaseParams as JParams
from openfoam_tpp_tpu.core.state import init_state as jinit
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import sweep as jsw
from openfoam_tpp_tpu.solver import momentum as jm
from openfoam_tpp_tpu.solver.timestep import make_step as jmake
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (params_from_numpy,
                                               state_from_numpy,
                                               state_to_numpy)
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.parallel import ranks as rk
from openfoam_tpp_tpu_torch.parallel import sharding as tsh
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.solver.timestep import (block_forcing,
                                                    make_step_core)
from openfoam_tpp_tpu_torch.utils import io as tio

# tests/test_torch_step.py's tank (12 fluid cells across, whose
# port-against-JAX gaps ROADMAP.md §3 logs) at round_to=8: 16×16×10, so 4
# x-ranks hold even slabs (the solid padding changes no value).
TANK = dict(H=0.04, D=0.048, mesh=0.004, geo="flat", round_to=8)
FARM_TANK = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=4)
FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = ("orbit_radius", "omega", "ramp_time")
# tests/test_torch_step.py's forcing: a short ramp, the tank shakes within
# N_STEPS.
ORBIT = dict(R=0.004, freq=1.88, duration=0.5)
SIGMA = 0.072
# tests/test_torch_sharding.py's forcing rows.
ROWS = [{"R": 0.002 + 5e-4 * i, "freq": 2.0 + 0.5 * i, "duration": 0.05}
        for i in range(4)]
N_STEPS = 3
N_FARM = 4
DOT_RTOL = 1e-5
RUN = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
       "freq": 3.0, "duration": 0.003, "dt": 5e-4, "ramp": -1.0}
# The rank runs of (a): (name, rank grid, port controls, env, props).
ISLANDS = TControls(use_pallas=True, fct_bf16=False)
PLAIN = TControls(use_pallas=False, fct_bf16=False)
STEP_RUNS = {
    "islands_off_4x1": ((4, 1), TControls(use_pallas=True, mom_pallas=False,
                                          fct_bf16=False), {}),
    "islands_off_2x2_env": ((2, 2), ISLANDS, {"OFTPP_MOM_PALLAS": "0",
                                              "OFTPP_CORR_PALLAS": "0"}),
    "plain_4x1": ((4, 1), PLAIN, {}),
    "plain_2x2": ((2, 2), PLAIN, {}),
}
FARMS = {"2x2x2": (2, 2, 2), "2x2x1": (2, 2, 1)}
# 12×12×10: x-slabs of 6 over 2 x-ranks, whose first coarse level (3
# planes a rank) the multigrid gathers within each case group.
AGG_TANK = dict(H=0.04, D=0.04, mesh=0.004, geo="flat", round_to=4)
ROUTES = ("auto", "interpret")
quiet = lambda *a: None


def _np(state):
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _jax_steps(jg, props, init, jp, controls):
    """The JAX unsharded step's state after N_STEPS and its p_iters."""
    step = jax.jit(jmake(jg, props, controls))
    s, iters = init, []
    for _ in range(N_STEPS):
        s, d = step(s, jp)
        iters.append(int(d.p_iters))
    return _np(s), iters


@pytest.fixture(scope="module")
def refs():
    """The JAX references: the plain step from rest and the plain CSF
    step from a wavy surface on TANK (N_STEPS each), the curvature of
    that surface, and the sweep step of ROWS on FARM_TANK (N_FARM)."""
    jg = jbuild(**TANK)
    jp = JParams.make(**ORBIT)
    rest = jinit(jg)
    wavy = dataclasses.replace(rest, alpha=jnp.asarray(_wavy_alpha(jg, 3)))
    out = {"rest": _np(rest), "wavy": _np(wavy),
           "params": {k: np.asarray(getattr(jp, k)) for k in PARAMS}}
    out["plain"] = _jax_steps(jg, JProps(), rest, jp, JControls())
    out["csf"] = _jax_steps(jg, JProps(sigma=SIGMA), wavy, jp, JControls())
    out["kappa"] = np.asarray(jm.curvature(wavy.alpha, jg.spacing,
                                           vfrac=jg.vfrac))
    fg = jbuild(**FARM_TANK)
    jpar = jsw.batch_params(ROWS)
    js = jsw.batch_states(fg, len(ROWS), dt0=4e-4, axis=-1)
    jstep = jax.jit(jsw.make_sweep_step(fg, JProps(), JControls(), axis=-1))
    for _ in range(N_FARM):
        js, _ = jstep(js, jpar)
    out["sweep"] = _np(js)
    return out


_RUNS = {}


def _four(refs):
    """The one launch of four CPU ranks: (a)'s steps, the curvature, the
    (2, 2, 1) farms on both routes and the swapped farm."""
    if "four" not in _RUNS:
        tasks = [("steps", (TANK, refs["wavy"], refs["params"], N_STEPS),
                  {"grid": (2, 2), "props": {"sigma": SIGMA},
                   "controls": ISLANDS}),
                 ("curvature", (TANK, refs["wavy"]["alpha"]),
                  {"grid": (2, 2)})]
        tasks += [("steps", (TANK, refs["rest"], refs["params"], N_STEPS),
                   {"grid": grid, "controls": controls, "env": env,
                    "with_single": True})
                  for grid, controls, env in STEP_RUNS.values()]
        tasks += [("farm", (FARM_TANK, ROWS, N_FARM, FARMS["2x2x1"], route),
                   {}) for route in ROUTES]
        tasks += [("farm", (FARM_TANK, ROWS, N_FARM, FARMS["2x2x1"]),
                   {"swap": True}),
                  ("farm", (AGG_TANK, ROWS, 1, FARMS["2x2x1"], "interpret"),
                   {})]
        _RUNS["four"] = rk.launch(jobs.many, ["cpu"] * 4, log=quiet,
                                  args=(tasks,))
    return _RUNS["four"]


def _eight():
    """The one launch of eight CPU ranks: the (2, 2, 2) farms on both
    routes."""
    if "eight" not in _RUNS:
        tasks = [("farm", (FARM_TANK, ROWS, N_FARM, FARMS["2x2x2"], route),
                  {}) for route in ROUTES]
        _RUNS["eight"] = rk.launch(jobs.many, ["cpu"] * 8, log=quiet,
                                   args=(tasks,))
    return _RUNS["eight"]


def _held(got, ref, bounds, label, iters=None, ref_iters=None, d_iters=0):
    """Every field of `got` within `bounds` (alpha absolute; u, v, w and
    p relative to the reference's scale), t to rtol 1e-6, step equal;
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


JAX_STEP = {"alpha": 2.5e-6, "u": 4.8e-4, "v": 4.8e-4, "w": 4.8e-4,
            "p": 1.4e-5}
CSF_STEP = {"alpha": 1e-5, "u": 1e-3, "v": 1e-3, "w": 1e-3, "p": 1e-4}


# --------------------------------------------------------------------- (a)

def test_csf_over_2x2_ranks_matches_jax(refs):
    res = _four(refs)
    got = res[0][0]
    ref, ref_iters = refs["csf"]
    for k in "uvw":
        assert float(np.abs(ref[k]).max()) > 1e-4, k   # CSF moves the fluid
    _held(got["last"], ref, CSF_STEP, "csf", got["iters"], ref_iters, 1)
    kappa, want = res[0][1], refs["kappa"]
    scale = float(np.abs(want).max())
    assert float(np.abs(kappa - want).max()) <= 1e-4 * scale
    # The islands run on every rank, with the CSF terms plain between them.
    for r in res:
        assert r[0]["calls"]["momentum_rhs.momentum_rhs_h"] == N_STEPS
        assert r[0]["calls"].get("momentum_rhs.momentum_rhs", 0) == 0


@pytest.mark.parametrize("name", sorted(STEP_RUNS))
def test_plain_terms_over_ranks_match_jax_and_one_process(refs, name):
    i = 2 + list(STEP_RUNS).index(name)
    res = _four(refs)
    got = res[0][i]
    ref, ref_iters = refs["plain"]
    _held(got["last"], ref, JAX_STEP, name, got["iters"], ref_iters)
    one = got["single"]
    for k in ("alpha", "dt"):
        np.testing.assert_array_equal(got["first"][k], one["first"][k],
                                      err_msg=k)
    assert got["iters"] == one["iters"]
    # Which terms stayed on their islands, on every rank.
    islands = STEP_RUNS[name][1].use_pallas
    for r in res:
        calls = r[i]["calls"]
        assert (calls.get("halo7.apply_dot_7pt_h", 0) > 0) == islands
        assert calls.get("momentum_rhs.momentum_rhs_h", 0) == 0
        assert calls.get("correction.correct_divmax_h", 0) == 0
        assert (calls.get("mules_flux.flux_all_h", 0) > 0) == islands
        if STEP_RUNS[name][0][1] > 1:
            assert r[i]["stats"]["y_exchanges"] > 0


# --------------------------------------------------------------------- (b)

def test_run_case_csf_and_plain_over_ranks(tmp_path, monkeypatch):
    """`run_case` over ranks with σ ≠ 0 ('2x2', the islands in their
    plain versions) and with OFTPP_SPMD_PALLAS=0 (4 x-ranks): both run
    to the end against the unsharded run of the same case."""
    for label, devices, env, props in (
            ("csf", "2x2", "interpret", TProps(sigma=SIGMA)),
            ("plain", 4, "0", TProps())):
        monkeypatch.setenv("OFTPP_SPMD_PALLAS", env)
        case = tcases.setup_case(RUN, str(tmp_path / label))
        lines = []
        stats = trunner.run_case(case, props=props, devices=devices,
                                 device="cpu", ranks=True, log=lines.append)
        assert len(stats["ranks"]) == 4, label
        mesh = next(ln for ln in lines if "mesh positions" in ln)
        if label == "csf":
            assert "σ = 0.072 N/m" in mesh and "halo kernel islands" in mesh
        else:
            assert "the plain step on every block (OFTPP_SPMD_PALLAS=0)" \
                in mesh
        final = tio.load_checkpoint(tio.latest_checkpoint(case)[1])
        monkeypatch.setenv("OFTPP_SPMD_PALLAS", "0")
        alone = tcases.setup_case(RUN, str(tmp_path / f"{label}_alone"))
        trunner.run_case(alone, props=props, device="cpu", log=quiet)
        want = tio.load_checkpoint(tio.latest_checkpoint(alone)[1])
        assert want["alpha"].shape == final["alpha"].shape
        assert np.abs(final["alpha"] - want["alpha"]).max() < 5e-3, label
        assert abs(float(final["t"]) - float(want["t"])) < 1e-9, label


# --------------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def unfarmed():
    """The port's unfarmed sweep of ROWS on FARM_TANK after one step and
    after N_FARM, on each route."""
    out = {}
    geom = tbuild(**FARM_TANK)
    for route in ROUTES:
        with pytest.MonkeyPatch.context() as m:
            m.setenv("OFTPP_SWEEP_PALLAS", route)
            step = tsw.make_sweep_step(geom, device="cpu")
        s = tsw.batch_states(geom, len(ROWS), dt0=4e-4, device="cpu")
        par = tsw.batch_params(ROWS, device="cpu")
        for i in range(N_FARM):
            s, _ = step(s, par)
            if i == 0:
                out[route] = state_to_numpy(s)
        out[route + " last"] = state_to_numpy(s)
    return out


def _farm(refs, grid, route, swap=False):
    """Every rank's farm result on the rank grid `grid`."""
    if grid == FARMS["2x2x2"]:
        return [r[ROUTES.index(route)] for r in _eight()]
    return [r[2 + len(STEP_RUNS) + (2 if swap else ROUTES.index(route))]
            for r in _four(refs)]


def _held_farm(res, unfarmed, sweep, label):
    """(c)'s checks of a farm's results against the unfarmed sweep after
    one step and the JAX sweep step after N_FARM."""
    one, last = res[0]["first"], res[0]["last"]
    np.testing.assert_allclose(one["t"], unfarmed["t"], rtol=1e-6)
    assert float(np.abs(one["alpha"] - unfarmed["alpha"]).max()) <= 5e-6, \
        label
    assert float(np.abs(one["w"] - unfarmed["w"]).max()) <= 5e-5, label
    np.testing.assert_array_equal(last["step"], sweep["step"])
    np.testing.assert_allclose(last["t"], sweep["t"], rtol=1e-6)
    np.testing.assert_allclose(last["dt"], sweep["dt"], rtol=1e-4)
    assert np.abs(last["alpha"] - sweep["alpha"]).max() <= 5e-5, label
    assert (np.abs(last["p"] - sweep["p"]).max()
            <= 2e-4 * np.abs(sweep["p"]).max()), label
    for k in ("u", "v", "w"):
        assert (np.abs(last[k] - sweep[k]).max()
                <= 1e-3 * np.abs(sweep[k]).max()), (label, k)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("grid", sorted(FARMS))
def test_sweep_farmed_over_case_x_y_ranks(refs, unfarmed, grid, route):
    """Plain (the CPU's route) held after N_FARM to the JAX sweep step;
    the batch kernels' route to the port's unfarmed sweep on that route
    at the same bounds (its JAX counterpart, the Pallas batch kernels in
    interpret mode, is not compiled here)."""
    c, n, m = FARMS[grid]
    res = _farm(refs, FARMS[grid], route)
    _held_farm(res, unfarmed[route], refs["sweep"] if route == "auto"
               else unfarmed[route + " last"], f"{grid} {route}")
    group = n * m
    for r, out in enumerate(res):
        assert out["block"] == (8 // n, 8 // m, 10, len(ROWS) // c)
        lead = res[(r // group) * group]
        for t, t0 in zip(out["t"], lead["t"]):
            np.testing.assert_array_equal(t, t0)
        assert all(it.shape == (len(ROWS) // c,) for it in out["iters"])
        called = sum(out["calls"].values())
        if route == "interpret":
            assert all(out["calls"].get(k, 0) > 0 for k in jobs.BATCH), r
        else:
            assert called == 0, r
        if m > 1:
            assert out["stats"]["y_exchanges"] > 0
    # The case positions' t, side by side, are the unfarmed batch's.
    t_all = np.concatenate([res[i * group]["t"][0] for i in range(c)])
    np.testing.assert_allclose(t_all, unfarmed[route]["t"], rtol=1e-6)


def test_farm_gathers_odd_coarse_levels_within_case_groups(refs):
    """AGG_TANK over (case=2, x=2, y=1): the V-cycle's first coarse level
    of odd local nx is gathered within each case group, the batch axis
    carried; after one step the farm holds the unfarmed sweep at the JAX
    sharded test's bounds."""
    res = [r[5 + len(STEP_RUNS)] for r in _four(refs)]
    geom = tbuild(**AGG_TANK)
    with pytest.MonkeyPatch.context() as m:
        m.setenv("OFTPP_SWEEP_PALLAS", "interpret")
        step = tsw.make_sweep_step(geom, device="cpu")
    s = tsw.batch_states(geom, len(ROWS), dt0=4e-4, device="cpu")
    ref = state_to_numpy(step(s, tsw.batch_params(ROWS, device="cpu"))[0])
    got = res[0]["first"]
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    assert float(np.abs(got["alpha"] - ref["alpha"]).max()) <= 5e-6
    assert float(np.abs(got["w"] - ref["w"]).max()) <= 5e-5
    for out in res:
        assert out["block"] == (6, 12, 10, 2)
        # The gathered level's operator and right-hand sides, beyond the
        # two gathers of the batch itself.
        assert out["stats"]["gathers"] > 10


def test_run_sweep_ranks_matches_run_sweep():
    """`run_sweep_ranks`, the sweep farmed over ranks as one call, to
    t_end (one step from the batch's dt0) over (case=2, x=2, y=1) against
    `run_sweep` in one process: the same step count, t bitwise, alpha
    within the JAX sharded test's 5e-6 and the velocities within
    chip_smoke.py phase 4's 1e-2 of their scale (at this dt, 2.5× the
    other farms', a CG stop moved by the farm's sum order leaves 1.2e-4
    in w); every rank's p_iters for its case position."""
    geom = tbuild(**FARM_TANK)
    t_end = 1e-3
    want, n = tsw.run_sweep(geom, ROWS, t_end, device="cpu")
    got, n_got, ranks = tsw.run_sweep_ranks(geom, ROWS, t_end, (2, 2, 1),
                                            ["cpu"] * 4, log=quiet)
    assert n_got == n == 1
    np.testing.assert_array_equal(got.t.numpy(), want.t.numpy())
    assert float((got.alpha - want.alpha).abs().max()) <= 5e-6
    for k in "uvw":
        g, r = getattr(got, k), getattr(want, k)
        assert float((g - r).abs().max()) <= 1e-2 * float(r.abs().max()), k
    assert [len(r["p_iters"]) for r in ranks] == [n] * 4
    assert all(len(it) == 2 for r in ranks for it in r["p_iters"])


def test_farm_check_refuses_swapped_params(refs, unfarmed):
    res = _farm(refs, FARMS["2x2x1"], "auto", swap=True)
    with pytest.raises(AssertionError):
        _held_farm(res, unfarmed["auto"], refs["sweep"], "swapped")


# --------------------------------------------------------------------- (d)

def test_windowed_batch_apply_dot_plain():
    rng = np.random.default_rng(11)
    shape = (8, 6, 5, 3)
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    split = tuple(torch.from_numpy(rng.uniform(0.05, 0.3, shape)
                                   .astype(np.float32)) for _ in range(3))
    ap, dot = sp.apply_dot_7pt_plain(p, split)
    ap_w, dot_w = sp.apply_dot_7pt_nb(p, split, window=((0, 8), (0, 6)))
    assert torch.equal(ap, ap_w) and torch.equal(dot, dot_w)
    assert dot.shape == (3,)
    parts = [sp.apply_dot_7pt_nb(p, split, window=w)
             for w in (((0, 4), (0, 3)), ((0, 4), (3, 6)),
                       ((4, 8), (0, 3)), ((4, 8), (3, 6)))]
    total = parts[0][1]
    for a, d in parts[1:]:
        assert torch.equal(a, ap)
        total = total + d
    np.testing.assert_allclose(total.numpy(), dot.numpy(), rtol=DOT_RTOL)
    with pytest.raises(ValueError, match="column window"):
        sp.apply_dot_7pt_nb(p, split, window=((0, 9), (0, 6)))


# --------------------------------------------------------------------- (e)

def test_farm_and_rank_refusals(monkeypatch):
    def no_spawn(*a, **k):
        raise AssertionError("a rank process was spawned")

    monkeypatch.setattr(rk, "launch", no_spawn)
    odd = tbuild(H=0.04, D=0.032, mesh=0.004, geo="flat", round_to=2)
    assert odd.shape[0] == 10   # x-slabs of 5 planes over x = 2
    with pytest.raises(ValueError, match="an odd number"):
        tsw.run_sweep_ranks(odd, ROWS, 0.01, (2, 2, 1), ["cpu"] * 4,
                            log=quiet)
    with pytest.raises(ValueError, match="do not divide"):
        tsw.run_sweep_ranks(tbuild(**FARM_TANK), ROWS[:3], 0.01, (2, 2, 1),
                            ["cpu"] * 4, log=quiet)
    cards = [torch.device(f"cuda:{i}") for i in range(4)]
    mesh = tsh.make_mesh(4, case_axis=2, devices=cards)
    with pytest.raises(NotImplementedError, match=r"grid=\(C, N, M\)"):
        tsh.case_devices(mesh)
    ctx = rk.RankCtx(rank=0, world=4, device=torch.device("cpu"),
                     backend="gloo", grid=(2, 2, 1))
    assert (ctx.cases, ctx.grid, ctx.group_size) == (2, (2, 1), 2)
    assert callable(make_step_core(forcing=lambda t, p: None,
                                   spmd=SpmdCtx(2, 1, ranks=ctx)))
    with pytest.raises(ValueError, match="neither 1 nor"):
        block_forcing((torch.zeros(3, 1, 1), 0.0, -9.81), ctx, 4, 8)
    with pytest.raises(NotImplementedError, match="one process"):
        tsw.make_sweep_step(odd, device="cpu", spmd=SpmdCtx(2))
