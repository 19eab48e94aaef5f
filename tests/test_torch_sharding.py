"""The port's device mesh (parallel/sharding.py, parallel/packed.py) and
the paths that run over it, on the CPU: `parse_devices`, `pack` /
`unpack`, `make_mesh`, `build_case_geometry(devices=...)` against the
JAX package's; a sweep farmed over the case axis of a mesh whose
positions all lie on the host (the JAX package's virtual CPU devices'
counterpart) against the unfarmed sweep and the JAX sweep step;
`run_cases_batched(devices=2)`; and `run_case(devices=4)` through the
x-sharded step's islands (their plain versions on the CPU), killed and
resumed, against the unsharded step on the same grid.

Tolerances. The farm against the unfarmed sweep: the JAX package's
sharded-against-unsharded bounds (tests/test_sharding.py: alpha 5e-6, w
5e-5, t rtol 1e-6) after one step, as that test takes; the parts reduce
over fewer cases a call, which moves the CPU's sum order, and a last bit
moved in a CG dot moves the stop: 5.3e-6 in alpha after four steps.
Against the JAX sweep step: tests/test_torch_sweep.py's bounds for the
port's sweep against JAX's. The farmed manager run against the unfarmed
one (0.05 s): tests/test_torch_case.py's run bounds (alpha 5e-4,
velocities 2e-4 and p 5e-5 of scale, dt 1e-4), the write times bitwise.
The sharded
run against the unsharded step on its grid over 0.1 s: the JAX sharded
run test's alpha bound (5e-3) and t to 1e-9: its coarse multigrid levels
run the plain path where the unsharded step runs the kernel path's, so
the preconditioners differ (ROADMAP.md §3), and on the CPU the shards'
chained dot is summed in another order than the whole grid's. Against
the same sharded step run without the kill: bitwise.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.config import PhysicalProperties as JProps
from openfoam_tpp_tpu.config import SolverControls as JControls
from openfoam_tpp_tpu.core.state import SimState as JState
from openfoam_tpp_tpu.manager import runner as jrunner
from openfoam_tpp_tpu.mesh import build_tank_geometry as jbuild
from openfoam_tpp_tpu.parallel import packed as jpk
from openfoam_tpp_tpu.parallel import sharding as jsh
from openfoam_tpp_tpu.parallel import sweep as jsw
from openfoam_tpp_tpu_torch.config import PhysicalProperties as TProps
from openfoam_tpp_tpu_torch.config import SolverControls as TControls
from openfoam_tpp_tpu_torch.core.state import (CaseParams, SimState,
                                               params_from_numpy,
                                               state_from_numpy)
from openfoam_tpp_tpu_torch.device import device_positions
from openfoam_tpp_tpu_torch.manager import cases as tcases
from openfoam_tpp_tpu_torch.manager import runner as trunner
from openfoam_tpp_tpu_torch.manager import sweeprun as tsweeprun
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry as tbuild
from openfoam_tpp_tpu_torch.parallel import packed as tpk
from openfoam_tpp_tpu_torch.parallel import sharding as tsh
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.parallel.spmd import SpmdCtx
from openfoam_tpp_tpu_torch.post.probes import make_probe_sampler
from openfoam_tpp_tpu_torch.solver.timestep import make_step
from openfoam_tpp_tpu_torch.utils import io as tio

FIELDS = ("alpha", "u", "v", "w", "p", "t", "dt", "step")
PARAMS = ("orbit_radius", "omega", "ramp_time")
TANK = dict(H=0.04, D=0.02, mesh=0.004, geo="flat", round_to=4)
# tests/test_torch_sweep.py's forcing rows (a 5 ms ramp: the flow is
# under way within N_STEPS), four of them.
ROWS = [{"R": 0.002 + 5e-4 * i, "freq": 2.0 + 0.5 * i, "duration": 0.05}
        for i in range(4)]
# tests/test_sharded_run.py's case, at two write intervals.
RUN = {"H": 0.04, "D": 0.02, "mesh": 0.004, "geo": "flat", "R": 0.002,
       "freq": 3.0, "duration": 0.1, "dt": 5e-4, "ramp": -1.0}
N_STEPS = 4
quiet = lambda *a: None


@pytest.mark.parametrize("spec", [None, 1, 4, "8", "4x2", "2X2", "4×2"])
def test_parse_devices_matches_jax(spec):
    assert tsh.parse_devices(spec) == jsh.parse_devices(spec)


def _random_state(shape, batch=()):
    rng = np.random.default_rng(3)
    nx, ny, nz = shape
    f = lambda *s: rng.standard_normal(s + batch).astype(np.float32)
    return {"alpha": rng.uniform(0, 1, shape + batch).astype(np.float32),
            "u": f(nx + 1, ny, nz), "v": f(nx, ny + 1, nz),
            "w": f(nx, ny, nz + 1), "p": f(nx, ny, nz),
            "t": np.full(batch, 0.25, np.float32),
            "dt": np.full(batch, 1e-3, np.float32),
            "step": np.full(batch, 7, np.int32)}


def test_pack_unpack_match_jax():
    """pack bitwise JAX's on the same seeded state; unpack restores the
    dropped u/v upper faces as zeros and w's top face from w_top."""
    d = _random_state((6, 5, 4))
    packed = tpk.pack(state_from_numpy(d, device="cpu"))
    jpacked = jpk.pack(JState(**{k: jax.numpy.asarray(v)
                                 for k, v in d.items()}))
    for f in dataclasses.fields(tpk.PackedState):
        np.testing.assert_array_equal(
            getattr(packed, f.name).numpy(),
            np.asarray(getattr(jpacked, f.name)), err_msg=f.name)
    assert packed.u.shape == packed.w.shape == (6, 5, 4)
    back = tpk.unpack(packed)
    jback = jpk.unpack(jpacked)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(back, k).numpy(),
                                      np.asarray(getattr(jback, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(back.w.numpy(), d["w"])
    assert float(back.u[-1].abs().max()) == 0.0
    assert float(back.v[:, -1].abs().max()) == 0.0
    np.testing.assert_array_equal(back.u[:-1].numpy(), d["u"][:-1])
    # A batch (case axis trailing) round-trips the same way.
    db = _random_state((6, 5, 4), (3,))
    db["u"][-1] = 0.0
    db["v"][:, -1] = 0.0
    sb = state_from_numpy(db, device="cpu")
    pb = tpk.pack(sb)
    assert pb.u.shape == (6, 5, 4, 3) and pb.w_top.shape == (6, 5, 3)
    for k in FIELDS:
        assert torch.equal(getattr(tpk.unpack(pb), k), getattr(sb, k)), k
    # packed_fn: a step on SimStates taking and returning PackedStates.
    seen = []
    out, extra = tpk.packed_fn(lambda s, p: (seen.append(s) or s, p))(pb, 5)
    assert extra == 5 and torch.equal(seen[0].w, sb.w)
    for f in dataclasses.fields(tpk.PackedState):
        assert torch.equal(getattr(out, f.name), getattr(pb, f.name)), f.name


def test_make_mesh_and_device_positions():
    mesh = tsh.make_mesh(8, case_axis=2, y_axis=2, devices=["cpu"] * 8)
    assert mesh.devices.shape == (2, 2, 2)
    assert mesh.axis_names == ("case", "x", "y")
    assert mesh.shape == {"case": 2, "x": 2, "y": 2}
    assert tsh.make_mesh(4, case_axis=4, devices=["cpu"] * 4).shape \
        == {"case": 4, "x": 1, "y": 1}
    assert tsh.case_devices(mesh) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="explicit list that repeats"):
        tsh.make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="does not divide"):
        tsh.make_mesh(6, case_axis=4, devices=["cpu"] * 6)
    # x (or y) positions on distinct cards raise in one process, naming
    # the rank form that runs them; case positions may lie on distinct
    # cards (the farm). No card is touched.
    cards = [torch.device("cuda:0"), torch.device("cuda:1")]
    for m in (tsh.make_mesh(2, devices=cards),
              tsh.make_mesh(2, y_axis=2, devices=cards)):
        with pytest.raises(NotImplementedError, match="run as ranks"):
            tsh.state_sharding(m)
        with pytest.raises(NotImplementedError, match="run as ranks"):
            tsh.sharded_step(lambda s, p: (s, None), m)
    farm = tsh.state_sharding(tsh.make_mesh(2, case_axis=2, devices=cards),
                              batched=True)
    assert farm.devices == tuple(cards) and farm.slices(6) == [
        slice(0, 3), slice(3, 6)]
    # device= for mesh positions: an indexed device or cpu for all, a list
    # (or comma list) one each.
    assert device_positions("cpu", 3) == [torch.device("cpu")] * 3
    assert device_positions("cuda:0", 2) == [torch.device("cuda:0")] * 2
    assert device_positions("cuda:0,cuda:1", 2) == cards
    assert device_positions(["cpu", "cpu"], 2) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="one device per position"):
        device_positions("cpu,cpu", 3)


ORBIT = {"H": 0.04, "D": 0.02}
SIX = {"model": "tank6dof"}


@pytest.mark.parametrize("devices,params,nx,env,want", [
    (None, ORBIT, 32, "1", (None, True, "one device")),
    (4, ORBIT, 32, "1", (SpmdCtx(4), True, "halo kernel islands")),
    ("2x2", ORBIT, 32, "1", (None, True, "'NxM'")),
    (4, SIX, 32, "1", (None, True, "a 6DoF case")),
    (4, ORBIT, 24, "1", (None, True, "nx 24 not a multiple of 8·4")),
    (4, ORBIT, 32, "0", (None, True, "OFTPP_SPMD_PALLAS=0")),
])
def test_step_choice_keeps_the_kernels_on_a_card(devices, params, nx, env,
                                                 want, monkeypatch):
    """Mesh positions that share a card run the x-sharded step's islands
    where they apply and otherwise the global step with the single-grid
    kernels, as one device does: never the plain step. A torch.device
    object: no card is touched."""
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", env)
    d_x, d_y = tsh.parse_devices(devices)
    spmd, use_k, what = trunner.step_choice(params, (nx, nx, 10), d_x, d_y,
                                            torch.device("cuda:0"))
    assert (spmd, use_k) == want[:2] and want[2] in what
    # On the CPU the caller's controls stand, except for the islands'
    # plain versions under OFTPP_SPMD_PALLAS=interpret.
    spmd, use_k, _ = trunner.step_choice(params, (nx, nx, 10), d_x, d_y,
                                         torch.device("cpu"))
    assert (spmd, use_k) == (None, False)
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")
    spmd, use_k, _ = trunner.step_choice(params, (nx, nx, 10), d_x, d_y,
                                         torch.device("cpu"))
    islands = want[0] is not None or env == "0"   # env "0" alone kept them off
    assert (spmd is not None, use_k) == (islands, islands)


@pytest.mark.parametrize("env", ["interpret", "0"])
@pytest.mark.parametrize("devices", [None, 2, 4, 8, "2x2", "4x2"])
def test_case_geometry_rounding_matches_jax(devices, env, monkeypatch):
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", env)
    params = {"H": 0.06, "D": 0.05, "mesh": 0.004, "geo": "flat"}
    got = trunner.build_case_geometry(params, devices=devices, device="cpu")
    want = jrunner.build_case_geometry(params, devices=devices)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.vfrac, np.asarray(want.vfrac))
    six = {"model": "tank6dof", "Lx": 0.2, "Ly": 0.2, "Lz": 0.4,
           "mesh": 0.05, "chamfer": 0.2}
    assert tuple(trunner.build_case_geometry(six, devices=devices,
                                             device="cpu").shape) \
        == tuple(jrunner.build_case_geometry(six, devices=devices).shape)


def _held_to_jax(got: SimState, ref):
    """tests/test_torch_sweep.py's bounds for the port's sweep step
    against the JAX one."""
    g = {k: getattr(got, k).numpy() for k in FIELDS}
    r = {k: np.asarray(getattr(ref, k)) for k in FIELDS}
    np.testing.assert_array_equal(g["step"], r["step"])
    np.testing.assert_allclose(g["t"], r["t"], rtol=1e-6)
    np.testing.assert_allclose(g["dt"], r["dt"], rtol=1e-4)
    assert np.abs(g["alpha"] - r["alpha"]).max() <= 5e-5
    assert np.abs(g["p"] - r["p"]).max() <= 2e-4 * np.abs(r["p"]).max()
    for k in ("u", "v", "w"):
        assert np.abs(g[k] - r[k]).max() <= 1e-3 * np.abs(r[k]).max(), k


def _held_to_unfarmed(got: SimState, ref: SimState):
    """The JAX package's sharded-against-unsharded bounds, after one step
    as its test takes."""
    np.testing.assert_allclose(got.t.numpy(), ref.t.numpy(), rtol=1e-6)
    assert float((got.alpha - ref.alpha).abs().max()) <= 5e-6
    assert float((got.w - ref.w).abs().max()) <= 5e-5


@pytest.fixture(scope="module")
def unfarmed():
    """The port's unfarmed sweep (make_sweep_step, the 4 rows, trailing
    layout) after one step and after N_STEPS, and the JAX sweep step after
    N_STEPS from the same state."""
    jg, tg = jbuild(**TANK), tbuild(**TANK)
    jpar = jsw.batch_params(ROWS)
    js = jsw.batch_states(jg, len(ROWS), dt0=4e-4, axis=-1)
    jstep = jax.jit(jsw.make_sweep_step(jg, JProps(), JControls(), axis=-1))
    tpar = params_from_numpy({k: np.asarray(getattr(jpar, k))
                              for k in PARAMS}, device="cpu")
    ts = tsw.batch_states(tg, len(ROWS), dt0=4e-4, device="cpu")
    tstep = tsw.make_sweep_step(tg, device="cpu")
    out = dict(start=ts, params=tpar, step=tstep)
    for i in range(N_STEPS):
        js, _ = jstep(js, jpar)
        ts, _ = tstep(ts, tpar)
        if i == 0:
            out["one"] = ts
    return dict(out, ts=ts, js=js)


@pytest.mark.parametrize("n,case_axis,y_axis", [(4, 2, 1), (8, 2, 2)])
def test_farmed_sweep_matches_unfarmed_and_jax(n, case_axis, y_axis,
                                               unfarmed):
    """make_sweep_step farmed over the mesh's case positions (their x and
    y positions on the same host device compute each part whole): after
    one step against the unfarmed sweep, after N_STEPS against the JAX
    sweep step."""
    u = unfarmed
    mesh = tsh.make_mesh(n, case_axis=case_axis, y_axis=y_axis,
                         devices=["cpu"] * n)
    farm = tsh.sharded_step(u["step"], mesh, batched=True)
    sharding = tsh.state_sharding(mesh, batched=True)
    parts = tsh.shard_state(u["start"], mesh, batched=True)
    pparts = tsh.params_sharding(mesh, batched=True).put(u["params"])
    assert len(parts) == case_axis and parts[0].alpha.shape[-1] == 2
    for i in range(N_STEPS):
        parts, diags = farm(parts, pparts)
        if i == 0:
            _held_to_unfarmed(sharding.gather(parts), u["one"])
    assert diags[0].p_iters.shape == (2,)
    _held_to_jax(sharding.gather(parts), u["js"])


def test_farmed_lockstep_geometry_sweep(unfarmed):
    """The lockstep geometry step (what runsweep runs), one step per case
    position built on its part of the batched geometry: the CFL dt is the
    minimum over every position, so all case times stay equal, and the
    farm holds to the unfarmed step within the JAX bounds; axis=0 equals
    axis=-1 bitwise."""
    rows = [dict(TANK, **r) for r in ROWS]
    rows[1]["H"] = 0.03
    bg = tsw.build_batched_geometry(rows, round_to=4, device="cpu")
    par = tsw.batch_params(ROWS, device="cpu")
    mesh = tsh.make_mesh(2, case_axis=2, devices=["cpu"] * 2)
    sharding = tsh.state_sharding(mesh, batched=True)
    bgs = tsh.shard_batched_geometry(bg, mesh)
    farm = tsh.sharded_step([tsw.make_geom_sweep_step(g) for g in bgs], mesh,
                            batched=True)
    parts = sharding.put(tsw.batch_states_geom(bg, dt0=4e-4))
    pparts = tsh.params_sharding(mesh, batched=True).put(par)
    step = tsw.make_geom_sweep_step(bg)
    ref = tsw.batch_states_geom(bg, dt0=4e-4)
    bg0 = tsw.build_batched_geometry(rows, round_to=4, axis=0, device="cpu")
    step0 = tsw.make_geom_sweep_step(bg0)
    lead = tsw.batch_states_geom(bg0, dt0=4e-4)
    for i in range(N_STEPS):
        parts, _ = farm(parts, pparts, t_stop=0.05)
        ref, _ = step(ref, par, t_stop=0.05)
        lead, _ = step0(lead, par, t_stop=0.05)
        got = sharding.gather(parts)
        assert len(set(got.t.tolist())) == 1 and len(set(got.dt.tolist())) == 1
        if i == 0:
            assert torch.equal(got.t, ref.t)
            _held_to_unfarmed(got, ref)
    for k in FIELDS:
        a = getattr(lead, k)
        assert torch.equal(a if a.dim() <= 1 else a.movedim(0, -1),
                           getattr(ref, k)), k


def _held_in_lockstep(farm, before, after):
    """The lockstep check: the farm's one step from `before` gave every
    case of every part the smallest of the parts' own CFL dt, and part 1
    (the fast one) is where it binds."""
    own = [float(s.lockstep.cfl(p).dt.min())
           for s, p in zip(farm.steps, before)]
    assert own[1] < own[0], own
    for part in after:
        np.testing.assert_array_equal(part.dt.numpy(),
                                      np.full(part.dt.shape, own[1],
                                              np.float32))


def test_farm_steps_every_case_at_the_binding_parts_dt():
    """The farm's lockstep: one part's cases start with a 10 m/s x
    velocity, so their CFL dt binds; after one farmed step every case of
    both parts carries that part's minimum (the CFL dt the step took).
    The same farm with each part keeping its own dt (each part stepped
    alone) must fail the check."""
    rows = [dict(TANK, **r) for r in ROWS]
    bg = tsw.build_batched_geometry(rows, round_to=4, device="cpu")
    par = tsw.batch_params(ROWS, device="cpu")
    mesh = tsh.make_mesh(2, case_axis=2, devices=["cpu"] * 2)
    sharding = tsh.state_sharding(mesh, batched=True)
    farm = tsh.sharded_step([tsw.make_geom_sweep_step(g)
                             for g in tsh.shard_batched_geometry(bg, mesh)],
                            mesh, batched=True)
    parts = sharding.put(tsw.batch_states_geom(bg, dt0=4e-4))
    fast = bg.ga["ax"][..., 2:] > 0.0
    parts[1] = dataclasses.replace(parts[1], u=torch.where(fast, 10.0, 0.0))
    pparts = tsh.params_sharding(mesh, batched=True).put(par)
    after, _ = farm(parts, pparts)
    _held_in_lockstep(farm, parts, after)
    own = [tsw.lockstep_step([s.lockstep], [p], [q])[0][0]
           for s, p, q in zip(farm.steps, parts, pparts)]
    with pytest.raises(AssertionError):
        _held_in_lockstep(farm, parts, own)


def test_farmed_run_cases_batched_matches_unfarmed(tmp_path):
    rows = [dict(RUN, R=0.001 + 0.001 * i, freq=2.0 + 0.5 * i,
                 duration=0.05) for i in range(4)]
    rows[2]["D"] = 0.016
    farm = [tcases.setup_case(r, str(tmp_path / "farm")) for r in rows]
    one = [tcases.setup_case(r, str(tmp_path / "one")) for r in rows]
    s2 = tsweeprun.run_cases_batched(farm, devices=2, device="cpu", log=quiet)
    s1 = tsweeprun.run_cases_batched(one, device="cpu", log=quiet)
    assert s2["steps"] == s1["steps"] and s2["n_cases"] == 4
    probe = os.path.join("postProcessing", "probes", "0")
    for d, e in zip(farm, one):
        chks, refs = tio.list_checkpoints(d), tio.list_checkpoints(e)
        assert [t for t, _ in chks] == [t for t, _ in refs] == [0.0, 0.05]
        got, want = (tio.load_checkpoint(c[-1][1]) for c in (chks, refs))
        assert got["t"] == want["t"]
        np.testing.assert_allclose(got["dt"], want["dt"], rtol=1e-4)
        assert np.abs(got["alpha"] - want["alpha"]).max() <= 5e-4
        for k in ("u", "v", "w"):
            assert np.abs(got[k] - want[k]).max() \
                <= 2e-4 * np.abs(want[k]).max(), k
        assert np.abs(got["p"] - want["p"]).max() \
            <= 5e-5 * np.abs(want["p"]).max()
        for name in ("p", "eta"):
            a = np.loadtxt(os.path.join(d, probe, name))
            b = np.loadtxt(os.path.join(e, probe, name))
            assert a.shape == b.shape and a.shape[0] == s1["steps"]
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0,
                                       atol=2e-3 * np.abs(b[:, 1:]).max())
    # A resumed farm takes no step.
    again = tsweeprun.run_cases_batched(farm, devices=2, device="cpu",
                                        log=quiet)
    assert again["steps"] == 0


def test_sharded_run_resume_and_match(tmp_path, monkeypatch):
    """run_case(devices=4) with the x-sharded step's islands (plain on the
    CPU): two write intervals, killed after the first, resumed; held
    against the same step's uninterrupted advance and the unsharded step
    on the same rounded grid, each driven through the runner's advance to
    the same write targets."""
    monkeypatch.setenv("OFTPP_SPMD_PALLAS", "interpret")
    built = []
    real = trunner.make_step
    monkeypatch.setattr(trunner, "make_step",
                        lambda *a, **k: built.append(k["spmd"]) or real(*a, **k))
    case = tcases.setup_case(RUN, str(tmp_path))
    trunner.run_case(case, devices=4, device="cpu", log=quiet)
    chks = tio.list_checkpoints(case)
    assert [t for t, _ in chks] == pytest.approx([0.0, 0.05, 0.1], abs=1e-6)
    for t, path in chks:
        if t > 0.05 + 1e-9:
            os.remove(path)
    trunner.run_case(case, devices=4, device="cpu", log=quiet)
    assert built == [SpmdCtx(4)] * 2
    chks = dict(tio.list_checkpoints(case))
    final = tio.load_checkpoint(chks[max(chks)])
    geom = trunner.build_case_geometry(RUN, devices=4, device="cpu")
    assert final["alpha"].shape == geom.shape == (32, 32, 10)

    def solo(spmd):
        step = make_step(geom, TProps(), TControls(use_pallas=True),
                         carry_precond=True, spmd=spmd, device="cpu")
        sampler, width = make_probe_sampler(
            geom, trunner.default_probe_points(geom),
            trunner.default_wave_columns(geom), device="cpu")
        adv = trunner.make_advance(step, sampler=sampler, sample_width=width)
        state = trunner.init_state(geom, dt0=RUN["dt"], device="cpu")
        params = CaseParams.make(RUN["R"], RUN["freq"], RUN["duration"],
                                 device="cpu")
        for t in (float(np.float32(0.05)), float(np.float32(2) *
                                               np.float32(0.05))):
            state = adv(state, params, t)[0]
        return {k: getattr(state, k).numpy() for k in FIELDS}

    # Killed and resumed: bitwise the same step's uninterrupted advance.
    once = solo(SpmdCtx(4))
    for k in FIELDS:
        np.testing.assert_array_equal(final[k], once[k], err_msg=k)
    whole = solo(None)
    assert np.abs(final["alpha"] - whole["alpha"]).max() < 5e-3
    assert abs(float(final["t"]) - float(whole["t"])) < 1e-9
    probe = os.path.join(case, "postProcessing", "probes", "0", "p")
    assert np.loadtxt(probe).shape[0] == int(final["step"])
