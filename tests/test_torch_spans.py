"""The port's spans and host-read counters (utils/profiling.py), on the CPU.

Off, `span()` is one shared context and `host_read` is `tolist()`: a
step records nothing and opens no `record_function`. Under `collect()`
a tiny `make_step` case and a tiny batched sweep record one `step` root
a step, every span inside its parent, the spans the step path names,
and one `host.sync` a CG test: iterations + 1 a CG call (the loop ends
on a false test), held against `StepDiagnostics.p_iters`; a carried
bundle reads the step count each step and opens `pressure.bundle` only
when it is rebuilt. The span
stamps share kineto's clock: a span and the `record_function` range it
opens agree within 50 µs at both ends.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from openfoam_tpp_tpu_torch.config import PhysicalProperties, SolverControls
from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
from openfoam_tpp_tpu_torch.ops.kernels import seven_point
from openfoam_tpp_tpu_torch.parallel import ranks
from openfoam_tpp_tpu_torch.parallel import sweep as tsw
from openfoam_tpp_tpu_torch.solver.timestep import make_step
from openfoam_tpp_tpu_torch.utils import profiling as prof

STEP_SPANS = set(prof.STEP_SPANS)
N_STEPS = 3


def _geom():
    return build_tank_geometry(H=0.04, D=0.016, mesh=0.004, geo="flat")


def _case_steps(n):
    """`n` steps of a tiny forced case from rest (the profile verb's
    tests/test_torch_profile.py case); the diagnostics."""
    geom = _geom()
    step = make_step(geom, PhysicalProperties(), SolverControls(),
                     device="cpu")
    state = init_state(geom, dt0=1e-3, device="cpu")
    params = CaseParams.make(R=0.002, freq=2.5, duration=0.2, ramp=0.02,
                             device="cpu")
    diags = []
    for _ in range(n):
        state, diag = step(state, params)
        diags.append(diag)
    return diags


def _sweep_steps(n):
    """`n` steps of a tiny batched sweep (three cases, the trailing case
    axis, the masked CG); the diagnostics."""
    geom = _geom()
    rows = [{"R": r, "freq": f, "duration": 0.2, "ramp": 0.02}
            for r, f in ((0.001, 2.0), (0.002, 2.5), (0.003, 4.0))]
    step = tsw.make_sweep_step(geom, device="cpu")
    states = tsw.batch_states(geom, len(rows), device="cpu")
    params = tsw.batch_params(rows, device="cpu")
    diags = []
    for _ in range(n):
        states, diag = step(states, params)
        diags.append(diag)
    return diags


def test_off_records_nothing():
    assert prof._collector is None
    assert prof.span("a") is prof.span("b") is prof.step_span()
    with prof.span("a") as inner:
        assert inner is None
    for t in (torch.tensor(True), torch.tensor(0.5) > 1.0,
              torch.tensor([1.0, 2.0]).sum() > 2.0):
        got = prof.host_read(t, "site")
        assert type(got) is bool and got == bool(t)
    for t in (torch.tensor(7, dtype=torch.int32), torch.tensor(-3)):
        got = prof.host_read(t, "site")
        assert type(got) is int and got == int(t)
    assert prof.host_read(torch.tensor([3, 4]), "site") == [3, 4]
    assert prof._collector is None
    with profile(activities=[ProfilerActivity.CPU]) as p:
        _case_steps(1)
    names = {e.name() for e in p.profiler.kineto_results.events()}
    assert not names & STEP_SPANS


@pytest.mark.parametrize("path", ["case", "sweep"])
def test_spans_of_a_step(path):
    run = _case_steps if path == "case" else _sweep_steps
    with prof.collect() as rec:
        diags = run(N_STEPS)
    assert prof._collector is None
    spans = rec.spans
    assert rec.steps == N_STEPS
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["step"] * N_STEPS
    assert [s.step for s in roots] == list(range(N_STEPS))
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
            assert s.step == up.step
    for i in range(N_STEPS):
        assert {s.name for s in spans if s.step == i} == STEP_SPANS

    # One host read a CG test: iterations + 1 a call (one CG call a
    # step here: one corrector, one refinement at p_tol_rel 1e-3); a
    # sweep's loop runs for its slowest case.
    iters = [int(d.p_iters.max()) for d in diags]
    assert min(iters) > 0
    cg = [s for s in spans if s.name == "pressure.cg"]
    assert [s.step for s in cg] == list(range(N_STEPS))
    syncs = [s for s in spans if s.name == "host.sync"]
    assert all(spans[s.parent].name == "pressure.cg" for s in syncs)
    assert [sum(s.step == i for s in syncs) for i in range(N_STEPS)] == [
        k + 1 for k in iters]
    site = "poisson.cg" if path == "case" else "poisson.cg_lanes"
    assert rec.host_reads == {site: sum(iters) + N_STEPS}


def test_a_sweep_loop_reads_its_test():
    geom = _geom()
    rows = [{"R": 0.002, "freq": 2.5, "duration": 0.2, "ramp": 0.02}] * 2
    with prof.collect() as rec:
        _, n = tsw.run_sweep(geom, rows, 0.2, max_steps=2, device="cpu")
    assert n == 2 and rec.steps == 2
    assert rec.host_reads["sweep.loop"] == 2
    loop_reads = [s for s in rec.spans
                  if s.name == "host.sync" and s.parent is None]
    assert len(loop_reads) == 2 and all(s.step is None for s in loop_reads)


def test_a_carried_bundle_reads_the_step_and_builds_on_refresh():
    geom = _geom()
    step = make_step(geom, PhysicalProperties(),
                     SolverControls(precond_refresh=2), carry_precond=True,
                     device="cpu")
    state = init_state(geom, dt0=1e-3, device="cpu")
    params = CaseParams.make(R=0.002, freq=2.5, duration=0.2, ramp=0.02,
                             device="cpu")
    bundle = step.init_precond(state)
    with prof.collect() as rec:
        for _ in range(4):     # state.step 0, 1, 2, 3: built at 0 and 2
            state, _, bundle = step(state, params, precond=bundle)
    assert rec.host_reads["timestep.precond_refresh"] == 4
    built = [s.step for s in rec.spans if s.name == "pressure.bundle"]
    assert built == [0, 2]


def test_span_stamps_share_kinetos_clock():
    with prof.collect() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as p:
            # The first record_function of a profile pays the profiler's
            # one-time set-up (~1 ms here): a warm-up span takes it.
            with prof.span("warm-up"):
                pass
            for i in range(8):
                with prof.span(f"s{i}"):
                    torch.ones(1000).sum()
    kin = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
           for e in p.profiler.kineto_results.events()}
    for s in rec.spans[1:]:
        start, end = kin[s.name]
        assert abs(s.start_ns - start) < 50_000, s
        assert abs(s.end_ns - end) < 50_000, s


def test_collect_counts_launches_over_its_block():
    entry = seven_point.apply_7pt
    seven_point.apply_7pt.launches += 5          # before: not counted
    with prof.collect() as rec:
        entry.launches += 2
    assert rec.launches == {"seven_point.apply_7pt": 2}
    assert ranks.launch_counts is prof.launch_counts
    with prof.collect():
        with pytest.raises(RuntimeError):
            with prof.collect():
                pass


def test_self_time_and_per_step_counts():
    S = prof.Span
    spans = [S("step", 0, 100, None, 0), S("a", 10, 40, 0, 0),
             S("host.sync", 20, 30, 1, 0), S("a", 50, 60, 0, 0),
             S("step", 200, 250, None, 1)]
    assert prof.self_ns(spans) == [60, 20, 10, 10, 50]
    rec = prof.Record(spans=spans, host_reads={"poisson.cg": 4},
                      launches={"seven_point.apply_7pt": 6}, steps=2)
    got = prof.per_step_counts(rec)
    assert got == pytest.approx({
        "self_ms_per_step.a": 15e-6, "self_ms_per_step.host.sync": 5e-6,
        "self_ms_per_step.step": 55e-6, "host_reads_per_step.poisson.cg": 2.0,
        "launches_per_step.seven_point.apply_7pt": 3.0}, rel=1e-12)
