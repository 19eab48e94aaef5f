"""The pressure CG's loop written in place, and its CUDA graph (solver/
poisson.py `_cg_core`, `_cg_lanes`, `_iterate`, `_IterGraph`).

On the CPU (no graph is taken there):
- the in-place loops against a frozen copy of the out-of-place loops
  they replaced, bit for bit in x and the iteration count: one grid with
  an open top and a closed (singular) box, with and without the kernel
  path's apply-dot and with the fused cheb2 exit dot; a batch of cases
  where one case stops at the cap and one is converged before the first
  iteration;
- the rule that takes the graph, from the input alone: CUDA operands, no
  rank block open, no NaN hook;
- the loop's runner (`_iterate`) with a stand-in for the graph that
  runs the captured body at each replay: the first iteration eager, one
  capture, replays = iterations − 1, the result bitwise the eager
  loop's; under `collect()` the counters and the kernel launches a
  replay credits, keyed by the entries themselves, once each;
- under `collect()` the graph counters read 0 on the CPU and in a rank
  block, and the CG's host reads stay iterations + 1.

Marked `gpu` (they skip without a CUDA device, decided in a fixture at
run time): graph replay against the eager loop (`_graphs=False`) on a
kernel-path single grid of 64³ (open top and closed box, one and two
Chebyshev sweeps) and on a batch of 12×12×50×128 cases: x and the
iterations bitwise, captures 1 and replays = iterations − 1, the kernel
launches counted as the eager loop counts them, and
`torch.cuda.max_memory_allocated()` over the solve at most the eager
solve's plus 1%. Run on the card with

    python -m pytest --noconftest tests/test_torch_cg_graph.py -m gpu
"""

import dataclasses

import pytest
import torch

from openfoam_tpp_tpu_torch.ops import stencil as st
from openfoam_tpp_tpu_torch.ops.kernels import _build, seven_point
from openfoam_tpp_tpu_torch.solver import poisson as tpo
from openfoam_tpp_tpu_torch.utils import profiling as prof


# ------------------------------------------ the loops this file holds to

def _cg_core_frozen(apply_h, precond_h, fluid, b, tol, max_iters, nullv,
                    nullvv, apply_dot_h=None, precond_rz_h=None):
    """The out-of-place CG loop as it was before the in-place one."""
    _dot = tpo._dot
    _project_out = tpo._project_out

    def precond_rz(r):
        if precond_rz_h is not None:
            z, rz = precond_rz_h(r)
            return z, (_dot(r, z) if rz is None else rz)
        z = precond_h(r)
        return z, _dot(r, z)

    r = b
    z, rz = precond_rz(r)
    x = torch.zeros_like(b)
    p = z
    rr = _dot(r, r)
    tol2 = tol * tol
    if b.dim() == 4:
        return _cg_lanes_frozen(apply_h, precond_rz, fluid, nullv, nullvv,
                                apply_dot_h, max_iters, tol2, x, r, p, rz,
                                rr)
    k = 0
    while k < max_iters and bool(rr > tol2):
        if apply_dot_h is not None:
            ap, denom = apply_dot_h(p)
        else:
            ap = apply_h(p)
            denom = _dot(p, ap)
        alpha = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        if nullv is not None:
            r = _project_out(r, nullv, fluid, nullvv)
        z, rz_new = precond_rz(r)
        beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        rr = _dot(r, r)
        k += 1
    return x, k


def _cg_lanes_frozen(apply_h, precond_rz, fluid, nullv, nullvv, apply_dot_h,
                     max_iters, tol2, x, r, p, rz, rr):
    _dot = tpo._dot
    k = torch.zeros_like(rr, dtype=torch.int32)
    active = rr > tol2
    while bool(active.any()):
        if apply_dot_h is not None:
            ap, denom = apply_dot_h(p)
        else:
            ap = apply_h(p)
            denom = _dot(p, ap)
        alpha = rz / torch.where(denom.abs() > 1e-30, denom, 1e-30)
        x_new = x + alpha * p
        r_new = r - alpha * ap
        if nullv is not None:
            r_new = tpo._project_out(r_new, nullv, fluid, nullvv)
        z, rz_new = precond_rz(r_new)
        beta = rz_new / torch.where(rz.abs() > 1e-30, rz, 1e-30)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        rr = torch.where(active, _dot(r_new, r_new), rr)
        k = k + active.to(torch.int32)
        active = (k < max_iters) & (rr > tol2)
    return x, k


# ------------------------------------------------------------- problems

def _box(shape, seed, open_top, device, dtype=torch.float32):
    """Geometry arrays, density and a right-hand side on a box: a density
    jump of 500 across a tilted interface, zero boundary faces, an open
    or a closed top."""
    g = torch.Generator().manual_seed(seed)
    nx, ny, nz = shape
    z = (torch.arange(nz, dtype=torch.float64) + 0.5)[None, None, :] / nz
    x = (torch.arange(nx, dtype=torch.float64) + 0.5)[:, None, None] / nx
    alpha = ((0.5 + 0.2 * (x - 0.5) - z) * nz).clamp(0.0, 1.0)
    alpha = alpha.expand(nx, ny, nz)
    rho = (alpha * 500.0 + (1.0 - alpha)).to(dtype)
    ax, ay, az = (torch.ones(nx + 1, ny, nz), torch.ones(nx, ny + 1, nz),
                  torch.ones(nx, ny, nz + 1))
    ax[0] = ax[-1] = 0
    ay[:, 0] = ay[:, -1] = 0
    az[:, :, 0] = 0
    if not open_top:
        az[:, :, -1] = 0
    ga = {"vfrac": torch.ones(nx, ny, nz), "ax": ax, "ay": ay, "az": az,
          "top_open": torch.ones(nx, ny)}
    b = torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)
    to = lambda t: t.to(device).contiguous()
    return {k: to(v) for k, v in ga.items()}, to(rho), to(b)


def _stack(items):
    return torch.stack(items, -1).contiguous()


def _problem(shape, open_top, device, use_pallas, knobs=None, cases=None):
    """(problem, b): one grid, or `cases` grids stacked on a trailing
    axis (each its own seed)."""
    knobs = knobs or tpo.SolverKnobs()
    if cases is None:
        ga, rho, b = _box(shape, 3, open_top, device)
    else:
        boxes = [_box(shape, 3 + i, open_top, device) for i in range(cases)]
        ga = {k: _stack([bx[0][k] for bx in boxes]) for k in boxes[0][0]}
        rho, b = (_stack([bx[i] for bx in boxes]) for i in (1, 2))
    prob = tpo.build_poisson(ga, (0.004, 0.004, 0.004), rho,
                             ga["top_open"] if open_top else None,
                             use_pallas=use_pallas, knobs=knobs)
    return prob, b


def _cg_args(prob, b, tol_rel=1e-6):
    """solve_pcg's arguments of its first `_cg_core` call from x0 = 0:
    (positional, keyword)."""
    s, inv_s, fluid = prob.scale, prob.inv_scale, prob.fluid
    nullv = inv_s if prob.singular else None
    nullvv = tpo._dot(inv_s, inv_s) if prob.singular else None
    r = s * b
    if prob.singular:
        r = tpo._project_out(r, nullv, fluid, nullvv)
    tol = tol_rel * torch.sqrt(tpo._dot(r, r))
    return ([prob.apply_hat, prob.precond_hat, fluid, r, tol, 60, nullv,
             nullvv], {"apply_dot_h": prob.apply_dot_hat,
                       "precond_rz_h": prob.precond_rz_hat})


def _run(fn, args, kw, **extra):
    """`fn` on a copy of the right-hand side (the loop overwrites it)."""
    args = list(args)
    args[3] = args[3].clone()
    return fn(*args, **kw, **extra)


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


_KNOBS = {"one_sweep": tpo.SolverKnobs(),
          "cheb2": tpo.SolverKnobs(smooth_sweeps=2)}


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("knobs", sorted(_KNOBS))
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("open_top", [True, False], ids=["open", "closed"])
def test_in_place_loop_is_the_out_of_place_loop(open_top, use_pallas,
                                                knobs):
    prob, b = _problem((8, 6, 10), open_top, "cpu", use_pallas,
                       _KNOBS[knobs])
    args, kw = _cg_args(prob, b)
    x, k = _run(tpo._cg_core, args, kw)
    x0, k0 = _run(_cg_core_frozen, args, kw)
    assert k == k0 and k > 2
    assert _same_bits(x, x0)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_in_place_lanes_are_the_out_of_place_lanes(use_pallas):
    """Three cases: one stops at the cap (tol 0), one is converged before
    the first iteration (tol ∞), one converges in between."""
    prob, b = _problem((8, 6, 10), True, "cpu", use_pallas, cases=3)
    args, kw = _cg_args(prob, b)
    args[4] = args[4] * torch.tensor([0.0, float("inf"), 100.0])
    args[5] = 9
    x, k = _run(tpo._cg_core, args, kw)
    x0, k0 = _run(_cg_core_frozen, args, kw)
    assert k.tolist() == k0.tolist()
    assert k[0] == 9 and k[1] == 0 and 2 < k[2] < 9
    assert _same_bits(x, x0)


class _CudaLike(torch.Tensor):
    @property
    def is_cuda(self):
        return True


class _OneRank:
    """A rank context of one rank: every exchange meets a global end."""

    grid = (1, 1)

    def all_reduce(self, t, op="sum"):
        return t

    def exchange(self, hi, lo, axis=0):
        return None, None


def test_graph_rule_reads_the_input_alone(monkeypatch):
    on_card = torch.zeros(3).as_subclass(_CudaLike)
    assert tpo._graphs_engage(on_card)
    assert not tpo._graphs_engage(torch.zeros(3))
    with st.rank_block(_OneRank(), 8, 6):
        assert not tpo._graphs_engage(on_card)
    monkeypatch.setattr(_build, "nan_hook", lambda what, outputs: None)
    assert not tpo._graphs_engage(on_card)


class _StandIn:
    """tpo._IterGraph on the CPU: the capture runs nothing, a replay runs
    the captured body; both counted as the graph counts them."""

    made = 0

    def __init__(self, body, site, device):
        _StandIn.made += 1
        self.body, self.site = body, site
        self.launches = {seven_point.apply_7pt: 2}
        prof.graph_captured(site, self.launches)

    def replay(self):
        self.body()
        prof.graph_replayed(self.site, self.launches)


@pytest.mark.parametrize("batched", [False, True], ids=["grid", "lanes"])
def test_loop_captures_once_and_replays_the_rest(monkeypatch, batched):
    """The first iteration eager, one capture at the second, a replay for
    it and every later one; the launches a capture counted are taken back
    and each replay credits them."""
    monkeypatch.setattr(tpo, "_graphs_engage", lambda b: True)
    monkeypatch.setattr(tpo, "_IterGraph", _StandIn)
    prob, b = _problem((8, 6, 10), True, "cpu", True,
                       cases=2 if batched else None)
    args, kw = _cg_args(prob, b)
    _StandIn.made = 0
    with prof.collect() as rec:
        x, k = _run(tpo._cg_core, args, kw)
    x0, k0 = _run(tpo._cg_core, args, kw, _graphs=False)
    n = int(k.max()) if batched else k
    site = "poisson.cg_lanes" if batched else "poisson.cg"
    assert _same_bits(x, x0) and n > 2
    assert torch.equal(torch.as_tensor(k), torch.as_tensor(k0))
    assert _StandIn.made == 1
    assert rec.graph_captures == {site: 1}
    assert rec.graph_replays == {site: n - 1}
    assert rec.host_reads == {site: n + 1}
    assert rec.launches == {"seven_point.apply_7pt": 2 * (n - 2)}
    counts = prof.per_step_counts(dataclasses.replace(rec, steps=2))
    assert counts[f"graph_captures_per_step.{site}"] == 0.5
    assert counts[f"graph_replays_per_step.{site}"] == (n - 1) / 2


def test_a_replay_credits_each_entry_once():
    """A capture's launches are keyed by the entries themselves, each of
    which `launch_counts()` names once (no module's loop variable names
    an entry a second time): a replay adds to each entry once."""
    from openfoam_tpp_tpu_torch.ops.kernels import halo7

    assert not hasattr(seven_point, "_fn") and not hasattr(halo7, "_fn")
    entries = [fn for _, fn in prof._entries()]
    assert len({id(fn) for fn in entries}) == len(entries)
    assert set(prof.entry_launches()) == set(entries)
    assert not any(k.split(".", 1)[1].startswith("_")
                   for k in prof.launch_counts())
    entry = seven_point.cheb2_post_dot_7pt
    n0 = entry.launches
    with prof.collect() as rec:
        prof.graph_captured("test.site", {entry: 1})
        prof.graph_replayed("test.site", {entry: 1})
        prof.graph_replayed("test.site", {entry: 1})
    assert entry.launches == n0 + 1
    assert rec.launches == {"seven_point.cheb2_post_dot_7pt": 1}
    assert rec.graph_captures == {"test.site": 1}
    assert rec.graph_replays == {"test.site": 2}


def test_counters_read_zero_on_the_cpu_and_in_a_rank_block():
    prob, b = _problem((8, 6, 10), True, "cpu", True)
    with prof.collect() as rec:
        _, _, iters = tpo.solve_pcg(prob, b, torch.zeros_like(b),
                                    tol_rel=1e-6, n_refine=1)
    assert rec.graph_captures == {} and rec.graph_replays == {}
    assert rec.host_reads == {"poisson.cg": int(iters) + 1}
    assert not any(k.startswith("graph_")
                   for k in prof.per_step_counts(rec))
    args, kw = _cg_args(prob, b)
    with prof.collect() as rec, st.rank_block(_OneRank(), 8, 6):
        x, k = _run(tpo._cg_core, args, kw)
    x0, k0 = _run(_cg_core_frozen, args, kw)
    assert rec.graph_captures == {} and rec.graph_replays == {}
    assert rec.host_reads == {"poisson.cg": k + 1}
    assert k == k0 and _same_bits(x, x0)


def test_a_problem_carries_its_islands():
    from openfoam_tpp_tpu_torch.parallel import spmd as sm

    ga, rho, _ = _box((8, 6, 10), 3, True, "cpu")
    spmd = sm.SpmdCtx(2)
    op, pack = tpo.build_operator(ga, (0.004,) * 3, rho, ga["top_open"],
                                  use_pallas=True, spmd=spmd)
    assert op.spmd is spmd
    bundle = tpo.make_bundle(pack, use_pallas=True, spmd=spmd)
    assert tpo.attach_precond(op, bundle, spmd=spmd).spmd is spmd
    assert tpo.build_poisson(ga, (0.004,) * 3, rho, ga["top_open"],
                             knobs=tpo.SolverKnobs()).spmd is None


# ---------------------------------------------------------------- card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _graph_against_eager(args, kw, site):
    """One CG call eagerly and one with the graph, each after a call that
    builds and warms: the same bits, counters and launches, and the peak
    of allocated memory (each call's x leaves the card before the next
    call is measured)."""
    out = []
    for graphs in (False, True):
        _run(tpo._cg_core, args, kw, _graphs=graphs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with prof.collect() as rec:
            x, k = _run(tpo._cg_core, args, kw, _graphs=graphs)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out.append((x.cpu(), torch.as_tensor(k).cpu(), peak, rec))
        del x, k
    (xe, ke, peak_e, rec_e), (xg, kg, peak_g, rec_g) = out
    n = int(kg.max())
    assert torch.equal(ke, kg) and n > 2
    assert _same_bits(xe, xg)
    assert rec_e.graph_captures == {} and rec_e.graph_replays == {}
    assert rec_g.graph_captures == {site: 1}
    assert rec_g.graph_replays == {site: n - 1}
    assert rec_g.host_reads == rec_e.host_reads == {site: n + 1}
    assert rec_g.launches == rec_e.launches
    assert peak_g <= 1.01 * peak_e, (peak_g, peak_e)


@pytest.mark.gpu
@pytest.mark.parametrize("knobs", sorted(_KNOBS))
@pytest.mark.parametrize("open_top", [True, False], ids=["open", "closed"])
def test_graph_replay_is_the_eager_loop_on_a_grid(dev, open_top, knobs):
    prob, b = _problem((64, 64, 64), open_top, dev, True, _KNOBS[knobs])
    args, kw = _cg_args(prob, b)
    _graph_against_eager(args, kw, "poisson.cg")


@pytest.mark.gpu
def test_graph_replay_is_the_eager_loop_on_a_batch(dev):
    prob, b = _problem((12, 12, 50), True, dev, True, cases=128)
    args, kw = _cg_args(prob, b)
    # a spread of tolerances: the cases stop at different iterations
    args[4] = args[4] * torch.logspace(-1, 1, 128, device=dev)
    _graph_against_eager(args, kw, "poisson.cg_lanes")
