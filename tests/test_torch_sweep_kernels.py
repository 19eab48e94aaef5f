"""The batch-native 7-point entry points and the batched pressure solve of
the port's sweep path, on the CPU.

(a) `apply_7pt_nb` / `resid_scaled_7pt_nb` / `apply_dot_7pt_nb` on CPU
    tensors (their plain versions; the CUDA kernels run only on the card,
    where chip_smoke.py and tests/test_torch_cuda.py hold them against
    these) against the JAX package's Pallas kernels of
    ops/pallas/seven_point_batch.py in interpret mode, on
    tests/test_batch_kernels.py's problem (12×8×8 cells × 3 cases, zero
    domain-boundary faces), from numpy-seeded inputs; and against the
    rank-3 plain version case by case, bitwise; the apply-dot also at
    the CUDA kernel's edge shapes (nz = 50 with odd B, nz < 8).
(b) a batched `solve_pcg` on two cases of different stiffness: each case
    equals its solo solve.

Tolerances: f32 outputs 1e-6 absolute (the JAX test's own bound;
measured 4.8e-7 at outputs up to 6.9: XLA's CPU backend contracts
multiply-adds), per-case dots 1e-5 relative (measured 1.5e-7). bf16: the
Pallas body rounds after each of its ~12 operations where the port
computes in f32 and rounds once, as for the single-grid kernels: held to
four bf16 ulps of the largest output (2^-6 of scale; measured 0.031 at
outputs up to 4.5, 1.8 ulps) and the dots to 5e-3 relative (measured
1.6e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.ops.pallas import seven_point_batch as jsb
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as tsp
from openfoam_tpp_tpu_torch.solver import poisson as tpo

NX, NY, NZ, B = 12, 8, 8, 3
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_ATOL = 1e-6
DOT_RTOL = 1e-5
BF16_STENCIL_RTOL = 2.0 ** -6   # four bf16 ulps of the largest output
BF16_DOT_RTOL = 5e-3


def _problem(seed=0):
    """test_batch_kernels.py's problem from a numpy seed: p, b, diag and the
    face-lite weights (boundary faces zero), all (NX, NY, NZ, B) f32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0, 0.16, s).astype(np.float32)
    p, b = f(NX, NY, NZ, B), f(NX, NY, NZ, B)
    wx, wy, wz = u(NX + 1, NY, NZ, B), u(NX, NY + 1, NZ, B), u(NX, NY, NZ + 1, B)
    wx[0] = wx[-1] = 0
    wy[:, 0] = wy[:, -1] = 0
    wz[:, :, 0] = wz[:, :, -1] = 0
    diag = (1.0 + rng.uniform(0, 1, (NX, NY, NZ, B))).astype(np.float32)
    split = tuple(np.ascontiguousarray(w)
                  for w in (wx[:-1], wy[:, :-1], wz[:, :, :-1]))
    return p, b, diag, split


def _pair(a, dt):
    jdt, tdt = _DT[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(jnp.asarray(a, jnp.float32)))


def _close(got, ref, dt):
    got, ref = _f32(got), _f32(ref)
    err = float(np.abs(got - ref).max())
    lim = (F32_ATOL if dt == "f32"
           else BF16_STENCIL_RTOL * float(np.abs(ref).max()))
    assert err <= lim, (err, lim)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_diag", [False, True])
def test_batch_entry_points_match_pallas(dt, with_diag):
    p, b, diag, split = _problem()
    (jp, tp), (jb, tb) = _pair(p, dt), _pair(b, dt)
    jd, td = _pair(diag, dt) if with_diag else (None, None)
    js, ts = zip(*(_pair(w, dt) for w in split))
    _close(tsp.apply_7pt_nb(tp, ts, td),
           jsb.apply_7pt_nb(jp, js, diag=jd, interpret=True), dt)
    _close(tsp.resid_scaled_7pt_nb(tp, ts, td, tb),
           jsb.resid_scaled_7pt_nb(jp, js, jd, jb, interpret=True), dt)
    if not with_diag:
        ap, dots = tsp.apply_dot_7pt_nb(tp, ts)
        jap, jdots = jsb.apply_dot_7pt_nb(jp, js, interpret=True)
        _close(ap, jap, dt)
        assert dots.shape == (B,) and dots.dtype == torch.float32
        np.testing.assert_allclose(
            dots.numpy(), np.asarray(jdots),
            rtol=DOT_RTOL if dt == "f32" else BF16_DOT_RTOL)


@pytest.mark.parametrize("shape", [(4, 3, 50, 5), (4, 1, 3, 3)])
def test_apply_dot_nb_matches_pallas_at_kernel_edges(shape):
    """The batch apply-dot at the CUDA kernel's edge shapes (its blocks are
    one (x, y) column and 32 cases, 8 warps along z): nz = 50 with odd B
    (a ragged last z chunk) and nz < 8 on single-row columns (idle
    warps), f32 with zero domain-boundary faces: Â·p and the per-case dots
    of the plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(7)
    p = rng.standard_normal(shape).astype(np.float32)
    split = [rng.uniform(0, 0.16, shape).astype(np.float32) for _ in range(3)]
    split[0][0], split[1][:, 0], split[2][:, :, 0] = 0, 0, 0
    (jp, tp), *ws = [_pair(a, "f32") for a in (p, *split)]
    js, ts = zip(*ws)
    ap, dots = tsp.apply_dot_7pt_nb(tp, ts)
    jap, jdots = jsb.apply_dot_7pt_nb(jp, js, interpret=True)
    _close(ap, jap, "f32")
    assert dots.shape == (shape[-1],) and dots.dtype == torch.float32
    np.testing.assert_allclose(dots.numpy(), np.asarray(jdots), rtol=DOT_RTOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_batch_plain_equals_rank3_plain_per_case(dt):
    """The case axis never shifts: case i of the batched result is the
    single-grid result on case i's operands, bitwise; the rank dispatch
    sends rank 4 to the batch entry points and rank 3 to the others."""
    p, b, diag, split = _problem(1)
    tp, tb, td = (_pair(a, dt)[1] for a in (p, b, diag))
    ts = tuple(_pair(w, dt)[1] for w in split)
    lane = lambda t, i: t[..., i].contiguous()
    out_a = tsp.apply_7pt(tp, ts)
    out_d = tsp.apply_7pt(tp, ts, td)
    out_r = tsp.resid_scaled_7pt(tp, ts, None, tb)
    out_rd = tsp.resid_scaled_7pt(tp, ts, td, tb)
    out_ap, dots = tsp.apply_dot_7pt(tp, ts)
    assert torch.equal(out_a, tsp.apply_7pt_nb(tp, ts))
    assert torch.equal(out_ap, out_a)
    for i in range(B):
        s_i = tuple(lane(w, i) for w in ts)
        p_i, b_i, d_i = lane(tp, i), lane(tb, i), lane(td, i)
        assert torch.equal(out_a[..., i], tsp.apply_7pt_plain(p_i, s_i))
        assert torch.equal(out_d[..., i], tsp.apply_7pt_plain(p_i, s_i, d_i))
        assert torch.equal(out_r[..., i],
                           tsp.resid_scaled_7pt_plain(p_i, s_i, None, b_i))
        assert torch.equal(out_rd[..., i],
                           tsp.resid_scaled_7pt_plain(p_i, s_i, d_i, b_i))
        ap_i, dot_i = tsp.apply_dot_7pt(p_i, s_i)
        assert torch.equal(out_ap[..., i], ap_i) and dot_i.dim() == 0
        # Another reduction shape than the single grid's full sum.
        np.testing.assert_allclose(float(dots[i]), float(dot_i), rtol=1e-5)


def test_rank_and_operand_checks():
    p, b, diag, split = _problem(2)
    tp = torch.from_numpy(p)
    ts = tuple(torch.from_numpy(w) for w in split)
    with pytest.raises(ValueError, match="batched"):
        tsp.apply_7pt(tp[..., 0, 0], tuple(w[..., 0, 0] for w in ts))
    with pytest.raises(ValueError, match="batched"):
        tsp.apply_dot_7pt(tp[None], tuple(w[None] for w in ts))
    # What a CUDA launch would refuse: a rank the entry point does not
    # take, a non-contiguous or mismatched operand.
    with pytest.raises(ValueError, match="4-D"):
        tsp._check(tp[..., 0], ts, rank=4)
    strided = torch.zeros(NX, NY, NZ, 2 * B)[..., ::2]   # p's shape
    with pytest.raises(ValueError, match="contiguous"):
        tsp._check(tp, ts, strided, rank=4)
    with pytest.raises(ValueError, match="contiguous"):
        tsp._check(strided, ts, rank=4)
    with pytest.raises(ValueError, match="share"):
        tsp._check(tp, ts, torch.from_numpy(b)[..., :2].contiguous(), rank=4)
    for fn in (tsp.apply_7pt_nb, tsp.resid_scaled_7pt_nb, tsp.apply_dot_7pt_nb):
        assert fn.launches == 0   # no kernel launches on CPU tensors


# ---------------------------------------------------------------- (b) CG

def _lane_problem(seed, contrast):
    """A closed-form pressure problem on a small box with an open top: a
    density jump of `contrast` across a tilted interface, so the two
    cases differ in stiffness."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = 8, 8, 12
    z = (np.arange(nz) + 0.5)[None, None, :] / nz
    x = (np.arange(nx) + 0.5)[:, None, None] / nx
    alpha = np.clip((0.5 + 0.2 * (x - 0.5) - z) * nz, 0.0, 1.0)
    alpha = np.broadcast_to(alpha, (nx, ny, nz))
    rho = (alpha * contrast + (1.0 - alpha)).astype(np.float32)
    ones = lambda *s: np.ones(s, np.float32)
    ax, ay, az = ones(nx + 1, ny, nz), ones(nx, ny + 1, nz), ones(nx, ny, nz + 1)
    ax[0] = ax[-1] = 0
    ay[:, 0] = ay[:, -1] = 0
    az[:, :, 0] = 0
    ga = {"vfrac": ones(nx, ny, nz), "ax": ax, "ay": ay, "az": az,
          "top_open": ones(nx, ny)}
    b = rng.standard_normal((nx, ny, nz)).astype(np.float32)
    return ga, rho, b


@pytest.mark.parametrize("precond,bound", [("f32", 1e-6), ("bf16", 5e-6)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_batched_solve_equals_solo_solves(use_pallas, precond, bound):
    """Two cases, density contrast 10 and 998.2, hz 4 mm and 0.5 mm: each
    case of the batched solve takes its solo iteration count (11 and 24)
    and gives its solo x. The easy case converges first and is held while
    the stiff one goes on. The batched dots sum in another order than the
    single grid's full sum: with the f32 V-cycle x agrees to 1e-6 of its
    scale (measured 4.5e-7); with the default bf16 V-cycle a last-bit
    difference in r can flip a bf16 rounding inside the preconditioner,
    measured 1.7e-6, held to 5e-6. Both solves get hz as an f32 tensor,
    as the sweep step gives it."""
    knobs = tpo.SolverKnobs(precond_f32=precond == "f32")
    lanes = [_lane_problem(3, 10.0), _lane_problem(4, 998.2)]
    hz = torch.tensor([0.004, 0.0005], dtype=torch.float32)
    t = torch.from_numpy
    solo = []
    for (ga, rho, b), h in zip(lanes, hz):
        prob = tpo.build_poisson({k: t(v) for k, v in ga.items()},
                                 (0.004, 0.004, h), t(rho),
                                 t(ga["top_open"]), use_pallas=use_pallas,
                                 knobs=knobs)
        solo.append(tpo.solve_pcg(prob, t(b), torch.zeros_like(t(b)),
                                  tol_rel=1e-6, max_iters=60))
    stack = lambda arrs: t(np.stack(arrs, -1))
    ga4 = {k: stack([ln[0][k] for ln in lanes]) for k in lanes[0][0]}
    prob4 = tpo.build_poisson(ga4, (0.004, 0.004, hz),
                              stack([ln[1] for ln in lanes]),
                              ga4["top_open"], use_pallas=use_pallas,
                              knobs=knobs)
    b4 = stack([ln[2] for ln in lanes])
    x4, res4, it4 = tpo.solve_pcg(prob4, b4, torch.zeros_like(b4),
                                  tol_rel=1e-6, max_iters=60)
    assert it4.shape == (2,) and it4.dtype == torch.int32
    assert res4.shape == (2,)
    iters = [int(s[2]) for s in solo]
    assert iters == [11, 24]            # different stiffness
    assert it4.tolist() == iters
    for i, (x, res, _) in enumerate(solo):
        scale = float(x.abs().max())
        assert float((x4[..., i] - x).abs().max()) <= bound * scale
        np.testing.assert_allclose(float(res4[i]), float(res), rtol=0.1)
