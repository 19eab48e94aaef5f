"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, at run time). On a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m gpu

Small shapes with all three extents distinct. Tolerances: f32 outputs
are held bitwise-close (1e-6 relative; the kernels are built without
FMA contraction and use the plain versions' operation order), bf16
outputs to one bf16 ulp, the apply-dot scalar to 1e-5 relative (its sum
runs in another order than torch.sum); the momentum right-hand side to
1e-5 of its scale. The fused Chebyshev smoothers chain two stencil passes
in f32 and round once, like their plain versions: bitwise equal. The
batch-native 7-point kernels (cases on a trailing axis) hold the
single-grid family's bounds, and a case equals the single-grid kernel on
that case bitwise. The halo kernels of the x-sharded step hold their
single-grid rows' bounds against their plain versions per shard, and the
4-shard islands equal the single-grid kernels on the whole grid bitwise
(the dot and the div max: 1e-6 relative). The FCT, momentum, MULES flux
and apply-dot kernels, which march x chunks over (y, z) tiles, are also
held at shapes that divide neither, down to one cell across: the flux
kernel and the apply-dot output bitwise, the apply-dot dot to 1e-5 of the
plain sum and bitwise from call to call (its ticket counter back at 0
after every call), the apply-dot island's dot bitwise equal to the
single-grid kernel's. The FCT limiter and momentum RHS also at spacing
(0.002, 0.013, 0.004), where 1.0f / (float)h is an ulp off the
(float)(1.0 / h) that the plain versions' division by a Python float
multiplies by: the limiter (single grid and every shard) bitwise equal
to plain, the momentum RHS to 1e-5 of scale. The cheb2 smoothers (every mode and type pair) and
the projection epilogue (open and closed top, a NaN in a fluid cell) at
such shapes too: the smoothers bitwise equal to their plain versions, the
post-dot's dot repeating bitwise with the ticket back at 0; the epilogue's
velocities and div max bitwise equal to the plain version on the card
(both multiply by the f32 reciprocal of the spacing), its islands bitwise
equal to the single grid. The V-cycle residual: its island, with the
launches after the first chained, bitwise equal to the single-grid
kernel at slabs of 2, 3 and 18 planes and of 3 planes of a wide grid,
and complete for the plain op that reads it next; its batch form (a z
march over case pairs from 2**18 elements) at odd and small B, short z
and single columns, below and at that size, within the family's bounds
of its plain version and bitwise equal to the single-grid kernel on
every case, unaligned operands included. The batch apply-dot (one
launch, a z march per column with the dots finished through the ticket)
at the same edges and on a grid of one block: Â·p bitwise equal to the
single-grid kernel on every case, the dots within 1e-5 of the plain sums
and bitwise from call to call, and the one ticket shared in sequence
with the single-grid apply-dot and the cheb2 post-dot. Built with
OFTPP_FINISH_PALLAS=1, the momentum finish kernel launches 0 times with
surface tension and in the tiled sweep, and once a step under a forcing
of three 0-d components. Under the NaN trap (OFTPP_DEBUG_NANS=1) a NaN
operand of each of the 21 entry points raises from the kernel hook, but
the FCT limiter's, whose clip maps a NaN λ to a finite one."""

import numpy as np
import pytest
import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import halo7
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as mfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp
from openfoam_tpp_tpu_torch.parallel import spmd as sm

pytestmark = pytest.mark.gpu

SHAPE = (20, 13, 37)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, ref):
    got, ref = got.float(), ref.float()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _arr(rng, dev, dtype=torch.float32, lo=None, hi=None):
    a = (rng.standard_normal(SHAPE) if lo is None
         else rng.uniform(lo, hi, SHAPE)).astype(np.float32)
    return torch.from_numpy(a).to(dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seven_point_kernels_match_plain(dev, dtype):
    rng = np.random.default_rng(0)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    p, b = _arr(rng, dev, dtype), _arr(rng, dev, dtype)
    w = [_arr(rng, dev, dtype, 0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    d = _arr(rng, dev, dtype, 1.5, 2.5)
    n0 = sp.apply_7pt.launches
    for diag in (None, d):
        assert _rel(sp.apply_7pt(p, w, diag), sp.apply_7pt_plain(p, w, diag)) <= tol
        assert _rel(sp.resid_scaled_7pt(p, w, diag, b),
                    sp.resid_scaled_7pt_plain(p, w, diag, b)) <= tol
    ap, dot = sp.apply_dot_7pt(p, w)
    ap_p, dot_p = sp.apply_dot_7pt_plain(p, w)
    assert _rel(ap, ap_p) <= tol
    assert abs(float(dot) - float(dot_p)) <= 1e-5 * abs(float(dot_p))
    assert sp.apply_7pt.launches == n0 + 2


@pytest.mark.parametrize("cases", [128, 40, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_seven_point_kernels_match_plain(dev, dtype, cases):
    """The batch-native kernels on (nx, ny, nz, B) with the case axis
    trailing, B a multiple of the warp or ragged: against their plain
    versions (the single-grid family's bounds; the per-case dots 1e-5) and
    against the single-grid kernel on one case, bitwise."""
    rng = np.random.default_rng(6)
    shape = (6, 5, 11, cases)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    arr = lambda lo=None, hi=None: torch.from_numpy(
        (rng.standard_normal(shape) if lo is None
         else rng.uniform(lo, hi, shape)).astype(np.float32)).to(dev).to(dtype)
    p, b = arr(), arr()
    w = [arr(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    d = arr(1.5, 2.5)
    n0 = (sp.apply_7pt_nb.launches, sp.resid_scaled_7pt_nb.launches,
          sp.apply_dot_7pt_nb.launches, sp.apply_7pt.launches)
    for diag in (None, d):
        # Through the rank dispatch of the single-grid names.
        assert _rel(sp.apply_7pt(p, w, diag), sp.apply_7pt_plain(p, w, diag)) <= tol
        assert _rel(sp.resid_scaled_7pt(p, w, diag, b),
                    sp.resid_scaled_7pt_plain(p, w, diag, b)) <= tol
    ap, dots = sp.apply_dot_7pt(p, w)
    ap_p, dots_p = sp.apply_dot_7pt_plain(p, w)
    assert _rel(ap, ap_p) <= tol
    assert dots.shape == (cases,) and dots.dtype == torch.float32
    assert float(((dots - dots_p).abs() / dots_p.abs()).max()) <= 1e-5
    n1 = (sp.apply_7pt_nb.launches, sp.resid_scaled_7pt_nb.launches,
          sp.apply_dot_7pt_nb.launches, sp.apply_7pt.launches)
    assert [b_ - a_ for a_, b_ in zip(n0, n1)] == [2, 2, 1, 0]
    i = cases - 1
    lane = lambda t: t[..., i].contiguous()
    assert torch.equal(sp.apply_7pt_nb(p, w, d)[..., i],
                       sp.apply_7pt(lane(p), [lane(x) for x in w], lane(d)))
    with pytest.raises(ValueError, match="contiguous"):
        sp.apply_7pt_nb(p.permute(1, 0, 2, 3).permute(1, 0, 2, 3)[..., ::2],
                        [x[..., ::2] for x in w])
    with pytest.raises(ValueError, match="share"):
        sp.resid_scaled_7pt_nb(p, w, None, b[..., :1].contiguous())


# The cheb2 and projection-epilogue kernels march x chunks over (y, z)
# tiles (30 × 14 outputs, 8 × 32 cells): shapes that divide neither, a z
# length that is not a multiple of 4, down to one cell across.
CHEB_EDGES = [SHAPE, (4, 3, 2), (1, 1, 70), (17, 9, 33), (9, 21, 38)]


@pytest.mark.parametrize("shape", CHEB_EDGES)
@pytest.mark.parametrize("dtype,out", [(torch.float32, None),
                                       (torch.bfloat16, None),
                                       (torch.bfloat16, torch.float32)])
def test_cheb2_kernels_match_plain(dev, dtype, out, shape):
    """Weights with zero domain-boundary faces, as on every real level;
    shapes down to one cell across, where every neighbour is clamped.
    x, r and z bitwise equal to the plain versions (f32 arithmetic in
    nb_sum's order, rounded once on store); the post-dot's z equal to the
    post's, its dot within 1e-5 of the plain sum and bitwise over 3
    calls, the ticket back at 0; one launch per call."""
    rng = np.random.default_rng(5)
    arr = lambda lo=None, hi=None: torch.from_numpy(
        (rng.standard_normal(shape) if lo is None
         else rng.uniform(lo, hi, shape)).astype(np.float32)).to(dev).to(dtype)
    x, b = arr(), arr()
    w = [arr(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    n0 = (sp.cheb2_pre_7pt.launches, sp.cheb2_post_7pt.launches,
          sp.cheb2_post_dot_7pt.launches)
    for lmin in (0.10, 0.25):
        got = sp.cheb2_pre_7pt(b, w, 2.0, lmin)
        ref = sp.cheb2_pre_7pt_plain(b, w, 2.0, lmin)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == dtype and torch.equal(g, r)
        z = sp.cheb2_post_7pt(x, b, w, 2.0, lmin, out_dtype=out)
        z_p = sp.cheb2_post_7pt_plain(x, b, w, 2.0, lmin, out_dtype=out)
        assert z.dtype == z_p.dtype == (out or dtype) and torch.equal(z, z_p)
        _, dot_p = sp.cheb2_post_dot_7pt_plain(x, b, w, 2.0, lmin,
                                               out_dtype=out)
        dots = []
        for _ in range(3):
            z2, dot = sp.cheb2_post_dot_7pt(x, b, w, 2.0, lmin, out_dtype=out)
            assert torch.equal(z2, z)
            assert dot.dtype == torch.float32 and dot.device == x.device
            assert int(_build.ticket(x.device)[0]) == 0
            dots.append(float(dot))
        assert abs(dots[0] - float(dot_p)) <= 1e-5 * abs(float(dot_p))
        assert dots == [dots[0]] * 3
    n1 = (sp.cheb2_pre_7pt.launches, sp.cheb2_post_7pt.launches,
          sp.cheb2_post_dot_7pt.launches)
    assert [b_ - a_ for a_, b_ in zip(n0, n1)] == [2, 2, 6]
    with pytest.raises(ValueError, match="stores"):
        sp.cheb2_post_7pt(x.float(), b.float(), [v.float() for v in w], 2.0,
                          0.1, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mules_kernels_match_plain(dev, dtype):
    rng = np.random.default_rng(1)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    alpha = _arr(rng, dev, lo=0, hi=1)
    phis = tuple(1e-3 * _arr(rng, dev) for _ in range(3))
    ucs = tuple((1e-3 * _arr(rng, dev)).to(dtype) for _ in range(3))
    anti_dt = dtype if dtype == torch.bfloat16 else None
    got = mfx.flux_all(alpha, phis, ucs, anti_dt)
    ref = mfx.flux_all_plain(alpha, phis, ucs, anti_dt)
    for g, r in zip(sum(got, ()), sum(ref, ())):
        assert g.dtype == r.dtype and _rel(g, r) <= tol
    al = _arr(rng, dev, lo=0, hi=1)
    amax = torch.clamp(al + _arr(rng, dev, lo=0, hi=0.2), max=1.0)
    amin = torch.clamp(al - _arr(rng, dev, lo=0, hi=0.2), min=0.0)
    dt_iv = _arr(rng, dev, lo=1e-4, hi=2e-4)
    lams = tuple(_arr(rng, dev, dtype, 0, 1) for _ in range(3))
    antis = tuple((1e-3 * _arr(rng, dev)).to(dtype) for _ in range(3))
    sp_ = (0.004, 0.004, 0.0035)
    got = mf.fct_iter(lams, antis, al, amax, amin, dt_iv, sp_)
    ref = mf.fct_iter_plain(lams, antis, al, amax, amin, dt_iv, sp_)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and _rel(g, r) <= tol


def _faces(rng, dev, shape, lo=-1.0, hi=1.0):
    nx, ny, nz = shape
    return tuple(torch.from_numpy(rng.uniform(lo, hi, s).astype(np.float32)).to(dev)
                 for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1)))


def _walls(f, open_top=True):
    """Zero the wall faces of a face triple (physical inputs)."""
    f[0][0], f[0][-1], f[1][:, 0], f[1][:, -1], f[2][:, :, 0] = 0, 0, 0, 0, 0
    if not open_top:
        f[2][:, :, -1] = 0


@pytest.mark.parametrize("dev2", [True, False])
def test_momentum_rhs_kernel_matches_plain(dev, dev2):
    """1e-5 of the output scale: the plain version on the card divides by
    a Python-scalar spacing through its reciprocal, the kernel divides."""
    rng = np.random.default_rng(2)
    vel, rp = _faces(rng, dev, SHAPE), _faces(rng, dev, SHAPE)
    _walls(vel)
    _walls(rp)
    mu = _arr(rng, dev, lo=1e-5, hi=2e-3)
    div_u = 0.1 * _arr(rng, dev)
    h = (0.011, 0.009, 0.013)
    n0 = mrk.momentum_rhs.launches
    got = mrk.momentum_rhs(*vel, rp, mu, div_u, h, dev2=dev2)
    ref = mrk.momentum_rhs_plain(*vel, rp, mu, div_u, h, dev2=dev2)
    scale = max(float(r.abs().max()) for r in ref)
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * scale
    assert float(got[0][-1].abs().max()) == 0.0
    assert mrk.momentum_rhs.launches == n0 + 1


@pytest.mark.parametrize("shape", CHEB_EDGES)
@pytest.mark.parametrize("open_top", [True, False])
def test_correct_divmax_kernel_matches_plain(dev, open_top, shape):
    """u_c, v_c, w_c and div max bitwise equal to the plain version on the
    card (both multiply by 1/h rounded as PyTorch rounds it), the ticket
    back at 0, one launch per call; a NaN in one fluid cell's dp comes
    back as a NaN div max."""
    rng = np.random.default_rng(3)
    args = _corr_operands(rng, dev, shape, open_top)
    n0 = ck.correct_divmax.launches
    got = ck.correct_divmax(*args, open_top=open_top)
    ref = ck.correct_divmax_plain(*args, open_top=open_top)
    assert ck.correct_divmax.launches == n0 + 1
    assert int(_build.ticket(args[0].device)[0]) == 0
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # A fluid cell above an open interior z face: its NaN reaches that
    # face's flux, so the divergence of the cells beside it.
    dp, az, vfrac = args[0].clone(), args[7], args[8]
    above = torch.zeros_like(vfrac, dtype=torch.bool)
    above[:, :, 1:] = az[:, :, 1:-1] > 0
    dp[tuple(torch.nonzero((vfrac > 0) & above)[0])] = float("nan")
    got = ck.correct_divmax(dp, *args[1:], open_top=open_top)
    assert torch.isnan(got[3])
    assert torch.isnan(ck.correct_divmax_plain(dp, *args[1:],
                                               open_top=open_top)[3])
    assert int(_build.ticket(dp.device)[0]) == 0


def _corr_operands(rng, dev, shape, open_top):
    dp = _at(rng, dev, shape, lo=-50, hi=50)
    vel = _faces(rng, dev, shape)
    _walls(vel)
    beta = _faces(rng, dev, shape, 8e-4, 1e-3)
    aps = _faces(rng, dev, shape, 0.0, 1.0)
    for a in aps:
        a[a < 0.2] = 0
    _walls(aps, open_top)
    vfrac = _at(rng, dev, shape, lo=0, hi=1)
    vfrac[vfrac < 0.1] = 0
    topo = (_at(rng, dev, shape, lo=0, hi=1)[:, :, 0] > 0.3).float().contiguous()
    rho = _at(rng, dev, shape, lo=1, hi=998)
    dt = torch.tensor(3.7e-3, device=dev)
    return (dp, *vel, beta, *aps, vfrac, topo, rho, dt, (0.011, 0.009, 0.013))


def test_momentum_finish_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    vel = _faces(rng, dev, SHAPE)
    vc = _faces(rng, dev, SHAPE, -50, 50)
    vc = (vc[0][:-1].contiguous(), vc[1], vc[2])
    ro, rn = _arr(rng, dev, lo=1, hi=998), _arr(rng, dev, lo=1, hi=998)
    aps = _faces(rng, dev, SHAPE, 0.0, 1.0)
    for a in aps:
        a[a < 0.25] = 0
    _walls(aps)
    dt = torch.tensor(2.9e-3, device=dev)
    G = torch.tensor([0.31, -0.12, -9.81], device=dev)
    got = mfk.momentum_finish(*vel, vc, ro, rn, *aps, dt, G)
    ref = mfk.momentum_finish_plain(*vel, vc, ro, rn, *aps, dt, G)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-6


CTX4 = sm.SpmdCtx(4)      # SHAPE's nx = 20: slabs of 5 planes


def _halo_inputs(rng, dev, dtype):
    """Every island's global inputs, with zero wall faces."""
    p, b = _arr(rng, dev, dtype), _arr(rng, dev, dtype)
    w = [_arr(rng, dev, dtype, 0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    d = _arr(rng, dev, dtype, 1.5, 2.5)
    alpha = _arr(rng, dev, lo=0, hi=1)
    phis = tuple(1e-3 * _arr(rng, dev) for _ in range(3))
    ucs = tuple((1e-3 * _arr(rng, dev)).to(dtype) for _ in range(3))
    al = _arr(rng, dev, lo=0, hi=1)
    cells = (al, torch.clamp(al + _arr(rng, dev, lo=0, hi=0.2), max=1.0),
             torch.clamp(al - _arr(rng, dev, lo=0, hi=0.2), min=0.0),
             _arr(rng, dev, lo=1e-4, hi=2e-4))
    lams = tuple(_arr(rng, dev, dtype, 0, 1) for _ in range(3))
    antis = tuple((1e-3 * _arr(rng, dev)).to(dtype) for _ in range(3))
    antis[0][0], antis[1][:, 0], antis[2][:, :, 0] = 0, 0, 0
    return p, b, tuple(w), d, alpha, phis, ucs, lams, antis, cells


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_islands_equal_single_grid_kernels(dev, dtype):
    """4 shards of halo kernels against the single-grid kernel on the
    whole grid: bitwise, the dot to 1e-6 relative. One launch per shard."""
    rng = np.random.default_rng(5)
    p, b, w, d, alpha, phis, ucs, lams, antis, cells = _halo_inputs(
        rng, dev, dtype)
    n0 = (halo7.apply_7pt_h.launches, halo7.resid_scaled_7pt_h.launches)
    for diag in (None, d):
        assert torch.equal(sm.apply_7pt(p, w, CTX4, diag=diag),
                           sp.apply_7pt(p, w, diag))
        assert torch.equal(sm.resid_scaled_7pt(p, w, CTX4, b, diag=diag),
                           sp.resid_scaled_7pt(p, w, diag, b))
    assert (halo7.apply_7pt_h.launches - n0[0],
            halo7.resid_scaled_7pt_h.launches - n0[1]) == (8, 8)
    ap, dot = sm.apply_dot_7pt(p, w, CTX4)
    ap1, dot1 = sp.apply_dot_7pt(p, w)
    assert torch.equal(ap, ap1)
    assert abs(float(dot) - float(dot1)) <= 1e-6 * abs(float(dot1))
    anti_dt = dtype if dtype == torch.bfloat16 else None
    got = sm.flux_all(alpha, phis, ucs, CTX4, anti_dtype=anti_dt)
    ref = mfx.flux_all(alpha, phis, ucs, anti_dt)
    assert all(torch.equal(g, r) for g, r in zip(sum(got, ()), sum(ref, ())))
    sp_ = (0.004, 0.004, 0.0035)
    got = sm.fct_iters(lams, antis, *cells, sp_, 3, CTX4)
    ref = lams
    for _ in range(3):
        ref = mf.fct_iter(ref, antis, *cells, sp_)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_halo_kernels_match_plain(dev, dtype):
    """Each 7-point and MULES halo entry point against its plain version
    on one interior shard (their single-grid rows' bounds)."""
    rng = np.random.default_rng(6)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    p, b, w, d, alpha, phis, ucs, lams, antis, cells = _halo_inputs(
        rng, dev, dtype)
    s = 1
    sl = lambda ts: tuple(CTX4.split(t)[s] for t in ts)
    lo, hi = sm.exchange_halo(CTX4.split(p), 1, CTX4)[s]
    wx_hi = sm.exchange_hi(CTX4.split(w[0]), 1, CTX4)[s]
    (p_s, b_s, d_s), w_s = sl((p, b, d)), sl(w)
    for diag in (None, d_s):
        assert _rel(halo7.apply_7pt_h(p_s, lo, hi, wx_hi, w_s, diag),
                    halo7.apply_7pt_h_plain(p_s, lo, hi, wx_hi, w_s,
                                            diag)) <= tol
        assert _rel(halo7.resid_scaled_7pt_h(p_s, lo, hi, wx_hi, w_s, b_s,
                                             diag),
                    halo7.resid_scaled_7pt_h_plain(p_s, lo, hi, wx_hi, w_s,
                                                   b_s, diag)) <= tol
    (ap, dot), (ap_p, dot_p) = (
        halo7.apply_dot_7pt_h(p_s, lo, hi, wx_hi, w_s),
        halo7.apply_dot_7pt_h_plain(p_s, lo, hi, wx_hi, w_s))
    assert _rel(ap, ap_p) <= tol
    assert abs(float(dot) - float(dot_p)) <= 1e-5 * abs(float(dot_p))
    a_lo, a_hi = sm.exchange_halo(CTX4.split(alpha), 2, CTX4)[s]
    anti_dt = dtype if dtype == torch.bfloat16 else None
    args = (sl((alpha,))[0], a_lo, a_hi[:1], sl(phis), sl(ucs), anti_dt)
    for g, r in zip(sum(mfx.flux_all_h(*args), ()),
                    sum(mfx.flux_all_h_plain(*args), ())):
        assert g.dtype == r.dtype and _rel(g, r) <= tol
    ex = lambda t, **k: sm.exchange_halo(CTX4.split(t), 1, CTX4, **k)[s]
    lh = [ex(t, hi_edge="zero") for t in lams]
    ah = [ex(t, hi_edge="zero") for t in antis]
    args = (sl(lams), (lh[0], (lh[1][0], None), (lh[2][0], None)), sl(antis),
            (ah[0], (ah[1][0], None), (ah[2][0], None)),
            tuple(ex(c)[0] for c in cells), *sl(cells), (0.004, 0.004, 0.0035))
    for g, r in zip(mf.fct_iter_h(*args), mf.fct_iter_h_plain(*args)):
        assert g.dtype == r.dtype and _rel(g, r) <= tol


def test_momentum_and_correction_halo_kernels(dev):
    """The momentum RHS and projection-epilogue islands: per shard against
    the plain versions (1e-5 of scale, 1e-6), and composed over 4 shards
    against the single-grid kernels bitwise (div max 1e-6 relative)."""
    rng = np.random.default_rng(7)
    vel, rp = _faces(rng, dev, SHAPE), _faces(rng, dev, SHAPE)
    _walls(vel)
    _walls(rp)
    mu = _arr(rng, dev, lo=1e-5, hi=2e-3)
    div_u = 0.1 * _arr(rng, dev)
    h = (0.011, 0.009, 0.013)
    n0 = mrk.momentum_rhs_h.launches
    got = sm.momentum_rhs(*vel, rp, mu, div_u, h, CTX4)
    assert mrk.momentum_rhs_h.launches == n0 + 4
    ref = mrk.momentum_rhs(*vel, rp, mu, div_u, h)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    nx = SHAPE[0]
    ex = lambda t, wd, **k: sm.exchange_halo(CTX4.split(t, nx), wd, CTX4,
                                             **k)[2]
    halos = (*ex(vel[0], 2, hi_edge="zero"), *ex(vel[1], 2), *ex(vel[2], 2),
             *ex(rp[0], 1, hi_edge="zero"), ex(rp[1], 1)[0], ex(rp[2], 1)[0],
             *ex(mu, 1), ex(div_u, 1, lo_edge="zero")[0])
    args = (*(CTX4.split(t, nx)[2] for t in (*vel, *rp, mu, div_u)), halos, h)
    k_out = mrk.momentum_rhs_h(*args)
    p_out = mrk.momentum_rhs_h_plain(*args)
    scale = max(float(r.abs().max()) for r in p_out)
    assert all(float((g - r).abs().max()) <= 1e-5 * scale
               for g, r in zip(k_out, p_out))

    dp = _arr(rng, dev, lo=-50, hi=50)
    beta = _faces(rng, dev, SHAPE, 8e-4, 1e-3)
    aps = _faces(rng, dev, SHAPE, 0.0, 1.0)
    for a in aps:
        a[a < 0.2] = 0
    _walls(aps)
    vfrac = _arr(rng, dev, lo=0, hi=1)
    vfrac[vfrac < 0.1] = 0
    topo = (_arr(rng, dev, lo=0, hi=1)[:, :, 0] > 0.3).float().contiguous()
    rho = _arr(rng, dev, lo=1, hi=998)
    dt = torch.tensor(3.7e-3, device=dev)
    got = sm.correct_divmax(dp, *vel, beta, *aps, vfrac, topo, rho, dt, h,
                            CTX4)
    ref = ck.correct_divmax(dp, *vel, beta, *aps, vfrac, topo, rho, dt, h)
    assert all(torch.equal(g, r) for g, r in zip(got[:3], ref[:3]))
    assert abs(float(got[3]) - float(ref[3])) <= 1e-6 * float(ref[3])
    s = 2
    part = lambda t: CTX4.split(t, nx)[s]
    dlo, dhi = sm.exchange_halo(CTX4.split(dp), 1, CTX4)[s]
    hi3 = [sm.exchange_hi(CTX4.split(t, nx), 1, CTX4)[s]
           for t in (vel[0], beta[0], aps[0])]
    args = (part(dp), dlo, dhi, part(vel[0]), hi3[0], part(vel[1]),
            part(vel[2]), part(beta[0]), hi3[1], part(beta[1]), part(beta[2]),
            part(aps[0]), hi3[2], part(aps[1]), part(aps[2]), part(vfrac),
            part(topo), part(rho), dt, h)
    k_out = ck.correct_divmax_h(*args)
    p_out = ck.correct_divmax_h_plain(*args)
    assert all(_rel(g, r) <= 1e-6 for g, r in zip(k_out[:3], p_out[:3]))
    assert abs(float(k_out[3]) - float(p_out[3])) <= 1e-6 * float(p_out[3])


# The FCT and momentum kernels march 16 x planes per block over 8 × 32
# (y, z) tiles, the flux kernel over 16 × 16 tiles, the apply-dot kernel
# over 8 × 32: shapes that divide none, down to one cell across.
EDGES = [(13, 11, 37), (1, 1, 70), (37, 1, 1), (1, 13, 1), (40, 9, 65)]
# Island shapes: 4 slabs of 2, 3 and 18 planes (the last more than one x
# chunk per slab).
ISLAND_EDGES = [(8, 11, 37), (12, 1, 1), (72, 9, 33)]


def _at(rng, dev, shape, dtype=torch.float32, lo=None, hi=None):
    a = (rng.standard_normal(shape) if lo is None
         else rng.uniform(lo, hi, shape)).astype(np.float32)
    return torch.from_numpy(a).to(dev).to(dtype)


def _fct_operands(rng, dev, shape, dtype):
    al = _at(rng, dev, shape, lo=0, hi=1)
    cells = (al, torch.clamp(al + _at(rng, dev, shape, lo=0, hi=0.2), max=1.0),
             torch.clamp(al - _at(rng, dev, shape, lo=0, hi=0.2), min=0.0),
             _at(rng, dev, shape, lo=1e-4, hi=2e-4))
    lams = tuple(_at(rng, dev, shape, dtype, 0, 1) for _ in range(3))
    antis = tuple((1e-3 * _at(rng, dev, shape)).to(dtype) for _ in range(3))
    antis[0][0], antis[1][:, 0], antis[2][:, :, 0] = 0, 0, 0
    return lams, antis, cells


def _mom_operands(rng, dev, shape, walls=True):
    vel, rp = _faces(rng, dev, shape), _faces(rng, dev, shape)
    if walls:
        _walls(vel)
        _walls(rp)
    mu = _at(rng, dev, shape, lo=1e-5, hi=2e-3)
    return vel, rp, mu, 0.1 * _at(rng, dev, shape)


@pytest.mark.parametrize("shape", EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fct_iter_kernel_at_tiling_edges(dev, dtype, shape):
    """λ from zero (the limiter's first iteration) and from random values:
    f32 to 1e-6 relative, bf16 to one ulp; one launch per call."""
    rng = np.random.default_rng(8)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    lams, antis, cells = _fct_operands(rng, dev, shape, dtype)
    sp_ = (0.004, 0.0045, 0.0035)
    n0 = mf.fct_iter.launches
    for start in (tuple(torch.zeros_like(l) for l in lams), lams):
        got = mf.fct_iter(start, antis, *cells, sp_)
        ref = mf.fct_iter_plain(start, antis, *cells, sp_)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and _rel(g, r) <= tol
    assert mf.fct_iter.launches == n0 + 2


@pytest.mark.parametrize("shape", EDGES)
@pytest.mark.parametrize("dev2,with_div", [(True, True), (True, False),
                                           (False, True)])
def test_momentum_rhs_kernel_at_tiling_edges(dev, shape, dev2, with_div):
    """With and without zero wall faces; 1e-5 of the output scale."""
    rng = np.random.default_rng(9)
    h = (0.011, 0.009, 0.013)
    for walls in (True, False):
        vel, rp, mu, div_u = _mom_operands(rng, dev, shape, walls)
        div_u = div_u if with_div else None
        got = mrk.momentum_rhs(*vel, rp, mu, div_u, h, dev2=dev2)
        ref = mrk.momentum_rhs_plain(*vel, rp, mu, div_u, h, dev2=dev2)
        scale = max(float(r.abs().max()) for r in ref)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 1e-5 * scale
        assert float(got[0][-1].abs().max()) == 0.0


@pytest.mark.parametrize("shape", ISLAND_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fct_and_momentum_islands_at_tiling_edges(dev, dtype, shape):
    """4 shards of the FCT (3 iterations) and momentum halo kernels against
    the single-grid kernels, bitwise; an interior shard's FCT against its
    plain version."""
    rng = np.random.default_rng(10)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    lams, antis, cells = _fct_operands(rng, dev, shape, dtype)
    sp_ = (0.004, 0.0045, 0.0035)
    n0 = mf.fct_iter_h.launches
    got = sm.fct_iters(lams, antis, *cells, sp_, 3, CTX4)
    assert mf.fct_iter_h.launches == n0 + 12
    ref = lams
    for _ in range(3):
        ref = mf.fct_iter(ref, antis, *cells, sp_)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    s = 1
    ex = lambda t, **k: sm.exchange_halo(CTX4.split(t), 1, CTX4, **k)[s]
    lh = [ex(t, hi_edge="zero") for t in lams]
    ah = [ex(t, hi_edge="zero") for t in antis]
    args = (tuple(CTX4.split(t)[s] for t in lams),
            (lh[0], (lh[1][0], None), (lh[2][0], None)),
            tuple(CTX4.split(t)[s] for t in antis),
            (ah[0], (ah[1][0], None), (ah[2][0], None)),
            tuple(ex(c)[0] for c in cells),
            *(CTX4.split(c)[s] for c in cells), sp_)
    for g, r in zip(mf.fct_iter_h(*args), mf.fct_iter_h_plain(*args)):
        assert _rel(g, r) <= tol
    if dtype == torch.float32:   # the momentum kernels are f32 only
        vel, rp, mu, div_u = _mom_operands(rng, dev, shape)
        h = (0.011, 0.009, 0.013)
        for dev2, du in ((True, div_u), (True, None), (False, div_u)):
            got = sm.momentum_rhs(*vel, rp, mu, du, h, CTX4, dev2=dev2)
            ref = mrk.momentum_rhs(*vel, rp, mu, du, h, dev2=dev2)
            assert all(torch.equal(g, r) for g, r in zip(got, ref))


UC_ANTI = [(torch.float32, None), (torch.float32, torch.bfloat16),
           (torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)]


def _flux_operands(rng, dev, shape, uc_dt):
    alpha = _at(rng, dev, shape, lo=0, hi=1)
    phis = tuple(1e-3 * _at(rng, dev, shape) for _ in range(3))
    ucs = tuple((1e-3 * _at(rng, dev, shape)).to(uc_dt) for _ in range(3))
    return alpha, phis, ucs


def _dot_operands(rng, dev, shape, dtype=torch.float32):
    p = _at(rng, dev, shape, dtype)
    w = [_at(rng, dev, shape, dtype, 0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    return p, tuple(w)


@pytest.mark.parametrize("shape", EDGES)
@pytest.mark.parametrize("uc_dt,anti_dt", UC_ANTI)
def test_flux_all_kernel_at_tiling_edges(dev, shape, uc_dt, anti_dt):
    """Every uc/anti dtype pair: bitwise equal to the plain version (the
    kernel keeps its IEEE divisions and operation order); one launch."""
    rng = np.random.default_rng(11)
    alpha, phis, ucs = _flux_operands(rng, dev, shape, uc_dt)
    n0 = mfx.flux_all.launches
    got = mfx.flux_all(alpha, phis, ucs, anti_dt)
    ref = mfx.flux_all_plain(alpha, phis, ucs, anti_dt)
    assert mfx.flux_all.launches == n0 + 1
    for g, r in zip(sum(got, ()), sum(ref, ())):
        assert g.dtype == r.dtype and torch.equal(g, r)


def _check_dot_calls(p, w, calls=3):
    """The apply-dot kernel `calls` times on (p, w): Â·p bitwise equal to
    the plain version's, the dot within 1e-5 of the plain sum and bitwise
    equal from call to call, the ticket counter 0 after each call."""
    ap_p, dot_p = sp.apply_dot_7pt_plain(p, w)
    dots = []
    for _ in range(calls):
        ap, dot = sp.apply_dot_7pt(p, w)
        assert torch.equal(ap, ap_p)
        assert int(_build.ticket(p.device)[0]) == 0
        dots.append(float(dot))
    assert abs(dots[0] - float(dot_p)) <= 1e-5 * abs(float(dot_p))
    assert dots == [dots[0]] * calls


@pytest.mark.parametrize("shape", EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_dot_kernel_at_tiling_edges(dev, dtype, shape):
    rng = np.random.default_rng(12)
    p, w = _dot_operands(rng, dev, shape, dtype)
    n0 = sp.apply_dot_7pt.launches
    _check_dot_calls(p, w)
    assert sp.apply_dot_7pt.launches == n0 + 3


def test_apply_dot_one_block_and_many_in_sequence(dev):
    """A grid of one block (its only block draws the last ticket), one of
    many blocks, then one block again: each dot right, so the counter
    wraps back to 0 however many blocks took a ticket."""
    rng = np.random.default_rng(13)
    for shape in ((1, 5, 20), (40, 9, 65), (1, 5, 20), (112, 24, 40)):
        _check_dot_calls(*_dot_operands(rng, dev, shape), calls=2)


@pytest.mark.parametrize("shape", ISLAND_EDGES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flux_and_apply_dot_islands_at_tiling_edges(dev, dtype, shape):
    """4 shards of the flux and apply-dot halo kernels against the
    single-grid kernels: bitwise, the dot included (the shards' chain adds
    the planes in the single-grid kernel's order), and a shard's partial
    dot bitwise from call to call; an interior shard's flux against its
    plain version bitwise."""
    rng = np.random.default_rng(14)
    p, w = _dot_operands(rng, dev, shape, dtype)
    n0 = halo7.apply_dot_7pt_h.launches
    ap, dot = sm.apply_dot_7pt(p, w, CTX4)
    assert halo7.apply_dot_7pt_h.launches == n0 + 4
    ap1, dot1 = sp.apply_dot_7pt(p, w)
    assert torch.equal(ap, ap1)
    assert float(dot) == float(dot1)
    s = 1
    lo, hi = sm.exchange_halo(CTX4.split(p), 1, CTX4)[s]
    wx_hi = sm.exchange_hi(CTX4.split(w[0]), 1, CTX4)[s]
    args = (CTX4.split(p)[s], lo, hi, wx_hi, tuple(CTX4.split(x)[s] for x in w))
    parts = [float(halo7.apply_dot_7pt_h(*args)[1]) for _ in range(3)]
    assert parts == [parts[0]] * 3
    assert int(_build.ticket(p.device)[0]) == 0
    _, part_p = halo7.apply_dot_7pt_h_plain(*args)
    assert abs(parts[0] - float(part_p)) <= 1e-5 * abs(float(part_p))
    acc = torch.tensor(0.25 * parts[0], device=dev)
    chained = float(halo7.apply_dot_7pt_h(*args, acc=acc)[1])
    assert abs(chained - (float(acc) + parts[0])) <= 1e-5 * abs(parts[0])

    anti_dt = dtype if dtype == torch.bfloat16 else None
    alpha, phis, ucs = _flux_operands(rng, dev, shape, dtype)
    n0 = mfx.flux_all_h.launches
    got = sm.flux_all(alpha, phis, ucs, CTX4, anti_dtype=anti_dt)
    assert mfx.flux_all_h.launches == n0 + 4
    ref = mfx.flux_all(alpha, phis, ucs, anti_dt)
    assert all(torch.equal(g, r) for g, r in zip(sum(got, ()), sum(ref, ())))
    a_lo, a_hi = sm.exchange_halo(CTX4.split(alpha), 2, CTX4)[s]
    args = (CTX4.split(alpha)[s], a_lo, a_hi[:1],
            tuple(CTX4.split(f)[s] for f in phis),
            tuple(CTX4.split(f)[s] for f in ucs), anti_dt)
    for g, r in zip(sum(mfx.flux_all_h(*args), ()),
                    sum(mfx.flux_all_h_plain(*args), ())):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("shape", [(8, 11, 37), (72, 9, 33)])
@pytest.mark.parametrize("open_top", [True, False])
def test_correct_divmax_island_at_tiling_edges(dev, shape, open_top):
    """4 shards of the projection epilogue against the single-grid
    kernel: the velocities and the div max bitwise equal."""
    rng = np.random.default_rng(17)
    args = _corr_operands(rng, dev, shape, open_top)
    n0 = ck.correct_divmax_h.launches
    got = sm.correct_divmax(*args, CTX4, open_top=open_top)
    assert ck.correct_divmax_h.launches == n0 + 4
    ref = ck.correct_divmax(*args, open_top=open_top)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# The resid island (launches chained): ISLAND_EDGES, and slabs of 3
# planes of a grid of many (y, z) blocks.
RESID_ISLANDS = ISLAND_EDGES + [(12, 264, 1024)]


@pytest.mark.parametrize("shape", RESID_ISLANDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resid_island_at_tiling_edges(dev, dtype, shape):
    """4 shards of the resid halo kernel, unit and with diagonal: bitwise
    equal to the single-grid kernel, four launches per island call."""
    rng = np.random.default_rng(18)
    p, w = _dot_operands(rng, dev, shape, dtype)
    b = _at(rng, dev, shape, dtype)
    d = _at(rng, dev, shape, dtype, 1.5, 2.5)
    for diag in (None, d):
        n0 = halo7.resid_scaled_7pt_h.launches
        got = sm.resid_scaled_7pt(p, w, CTX4, b, diag=diag)
        assert halo7.resid_scaled_7pt_h.launches == n0 + 4
        assert torch.equal(got, sp.resid_scaled_7pt(p, w, diag, b))


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past an
    aligned address."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _batch_shape(kind, cases, march):
    """(nx, ny, nz) of `kind`, small, or with `march` with enough cells
    that the batch reaches the 2**18 elements (cells × cases) from which
    the batch resid marches (csrc/seven_point_batch.cu kMarchFrom)."""
    nx, ny, nz = {"nz < 8": (5, 4, 3), "nz = 50": (4, 3, 50),
                  "nx = ny = 1": (1, 1, 20)}[kind]
    if not march:
        return nx, ny, nz
    cells = -(-(1 << 18) // cases)
    if kind == "nx = ny = 1":
        return 1, 1, cells
    return -(-cells // (ny * nz)), ny, nz


@pytest.mark.parametrize("march", [False, True])
@pytest.mark.parametrize("cases", [1, 3, 63, 64, 130])
@pytest.mark.parametrize("kind", ["nz < 8", "nz = 50", "nx = ny = 1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resid_batch_kernel_at_edges(dev, dtype, kind, cases, march):
    """The batch resid kernel at odd and small B, nz < 8, nz = 50 and
    nx = ny = 1, below and at the size from which it marches (two cases a
    thread where B is even and the operands aligned, else one thread per
    element), unit and with diagonal: against the plain version (the
    single-grid family's bounds), every case bitwise equal to the
    single-grid kernel on that case, and unaligned operands give the same
    bits."""
    rng = np.random.default_rng(19)
    shape4 = _batch_shape(kind, cases, march) + (cases,)
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    p, w = _dot_operands(rng, dev, shape4, dtype)
    b = _at(rng, dev, shape4, dtype)
    d = _at(rng, dev, shape4, dtype, 1.5, 2.5)
    lane = lambda t, i: None if t is None else t[..., i].contiguous()
    for diag in (None, d):
        n0 = sp.resid_scaled_7pt_nb.launches
        got = sp.resid_scaled_7pt(p, w, diag, b)
        assert sp.resid_scaled_7pt_nb.launches == n0 + 1
        assert _rel(got, sp.resid_scaled_7pt_plain(p, w, diag, b)) <= tol
        for i in range(cases):
            one = sp.resid_scaled_7pt(lane(p, i), [lane(x, i) for x in w],
                                      lane(diag, i), lane(b, i))
            assert torch.equal(got[..., i], one)
        odd = sp.resid_scaled_7pt_nb(
            _misaligned(p), [_misaligned(x) for x in w],
            None if diag is None else _misaligned(diag), _misaligned(b))
        assert torch.equal(odd, got)


# The batch apply-dot: one block per (x, y) column and 32 cases, 8 warps
# along z: nz < 8 (idle warps), nz = 50 (a ragged last chunk), one column,
# and a grid of one block.
DOT_BATCH = {"nz < 8": (5, 4, 3), "nz = 50": (4, 3, 50),
             "nx = ny = 1": (1, 1, 20), "one block": (1, 1, 9)}


def _check_batch_dot_calls(p, w, calls=2):
    """The batch apply-dot kernel `calls` times on (p, w): Â·p bitwise equal
    to the single-grid kernel on every case, the per-case dots within 1e-5
    of the plain sums and bitwise equal from call to call, every ticket
    counter 0 after each call, one launch per call."""
    _, dots_p = sp.apply_dot_7pt_plain(p, w)
    lane = lambda t, i: t[..., i].contiguous()
    one = [sp.apply_dot_7pt(lane(p, i), [lane(x, i) for x in w])[0]
           for i in range(p.shape[-1])]
    got = []
    for _ in range(calls):
        n0 = sp.apply_dot_7pt_nb.launches
        ap, dots = sp.apply_dot_7pt(p, w)
        assert sp.apply_dot_7pt_nb.launches == n0 + 1
        assert not bool(_build.ticket(p.device).any())
        assert all(torch.equal(ap[..., i], a) for i, a in enumerate(one))
        assert dots.shape == dots_p.shape and dots.dtype == torch.float32
        assert float(((dots - dots_p).abs() / dots_p.abs()).max()) <= 1e-5
        got.append(dots)
    assert all(torch.equal(d, got[0]) for d in got)
    return ap, got[0]


@pytest.mark.parametrize("cases", [1, 3, 63, 64, 130])
@pytest.mark.parametrize("kind", list(DOT_BATCH))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_dot_batch_kernel_at_edges(dev, dtype, kind, cases):
    """The batch apply-dot at odd, small and ragged B, nz < 8, nz = 50, one
    column and one block: Â·p bitwise equal to the single-grid kernel on
    each case, the dots within 1e-5 of the plain version and bitwise from
    call to call; unaligned operands give the same bits."""
    rng = np.random.default_rng(21)
    p, w = _dot_operands(rng, dev, DOT_BATCH[kind] + (cases,), dtype)
    ap, dots = _check_batch_dot_calls(p, w)
    ap2, dots2 = sp.apply_dot_7pt_nb(_misaligned(p), [_misaligned(x) for x in w])
    assert torch.equal(ap2, ap) and torch.equal(dots2, dots)


def test_apply_dot_batch_and_others_share_the_ticket(dev):
    """The ticket counters through a one-block batch grid, a many-block
    one (the sweep's 12×12×50×128: four case groups, a counter each), the
    single-grid apply-dot, a cheb2 post-dot and the one-block batch grid
    again: each result right, so every counter wraps back to 0 after
    every kernel that takes it."""
    rng = np.random.default_rng(22)
    small = _dot_operands(rng, dev, (1, 1, 9, 3))
    _check_batch_dot_calls(*small)
    _check_batch_dot_calls(*_dot_operands(rng, dev, (12, 12, 50, 128)))
    _check_dot_calls(*_dot_operands(rng, dev, (40, 9, 65)), calls=2)
    x, b = _at(rng, dev, (9, 21, 38)), _at(rng, dev, (9, 21, 38))
    _, w = _dot_operands(rng, dev, (9, 21, 38))
    z, dot = sp.cheb2_post_dot_7pt(x, b, w, 2.0, 0.1)
    z_p, dot_p = sp.cheb2_post_dot_7pt_plain(x, b, w, 2.0, 0.1)
    assert torch.equal(z, z_p)
    assert abs(float(dot) - float(dot_p)) <= 1e-5 * abs(float(dot_p))
    assert not bool(_build.ticket(dev).any())
    _check_batch_dot_calls(*small)


def test_resid_island_is_complete_for_the_next_op(dev):
    """The island's shard launches after the first are chained to the one
    before it (programmatic dependent launch). Plain PyTorch ops issued
    right after the island see every shard's values: 20 islands at the
    flagship's 112³ (four 28-plane shards) on changing right-hand sides,
    unit and with diagonal, each followed at once by a copy and a sum of
    its output, against the single-grid kernel."""
    rng = np.random.default_rng(20)
    shape = (112, 112, 112)
    p, w = _dot_operands(rng, dev, shape, torch.bfloat16)
    b0 = _at(rng, dev, shape)
    d = _at(rng, dev, shape, torch.bfloat16, 1.5, 2.5)
    for n in range(20):
        b = (b0 * (n + 1)).to(torch.bfloat16)
        diag = d if n % 2 else None
        got = sm.resid_scaled_7pt(p, w, CTX4, b, diag=diag)
        copy, total = got.clone(), got.float().sum()
        ref = sp.resid_scaled_7pt(p, w, diag, b)
        assert torch.equal(copy, ref)
        assert float(total) == float(ref.float().sum())


# Spacings at which the f32 reciprocal of the f32 spacing, 1.0f / (float)h,
# is an ulp off (float)(1.0 / h), the reciprocal PyTorch's CUDA division
# by a Python float multiplies by (the plain versions').
F1_SPACING = (0.002, 0.013, 0.004)


def test_f1_spacings_are_where_the_reciprocal_forms_differ():
    """The check below would not see the old 1.0f / h form otherwise."""
    for h in F1_SPACING:
        assert np.float32(1.0) / np.float32(h) != np.float32(1.0 / h), h


def _fct_h_args(lams, antis, cells, sp_, s):
    """fct_iter_h's arguments for shard s of CTX4."""
    ex = lambda t, **k: sm.exchange_halo(CTX4.split(t), 1, CTX4, **k)[s]
    lh = [ex(t, hi_edge="zero") for t in lams]
    ah = [ex(t, hi_edge="zero") for t in antis]
    return (tuple(CTX4.split(t)[s] for t in lams),
            (lh[0], (lh[1][0], None), (lh[2][0], None)),
            tuple(CTX4.split(t)[s] for t in antis),
            (ah[0], (ah[1][0], None), (ah[2][0], None)),
            tuple(ex(c)[0] for c in cells),
            *(CTX4.split(c)[s] for c in cells), sp_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fct_iter_bitwise_at_f1_spacings(dev, dtype):
    """fct_iter and every shard of fct_iter_h bitwise equal to their plain
    versions at spacings where the two reciprocal forms differ (λ from
    zero and from random values); the island equal to the single grid."""
    rng = np.random.default_rng(12)
    lams, antis, cells = _fct_operands(rng, dev, SHAPE, dtype)
    for start in (tuple(torch.zeros_like(l) for l in lams), lams):
        got = mf.fct_iter(start, antis, *cells, F1_SPACING)
        ref = mf.fct_iter_plain(start, antis, *cells, F1_SPACING)
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        island = sm.fct_iters(start, antis, *cells, F1_SPACING, 1, CTX4)
        assert all(torch.equal(g, r) for g, r in zip(island, got))
        for s in CTX4.held:
            args = _fct_h_args(start, antis, cells, F1_SPACING, s)
            assert all(torch.equal(g, r) for g, r in zip(
                mf.fct_iter_h(*args), mf.fct_iter_h_plain(*args)))


def test_momentum_rhs_at_f1_spacings(dev):
    """momentum_rhs and a shard of momentum_rhs_h at those spacings, to
    1e-5 of the output scale (the van Leer division is 2 ulp)."""
    rng = np.random.default_rng(13)
    vel, rp, mu, div_u = _mom_operands(rng, dev, SHAPE)
    got = mrk.momentum_rhs(*vel, rp, mu, div_u, F1_SPACING)
    ref = mrk.momentum_rhs_plain(*vel, rp, mu, div_u, F1_SPACING)
    scale = max(float(r.abs().max()) for r in ref)
    assert all(float((g - r).abs().max()) <= 1e-5 * scale
               for g, r in zip(got, ref))
    nx = SHAPE[0]
    ex = lambda t, wd, **k: sm.exchange_halo(CTX4.split(t, nx), wd, CTX4,
                                             **k)[1]
    halos = (*ex(vel[0], 2, hi_edge="zero"), *ex(vel[1], 2), *ex(vel[2], 2),
             *ex(rp[0], 1, hi_edge="zero"), ex(rp[1], 1)[0], ex(rp[2], 1)[0],
             *ex(mu, 1), ex(div_u, 1, lo_edge="zero")[0])
    args = (*(CTX4.split(t, nx)[1] for t in (*vel, *rp, mu, div_u)), halos,
            F1_SPACING)
    k_out = mrk.momentum_rhs_h(*args)
    p_out = mrk.momentum_rhs_h_plain(*args)
    scale = max(float(r.abs().max()) for r in p_out)
    assert all(float((g - r).abs().max()) <= 1e-5 * scale
               for g, r in zip(k_out, p_out))


@pytest.mark.parametrize("what", ["csf", "tiled", "forcing_0d"])
def test_finish_kernel_gates_on_the_card(dev, what, monkeypatch):
    """Steps built with OFTPP_FINISH_PALLAS=1 and use_pallas=True on the
    card: with surface tension (κ set) and in the tiled sweep (G_x, G_y
    vary along x) the finish kernel launches 0 times while the momentum
    RHS launches once a step; a forcing of three 0-d components launches
    it once a step."""
    from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                               SolverControls)
    from openfoam_tpp_tpu_torch.core.state import CaseParams, init_state
    from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
    from openfoam_tpp_tpu_torch.parallel import tiled_sweep as ts
    from openfoam_tpp_tpu_torch.parallel.sweep import batch_params
    from openfoam_tpp_tpu_torch.solver import timestep

    monkeypatch.setenv("OFTPP_FINISH_PALLAS", "1")
    controls = SolverControls(use_pallas=True)
    geom = build_tank_geometry(H=0.04, D=0.016, mesh=0.004, geo="flat")
    params = CaseParams.make(0.002, 2.5, 1.0, device=dev)
    if what == "csf":
        step = timestep.make_step(geom, PhysicalProperties(sigma=0.072),
                                  controls, device=dev)
        state = init_state(geom, device=dev)
    elif what == "tiled":
        step = ts.make_tiled_sweep_step(geom, 3, PhysicalProperties(),
                                        controls, device=dev)
        state = ts.tile_state(geom, 3, device=dev)
        params = batch_params([{"R": 0.002 + 0.001 * i, "freq": 2.5,
                                "duration": 1.0} for i in range(3)],
                              device=dev)
    else:
        core = timestep.make_step_core(
            PhysicalProperties(), controls, forcing=lambda t, p: (
                0.0 * t, 0.1 + 0.0 * t, -9.81 + 0.0 * t))
        ga = timestep.geometry_arrays(geom, device=dev)
        spacing = tuple(float(h) for h in geom.spacing)

        def step(s, p):
            return core(s, p, ga, spacing)
        state = init_state(geom, device=dev)
    mfk.momentum_finish.launches = 0
    mrk.momentum_rhs.launches = 0
    for _ in range(2):
        state, _ = step(state, params)
    torch.cuda.synchronize()
    assert mrk.momentum_rhs.launches == 2
    assert mfk.momentum_finish.launches == (2 if what == "forcing_0d" else 0)
    assert bool(torch.isfinite(state.u).all())


def _nan_cases(rng, dev):
    """name → (call, operand to poison): every kernel entry point on
    operands made outside the trap; one NaN is written into the operand
    before the call."""
    p, b, w, d, alpha, phis, ucs, lams, antis, cells = _halo_inputs(
        rng, dev, torch.float32)
    p4, b4 = (_at(rng, dev, (6, 5, 11, 8)) for _ in range(2))
    w4 = [_at(rng, dev, (6, 5, 11, 8), lo=0.05, hi=0.3) for _ in range(3)]
    vel, rp, mu, div_u = _mom_operands(rng, dev, SHAPE)
    corr = _corr_operands(rng, dev, SHAPE, True)
    vc = _faces(rng, dev, SHAPE, -50, 50)
    vc = (vc[0][:-1].contiguous(), vc[1], vc[2])
    ro, rn = _arr(rng, dev, lo=1, hi=998), _arr(rng, dev, lo=1, hi=998)
    aps = corr[5:8]
    dt, G = torch.tensor(2.9e-3, device=dev), torch.tensor(
        [0.31, -0.12, -9.81], device=dev)
    h, sp_ = (0.011, 0.009, 0.013), (0.004, 0.004, 0.0035)
    s = 1
    sl = lambda ts: tuple(CTX4.split(t)[s] for t in ts)
    lo, hi = sm.exchange_halo(CTX4.split(p), 1, CTX4)[s]
    wx_hi = sm.exchange_hi(CTX4.split(w[0]), 1, CTX4)[s]
    p_s, b_s, w_s = sl((p,))[0], sl((b,))[0], sl(w)
    a_lo, a_hi = sm.exchange_halo(CTX4.split(alpha), 2, CTX4)[s]
    ex = lambda t, **k: sm.exchange_halo(CTX4.split(t), 1, CTX4, **k)[s]
    lh = [ex(t, hi_edge="zero") for t in lams]
    ah = [ex(t, hi_edge="zero") for t in antis]
    fct_h = (sl(lams), (lh[0], (lh[1][0], None), (lh[2][0], None)),
             sl(antis), (ah[0], (ah[1][0], None), (ah[2][0], None)),
             tuple(ex(c)[0] for c in cells), *sl(cells), sp_)
    nx = SHAPE[0]
    exh = lambda t, wd, **k: sm.exchange_halo(CTX4.split(t, nx), wd, CTX4,
                                              **k)[2]
    halos = (*exh(vel[0], 2, hi_edge="zero"), *exh(vel[1], 2),
             *exh(vel[2], 2), *exh(rp[0], 1, hi_edge="zero"),
             exh(rp[1], 1)[0], exh(rp[2], 1)[0], *exh(mu, 1),
             exh(div_u, 1, lo_edge="zero")[0])
    part = lambda t: CTX4.split(t, nx)[2]
    mom_h = (*(part(t) for t in (*vel, *rp, mu, div_u)), halos, h)
    dp = corr[0]
    dlo, dhi = sm.exchange_halo(CTX4.split(dp), 1, CTX4)[2]
    hi3 = [sm.exchange_hi(CTX4.split(t, nx), 1, CTX4)[2]
           for t in (corr[1], corr[4][0], corr[5])]
    corr_h = (part(dp), dlo, dhi, part(corr[1]), hi3[0], part(corr[2]),
              part(corr[3]), part(corr[4][0]), hi3[1], part(corr[4][1]),
              part(corr[4][2]), part(corr[5]), hi3[2], part(corr[6]),
              part(corr[7]), part(corr[8]), part(corr[9]), part(corr[10]),
              corr[11], corr[12])
    return {
        "apply_7pt": (lambda: sp.apply_7pt(p, w), p),
        "resid_scaled_7pt": (lambda: sp.resid_scaled_7pt(p, w, d, b), p),
        "apply_dot_7pt": (lambda: sp.apply_dot_7pt(p, w), p),
        "apply_7pt_nb": (lambda: sp.apply_7pt_nb(p4, w4), p4),
        "resid_scaled_7pt_nb": (lambda: sp.resid_scaled_7pt_nb(p4, w4, None,
                                                               b4), p4),
        "apply_dot_7pt_nb": (lambda: sp.apply_dot_7pt_nb(p4, w4), p4),
        "cheb2_pre_7pt": (lambda: sp.cheb2_pre_7pt(b, w, 2.0, 0.1), b),
        "cheb2_post_7pt": (lambda: sp.cheb2_post_7pt(p, b, w, 2.0, 0.1), p),
        "cheb2_post_dot_7pt": (lambda: sp.cheb2_post_dot_7pt(p, b, w, 2.0,
                                                             0.1), p),
        "flux_all": (lambda: mfx.flux_all(alpha, phis, ucs), alpha),
        "fct_iter": (lambda: mf.fct_iter(lams, antis, *cells, sp_), lams[0]),
        "momentum_rhs": (lambda: mrk.momentum_rhs(*vel, rp, mu, div_u, h),
                         vel[0]),
        "correct_divmax": (lambda: ck.correct_divmax(*corr), dp),
        "momentum_finish": (lambda: mfk.momentum_finish(
            *vel, vc, ro, rn, *aps, dt, G), vel[0]),
        "apply_7pt_h": (lambda: halo7.apply_7pt_h(p_s, lo, hi, wx_hi, w_s),
                        p_s),
        "resid_scaled_7pt_h": (lambda: halo7.resid_scaled_7pt_h(
            p_s, lo, hi, wx_hi, w_s, b_s), p_s),
        "apply_dot_7pt_h": (lambda: halo7.apply_dot_7pt_h(
            p_s, lo, hi, wx_hi, w_s), p_s),
        "flux_all_h": (lambda: mfx.flux_all_h(sl((alpha,))[0], a_lo,
                                              a_hi[:1], sl(phis), sl(ucs)),
                       a_lo),
        "fct_iter_h": (lambda: mf.fct_iter_h(*fct_h), fct_h[0][0]),
        "momentum_rhs_h": (lambda: mrk.momentum_rhs_h(*mom_h), mom_h[0]),
        "correct_divmax_h": (lambda: ck.correct_divmax_h(*corr_h), corr_h[0]),
    }


# The FCT limiter's clip01 is fminf(fmaxf(v, 0), 1): CUDA's fminf/fmaxf
# return the other operand for a NaN, so a NaN λ leaves the kernel as 0
# and its neighbours' limiters as if the face were closed. Its plain
# version (torch.clamp) keeps the NaN.
SWALLOWS_NAN = ("fct_iter", "fct_iter_h")


@pytest.mark.parametrize("name", [
    "apply_7pt", "resid_scaled_7pt", "apply_dot_7pt", "apply_7pt_nb",
    "resid_scaled_7pt_nb", "apply_dot_7pt_nb", "cheb2_pre_7pt",
    "cheb2_post_7pt", "cheb2_post_dot_7pt", "flux_all", "fct_iter",
    "momentum_rhs", "correct_divmax", "momentum_finish", "apply_7pt_h",
    "resid_scaled_7pt_h", "apply_dot_7pt_h", "flux_all_h", "fct_iter_h",
    "momentum_rhs_h", "correct_divmax_h"])
def test_nan_trap_hook_sees_each_kernel(dev, name):
    """Under the NaN trap (OFTPP_DEBUG_NANS=1) a NaN operand of each
    kernel entry point raises FloatingPointError from the kernel hook
    (`_build.check`), naming the entry point and this file's line. The
    FCT limiter maps the NaN to a finite λ (SWALLOWS_NAN): the hook looks
    at its outputs, finds none, and they are finite."""
    from openfoam_tpp_tpu_torch.utils import nan_trap

    call, operand = _nan_cases(np.random.default_rng(12), dev)[name]
    flat = operand.view(-1)
    flat[flat.numel() // 2] = float("nan")
    if name in SWALLOWS_NAN:
        with nan_trap.trap_nans(True) as trap:
            out = call()
        assert trap.checked >= len(out)
        assert all(bool(torch.isfinite(t).all()) for t in out)
        return
    trap = None
    with pytest.raises(FloatingPointError,
                       match=rf"CUDA kernel {name} .* at tests/"
                             r"test_torch_cuda\.py:\d+, step 0"):
        with nan_trap.trap_nans(True) as trap:
            call()
    assert trap.checked >= 1 and _build.nan_hook is None
