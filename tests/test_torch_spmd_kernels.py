"""The x-sharded step's halo kernels and islands (openfoam_tpp_tpu_torch/
parallel/spmd.py and the `*_h` entry points), on the CPU.

(a) `exchange_halo` / `exchange_hi`: true neighbour planes inside, clamp
    or zero planes at the global ends (tests/test_spmd_kernels.py's
    check, on the port's in-process shards);
(b) each halo entry point's plain version against the JAX halo kernel
    called directly on one shard in interpret mode, for the first, an
    interior and the last of 4 shards, with the same halo planes;
(c) each island against the port's single-grid entry point on the global
    arrays: elementwise outputs bitwise (the halo content reproduces the
    single-grid edge rules on inputs with zero wall faces), the summed
    dot to 1e-6 relative (another order), the div max exactly.

Shapes: the JAX spmd test's 32×12×16 in 4 shards (local nx 8, a multiple
of every Pallas slab). Tolerances of (b): those of the single-grid rows
(tests/test_torch_kernels.py, tests/test_torch_kernels_momentum.py): f32
to a few ulps of the output scale, one bf16 ulp where both round once
from f32, four bf16 ulps for the bf16 7-point family (the Pallas body
rounds after every operation), the momentum RHS to 1e-5 of its scale,
the corrected velocities to 1e-6 and the div max to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.ops.pallas import correction as jck
from openfoam_tpp_tpu.ops.pallas import halo7 as jh7
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu.ops.pallas import mules_fct as jfct
from openfoam_tpp_tpu.ops.pallas import mules_flux as jflux
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import halo7 as th7
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as tfct
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as tflux
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as t7
from openfoam_tpp_tpu_torch.parallel import spmd as tsm

N_SHARDS = 4
NX, NY, NZ = 32, 12, 16
SHAPE = (NX, NY, NZ)
SHARDS = (0, 1, N_SHARDS - 1)     # first, interior, last
SPACING = (0.002, 0.0021, 0.0019)
F32_RTOL = 2e-6
BF16_RTOL = 2.0 ** -8
BF16_STENCIL_RTOL = 2.0 ** -6
CTX = tsm.SpmdCtx(N_SHARDS)
_DT = {"f32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _j(t, jdt=jnp.float32):
    """A torch tensor (any of the port's dtypes) as a JAX array."""
    return None if t is None else jnp.asarray(t.float().numpy(), jdt)


def _close(got_t, ref_j, rtol):
    got = got_t.float().numpy()
    ref = np.asarray(jnp.asarray(ref_j, jnp.float32))
    assert got.shape == ref.shape
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (err, rtol * scale)


def _rng(seed):
    return np.random.default_rng(seed)


def _seven_point_inputs(tdt):
    rng = _rng(31)
    f = lambda lo=None, hi=None: _t(
        (rng.standard_normal(SHAPE) if lo is None
         else rng.uniform(lo, hi, SHAPE)).astype(np.float32), tdt)
    p, b, diag = f(), f(), f(1.5, 2.5)
    w = [f(0.05, 0.3) for _ in range(3)]
    w[0][0], w[1][:, 0], w[2][:, :, 0] = 0, 0, 0
    return p, b, diag, tuple(w)


def _flux_inputs(tdt):
    rng = _rng(32)
    alpha = _t(np.clip(rng.uniform(-0.3, 1.3, SHAPE), 0, 1).astype(np.float32))
    phis = tuple(_t(1e-3 * rng.standard_normal(SHAPE).astype(np.float32))
                 for _ in range(3))
    ucs = tuple(_t(1e-3 * rng.standard_normal(SHAPE).astype(np.float32), tdt)
                for _ in range(3))
    return alpha, phis, ucs


def _fct_inputs(tdt):
    rng = _rng(33)
    lams = tuple(_t(rng.uniform(0, 1, SHAPE).astype(np.float32), tdt)
                 for _ in range(3))
    antis = tuple(_t(1e-3 * rng.standard_normal(SHAPE).astype(np.float32), tdt)
                  for _ in range(3))
    al = rng.uniform(0, 1, SHAPE).astype(np.float32)
    amax = np.minimum(al + rng.uniform(0, 0.2, SHAPE), 1).astype(np.float32)
    amin = np.maximum(al - rng.uniform(0, 0.2, SHAPE), 0).astype(np.float32)
    dt_iv = rng.uniform(1e-4, 2e-4, SHAPE).astype(np.float32)
    # Zero antidiffusive boundary faces, as the step gives the limiter.
    for a in antis:
        a[0] = 0
    antis[1][:, 0] = 0
    antis[2][:, :, 0] = 0
    return lams, antis, tuple(_t(c) for c in (al, amax, amin, dt_iv))


def _faces(rng, lo=-1.0, hi=1.0):
    return [rng.uniform(lo, hi, s).astype(np.float32)
            for s in ((NX + 1, NY, NZ), (NX, NY + 1, NZ), (NX, NY, NZ + 1))]


def _mom_inputs():
    """Physical inputs: wall velocity and wall mass-flux faces are zero."""
    rng = _rng(34)
    vel, rp = _faces(rng), _faces(rng)
    for f in (vel, rp):
        f[0][0] = f[0][-1] = 0
        f[1][:, 0] = f[1][:, -1] = 0
        f[2][:, :, 0] = 0
    mu = rng.uniform(1e-5, 2e-3, SHAPE).astype(np.float32)
    div_u = (0.1 * rng.uniform(-1, 1, SHAPE)).astype(np.float32)
    return tuple(map(_t, vel)), tuple(map(_t, rp)), _t(mu), _t(div_u)


def _corr_inputs():
    rng = _rng(35)
    dp = rng.uniform(-50, 50, SHAPE).astype(np.float32)
    vel, beta, aps = _faces(rng), _faces(rng, 8e-4, 1e-3), _faces(rng, 0, 1)
    for f in (vel, aps):
        f[0][0] = f[0][-1] = 0
        f[1][:, 0] = f[1][:, -1] = 0
        f[2][:, :, 0] = 0
    for a in aps:
        a[a < 0.2] = 0
    topo = (rng.uniform(0, 1, (NX, NY)) > 0.3).astype(np.float32)
    vfrac = rng.uniform(0, 1, SHAPE).astype(np.float32)
    vfrac[vfrac < 0.1] = 0
    rho = rng.uniform(1, 998, SHAPE).astype(np.float32)
    return (_t(dp), tuple(map(_t, vel)), tuple(map(_t, beta)),
            tuple(map(_t, aps)), _t(vfrac), _t(topo), _t(rho),
            torch.tensor(3.7e-3))


# --------------------------------------------------------------------- (a)

def test_exchange_halo_neighbors_and_edges():
    a = torch.arange(NX * NY * NZ, dtype=torch.float32).reshape(SHAPE)
    slabs = CTX.split(a)
    nxl = NX // N_SHARDS
    clamp = tsm.exchange_halo(slabs, 2, CTX)
    zero = tsm.exchange_halo(slabs, 2, CTX, lo_edge="zero", hi_edge="zero")
    hi1 = tsm.exchange_hi(slabs, 1, CTX)
    for s in range(N_SHARDS):
        (lo, hi), (lo_z, hi_z) = clamp[s], zero[s]
        if s == 0:
            assert torch.equal(lo, a[:1].expand(2, NY, NZ))
            assert torch.equal(lo_z, torch.zeros(2, NY, NZ))
        else:
            assert torch.equal(lo, a[s * nxl - 2:s * nxl]) and torch.equal(
                lo_z, lo)
            # Interior halos are views of the neighbour slab: no copy.
            assert lo.data_ptr() == a[s * nxl - 2].data_ptr()
        if s == N_SHARDS - 1:
            assert torch.equal(hi, a[-1:].expand(2, NY, NZ))
            assert torch.equal(hi_z, torch.zeros(2, NY, NZ))
            assert torch.equal(hi1[s], torch.zeros(1, NY, NZ))
        else:
            want = a[(s + 1) * nxl:(s + 1) * nxl + 2]
            assert torch.equal(hi, want) and torch.equal(hi_z, want)
            assert torch.equal(hi1[s], want[:1])
        assert all(h.is_contiguous() for h in (lo, hi, lo_z, hi_z, hi1[s]))
    # One shard: edge fills only (the JAX n == 1 branch).
    one = tsm.SpmdCtx(1)
    (lo, hi), = tsm.exchange_halo(one.split(a), 1, one, hi_edge="zero")
    assert torch.equal(lo, a[:1]) and torch.equal(hi, torch.zeros(1, NY, NZ))


def test_spmd_ctx_guards():
    assert CTX.local_shape(SHAPE) == (NX // N_SHARDS, NY, NZ)
    assert CTX.supports(SHAPE) and not CTX.supports((NX + 1, NY, NZ))
    with pytest.raises(ValueError, match="does not divide"):
        CTX.local_shape((NX + 1, NY, NZ))
    # A slab must hold the widest halo, 2 planes.
    assert not tsm.SpmdCtx(NX).supports(SHAPE)
    with pytest.raises(ValueError, match="at least 2"):
        tsm.SpmdCtx(NX).local_shape(SHAPE)
    with pytest.raises(ValueError):
        tsm.SpmdCtx(2, axis="y")
    with pytest.raises(ValueError):
        tsm.SpmdCtx(0)


# --------------------------------------------------------------------- (b)

def _shard(ctx_args, s):
    """Slab s of each tensor (None stays None)."""
    return tuple(None if t is None else CTX.split(t)[s] for t in ctx_args)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_seven_point_halo_matches_pallas(dt, s):
    jdt, tdt = _DT[dt]
    rtol = F32_RTOL if dt == "f32" else BF16_STENCIL_RTOL
    p, b, diag, w = _seven_point_inputs(tdt)
    ps, ws = CTX.split(p), [CTX.split(x) for x in w]
    lo, hi = tsm.exchange_halo(ps, 1, CTX)[s]
    wx_hi = tsm.exchange_hi(ws[0], 1, CTX)[s]
    p_s, b_s, d_s = _shard((p, b, diag), s)
    w_s = tuple(x[s] for x in ws)
    hj = tuple(_j(h, jdt) for h in (lo, hi, wx_hi))
    wj = tuple(_j(x, jdt) for x in w_s)
    for d in (None, d_s):
        _close(th7.apply_7pt_h(p_s, lo, hi, wx_hi, w_s, diag=d),
               jh7.apply_7pt_h(_j(p_s, jdt), *hj, wj, diag=_j(d, jdt),
                               interpret=True), rtol)
        _close(th7.resid_scaled_7pt_h(p_s, lo, hi, wx_hi, w_s, b_s, diag=d),
               jh7.resid_scaled_7pt_h(_j(p_s, jdt), *hj, wj, _j(b_s, jdt),
                                      diag=_j(d, jdt), interpret=True), rtol)
    if dt == "f32":   # the CG curvature step runs in f32 only
        ap_t, dot_t = th7.apply_dot_7pt_h(p_s, lo, hi, wx_hi, w_s)
        ap_j, dot_j = jh7.apply_dot_7pt_h(_j(p_s), *hj, wj, interpret=True)
        _close(ap_t, ap_j, rtol)
        assert abs(float(dot_t) - float(dot_j)) <= 1e-5 * abs(float(dot_j))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flux_all_halo_matches_pallas(dt, s):
    """`dt`: the compression-flux input and the anti outputs, as the step
    feeds them (both bf16 with fct_bf16)."""
    jdt, tdt = _DT[dt]
    alpha, phis, ucs = _flux_inputs(tdt)
    lo, hi = tsm.exchange_halo(CTX.split(alpha), 2, CTX)[s]
    a_s, = _shard((alpha,), s)
    ph_s, uc_s = _shard(phis, s), _shard(ucs, s)
    anti = tdt if dt == "bf16" else None
    lows_t, antis_t = tflux.flux_all_h(a_s, lo, hi[:1], ph_s, uc_s,
                                       anti_dtype=anti)
    lows_j, antis_j = jflux.flux_all_h(
        _j(a_s), _j(lo), _j(hi[:1]), tuple(map(_j, ph_s)),
        tuple(_j(u, jdt) for u in uc_s),
        anti_dtype=jdt if dt == "bf16" else None, interpret=True)
    for ax in range(3):
        assert antis_t[ax].dtype == tdt
        _close(lows_t[ax], lows_j[ax], F32_RTOL)
        _close(antis_t[ax], antis_j[ax], F32_RTOL if dt == "f32" else BF16_RTOL)


def _fct_halos(lams, antis, cells, s):
    lh = [tsm.exchange_halo(CTX.split(x), 1, CTX, hi_edge="zero")[s]
          for x in lams]
    ah = [tsm.exchange_halo(CTX.split(x), 1, CTX, hi_edge="zero")[s]
          for x in antis]
    cl = [tsm.exchange_halo(CTX.split(c), 1, CTX)[s][0] for c in cells]
    lam_h = (lh[0], (lh[1][0], None), (lh[2][0], None))
    anti_h = (ah[0], (ah[1][0], None), (ah[2][0], None))
    return lam_h, anti_h, tuple(cl)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fct_iter_halo_matches_pallas(dt, s):
    jdt, tdt = _DT[dt]
    lams, antis, cells = _fct_inputs(tdt)
    lam_h, anti_h, cell_lo = _fct_halos(lams, antis, cells, s)
    l_s, a_s, c_s = _shard(lams, s), _shard(antis, s), _shard(cells, s)
    got = tfct.fct_iter_h(l_s, lam_h, a_s, anti_h, cell_lo, *c_s, SPACING)
    jh = lambda hs: tuple((_j(a, jdt), _j(b, jdt)) for a, b in hs)
    want = jfct.fct_iter_h(
        tuple(_j(x, jdt) for x in l_s), jh(lam_h),
        tuple(_j(x, jdt) for x in a_s), jh(anti_h), tuple(map(_j, cell_lo)),
        *map(_j, c_s), SPACING, interpret=True)
    for ax in range(3):
        assert got[ax].dtype == tdt
        _close(got[ax], want[ax], F32_RTOL if dt == "f32" else BF16_RTOL)


def _mom_halos(vel, rp, mu, div_u, s):
    nx = NX
    ex = lambda t, w, **k: tsm.exchange_halo(CTX.split(t, nx), w, CTX,
                                             **k)[s]
    u, v, w = vel
    rpx, rpy, rpz = rp
    return (*ex(u, 2, hi_edge="zero"), *ex(v, 2), *ex(w, 2),
            *ex(rpx, 1, hi_edge="zero"), ex(rpy, 1)[0], ex(rpz, 1)[0],
            *ex(mu, 1), ex(div_u, 1, lo_edge="zero")[0])


@pytest.mark.parametrize("s", SHARDS)
def test_momentum_rhs_halo_matches_pallas(s):
    vel, rp, mu, div_u = _mom_inputs()
    halos = _mom_halos(vel, rp, mu, div_u, s)
    split = lambda t: CTX.split(t, NX)[s]
    args = (split(vel[0]), *_shard(vel[1:], s), split(rp[0]),
            *_shard(rp[1:], s), *_shard((mu, div_u), s))
    got = tmrk.momentum_rhs_h(*args, halos, SPACING, dev2=True)
    want = jmrk.momentum_rhs_h(*map(_j, args), tuple(map(_j, halos)),
                               SPACING, dev2=True, interpret=True)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in want)
    for g, r in zip(got, want):
        assert tuple(g.shape) == r.shape
        assert float(np.abs(g.numpy() - np.asarray(r)).max()) <= 1e-5 * scale


@pytest.mark.parametrize("s", SHARDS)
def test_correct_divmax_halo_matches_pallas(s):
    dp, vel, beta, aps, vfrac, topo, rho, dt = _corr_inputs()
    split = lambda t: CTX.split(t, NX)[s]
    dlo, dhi = tsm.exchange_halo(CTX.split(dp), 1, CTX)[s]
    his = [tsm.exchange_hi(CTX.split(t, NX), 1, CTX)[s]
           for t in (vel[0], beta[0], aps[0])]
    args = (dp.split(NX // N_SHARDS)[s], dlo, dhi, split(vel[0]), his[0],
            *_shard(vel[1:], s), split(beta[0]), his[1], *_shard(beta[1:], s),
            split(aps[0]), his[2], *_shard(aps[1:], s),
            *_shard((vfrac, topo), s))
    rho_s, = _shard((rho,), s)
    got = tck.correct_divmax_h(*args, rho_s, dt, SPACING)
    want = jck.correct_divmax_h(*map(_j, args), _j(rho_s[:, :, -1]), _j(dt),
                                SPACING, interpret=True)
    for g, r in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)


# --------------------------------------------------------------------- (c)

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_seven_point_islands_equal_single_grid(dt):
    _, tdt = _DT[dt]
    p, b, diag, w = _seven_point_inputs(tdt)
    for d in (None, diag):
        assert torch.equal(tsm.apply_7pt(p, w, CTX, diag=d),
                           t7.apply_7pt(p, w, d))
        assert torch.equal(tsm.resid_scaled_7pt(p, w, CTX, b, diag=d),
                           t7.resid_scaled_7pt(p, w, d, b))
    ap, dot = tsm.apply_dot_7pt(p, w, CTX)
    ap1, dot1 = t7.apply_dot_7pt(p, w)
    assert torch.equal(ap, ap1)
    assert abs(float(dot) - float(dot1)) <= 1e-6 * abs(float(dot1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mules_islands_equal_single_grid(dt):
    _, tdt = _DT[dt]
    alpha, phis, ucs = _flux_inputs(tdt)
    anti = tdt if dt == "bf16" else None
    got = tsm.flux_all(alpha, phis, ucs, CTX, anti_dtype=anti)
    want = tflux.flux_all(alpha, phis, ucs, anti_dtype=anti)
    for g, r in zip(got[0] + got[1], want[0] + want[1]):
        assert g.dtype == r.dtype and torch.equal(g, r)
    lams, antis, cells = _fct_inputs(tdt)
    got = tsm.fct_iters(lams, antis, *cells, SPACING, 3, CTX)
    want = lams
    for _ in range(3):
        want = tfct.fct_iter(want, antis, *cells, SPACING)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and torch.equal(g, r)


@pytest.mark.parametrize("dev2", [True, False])
def test_momentum_island_equals_single_grid(dev2):
    vel, rp, mu, div_u = _mom_inputs()
    got = tsm.momentum_rhs(*vel, rp, mu, div_u, SPACING, CTX, dev2=dev2)
    want = tmrk.momentum_rhs(*vel, rp, mu, div_u, SPACING, dev2=dev2)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.parametrize("open_top", [True, False])
def test_correction_island_equals_single_grid(open_top):
    dp, vel, beta, aps, vfrac, topo, rho, dt = _corr_inputs()
    args = (dp, *vel, beta, *aps, vfrac, topo, rho, dt, SPACING)
    got = tsm.correct_divmax(*args[:-1], SPACING, CTX, open_top=open_top)
    want = tck.correct_divmax(*args, open_top=open_top)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


def test_islands_launch_nothing_on_the_cpu():
    """CPU tensors take the plain versions: no launch is counted."""
    fns = (th7.apply_7pt_h, th7.resid_scaled_7pt_h, th7.apply_dot_7pt_h,
           tflux.flux_all_h, tfct.fct_iter_h, tmrk.momentum_rhs_h,
           tck.correct_divmax_h)
    before = [f.launches for f in fns]
    p, b, _, w = _seven_point_inputs(torch.float32)
    tsm.apply_dot_7pt(p, w, CTX)
    assert [f.launches for f in fns] == before
    m = torch.empty((8, NY, NZ), device="meta")
    plane = torch.empty((1, NY, NZ), device="meta")
    with pytest.raises(ValueError):
        th7.apply_7pt_h(m, plane, plane, plane, (m, m, m))
