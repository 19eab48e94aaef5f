"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, at run time). On a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m gpu

Small shapes with all three extents distinct. Tolerances: f32 outputs
are held bitwise-close (1e-6 relative; the kernels are built without
FMA contraction and use the plain versions' operation order), bf16
outputs to one bf16 ulp, the apply-dot scalar to 1e-5 relative (its sum
runs in another order than torch.sum); the momentum right-hand side to
1e-5 of its scale."""

import numpy as np
import pytest
import torch

from openfoam_tpp_tpu_torch.ops.kernels import correction as ck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as mfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as mrk
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as mf
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as mfx
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as sp

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


@pytest.mark.parametrize("open_top", [True, False])
def test_correct_divmax_kernel_matches_plain(dev, open_top):
    rng = np.random.default_rng(3)
    dp = _arr(rng, dev, lo=-50, hi=50)
    vel = _faces(rng, dev, SHAPE)
    beta = _faces(rng, dev, SHAPE, 8e-4, 1e-3)
    aps = _faces(rng, dev, SHAPE, 0.0, 1.0)
    for a in aps:
        a[a < 0.2] = 0
    _walls(aps, open_top)
    vfrac = _arr(rng, dev, lo=0, hi=1)
    vfrac[vfrac < 0.1] = 0
    topo = (_arr(rng, dev, lo=0, hi=1)[:, :, 0] > 0.3).float().contiguous()
    rho = _arr(rng, dev, lo=1, hi=998)
    dt = torch.tensor(3.7e-3, device=dev)
    args = (dp, *vel, beta, *aps, vfrac, topo, rho, dt, (0.011, 0.009, 0.013))
    got = ck.correct_divmax(*args, open_top=open_top)
    ref = ck.correct_divmax_plain(*args, open_top=open_top)
    for g, r in zip(got[:3], ref[:3]):
        assert _rel(g, r) <= 1e-6
    assert abs(float(got[3]) - float(ref[3])) <= 1e-6 * float(ref[3])


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
