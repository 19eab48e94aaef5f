"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: without a CUDA device every test here skips (decided in a
fixture, at run time). On a machine with one, run

    python -m pytest tests/test_torch_cuda.py -m gpu

Small shapes with all three extents distinct. Tolerances: f32 outputs
are held bitwise-close (1e-6 relative; the kernels are built without
FMA contraction and use the plain versions' operation order), bf16
outputs to one bf16 ulp, the apply-dot scalar to 1e-5 relative (its sum
runs in another order than torch.sum)."""

import numpy as np
import pytest
import torch

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
