"""Port kernel modules (openfoam_tpp_tpu_torch/ops/kernels/) against the
JAX Pallas kernels they replace, on the CPU.

The same seeded numpy inputs go through the JAX Pallas function in
interpret mode and through the port's entry point on CPU tensors, which
runs the kernel's plain PyTorch version (the CUDA kernel itself runs only
on the card: chip_smoke.py and tests/test_torch_cuda.py hold it against
this plain version there).

Tolerances: both sides compute every output in f32 with the same
products and add order, so f32 outputs agree to a few ulp (XLA's CPU
backend may contract a multiply-add that PyTorch evaluates in two
roundings); bf16 outputs are rounded once from those f32 values and agree
to one bf16 ulp (2^-8 relative). The exception is the bf16 7-point
family: the Pallas kernel's jnp arithmetic on bf16 blocks rounds after
each of its ~12 operations, where the port rounds once from f32, so the
two sit a few bf16 ulps apart (BF16_STENCIL_RTOL)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.ops.pallas import mules_fct as jfct
from openfoam_tpp_tpu.ops.pallas import mules_flux as jflux
from openfoam_tpp_tpu.ops.pallas import seven_point as j7
from openfoam_tpp_tpu_torch.ops.kernels import mules_fct as tfct
from openfoam_tpp_tpu_torch.ops.kernels import mules_flux as tflux
from openfoam_tpp_tpu_torch.ops.kernels import seven_point as t7

SHAPE = (12, 10, 9)          # nx a multiple of 4 (the TPU kernels' slab);
                             # all three extents distinct
F32_RTOL = 2e-6              # a few f32 ulp
BF16_RTOL = 2.0 ** -8        # one bf16 ulp
BF16_STENCIL_RTOL = 2.0 ** -6  # four bf16 ulps of the largest output

_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(got_t, ref_j, rtol):
    got = got_t.float().numpy()
    ref = np.asarray(jnp.asarray(ref_j, jnp.float32))
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * scale, (err, rtol * scale)


def _weights(rng):
    """Positive face-lite weights with the boundary-face invariant: the
    low faces of the first plane along each axis are walls (zero)."""
    w = [rng.uniform(0.05, 0.3, SHAPE).astype(np.float32) for _ in range(3)]
    w[0][0] = 0.0
    w[1][:, 0] = 0.0
    w[2][:, :, 0] = 0.0
    return w


def _pair(a, dt):
    jdt, tdt = _DT[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(np.ascontiguousarray(a)).to(tdt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("with_diag", [False, True])
def test_seven_point_family_matches_pallas(dt, with_diag):
    rng = np.random.default_rng(7)
    rtol = F32_RTOL if dt == "f32" else BF16_STENCIL_RTOL
    p_j, p_t = _pair(rng.standard_normal(SHAPE).astype(np.float32), dt)
    b_j, b_t = _pair(rng.standard_normal(SHAPE).astype(np.float32), dt)
    ws = [_pair(w, dt) for w in _weights(rng)]
    split_j = tuple(w[0] for w in ws)
    split_t = tuple(w[1] for w in ws)
    diag_j = diag_t = None
    if with_diag:
        diag_j, diag_t = _pair(rng.uniform(1.5, 2.5, SHAPE).astype(np.float32), dt)

    _close(t7.apply_7pt(p_t, split_t, diag_t),
           j7.apply_7pt(p_j, split_j, diag_j, interpret=True), rtol)
    _close(t7.resid_scaled_7pt(p_t, split_t, diag_t, b_t),
           j7.resid_scaled_7pt(p_j, split_j, diag_j, b_j, interpret=True), rtol)
    if not with_diag:
        ap_t, dot_t = t7.apply_dot_7pt(p_t, split_t)
        ap_j, dot_j = j7.apply_dot_7pt(p_j, split_j, interpret=True)
        _close(ap_t, ap_j, rtol)
        # f32 sums in another order: relative 1e-5 on a sum of ~1e3 terms.
        assert abs(float(dot_t) - float(dot_j)) <= 1e-5 * abs(float(dot_j))


def test_split_weights_matches_pallas():
    rng = np.random.default_rng(3)
    nx, ny, nz = SHAPE
    faces = [rng.standard_normal(s).astype(np.float32)
             for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    got = t7.split_weights(*(torch.from_numpy(f) for f in faces))
    ref = j7.split_weights(*(jnp.asarray(f) for f in faces))
    for g, r in zip(got, ref):
        assert g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _flux_inputs(rng):
    alpha = np.clip(rng.uniform(-0.3, 1.3, SHAPE), 0, 1).astype(np.float32)
    phis = [rng.standard_normal(SHAPE).astype(np.float32) * 1e-3 for _ in range(3)]
    ucs = [rng.standard_normal(SHAPE).astype(np.float32) * 1e-3 for _ in range(3)]
    return alpha, phis, ucs


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flux_all_matches_pallas(dt):
    """`dt` is the type of the compression-flux input and of the anti
    outputs, as mules.advect_alpha uses them (both bf16 with fct_bf16)."""
    rng = np.random.default_rng(11)
    alpha, phis, ucs = _flux_inputs(rng)
    jdt, tdt = _DT[dt]
    lows_j, antis_j = jflux.flux_all(
        jnp.asarray(alpha), tuple(jnp.asarray(f) for f in phis),
        tuple(jnp.asarray(u, jdt) for u in ucs),
        anti_dtype=jdt if dt == "bf16" else None, interpret=True)
    lows_t, antis_t = tflux.flux_all(
        torch.from_numpy(alpha), tuple(torch.from_numpy(f) for f in phis),
        tuple(torch.from_numpy(u).to(tdt) for u in ucs),
        anti_dtype=tdt if dt == "bf16" else None)
    for ax in range(3):
        assert antis_t[ax].dtype == tdt and lows_t[ax].dtype == torch.float32
        _close(lows_t[ax], lows_j[ax], F32_RTOL)
        _close(antis_t[ax], antis_j[ax], F32_RTOL if dt == "f32" else BF16_RTOL)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fct_iter_matches_pallas(dt):
    """Random λ/anti (no zero boundary faces): this also pins the clamped
    halo cell below the first x plane, which feeds λ of the x = 0 face."""
    rng = np.random.default_rng(5)
    jdt, tdt = _DT[dt]
    lams = [rng.uniform(0, 1, SHAPE).astype(np.float32) for _ in range(3)]
    antis = [rng.standard_normal(SHAPE).astype(np.float32) * 1e-3 for _ in range(3)]
    al = rng.uniform(0, 1, SHAPE).astype(np.float32)
    amax = np.minimum(al + rng.uniform(0, 0.2, SHAPE), 1).astype(np.float32)
    amin = np.maximum(al - rng.uniform(0, 0.2, SHAPE), 0).astype(np.float32)
    dt_iv = rng.uniform(1e-4, 2e-4, SHAPE).astype(np.float32)
    spacing = (0.004, 0.004, 0.0035)
    cells = (al, amax, amin, dt_iv)
    lam_t = tuple(torch.from_numpy(l).to(tdt) for l in lams)
    ant_t = tuple(torch.from_numpy(a).to(tdt) for a in antis)
    lam_j = tuple(jnp.asarray(l, jdt) for l in lams)
    ant_j = tuple(jnp.asarray(a, jdt) for a in antis)
    for _ in range(2):   # two chained iterations
        lam_j = jfct.fct_iter(lam_j, ant_j, *(jnp.asarray(c) for c in cells),
                              spacing, interpret=True)
        lam_t = tfct.fct_iter(lam_t, ant_t, *(torch.from_numpy(c) for c in cells),
                              spacing)
    for ax in range(3):
        assert lam_t[ax].dtype == tdt
        _close(lam_t[ax], lam_j[ax], F32_RTOL if dt == "f32" else BF16_RTOL)


# One NaN operand of the limiter, in a cell away from every edge: λ of an
# x face, anti of a y face, or alpha_low of a cell.
NAN_AT = {"lambda x": ("lam", 0), "anti y": ("anti", 1), "alpha_low": ("cell", 0)}


@pytest.mark.parametrize("where", list(NAN_AT))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fct_iter_keeps_a_nan_as_pallas_does(dt, where):
    """A NaN in λ, anti or alpha_low: the JAX kernel (interpret mode) and
    the port's plain version put NaN at the same faces, and agree to the
    FCT tolerance everywhere else (the CUDA kernel is held bitwise to the
    plain version, NaN positions included, in tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(6)
    jdt, tdt = _DT[dt]
    lams = [rng.uniform(0, 1, SHAPE).astype(np.float32) for _ in range(3)]
    antis = [rng.standard_normal(SHAPE).astype(np.float32) * 1e-3
             for _ in range(3)]
    al = rng.uniform(0, 1, SHAPE).astype(np.float32)
    amax = np.minimum(al + rng.uniform(0, 0.2, SHAPE), 1).astype(np.float32)
    amin = np.maximum(al - rng.uniform(0, 0.2, SHAPE), 0).astype(np.float32)
    dt_iv = rng.uniform(1e-4, 2e-4, SHAPE).astype(np.float32)
    cells = [al, amax, amin, dt_iv]
    kind, n = NAN_AT[where]
    {"lam": lams, "anti": antis, "cell": cells}[kind][n][5, 4, 3] = np.nan
    spacing = (0.004, 0.004, 0.0035)
    got = tfct.fct_iter_plain(
        tuple(torch.from_numpy(l).to(tdt) for l in lams),
        tuple(torch.from_numpy(a).to(tdt) for a in antis),
        *(torch.from_numpy(c) for c in cells), spacing)
    want = jfct.fct_iter(tuple(jnp.asarray(l, jdt) for l in lams),
                         tuple(jnp.asarray(a, jdt) for a in antis),
                         *(jnp.asarray(c) for c in cells), spacing,
                         interpret=True)
    rtol = F32_RTOL if dt == "f32" else BF16_RTOL
    n_nan = 0
    for g_t, w_j in zip(got, want):
        assert g_t.dtype == tdt
        g = g_t.float().numpy()
        w = np.asarray(jnp.asarray(w_j, jnp.float32))
        assert np.array_equal(np.isnan(g), np.isnan(w))
        n_nan += int(np.isnan(g).sum())
        ok = ~np.isnan(w)
        scale = max(float(np.abs(w[ok]).max()), 1e-30)
        assert float(np.abs(g[ok] - w[ok]).max()) <= rtol * scale
    assert n_nan >= 1


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any device but CUDA or CPU raises instead of falling back."""
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    split = tuple(torch.from_numpy(w) for w in _weights(rng))
    before = (t7.apply_7pt.launches, tflux.flux_all.launches,
              tfct.fct_iter.launches)
    torch.testing.assert_close(t7.apply_7pt(p, split),
                               t7.apply_7pt_plain(p, split), rtol=0, atol=0)
    tflux.flux_all(p, (p, p, p), (p, p, p))
    tfct.fct_iter((p, p, p), (p, p, p), p, p, p, p, (1.0, 1.0, 1.0))
    assert (t7.apply_7pt.launches, tflux.flux_all.launches,
            tfct.fct_iter.launches) == before
    m = torch.empty(SHAPE, device="meta")
    with pytest.raises(ValueError):
        t7.apply_7pt(m, (m, m, m))
    with pytest.raises(ValueError):
        t7.resid_scaled_7pt(m, (m, m, m), None, m)
    with pytest.raises(ValueError):
        t7.apply_dot_7pt(m, (m, m, m))
    with pytest.raises(ValueError):
        tflux.flux_all(m, (m, m, m), (m, m, m))
    with pytest.raises(ValueError):
        tfct.fct_iter((m, m, m), (m, m, m), m, m, m, m, (1.0, 1.0, 1.0))
