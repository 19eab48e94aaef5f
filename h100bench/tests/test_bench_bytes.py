"""The kernel byte functions reproduce PERF.md's kernel table (each
input read once, each output written once)."""

import pytest
import torch

from h100bench import harness


def _t(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def nbytes(entry, args, out):
    return harness.load_module("kernel_bytes", entry).nbytes(args, {}, out)


N = 112


def test_apply_7pt_112_f32_unit():
    p = _t(N, N, N)
    assert nbytes("apply_7pt", (p, (p, p, p), None), p) == 5 * N ** 3 * 4
    assert round(5 * N ** 3 * 4 / 1e6, 1) == 28.1


def test_apply_7pt_nb_sweep_f32_unit():
    p = _t(12, 12, 50, 128)
    b = nbytes("apply_7pt_nb", (p, (p, p, p), None), p)
    assert round(b / 1e6, 2) == 18.43


def test_resid_bf16_unit_and_apply_dot():
    p = _t(N, N, N, dtype=torch.bfloat16)
    assert round(nbytes("resid_scaled_7pt", (p, (p, p, p), None, p), p)
                 / 1e6, 1) == 16.9
    q = _t(N, N, N)
    assert round(nbytes("apply_dot_7pt", (q, (q, q, q)), (q, _t()))
                 / 1e6, 1) == 28.1


def test_mules_kernels():
    a = _t(N, N, N)
    h = _t(N, N, N, dtype=torch.bfloat16)
    assert round(nbytes("flux_all", (a, (a, a, a), (h, h, h)),
                        ((a, a, a), (h, h, h))) / 1e6, 1) == 56.2
    assert round(nbytes("fct_iter", ((h, h, h), (h, h, h), a, a, a, a,
                                     (0.1, 0.1, 0.1)), (h, h, h))
                 / 1e6, 1) == 47.8


@pytest.mark.parametrize("entry, mb", [("momentum_rhs", 62.3),
                                       ("correct_divmax", 79.4)])
def test_momentum_and_correction(entry, mb):
    c = _t(N, N, N)
    fu, fv, fw = _t(N + 1, N, N), _t(N, N + 1, N), _t(N, N, N + 1)
    if entry == "momentum_rhs":
        args = (fu, fv, fw, (fu, fv, fw), c, c, (0.1, 0.1, 0.1), True)
        out = (fu, fv, fw)
    else:
        args = (c, fu, fv, fw, (fu, fv, fw), fu, fv, fw, c, _t(N, N), c,
                _t(), (0.1, 0.1, 0.1), True)
        out = (fu, fv, fw, _t())
    assert abs(nbytes(entry, args, out) / 1e6 - mb) < 0.15
