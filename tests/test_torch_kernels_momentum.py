"""The port's momentum-RHS, projection-epilogue and momentum-finish kernel
modules against the JAX Pallas kernels they replace, on the CPU.

The same seeded numpy inputs go through the JAX Pallas function in
interpret mode and through the port's entry point on CPU tensors, which
runs the kernel's plain PyTorch version (the CUDA kernels run only on the
card: chip_smoke.py and tests/test_torch_cuda.py hold them against these
plain versions there). The input builders are copies of the JAX tests'
(test_pallas_momentum.py, test_pallas_correction.py, test_pallas_finish.py).

Tolerances, those of the JAX tests: the momentum RHS to 1e-5 of the
output scale (the plain version sums the terms in solver/momentum.py's
order, the Pallas kernel in its own); the corrected velocities to 1e-6
and the divergence maximum to 1e-6 relative; the finish to 1e-5 absolute
on outputs of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openfoam_tpp_tpu.ops.pallas import correction as jck
from openfoam_tpp_tpu.ops.pallas import mom_finish as jfk
from openfoam_tpp_tpu.ops.pallas import momentum_rhs as jmrk
from openfoam_tpp_tpu_torch.ops.kernels import correction as tck
from openfoam_tpp_tpu_torch.ops.kernels import mom_finish as tfk
from openfoam_tpp_tpu_torch.ops.kernels import momentum_rhs as tmrk

SPACING = (0.011, 0.009, 0.013)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mom_inputs(shape, open_top, seed=0):
    """Physical inputs: wall velocity and wall rhoPhi faces are zero."""
    nx, ny, nz = shape
    rng = np.random.RandomState(seed)

    def f(s):
        return rng.uniform(-1.0, 1.0, size=s).astype(np.float32)

    u = f((nx + 1, ny, nz))
    v = f((nx, ny + 1, nz))
    w = f((nx, ny, nz + 1))
    rpx = f((nx + 1, ny, nz))
    rpy = f((nx, ny + 1, nz))
    rpz = f((nx, ny, nz + 1))
    for a in (u, rpx):
        a[0] = 0.0
        a[-1] = 0.0
    for a in (v, rpy):
        a[:, 0] = 0.0
        a[:, -1] = 0.0
    for a in (w, rpz):
        a[:, :, 0] = 0.0
        if not open_top:
            a[:, :, -1] = 0.0
    mu = rng.uniform(1e-5, 2e-3, size=(nx, ny, nz)).astype(np.float32)
    div_u = f((nx, ny, nz)) * 0.1
    return u, v, w, rpx, rpy, rpz, mu, div_u


@pytest.mark.parametrize("open_top", [True, False])
@pytest.mark.parametrize("dev2", [True, False])
def test_momentum_rhs_matches_pallas(open_top, dev2):
    u, v, w, rpx, rpy, rpz, mu, div_u = _mom_inputs((16, 10, 12), open_top)
    want = jmrk.momentum_rhs(*(jnp.asarray(a) for a in (u, v, w)),
                             tuple(jnp.asarray(a) for a in (rpx, rpy, rpz)),
                             jnp.asarray(mu), jnp.asarray(div_u), SPACING,
                             dev2=dev2, interpret=True)
    got = tmrk.momentum_rhs(_t(u), _t(v), _t(w), (_t(rpx), _t(rpy), _t(rpz)),
                            _t(mu), _t(div_u), SPACING, dev2=dev2)
    want = [np.asarray(a) for a in want]
    scale = max(float(np.abs(a).max()) for a in want)
    for g, t, name in zip(got, want, "uvw"):
        assert g.shape == t.shape, name
        err = float(np.abs(g.numpy() - t).max())
        assert err <= 1e-5 * scale, (name, err, scale)
    assert float(got[0][-1].abs().max()) == 0.0


def test_momentum_rhs_quiescent_is_zero():
    """Zero velocity and zero mass flux give an identically zero RHS."""
    n = 8
    u, v, w = (torch.zeros(s) for s in ((n + 1, n, n), (n, n + 1, n),
                                        (n, n, n + 1)))
    rp = (torch.zeros_like(u), torch.zeros_like(v), torch.zeros_like(w))
    mu = torch.full((n, n, n), 1e-3)
    for a in tmrk.momentum_rhs(u, v, w, rp, mu, None, SPACING, dev2=True):
        assert float(a.abs().max()) == 0.0


def _corr_inputs(shape, open_top, seed=3):
    nx, ny, nz = shape
    rng = np.random.RandomState(seed)
    f = lambda s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)

    dp = f((nx, ny, nz), -50.0, 50.0)
    u = f((nx + 1, ny, nz))
    v = f((nx, ny + 1, nz))
    w = f((nx, ny, nz + 1))
    bx = f((nx + 1, ny, nz), 8e-4, 1e-3)
    by = f((nx, ny + 1, nz), 8e-4, 1e-3)
    bz = f((nx, ny, nz + 1), 8e-4, 1e-3)
    ax = f((nx + 1, ny, nz), 0.0, 1.0)
    ay = f((nx, ny + 1, nz), 0.0, 1.0)
    az = f((nx, ny, nz + 1), 0.0, 1.0)
    ax[0] = 0.0
    ax[-1] = 0.0
    ay[:, 0] = 0.0
    ay[:, -1] = 0.0
    az[:, :, 0] = 0.0
    topo = (rng.uniform(0, 1, (nx, ny)) > 0.3).astype(np.float32)
    if open_top:
        az[:, :, -1] = topo
    else:
        az[:, :, -1] = 0.0
        topo[:] = 0.0
    ax[ax < 0.2] = 0.0
    ay[ay < 0.2] = 0.0
    az[az < 0.2] = np.where(az[az < 0.2] > 0, az[az < 0.2], 0.0)
    vfrac = f((nx, ny, nz), 0.0, 1.0)
    vfrac[vfrac < 0.1] = 0.0
    rho_top = f((nx, ny), 1.0, 998.0)
    return dp, u, v, w, bx, by, bz, ax, ay, az, vfrac, topo, rho_top


@pytest.mark.parametrize("open_top", [True, False])
def test_correct_divmax_matches_pallas(open_top):
    shape = (16, 9, 11)
    args = _corr_inputs(shape, open_top)
    dp, u, v, w, bx, by, bz, ax, ay, az, vfrac, topo, rho_top = args
    dt = np.float32(3.7e-3)
    want = jck.correct_divmax(
        *(jnp.asarray(a) for a in (dp, u, v, w)),
        tuple(jnp.asarray(a) for a in (bx, by, bz)),
        *(jnp.asarray(a) for a in (ax, ay, az, vfrac, topo, rho_top)),
        jnp.float32(dt), SPACING, open_top=open_top, interpret=True)
    # The port takes the whole new density and reads its top plane.
    rho = np.random.RandomState(9).uniform(1.0, 998.0, shape).astype(np.float32)
    rho[:, :, -1] = rho_top
    got = tck.correct_divmax(
        *(_t(a) for a in (dp, u, v, w)), tuple(_t(a) for a in (bx, by, bz)),
        *(_t(a) for a in (ax, ay, az, vfrac, topo, rho)),
        torch.tensor(dt), SPACING, open_top=open_top)
    for g, t, name in zip(got[:3], want[:3], "uvw"):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=0,
                                   atol=1e-6, err_msg=name)
    assert got[3].dim() == 0
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)


def _finish_inputs(shape, seed=7):
    nx, ny, nz = shape
    rng = np.random.RandomState(seed)
    f = lambda s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, s).astype(np.float32)

    u = f((nx + 1, ny, nz))
    v = f((nx, ny + 1, nz))
    w = f((nx, ny, nz + 1))
    vcx = f((nx, ny, nz), -50, 50)
    vcy = f((nx, ny + 1, nz), -50, 50)
    vcz = f((nx, ny, nz + 1), -50, 50)
    rho_old = f((nx, ny, nz), 1.0, 998.0)
    rho_new = f((nx, ny, nz), 1.0, 998.0)
    ax = f((nx + 1, ny, nz), 0.0, 1.0)
    ay = f((nx, ny + 1, nz), 0.0, 1.0)
    az = f((nx, ny, nz + 1), 0.0, 1.0)
    ax[0] = ax[-1] = 0.0
    ay[:, 0] = ay[:, -1] = 0.0
    az[:, :, 0] = 0.0
    for a in (ax, ay, az):
        a[a < 0.25] = 0.0
    return u, v, w, vcx, vcy, vcz, rho_old, rho_new, ax, ay, az


def test_momentum_finish_matches_pallas():
    u, v, w, vcx, vcy, vcz, ro, rn, ax, ay, az = _finish_inputs((16, 9, 11))
    dt = np.float32(2.9e-3)
    G = np.array([0.31, -0.12, -9.81], np.float32)
    want = jfk.momentum_finish(
        *(jnp.asarray(a) for a in (u, v, w)),
        tuple(jnp.asarray(a) for a in (vcx, vcy, vcz)),
        *(jnp.asarray(a) for a in (ro, rn, ax, ay, az)), jnp.float32(dt),
        tuple(jnp.float32(g) for g in G), interpret=True)
    got = tfk.momentum_finish(
        *(_t(a) for a in (u, v, w)), tuple(_t(a) for a in (vcx, vcy, vcz)),
        *(_t(a) for a in (ro, rn, ax, ay, az)), torch.tensor(dt), _t(G))
    for g, t, name in zip(got, want, "uvw"):
        np.testing.assert_allclose(g.numpy(), np.asarray(t), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert float(got[0][-1].abs().max()) == 0.0


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any device but CUDA or CPU raises; an operand of the wrong shape
    raises before either runs."""
    n = 8
    cells, faces = (n, n, n), ((n + 1, n, n), (n, n + 1, n), (n, n, n + 1))
    before = (tmrk.momentum_rhs.launches, tck.correct_divmax.launches,
              tfk.momentum_finish.launches)

    def operands(device):
        c = torch.ones(cells, device=device)
        f = tuple(torch.ones(s, device=device) for s in faces)
        t = torch.ones((), device=device)
        return c, f, t

    for device in ("cpu", "meta"):
        c, f, t = operands(device)
        calls = (
            lambda: tmrk.momentum_rhs(*f, f, c, c, SPACING),
            lambda: tck.correct_divmax(c, *f, f, *f, c, c[:, :, 0].clone(),
                                       c, t, SPACING),
            lambda: tfk.momentum_finish(*f, (c, *f[1:]), c, c, *f, t,
                                        torch.ones(3, device=device)))
        for call in calls:
            if device == "cpu":
                call()
            else:
                with pytest.raises(ValueError):
                    call()
    assert (tmrk.momentum_rhs.launches, tck.correct_divmax.launches,
            tfk.momentum_finish.launches) == before
    c, f, t = operands("cpu")
    with pytest.raises(ValueError, match="momentum_rhs"):
        tmrk.momentum_rhs(f[1], f[0], f[2], f, c, c, SPACING)
