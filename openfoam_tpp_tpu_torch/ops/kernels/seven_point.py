"""7-point variable-coefficient stencil family: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/seven_point.py (`apply_7pt`,
`resid_scaled_7pt`, `apply_dot_7pt`, and the fused degree-2 Chebyshev
smoothers `cheb2_pre_7pt`, `cheb2_post_7pt`, `cheb2_post_dot_7pt` on the
unit-diagonal operator). The pressure operator is
A(p) = diag·p − Σ_f w_f·p_nb, in the face-lite layout: `split_weights`
keeps only the three LOW-face coefficient arrays; the high-face term of
cell c is (w_l·p)[c+1], zero at the domain edge (exact, because
domain-boundary faces carry zero weight).

Each entry point launches its kernel (csrc/seven_point.cu; the cheb2
smoothers csrc/cheb2.cu) for CUDA tensors and runs its plain PyTorch version (`*_plain`) for CPU tensors;
any other device raises. The plain version computes in f32 and rounds
once on output, exactly like the kernel. Each entry point counts its
kernel launches in `.launches`. Every call is one launch: the dots of
`apply_dot_7pt` and `cheb2_post_dot_7pt` are finished inside it through
the device's ticket counter (`_build.ticket`).

Parameter sweeps stack many cases on a trailing axis: (nx, ny, nz, B).
`apply_7pt`, `resid_scaled_7pt` and `apply_dot_7pt` dispatch on rank:
rank 3 to the kernels above, rank 4 to the batch-native entry points
`apply_7pt_nb`, `resid_scaled_7pt_nb` and `apply_dot_7pt_nb`
(csrc/seven_point_batch.cu; port of
openfoam_tpp_tpu/ops/pallas/seven_point_batch.py), each with its own
`.launches`. The case axis never shifts, so no case reads another's
data, and the dot of `apply_dot_7pt_nb` is per case, shape (B,), finished
inside its one launch through the device's ticket counters (one per 32
cases). The plain versions take either rank. The cheb2 smoothers are
single-grid only: on rank 4 the solver runs two sweeps as batch-kernel
passes.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build
from openfoam_tpp_tpu_torch.ops.stencil import sum_cells

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_APPLY, _RESID, _APPLY_DOT = 0, 1, 2


def split_weights(wx, wy, wz):
    """Face weight arrays → the three cell-shaped LOW-face coefficient
    arrays: wxl[c] multiplies p[x−1]."""
    return (wx[:-1].contiguous(), wy[:, :-1].contiguous(),
            wz[:, :, :-1].contiguous())


# ------------------------------------------------------------- plain versions

def _nb_sum_plain(p, split):
    """Face-lite neighbour sum in f32, same products and add order as the
    kernel (and as the TPU kernel's `_nb_core`)."""
    wx, wy, wz = (w.float() for w in split)
    c = p.float()
    xm = torch.cat([c[:1], c[:-1]], 0)
    tx = wx * c
    xh = torch.cat([tx[1:], torch.zeros_like(tx[:1])], 0)
    ym = torch.cat([c[:, :1], c[:, :-1]], 1)
    ty = wy * c
    yh = torch.cat([ty[:, 1:], torch.zeros_like(ty[:, :1])], 1)
    zm = torch.cat([c[:, :, :1], c[:, :, :-1]], 2)
    tz = wz * c
    zh = torch.cat([tz[:, :, 1:], torch.zeros_like(tz[:, :, :1])], 2)
    return wx * xm + xh + wy * ym + yh + wz * zm + zh, c


def apply_7pt_plain(p, split, diag=None):
    nb, c = _nb_sum_plain(p, split)
    out = c - nb if diag is None else diag.float() * c - nb
    return out.to(p.dtype)


def resid_scaled_7pt_plain(p, split, diag, b):
    nb, c = _nb_sum_plain(p, split)
    if diag is None:
        out = b.float() - (c - nb)
    else:
        d = diag.float()
        out = (b.float() - (d * c - nb)) / d
    return out.to(p.dtype)


def apply_dot_7pt_plain(p, split):
    nb, c = _nb_sum_plain(p, split)
    ap = (c - nb).to(p.dtype)
    return ap, sum_cells(c * ap.float())


def cheb_coefs(lmax, lmin_frac):
    """(1/θ, c_pp, c_pd) of the degree-2 Chebyshev smoother over
    [lmin_frac·lmax, 1.02·lmax]: the first step is p₁ = d/θ and the
    second p₂ = c_pp·p₁ + c_pd·d₂. The kernels and the plain versions
    multiply by 1/θ (rounded to f32 once) instead of dividing."""
    a, c = lmin_frac * lmax, 1.02 * lmax
    theta = 0.5 * (c + a)
    delta = 0.5 * (c - a)
    sigma = theta / delta
    rho = 1.0 / sigma
    rho_new = 1.0 / (2.0 * sigma - rho)
    return 1.0 / theta, rho_new * rho, 2.0 * rho_new / delta


def _resid_f32(x, split, b):
    """b − Â·x in f32 from f32 operands (`split` may be bf16)."""
    nb, c = _nb_sum_plain(x, split)
    return b - (c - nb)


def cheb2_pre_7pt_plain(b, split, lmax, lmin_frac):
    inv_theta, c_pp, c_pd = cheb_coefs(lmax, lmin_frac)
    bf = b.float()
    x1 = bf * inv_theta
    d1 = _resid_f32(x1, split, bf)
    x = x1 + (c_pp * x1 + c_pd * d1)
    r = _resid_f32(x, split, bf)
    return x.to(b.dtype), r.to(b.dtype)


def cheb2_post_7pt_plain(x, b, split, lmax, lmin_frac, out_dtype=None):
    inv_theta, c_pp, c_pd = cheb_coefs(lmax, lmin_frac)
    xf, bf = x.float(), b.float()
    p1 = _resid_f32(xf, split, bf) * inv_theta
    x1 = xf + p1
    d2 = _resid_f32(x1, split, bf)
    return (x1 + (c_pp * p1 + c_pd * d2)).to(out_dtype or b.dtype)


def cheb2_post_dot_7pt_plain(x, b, split, lmax, lmin_frac, out_dtype=None):
    z = cheb2_post_7pt_plain(x, b, split, lmax, lmin_frac, out_dtype)
    return z, (b.float() * z.float()).sum()


# ------------------------------------------------------------------ kernels

def _check(p, split, *extra, rank=3):
    if p.dim() != rank or p.dtype not in _DTYPES:
        raise ValueError(f"7-point kernel takes a {rank}-D f32/bf16 grid, got "
                         f"{p.dtype} {tuple(p.shape)}")
    for a in (*split, *extra):
        if a is None:
            continue
        if (a.shape != p.shape or a.dtype != p.dtype or a.device != p.device
                or not a.is_contiguous()):
            raise ValueError("7-point kernel operands must share p's shape, "
                             "dtype and device and be contiguous")
    if not p.is_contiguous():
        raise ValueError("7-point kernel: p must be contiguous")


def _lib():
    lib = _build.load("seven_point")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seven_point_launch.argtypes = [ci, ci, ci] + [vp] * 10 + [ci] * 3 + [vp]
        lib.seven_point_launch.restype = ci
        lib.seven_point_num_partials.argtypes = [ci] * 3
        lib.seven_point_num_partials.restype = ci
        lib._typed = True
    return lib


def _dot_scratch(lib, p):
    """(partials, dot, ticket) of one apply-dot launch on p's grid."""
    partial = torch.empty(lib.seven_point_num_partials(*p.shape),
                          dtype=torch.float32, device=p.device)
    dot = torch.empty((), dtype=torch.float32, device=p.device)
    return partial, dot, _build.ticket(p.device)


def _launch(mode, p, split, diag=None, b=None):
    lib = _lib()
    out = torch.empty_like(p)
    partial = dot = ticket = None
    if mode == _APPLY_DOT:
        partial, dot, ticket = _dot_scratch(lib, p)
    nx, ny, nz = p.shape
    nul = ctypes.c_void_p(None)
    opt = lambda t: nul if t is None else _build.ptr(t)
    rc = lib.seven_point_launch(
        mode, _DTYPES[p.dtype], int(diag is not None), _build.ptr(p),
        *(_build.ptr(w) for w in split), opt(diag), opt(b), _build.ptr(out),
        opt(partial), opt(dot), opt(ticket), nx, ny, nz, _build.stream_of(p))
    _build.check(rc, "seven_point", out, dot)
    return out, dot


def _rank(p, what):
    """3 (one grid) or 4 (cases stacked on a trailing axis); else raises."""
    if p.dim() not in (3, 4):
        raise ValueError(f"{what} takes a (nx, ny, nz) grid or a batched "
                         f"(nx, ny, nz, B) one, got {tuple(p.shape)}")
    return p.dim()


def apply_7pt(p, split, diag=None):
    """A(p). `split` from `split_weights`; `diag=None` = unit diagonal
    (the scaled operator Â)."""
    if _rank(p, "apply_7pt") == 4:
        return apply_7pt_nb(p, split, diag)
    if _build.route(p, "apply_7pt") == "cpu":
        return apply_7pt_plain(p, split, diag)
    _check(p, split, diag)
    out, _ = _launch(_APPLY, p, split, diag=diag)
    apply_7pt.launches += 1
    return out


def resid_scaled_7pt(p, split, diag, b):
    """(b − A·p)/diag; `diag=None` = unit diagonal: b − Â·p."""
    if _rank(p, "resid_scaled_7pt") == 4:
        return resid_scaled_7pt_nb(p, split, diag, b)
    if _build.route(p, "resid_scaled_7pt") == "cpu":
        return resid_scaled_7pt_plain(p, split, diag, b)
    _check(p, split, diag, b)
    out, _ = _launch(_RESID, p, split, diag=diag, b=b)
    resid_scaled_7pt.launches += 1
    return out


def apply_dot_7pt(p, split):
    """(Â·p, p·Â·p) in one pass (unit diagonal) — the CG curvature step.
    The dot is a 0-d f32 tensor on p's device ((B,) on a batched grid)."""
    if _rank(p, "apply_dot_7pt") == 4:
        return apply_dot_7pt_nb(p, split)
    if _build.route(p, "apply_dot_7pt") == "cpu":
        return apply_dot_7pt_plain(p, split)
    _check(p, split)
    out, dot = _launch(_APPLY_DOT, p, split)
    apply_dot_7pt.launches += 1
    return out, dot


# ------------------------------------------ batch-native (rank-4) kernels

def _batch_lib():
    lib = _build.load("seven_point_batch")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.seven_point_batch_launch.argtypes = ([ci, ci, ci] + [vp] * 10
                                                 + [ci] * 4 + [vp])
        lib.seven_point_batch_launch.restype = ci
        lib.seven_point_batch_num_partials.argtypes = [ci] * 3
        lib.seven_point_batch_num_partials.restype = ci
        lib._typed = True
    return lib


def _batch_launch(mode, p, split, diag=None, b=None):
    lib = _batch_lib()
    out = torch.empty_like(p)
    nx, ny, nz, nb = p.shape
    partial = dots = ticket = None
    if mode == _APPLY_DOT:
        partial = torch.empty(
            (lib.seven_point_batch_num_partials(nx, ny, nz), nb),
            dtype=torch.float32, device=p.device)
        dots = torch.empty((nb,), dtype=torch.float32, device=p.device)
        ticket = _build.ticket(p.device, -(-nb // 32))
    nul = ctypes.c_void_p(None)
    opt = lambda t: nul if t is None else _build.ptr(t)
    rc = lib.seven_point_batch_launch(
        mode, _DTYPES[p.dtype], int(diag is not None), _build.ptr(p),
        *(_build.ptr(w) for w in split), opt(diag), opt(b), _build.ptr(out),
        opt(partial), opt(dots), opt(ticket), nx, ny, nz, nb,
        _build.stream_of(p))
    _build.check(rc, "seven_point_batch", out, dots)
    return out, dots


def apply_7pt_nb(p, split, diag=None):
    """A(p) of every case of a batched (nx, ny, nz, B) grid."""
    if _build.route(p, "apply_7pt_nb") == "cpu":
        return apply_7pt_plain(p, split, diag)
    _check(p, split, diag, rank=4)
    out, _ = _batch_launch(_APPLY, p, split, diag=diag)
    apply_7pt_nb.launches += 1
    return out


def resid_scaled_7pt_nb(p, split, diag, b):
    """(b − A·p)/diag (b − Â·p with `diag=None`) on a batched grid."""
    if _build.route(p, "resid_scaled_7pt_nb") == "cpu":
        return resid_scaled_7pt_plain(p, split, diag, b)
    _check(p, split, diag, b, rank=4)
    out, _ = _batch_launch(_RESID, p, split, diag=diag, b=b)
    resid_scaled_7pt_nb.launches += 1
    return out


def apply_dot_7pt_nb(p, split):
    """(Â·p, per-case p·Â·p) on a batched grid; the dots are a (B,) f32
    tensor on p's device."""
    if _build.route(p, "apply_dot_7pt_nb") == "cpu":
        return apply_dot_7pt_plain(p, split)
    _check(p, split, rank=4)
    out, dots = _batch_launch(_APPLY_DOT, p, split)
    apply_dot_7pt_nb.launches += 1
    return out, dots


_CHEB_PRE, _CHEB_POST, _CHEB_POST_DOT = 0, 1, 2


def _cheb_lib():
    lib = _build.load("cheb2")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.cheb2_launch.argtypes = ([ci] * 3 + [vp] * 10 + [cf] * 3
                                     + [ci] * 3 + [vp])
        lib.cheb2_launch.restype = ci
        lib.cheb2_num_partials.argtypes = [ci] * 3
        lib.cheb2_num_partials.restype = ci
        lib._typed = True
    return lib


def _cheb_out_dtype(b, out_dtype):
    """The store type: the operands' own, or f32 (the widened store)."""
    out_dtype = out_dtype or b.dtype
    if out_dtype not in (b.dtype, torch.float32):
        raise ValueError(f"cheb2 kernel stores {b.dtype} or float32, not "
                         f"{out_dtype}")
    return out_dtype


def _cheb_launch(mode, x, b, split, lmax, lmin_frac, out_dtype):
    lib = _cheb_lib()
    out = torch.empty_like(b, dtype=out_dtype)
    out2 = torch.empty_like(b) if mode == _CHEB_PRE else None
    partial = dot = ticket = None
    if mode == _CHEB_POST_DOT:
        partial = torch.empty(lib.cheb2_num_partials(*b.shape),
                              dtype=torch.float32, device=b.device)
        dot = torch.empty((), dtype=torch.float32, device=b.device)
        ticket = _build.ticket(b.device)
    nul = ctypes.c_void_p(None)
    opt = lambda t: nul if t is None else _build.ptr(t)
    rc = lib.cheb2_launch(
        mode, _DTYPES[b.dtype], _DTYPES[out_dtype], opt(x), _build.ptr(b),
        *(_build.ptr(w) for w in split), _build.ptr(out), opt(out2),
        opt(partial), opt(dot), opt(ticket), *cheb_coefs(lmax, lmin_frac),
        *b.shape, _build.stream_of(b))
    _build.check(rc, "cheb2", out, out2, dot)
    return out, out2, dot


def cheb2_pre_7pt(b, split, lmax, lmin_frac):
    """(x, r): degree-2 Chebyshev on Â·x = b from x ≡ 0, and b − Â·x, in
    one pass — the V-cycle's entry smoothing and its residual."""
    if _build.route(b, "cheb2_pre_7pt") == "cpu":
        return cheb2_pre_7pt_plain(b, split, lmax, lmin_frac)
    _check(b, split)
    x, r, _ = _cheb_launch(_CHEB_PRE, None, b, split, lmax, lmin_frac,
                           b.dtype)
    cheb2_pre_7pt.launches += 1
    return x, r


def cheb2_post_7pt(x, b, split, lmax, lmin_frac, out_dtype=None):
    """Degree-2 Chebyshev on Â·x = b continuing from x, in one pass — the
    V-cycle's exit smoothing. `out_dtype=torch.float32` widens a bf16
    cycle's result on the store."""
    if _build.route(b, "cheb2_post_7pt") == "cpu":
        return cheb2_post_7pt_plain(x, b, split, lmax, lmin_frac, out_dtype)
    _check(b, split, x)
    z, _, _ = _cheb_launch(_CHEB_POST, x, b, split, lmax, lmin_frac,
                           _cheb_out_dtype(b, out_dtype))
    cheb2_post_7pt.launches += 1
    return z


def cheb2_post_dot_7pt(x, b, split, lmax, lmin_frac, out_dtype=None):
    """(z, Σ b·z): `cheb2_post_7pt` plus CG's coupling dot, with b widened
    to f32 and z as stored. The dot is a 0-d f32 tensor on b's device."""
    if _build.route(b, "cheb2_post_dot_7pt") == "cpu":
        return cheb2_post_dot_7pt_plain(x, b, split, lmax, lmin_frac,
                                        out_dtype)
    _check(b, split, x)
    z, _, dot = _cheb_launch(_CHEB_POST_DOT, x, b, split, lmax, lmin_frac,
                             _cheb_out_dtype(b, out_dtype))
    cheb2_post_dot_7pt.launches += 1
    return z, dot


for _fn in (apply_7pt, resid_scaled_7pt, apply_dot_7pt, apply_7pt_nb,
            resid_scaled_7pt_nb, apply_dot_7pt_nb, cheb2_pre_7pt,
            cheb2_post_7pt, cheb2_post_dot_7pt):
    _fn.launches = 0
