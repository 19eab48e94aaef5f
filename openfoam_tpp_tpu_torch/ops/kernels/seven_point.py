"""7-point variable-coefficient stencil family: CUDA kernel + plain version.

Port of openfoam_tpp_tpu/ops/pallas/seven_point.py (`apply_7pt`,
`resid_scaled_7pt`, `apply_dot_7pt`). The pressure operator is
A(p) = diag·p − Σ_f w_f·p_nb, in the face-lite layout: `split_weights`
keeps only the three LOW-face coefficient arrays; the high-face term of
cell c is (w_l·p)[c+1], zero at the domain edge (exact, because
domain-boundary faces carry zero weight).

Each entry point launches the kernel in csrc/seven_point.cu for CUDA
tensors and runs its plain PyTorch version (`*_plain`) for CPU tensors;
any other device raises. The plain version computes in f32 and rounds
once on output, exactly like the kernel. Each entry point counts its
kernel launches in `.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from openfoam_tpp_tpu_torch.ops.kernels import _build

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
    return ap, (c * ap.float()).sum()


# ------------------------------------------------------------------ kernels

def _check(p, split, *extra):
    if p.dim() != 3 or p.dtype not in _DTYPES:
        raise ValueError(f"7-point kernel takes a 3-D f32/bf16 grid, got "
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
        lib.seven_point_launch.argtypes = [ci, ci, ci] + [vp] * 9 + [ci] * 3 + [vp]
        lib.seven_point_launch.restype = ci
        lib.seven_point_num_partials.argtypes = [ci] * 3
        lib.seven_point_num_partials.restype = ci
        lib._typed = True
    return lib


def _launch(mode, p, split, diag=None, b=None):
    lib = _lib()
    out = torch.empty_like(p)
    partial = dot = None
    if mode == _APPLY_DOT:
        partial = torch.empty(lib.seven_point_num_partials(*p.shape),
                              dtype=torch.float32, device=p.device)
        dot = torch.empty((), dtype=torch.float32, device=p.device)
    nx, ny, nz = p.shape
    nul = ctypes.c_void_p(None)
    opt = lambda t: nul if t is None else _build.ptr(t)
    rc = lib.seven_point_launch(
        mode, _DTYPES[p.dtype], int(diag is not None), _build.ptr(p),
        *(_build.ptr(w) for w in split), opt(diag), opt(b), _build.ptr(out),
        opt(partial), opt(dot), nx, ny, nz, _build.stream_of(p))
    _build.check(rc, "seven_point")
    return out, dot


def apply_7pt(p, split, diag=None):
    """A(p). `split` from `split_weights`; `diag=None` = unit diagonal
    (the scaled operator Â)."""
    if _build.route(p, "apply_7pt") == "cpu":
        return apply_7pt_plain(p, split, diag)
    _check(p, split, diag)
    out, _ = _launch(_APPLY, p, split, diag=diag)
    apply_7pt.launches += 1
    return out


def resid_scaled_7pt(p, split, diag, b):
    """(b − A·p)/diag; `diag=None` = unit diagonal: b − Â·p."""
    if _build.route(p, "resid_scaled_7pt") == "cpu":
        return resid_scaled_7pt_plain(p, split, diag, b)
    _check(p, split, diag, b)
    out, _ = _launch(_RESID, p, split, diag=diag, b=b)
    resid_scaled_7pt.launches += 1
    return out


def apply_dot_7pt(p, split):
    """(Â·p, p·Â·p) in one pass (unit diagonal) — the CG curvature step.
    The dot is a 0-d f32 tensor on p's device."""
    if _build.route(p, "apply_dot_7pt") == "cpu":
        return apply_dot_7pt_plain(p, split)
    _check(p, split)
    out, dot = _launch(_APPLY_DOT, p, split)
    apply_dot_7pt.launches += 1
    return out, dot


apply_7pt.launches = 0
resid_scaled_7pt.launches = 0
apply_dot_7pt.launches = 0
