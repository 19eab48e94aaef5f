"""Bytes a call of `ops/kernels/correction.py` `correct_divmax`: dp, the
three velocities, the three face 1/rho, the three apertures and the
fluid fraction read once, the three corrected velocities and the
divergence maximum written once; with an open top (`open_top`, argument
13, default true) also the top plane's aperture and of rho the top plane
the open-top faces read. A closed top reads neither."""

from h100bench.kernel_bytes._bytes import operands_and_result, tensor_bytes

MODULE = "correction"
# positions in (dp, u, v, w, beta_f, ax, ay, az, vfrac, top_open, rho, dt,
# spacing, open_top)
TOP_OPEN, RHO, OPEN_TOP = 9, 10, 13


def _arg(args, kwargs, pos, name, default=None):
    return args[pos] if len(args) > pos else kwargs.get(name, default)


def nbytes(args, kwargs, out) -> int:
    rho = _arg(args, kwargs, RHO, "rho")
    read = operands_and_result(args, kwargs, out) - tensor_bytes(rho)
    if _arg(args, kwargs, OPEN_TOP, "open_top", True):
        return read + tensor_bytes(rho[:, :, -1])
    return read - tensor_bytes(_arg(args, kwargs, TOP_OPEN, "top_open"))
