"""Bytes a call of `ops/kernels/correction.py` `correct_divmax`: dp, the
three velocities, the three face 1/rho, the three apertures, the fluid
fraction and the top plane's aperture read once, of rho only the top
plane the open-top faces read, the three corrected velocities and the
divergence maximum written once."""

from h100bench.kernel_bytes._bytes import operands_and_result, tensor_bytes

MODULE = "correction"
RHO = 10   # position of `rho`: (dp, u, v, w, beta_f, ax, ay, az, vfrac, top_open, rho, ...)


def nbytes(args, kwargs, out) -> int:
    rho = args[RHO] if len(args) > RHO else kwargs["rho"]
    return (operands_and_result(args, kwargs, out) - tensor_bytes(rho)
            + tensor_bytes(rho[:, :, -1]))
