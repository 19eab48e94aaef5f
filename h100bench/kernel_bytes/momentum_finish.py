"""Bytes a call of `ops/kernels/mom_finish.py` `momentum_finish`: the velocities, right-hand sides,
densities, apertures, dt and G read once, the three updated velocities
written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "mom_finish"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
