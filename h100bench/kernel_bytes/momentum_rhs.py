"""Bytes a call of `ops/kernels/momentum_rhs.py` `momentum_rhs`: u, v, w, the three mass fluxes, mu and
(with dev2) div u read once, the three right-hand sides written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "momentum_rhs"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
