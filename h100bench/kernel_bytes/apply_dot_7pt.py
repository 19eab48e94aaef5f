"""Bytes a call of `ops/kernels/seven_point.py` `apply_dot_7pt`: p and the three low-face weights read once,
Ahat p and the dot written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
