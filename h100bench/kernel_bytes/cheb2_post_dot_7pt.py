"""Bytes a call of `ops/kernels/seven_point.py` `cheb2_post_dot_7pt`: x, b and the weights read once, the
smoothed x and r.z written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
