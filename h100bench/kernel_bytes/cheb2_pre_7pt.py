"""Bytes a call of `ops/kernels/seven_point.py` `cheb2_pre_7pt`: b and the weights read once, x and r
written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
