"""Bytes a call of `ops/kernels/seven_point.py` `apply_dot_7pt_nb`: the batched grid's p and weights read
once, Ahat p and the per-case dots written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
