"""Bytes a call of `ops/kernels/seven_point.py` `apply_7pt_nb`: the batched grid's p, weights and diagonal
read once, A(p) written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
