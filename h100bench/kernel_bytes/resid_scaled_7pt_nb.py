"""Bytes a call of `ops/kernels/seven_point.py` `resid_scaled_7pt_nb`: the batched grid's p, weights,
diagonal and b read once, the scaled residual written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
