"""Bytes a call of `ops/kernels/seven_point.py` `resid_scaled_7pt`: p, the three low-face weights, the
diagonal (when given) and b read once, (b - A p)/diag written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "seven_point"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
