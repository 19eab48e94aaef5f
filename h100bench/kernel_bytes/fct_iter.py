"""Bytes a call of `ops/kernels/mules_fct.py` `fct_iter`: the three lambda and three antidiffusive flux
streams, alpha_low, the bounds and dt/V read once, the three new lambda
streams written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "mules_fct"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
