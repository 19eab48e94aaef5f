"""Bytes a call of `ops/kernels/mules_flux.py` `flux_all`: alpha, the three face fluxes phi and the three
compression fluxes read once, the three low-order and three
antidiffusive fluxes written once."""

from h100bench.kernel_bytes._bytes import operands_and_result

MODULE = "mules_flux"


def nbytes(args, kwargs, out) -> int:
    return operands_and_result(args, kwargs, out)
