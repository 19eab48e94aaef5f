"""Layer `ops/kernels/*`: the share of the device's busy time in the
hand-written kernels; the rest is PyTorch's own kernels, copies and
fills."""

UNIT = "%"


def read(run):
    if run.trace is None or run.trace.handwritten_share <= 0:
        return None
    return 100.0 * run.trace.handwritten_share
