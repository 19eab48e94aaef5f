"""Layer host dispatch: device kernels, copies and fills a step in the
traced segment."""

UNIT = "ops"


def read(run):
    if run.trace is None:
        return None
    return run.trace.device_ops / run.trace.steps
