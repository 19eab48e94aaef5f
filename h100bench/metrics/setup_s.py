"""Process start to the first timed step: the port's geometry and step,
the seeded inputs, one untimed segment (and, in a new checkout, the
build of the CUDA kernels)."""

UNIT = "s"


def read(run):
    return run.setup_s
