"""The 95th percentile of the wall time of every step of the window (a
sweep's step is one batched step of all its cases), each read after a
synchronize at the step's end."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(np.asarray(run.step_s), 95)) * 1e3
