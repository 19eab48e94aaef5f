"""Layer `step` (solver/timestep.py, parallel/sweep.py): the median wall
time of the window's steps."""

import numpy as np

UNIT = "ms"


def read(run):
    return float(np.percentile(np.asarray(run.step_s), 50)) * 1e3
