"""Layer `solver/poisson.py` (MG-PCG): CG iterations a step, from
StepDiagnostics.p_iters; in a sweep the batch's count, the slowest
case's, which the masked CG runs for all."""

import numpy as np

UNIT = "iters"


def read(run):
    return float(np.mean(run.p_iters))
