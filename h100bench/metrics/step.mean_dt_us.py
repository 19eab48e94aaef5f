"""Layer `step`: simulated time per step, averaged over the cases. It
tells a move of the numerics (a larger CFL dt) from one of speed."""

UNIT = "us"


def read(run):
    return run.case_sim_s / (run.steps * run.n_cases) * 1e6
