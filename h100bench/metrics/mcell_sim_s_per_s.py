"""Fluid cells x simulated seconds, summed over the cases, per wall
second of the window, / 1e6: what the users' bill follows."""

UNIT = "Mcell-s/s"


def read(run):
    return run.fluid_cells * run.case_sim_s / run.window_s / 1e6
