"""The system under test of a one-case configuration: the port's
`solver/timestep.make_step` with `SolverControls(use_pallas=True)` and
`carry_precond=True`, as bench.py and the case path run it: every
default-path CUDA kernel (rows 1-7 of PERF.md's kernel table)."""

from __future__ import annotations

import torch


class CaseSystem:
    """One case. The carry is (SimState, preconditioner bundle)."""

    def __init__(self, config, device):
        from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                                   SolverControls)
        from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
        from openfoam_tpp_tpu_torch.solver.timestep import make_step

        geom = build_tank_geometry(H=config["H"], D=config["D"],
                                   mesh=config["mesh"], geo=config["geo"],
                                   round_to=config["round_to"])
        self.shape = geom.shape
        self.fluid_cells = geom.n_fluid_cells   # per case
        self.n_cases = 1
        self.p_max_iters = SolverControls().p_max_iters
        self._step = make_step(geom, PhysicalProperties(),
                               SolverControls(use_pallas=True),
                               carry_precond=True, device=device)

    def start(self, inputs):
        """The carry of the seeded input state."""
        from openfoam_tpp_tpu_torch.core.state import CaseParams, SimState

        s = inputs["state"]
        f = inputs["forcing"]
        state = SimState(step=torch.zeros((), dtype=torch.int32,
                                          device=s["t"].device), **s)
        self._params = CaseParams(orbit_radius=f["R"], omega=f["omega"],
                                  ramp_time=f["ramp_time"])
        return state, self._step.init_precond(state)

    def step(self, carry):
        """(carry', record): the record holds the step's scalars on the
        device (t, Courant, alpha Courant, p_iters, p residual, alpha
        min and max)."""
        state, bundle = carry
        state, diag, bundle = self._step(state, self._params, precond=bundle)
        return (state, bundle), (state.t, diag.courant, diag.alpha_courant,
                                 diag.p_iters, diag.p_residual,
                                 diag.alpha_min, diag.alpha_max)

    @staticmethod
    def fields(carry) -> dict:
        s = carry[0]
        return {k: getattr(s, k) for k in ("alpha", "u", "v", "w", "p", "t",
                                            "dt")}


def build(config, device):
    return CaseSystem(config, device)
