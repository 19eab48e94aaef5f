"""The system under test of a study configuration: the port's
`parallel/sweep.make_sweep_step` over every case batched on a trailing
case axis, with the port's own policy on a card (the batch 7-point
kernels, MULES and momentum on their plain path, one lockstep dt base)."""

from __future__ import annotations

import torch


class SweepSystem:
    """A batch of cases of one tank. The carry is the batched SimState."""

    def __init__(self, config, device):
        from openfoam_tpp_tpu_torch.config import (PhysicalProperties,
                                                   SolverControls)
        from openfoam_tpp_tpu_torch.mesh import build_tank_geometry
        from openfoam_tpp_tpu_torch.parallel.sweep import make_sweep_step

        geom = build_tank_geometry(H=config["H"], D=config["D"],
                                   mesh=config["mesh"], geo=config["geo"],
                                   round_to=config["round_to"])
        self.shape = geom.shape
        self.fluid_cells = geom.n_fluid_cells   # per case
        self.p_max_iters = SolverControls().p_max_iters
        self._step = make_sweep_step(geom, PhysicalProperties(),
                                     SolverControls(), device=device)

    def start(self, inputs):
        from openfoam_tpp_tpu_torch.core.state import CaseParams, SimState

        s = inputs["state"]
        f = inputs["forcing"]
        self.n_cases = int(s["t"].shape[0])
        state = SimState(step=torch.zeros(self.n_cases, dtype=torch.int32,
                                          device=s["t"].device), **s)
        self._params = CaseParams(orbit_radius=f["R"], omega=f["omega"],
                                  ramp_time=f["ramp_time"])
        return state

    def step(self, carry):
        state, diag = self._step(carry, self._params)
        return state, (state.t, diag.courant, diag.alpha_courant,
                       diag.p_iters, diag.p_residual, diag.alpha_min,
                       diag.alpha_max)

    @staticmethod
    def fields(carry) -> dict:
        return {k: getattr(carry, k) for k in ("alpha", "u", "v", "w", "p",
                                                "t", "dt")}


def build(config, device):
    return SweepSystem(config, device)
