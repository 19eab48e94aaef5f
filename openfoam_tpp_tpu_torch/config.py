"""Global defaults, physical properties and solver controls.

The port's own copy of ``openfoam_tpp_tpu/config.py``: the same schema,
fields and defaults, so a configuration means the same thing in both
packages. The rationale of each default is documented there.
"""

from __future__ import annotations

import dataclasses

# Parameter schema of a case (reference manager DEFAULTS):
#   H tank height [m], D tank diameter [m], mesh cell size [m],
#   geo 'flat' | 'cap', R orbital radius [m], freq shaking frequency [Hz],
#   duration simulated time [s], dt initial step [s],
#   ramp soft-start duration [s] (negative => 10% of duration), n_cpus (unused).
DEFAULTS = {
    "H": 0.1,
    "D": 0.02,
    "mesh": 0.002,
    "geo": "flat",
    "R": 0.003,
    "freq": 2.0,
    "duration": 10.0,
    "dt": 0.001,
    "ramp": -1,
    "n_cpus": 1,
}

GRAVITY = 9.81  # m/s^2, along -z


@dataclasses.dataclass(frozen=True)
class PhysicalProperties:
    """Two-phase incompressible properties (phase1 = water, phase2 = air)."""

    rho1: float = 998.2     # water density [kg/m^3]
    rho2: float = 1.0       # air density [kg/m^3]
    nu1: float = 1.0e-6     # water kinematic viscosity [m^2/s]
    nu2: float = 1.48e-5    # air kinematic viscosity [m^2/s]
    sigma: float = 0.0      # surface tension [N/m]
    g: float = GRAVITY

    @property
    def mu1(self) -> float:
        return self.rho1 * self.nu1

    @property
    def mu2(self) -> float:
        return self.rho2 * self.nu2


@dataclasses.dataclass(frozen=True)
class SolverControls:
    """Numerical controls (controlDict + fvSolution of the reference)."""

    max_co: float = 0.5
    max_alpha_co: float = 0.5
    max_dt: float = 1.0
    dt_growth: float = 1.2
    n_alpha_subcycles: int = 3
    n_limiter_iters: int = 3
    c_alpha: float = 1.0
    p_tol_rel: float = 1e-3
    p_tol_abs: float = 1e-8
    p_tol_rel_b: float = 3e-4
    p_max_iters: int = 50
    write_interval: float = 0.05
    use_pallas: bool = False     # in the port: run the hand-written CUDA
                                 # kernels (ops/kernels/) on CUDA tensors;
                                 # on CPU tensors their plain versions
    batch_lanes: bool = False    # vmapped sweeps; not ported yet
    n_correctors: int = 1
    dev2_stress: bool = True
    precond_refresh: int = 1
    max_diff_co: float = 0.25
    max_capillary_co: float = 1.0
    fct_bf16: bool = True        # bf16 λ/anti streams on the kernel path
    csf_curvature: str = "blend"
    mom_pallas: bool | None = None  # None = follow use_pallas; False pins
                                    # the fused momentum, finish and
                                    # correction kernels off
