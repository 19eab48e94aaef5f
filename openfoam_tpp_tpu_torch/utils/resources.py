"""Resource estimate of a case on one H100.

The port's own copy of openfoam_tpp_tpu/utils/resources.py (it imports
nothing of that package): the same API and formulas (cells → steps →
wall seconds and device bytes, and how many cases of a batched sweep fit
on the card), with constants measured on the card in place of the JAX
package's. Each was measured by chip_smoke.py (the phase named beside
it; phase 11 prints them all again, beside these values) on an NVIDIA
H100 80GB HBM3 at a 700.00 W power limit.
"""

from __future__ import annotations

import dataclasses
import math

# Fluid cells × steps per wall second of `run_case` on the 112³ flagship
# (1,029,504 fluid cells, 0.1 s simulated in 17 steps; phase 5): the whole
# case path, whose checkpoint and probe writes took 2.74 of its 3.38 s.
GPU_CELL_UPDATES_PER_SEC = 5.18e6
# Device bytes per fluid cell of one case: the peak of
# torch.cuda.max_memory_allocated over that run, above what was allocated
# before it (388,623,360 bytes), over its fluid cells.
BYTES_PER_CELL = 377.5
# Device bytes per fluid cell of a case in a batched sweep: the same peak
# over the 128-case `runsweep` of phase 7 (313,311,744 bytes, 2.45 MB a
# case), over the batch's 422,400 fluid cells.
SWEEP_BYTES_PER_CELL = 741.7
# torch.cuda.get_device_properties(0).total_memory of that card.
DEVICE_BYTES = 85_017_510_912


def estimate_cells(params: dict) -> int:
    """πr²H / mesh³ cells (reference formula, main.py:199-203)."""
    r = params["D"] / 2.0
    vol = math.pi * r * r * params["H"]
    if params.get("geo") == "cap":
        vol += (2.0 / 3.0) * math.pi * r ** 3
    return max(int(vol / params["mesh"] ** 3), 1)


def estimate_steps(params: dict) -> int:
    """Adaptive-dt step count estimate from the CFL bound: wave speed
    ~ max(orbit speed, sqrt(g·H/2)) at maxCo 0.5."""
    u = max(
        2.0 * math.pi * params["freq"] * params["R"],
        math.sqrt(9.81 * params["H"] / 2.0) * 0.5,
    )
    dt_cfl = 0.5 * params["mesh"] / max(u, 1e-9)
    dt = min(dt_cfl, 1.0)
    return max(int(params["duration"] / dt), 1)


@dataclasses.dataclass
class ResourceEstimate:
    n_cells: int
    n_steps: int
    wall_seconds: float
    memory_bytes: float
    cases_per_chip: int       # batched-sweep cases that fit on the card
    fits_on_chip: bool

    def summary(self) -> str:
        return (
            f"~{self.n_cells:,} cells, ~{self.n_steps:,} steps, "
            f"~{format_time(self.wall_seconds)} wall on one H100, "
            f"{self.memory_bytes / 1e9:.2f} GB device memory "
            f"(~{self.cases_per_chip} sweep cases/H100)"
        )


def estimate_resources(params: dict) -> ResourceEstimate:
    n_cells = estimate_cells(params)
    n_steps = estimate_steps(params)
    wall = n_cells * n_steps / GPU_CELL_UPDATES_PER_SEC
    mem = n_cells * BYTES_PER_CELL + 0.5e9
    per_case = n_cells * SWEEP_BYTES_PER_CELL
    cases = max(int((DEVICE_BYTES - 1e9) / max(per_case, 1)), 1)
    return ResourceEstimate(
        n_cells=n_cells,
        n_steps=n_steps,
        wall_seconds=wall,
        memory_bytes=mem,
        cases_per_chip=cases,
        fits_on_chip=mem < DEVICE_BYTES,
    )


def format_time(seconds: float) -> str:
    """hh:mm:ss (the helper the reference calls but never defines —
    main.py:243, a documented latent NameError)."""
    seconds = int(round(seconds))
    h, rem = divmod(seconds, 3600)
    m, s = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m{s:02d}s"
    if m:
        return f"{m}m{s:02d}s"
    return f"{s}s"
