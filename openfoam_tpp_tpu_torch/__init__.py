"""PyTorch/CUDA port of the openfoam_tpp_tpu two-phase sloshing solver.

Plain tensor code is PyTorch; every TPU Pallas kernel on the ported path
is a hand-written CUDA kernel (``csrc/``, built for sm_90a at first use).
Imports torch and numpy only.
"""

from openfoam_tpp_tpu_torch.config import (  # noqa: F401
    DEFAULTS,
    PhysicalProperties,
    SolverControls,
)
