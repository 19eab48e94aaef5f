from openfoam_tpp_tpu_torch.core.motion import TableMotion, motion_from_numpy  # noqa: F401
from openfoam_tpp_tpu_torch.core.state import (  # noqa: F401
    CaseParams,
    SimState,
    init_state,
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
)
