from openfoam_tpp_tpu_torch.mesh.geometry import (  # noqa: F401
    TankGeometry,
    build_tank_geometry,
    natural_shape,
)
