from openfoam_tpp_tpu_torch.mesh.geometry import (  # noqa: F401
    TankGeometry,
    build_box_geometry,
    build_chamfer_tank_geometry,
    build_tank_geometry,
    chamfer_tank_volume,
    natural_shape,
)
