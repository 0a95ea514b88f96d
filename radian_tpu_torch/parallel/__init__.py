from radian_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    data_sharding,
    replicated_sharding,
    model_row_devices,
    param_shardings,
)
