from velox_tpu_torch.vector.device import (  # noqa: F401
    DeviceBatch,
    DeviceColumn,
    Dictionary,
    batch_from_numpy,
    default_capacity,
    from_arrow,
    to_arrow,
)
