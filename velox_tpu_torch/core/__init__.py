from velox_tpu_torch.core import expressions  # noqa: F401
