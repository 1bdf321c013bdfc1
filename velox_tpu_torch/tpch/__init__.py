from velox_tpu_torch.tpch.queries import tpch_plan  # noqa: F401
