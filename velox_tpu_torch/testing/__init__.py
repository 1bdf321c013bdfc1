from velox_tpu_torch.testing.plan_builder import PlanBuilder  # noqa: F401
