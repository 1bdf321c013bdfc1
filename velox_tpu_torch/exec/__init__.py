from velox_tpu_torch.exec.task import QueryCtx, Task  # noqa: F401
