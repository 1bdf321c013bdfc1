from velox_tpu_torch.parse.parser import parse_expression  # noqa: F401
