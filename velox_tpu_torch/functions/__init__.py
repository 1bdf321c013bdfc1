from velox_tpu_torch.functions import registry  # noqa: F401
from velox_tpu_torch.functions import scalar  # noqa: F401
