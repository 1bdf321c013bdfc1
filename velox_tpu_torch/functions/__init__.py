from velox_tpu_torch.functions import registry  # noqa: F401
from velox_tpu_torch.functions import scalar  # noqa: F401
from velox_tpu_torch.functions import datetime  # noqa: F401
from velox_tpu_torch.functions import complex  # noqa: F401
# the raw-string forms wrap names registered above: import them last
from velox_tpu_torch.functions import raw_strings  # noqa: F401
