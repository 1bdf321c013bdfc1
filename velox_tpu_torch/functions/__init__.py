from velox_tpu_torch.functions import registry  # noqa: F401
from velox_tpu_torch.functions import scalar  # noqa: F401
from velox_tpu_torch.functions import datetime  # noqa: F401
from velox_tpu_torch.functions import misc  # noqa: F401
from velox_tpu_torch.functions import complex  # noqa: F401
from velox_tpu_torch.functions import sparksql  # noqa: F401
from velox_tpu_torch.functions import strings_ext  # noqa: F401
# spark_batch3 aliases names registered above (regexp_like, json_extract,
# any_match, ...): import it after them
from velox_tpu_torch.functions import spark_batch3  # noqa: F401
from velox_tpu_torch.functions import url_ip  # noqa: F401
# the raw-string forms wrap names registered above: import them last
from velox_tpu_torch.functions import raw_strings  # noqa: F401
