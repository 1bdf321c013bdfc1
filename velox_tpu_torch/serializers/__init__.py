from velox_tpu_torch.serializers.pages import (  # noqa: F401
    PageSerde, deserialize_page, serialize_page,
)
