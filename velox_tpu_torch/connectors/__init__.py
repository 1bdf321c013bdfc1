from velox_tpu_torch.connectors.connector import (  # noqa: F401
    Connector, ConnectorSplit, DataSource, get_connector,
    register_connector,
)
