"""Connector SPI: pluggable table providers.

Role parity: ``velox/connectors/Connector.h:193,407-472`` (Connector /
DataSource / DataSink / ConnectorSplit) with a process-wide registry.
A DataSource uploads each split onto the device its query names; a
DataSink (connectors/hive.py ``HiveDataSink``) takes device batches and
writes them to files on the host, and exec/writer.py drives it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from velox_tpu_torch import types as T
from velox_tpu_torch.vector.device import DeviceBatch, Dictionary


@dataclass(frozen=True)
class ConnectorSplit:
    """A unit of scan work. Parity: connectors/Connector.h ConnectorSplit."""
    connector_id: str


class DataSource:
    """Scan-side SPI. Parity: connectors/Connector.h:407."""

    def next(self, split: ConnectorSplit) -> Optional[DeviceBatch]:
        """Produce the next batch for `split`; None when exhausted."""
        raise NotImplementedError

    def dictionaries(self) -> Dict[str, Dictionary]:
        """Per-column string dictionaries, one per table and shared by all
        its batches, so dictionary ids compare across batches."""
        return {}


class DataSink:
    """Write-side SPI. Parity: connectors/Connector.h:444."""

    def append(self, batch: DeviceBatch) -> None:
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class Connector:
    """Parity: connectors/Connector.h:193."""

    def __init__(self, connector_id: str):
        self.connector_id = connector_id

    def create_data_source(self, table: str, columns, ctx) -> DataSource:
        raise NotImplementedError

    def table_schema(self, table: str) -> T.DataType:
        raise NotImplementedError

    def default_splits(self, table: str, ctx=None) -> List[ConnectorSplit]:
        """Splits covering the whole table (host engines normally supply
        splits; this is the single-process convenience path). ``ctx`` may
        ask for a split count (``scan.splits_per_table``)."""
        raise NotImplementedError


_CONNECTORS: Dict[str, Connector] = {}


def register_connector(connector: Connector):
    _CONNECTORS[connector.connector_id] = connector


def get_connector(connector_id: str) -> Connector:
    try:
        return _CONNECTORS[connector_id]
    except KeyError:
        raise KeyError(
            f"connector {connector_id!r} not registered "
            f"(have {sorted(_CONNECTORS)})") from None
