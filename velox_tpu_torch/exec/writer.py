"""TableWriter operator.

Counterpart of ``velox_tpu/exec/writer.py`` (velox/exec/TableWriter.h:100):
drains its input into a connector DataSink and emits one summary row
(rows and bytes written, the target path) on the query's device.
"""

from __future__ import annotations

from typing import Optional

from velox_tpu_torch.connectors.connector import get_connector
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec.operator import Operator
from velox_tpu_torch.vector.device import DeviceBatch, from_arrow


class TableWriterOperator(Operator):
    def __init__(self, node: P.TableWriteNode, device):
        super().__init__(node)
        self._node = node
        self._device = device
        conn = get_connector(node.connector_id)
        kw = {}
        if node.file_format:
            kw["file_format"] = node.file_format
        if node.partition_keys or node.bucket_count:
            self.sink = conn.create_data_sink(
                node.target_path, partition_keys=node.partition_keys,
                bucket_count=node.bucket_count,
                bucket_keys=node.bucket_keys, **kw)
        else:
            self.sink = conn.create_data_sink(node.target_path, **kw)
        self._out: Optional[DeviceBatch] = None

    def add_input(self, batch):
        self.sink.append(batch)

    def no_more_input(self):
        import pyarrow as pa
        super().no_more_input()
        self.sink.close()
        summary = pa.table({
            "rows": pa.array([self.sink.rows_written], pa.int64()),
            "bytes": pa.array([self.sink.bytes_written], pa.int64()),
            "path": pa.array([self._node.target_path], pa.string()),
        })
        self._out = from_arrow(summary, device=self._device)

    def get_output(self):
        out, self._out = self._out, None
        return out

    def is_finished(self):
        return self._no_more_input and self._out is None
