"""Fault-injecting connector wrapper.

Counterpart of ``velox_tpu/connectors/faulty.py``. Role parity:
``velox/common/file/tests/FaultyFileSystem.h:33,85-103`` — a wrapper that
injects per-operation errors/delays, used to test operator error handling
and retries without a real flaky filesystem.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from velox_tpu_torch.connectors.connector import Connector, DataSource


class FaultyDataSource(DataSource):
    def __init__(self, inner: DataSource, hook: Callable):
        self._inner = inner
        self._hook = hook

    def dictionaries(self):
        return self._inner.dictionaries()

    def next(self, split):
        self._hook("next", split)
        return self._inner.next(split)


class FaultyConnector(Connector):
    """Wraps another connector; `hook(op, arg)` runs before every data
    operation and may raise (error injection) or sleep (delay injection)."""

    def __init__(self, inner: Connector, connector_id: str = "faulty"):
        super().__init__(connector_id)
        self.inner = inner
        self._hook: Optional[Callable] = None

    def set_fault_hook(self, hook: Callable):
        self._hook = hook

    def clear_fault_hook(self):
        self._hook = None

    def _fire(self, op, arg):
        if self._hook is not None:
            self._hook(op, arg)

    def table_schema(self, table):
        return self.inner.table_schema(table)

    def create_data_source(self, table, columns, ctx):
        self._fire("create_data_source", table)
        src = self.inner.create_data_source(table, columns, ctx)
        return FaultyDataSource(src, self._fire)

    def default_splits(self, table, ctx=None):
        self._fire("splits", table)
        return self.inner.default_splits(table, ctx)


def delay_hook(seconds: float) -> Callable:
    return lambda op, arg: time.sleep(seconds)


def error_hook(error: Exception, ops=("next",)) -> Callable:
    def hook(op, arg):
        if op in ops:
            raise error
    return hook
