"""Named injection points for deterministic concurrency/fault tests.

Copy of ``velox_tpu/common/testvalue.py``. Role parity:
``velox/common/testutil/TestValue.h:32-106`` — production code calls
``adjust("module::point", payload)``; tests register callbacks to pause,
mutate, or fail at precise spots. Disabled (zero-cost dict miss) unless a
test enables it.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_enabled = False
_callbacks: Dict[str, Callable] = {}
_lock = threading.Lock()


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    with _lock:
        _enabled = False
        _callbacks.clear()


def set_callback(point: str, fn: Callable):
    with _lock:
        _callbacks[point] = fn


def clear_callback(point: str):
    with _lock:
        _callbacks.pop(point, None)


def adjust(point: str, payload=None):
    """Call from production code at interesting points."""
    if not _enabled:
        return
    fn = _callbacks.get(point)
    if fn is not None:
        fn(payload)
