"""Thread-state process tracing.

Role parity: ``velox/common/process/TraceContext.h:54,70`` (a registry of
what every thread is doing, queryable as a status line for stuck-process
debugging) and ``TraceHistory`` (a per-thread ring buffer of recent
entries). Used by the Task driver around operator calls so a hung query
can be diagnosed from another thread: ``status_lines()`` shows each live
thread's current operator and how long it has been there;
``recent(thread)`` shows the last N transitions.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

_lock = threading.Lock()
_current: Dict[int, tuple] = {}          # thread id -> (label, t0)
_history: Dict[int, deque] = {}          # thread id -> ring buffer
_names: Dict[int, str] = {}
HISTORY_DEPTH = 16


class TraceContext:
    """Scoped thread-state label (parity: process::TraceContext RAII).

    >>> with TraceContext("HashJoin[3] add_input"):
    ...     ...
    """

    __slots__ = ("label", "_tid")

    def __init__(self, label: str):
        self.label = label

    def __enter__(self):
        t = threading.current_thread()
        self._tid = t.ident
        with _lock:
            _names[self._tid] = t.name
            _current[self._tid] = (self.label, time.time())
            _history.setdefault(
                self._tid, deque(maxlen=HISTORY_DEPTH)).append(
                (self.label, time.time()))
        return self

    def __exit__(self, *exc):
        with _lock:
            _current.pop(self._tid, None)
        return False


def status_lines() -> List[str]:
    """One line per live traced thread: what it runs and for how long.
    Parity: TraceContext::statusLine()."""
    now = time.time()
    with _lock:
        return [
            f"{_names.get(tid, tid)}: {label} ({now - t0:.1f}s)"
            for tid, (label, t0) in sorted(_current.items())
        ]


def recent(thread_ident: Optional[int] = None) -> List[str]:
    """Last transitions of one thread (default: current).
    Parity: process::TraceHistory ring buffer."""
    tid = thread_ident or threading.current_thread().ident
    with _lock:
        return [f"{label} @{t0:.3f}"
                for label, t0 in _history.get(tid, ())]
