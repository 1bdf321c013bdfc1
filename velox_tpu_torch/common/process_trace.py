"""Spans: what every thread of the engine is doing, and, while recording,
when each layer's host code ran.

Role parity: ``velox/common/process/TraceContext.h:54,70`` (a registry of
what every thread is doing, queryable as a status line for stuck-process
debugging) and ``TraceHistory`` (a per-thread ring buffer of recent
entries), grown into the port's one span recorder.

A ``Span`` (``TraceContext`` is the same class) is opened and closed
around a piece of host work: a query (``Task.run``), an operator's
``add_input``/``get_output``/``finish``, a join's build, a scan's wait
for its prefetch queue or its producer's split, and the calls into
another layer's module from inside an operator (a fused chain, an
expression set, a radix sort, a group-by's reduce, a merge-rank, a hash
table's insert or lookup rounds, a sort's key words, the rank table of
an unsorted dictionary). Each thread keeps its open spans on a stack
and its last ``HISTORY_DEPTH`` openings in a ring, without a lock:
``status_lines()`` names each live thread's innermost span and
``recent()`` a thread's last openings.

*Recording* is off by default. ``start_recording()`` ... ``stop_recording()``
returns every span closed in between, from every thread: its name, its
layer (``LAYERS``), its plan node id, its thread, its start and end in
nanoseconds,
its own id, the id of the span that caused it (the span it opened
inside, or the one named as its cause on another thread) and the id of
its query (the query span's own id, shared by every span opened under
it). A closed span is appended to one list; the hot path takes no lock.

*The clock* is ``time.time_ns()``: the Unix-epoch nanoseconds that
``torch.profiler`` stamps its host events and its CUDA runtime records
with, so a span can be set directly against a device trace of the same
window (tests/test_torch_spans.py holds a profiler range inside a span
within it).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

HISTORY_DEPTH = 16

# the span clock (see the module docstring)
clock = time.time_ns

# The layer of every span, by its kind: an operator's class name without
# ``Operator``, or the name of a call into a layer's module. The layers
# are portbench/metrics/layers.json's; ``task`` is the query's own work
# (plan set-up, the join's dynamic filter, the error check, ``to_arrow``).
LAYERS: Dict[str, str] = {
    "query": "task",
    # operator phases
    "TableScan": "scan", "Values": "scan", "ArrowStream": "scan",
    "Exchange": "scan",
    "FilterProject": "expr", "Limit": "expr", "Unnest": "expr",
    "Expand": "expr", "GroupId": "expr", "AssignUniqueId": "expr",
    "EnforceSingleRow": "expr",
    "Aggregation": "agg", "StreamingAggregation": "agg", "FilterSum": "agg",
    "MarkDistinct": "agg",
    "HashJoin": "join", "MergeJoin": "join", "NestedLoopJoin": "join",
    "OrderBy": "sort", "TopN": "sort", "Window": "sort", "RowNumber": "sort",
    "TopNRowNumber": "sort",
    "TableWriter": "task", "PartitionedOutput": "task",
    "LocalPartition": "task",
    # calls into another layer's module from inside an operator
    "chain": "expr", "eval": "expr",
    "radix_sort": "sort", "sort_keys": "sort", "dictionary_rank": "sort",
    "group_reduce": "agg",
    "merge_rank": "join", "hash_insert": "join", "hash_lookup": "join",
}


class Site:
    """Where spans open: a name, its layer and its plan node id, built
    once (per operator phase, per call site), never per call."""

    __slots__ = ("name", "layer", "node_id", "root")

    def __init__(self, name: str, layer: str, node_id: str = "",
                 root: bool = False):
        self.name, self.layer, self.node_id = name, layer, node_id
        self.root = root  # a query: its spans' query id is its own id

    def __str__(self) -> str:
        return self.name


def site(kind: str, node_id: str = "", phase: str = "") -> Site:
    """The site of a span of ``kind`` (a key of ``LAYERS``); for an
    operator phase, named ``Kind[node id].phase``."""
    name = f"{kind}[{node_id}].{phase}" if phase else kind
    return Site(name, LAYERS.get(kind, "task"), node_id,
                root=kind == "query")


class OperatorSites:
    """An operator's phase sites, built when the Task starts driving it."""

    __slots__ = ("add_input", "get_output", "finish")

    def __init__(self, operator_type: str, node_id: str):
        kind = operator_type.removesuffix("Operator")
        self.add_input = site(kind, node_id, "add_input")
        self.get_output = site(kind, node_id, "get_output")
        self.finish = site(kind, node_id, "finish")


class _Thread:
    """One thread's open spans and recent openings."""

    __slots__ = ("name", "ident", "native", "stack", "history")

    def __init__(self):
        t = threading.current_thread()
        self.name, self.ident, self.native = t.name, t.ident, t.native_id
        self.stack: List[Span] = []
        self.history: deque = deque(maxlen=HISTORY_DEPTH)


_local = threading.local()
_threads: Dict[int, _Thread] = {}   # thread ident -> its state
_register_lock = threading.Lock()   # taken once a thread, and to list them
_ids = itertools.count(1)
_sink: Optional[List["Span"]] = None  # the recording's list, or None


def _thread() -> _Thread:
    try:
        return _local.state
    except AttributeError:
        st = _local.state = _Thread()
        with _register_lock:
            _threads[st.ident] = st
        return st


class Span:
    """A scoped span (parity: process::TraceContext RAII).

    >>> with Span(site("HashJoin", "3", "add_input")) as s:
    ...     ...
    >>> s.end - s.start  # host nanoseconds

    ``site`` is a ``Site`` or, for a label alone, a string (layer
    ``task``). ``cause`` names the span that caused this one when it
    opens on another thread (a scan's producer); ``start`` backdates the
    opening (a query opens when its Task is made). ``id``, ``parent``,
    ``query``, ``thread`` (``threading.get_ident()``) and ``tid`` (the
    system's thread id) are set only while recording."""

    __slots__ = ("site", "start", "end", "id", "parent", "query", "thread",
                 "tid", "_cause", "_sink", "_stack")

    def __init__(self, site, cause: Optional["Span"] = None,
                 start: Optional[int] = None):
        self.site = site if isinstance(site, Site) else Site(site, "task")
        self._cause = cause
        self.start = start
        self.end = None
        self.id = self.parent = self.query = self.thread = self.tid = None

    @property
    def name(self) -> str:
        return self.site.name

    @property
    def layer(self) -> str:
        return self.site.layer

    @property
    def node_id(self) -> str:
        return self.site.node_id

    def __enter__(self) -> "Span":
        st = _thread()
        stack = st.stack
        sink = self._sink = _sink
        if sink is not None:
            up = self._cause if self._cause is not None else (
                stack[-1] if stack else None)
            self.id = next(_ids)
            self.parent = up.id if up is not None else None
            self.query = self.id if self.site.root else (
                up.query if up is not None else None)
            self.thread, self.tid = st.ident, st.native
        if self.start is None:
            self.start = clock()
        stack.append(self)
        st.history.append(self)
        self._stack = stack
        return self

    def __exit__(self, *exc) -> bool:
        self.end = clock()
        self._stack.pop()
        if self._sink is not None:
            self._sink.append(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.site.layer}:{self.site.name}, id={self.id}, "
                f"parent={self.parent}, query={self.query})")


TraceContext = Span


def spanned(kind: str):
    """Decorate a function of a layer's module: each call runs inside a
    span of ``kind`` (a key of ``LAYERS``)."""
    s = site(kind)

    def deco(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with Span(s):
                return fn(*args, **kwargs)
        return call
    return deco


def current() -> Optional[Span]:
    """This thread's innermost open span, or None."""
    stack = _thread().stack
    return stack[-1] if stack else None


def start_recording() -> None:
    """Record every span closed from now on, on every thread."""
    global _sink
    _sink = []


def stop_recording() -> List[Span]:
    """Stop recording; return the spans closed since ``start_recording``
    (none if it was not called)."""
    global _sink
    spans, _sink = _sink, None
    return list(spans or ())


def recording() -> bool:
    return _sink is not None


def status_lines() -> List[str]:
    """One line per live traced thread: its innermost span and for how
    long it has been open. Parity: TraceContext::statusLine()."""
    now = clock()
    out = []
    with _register_lock:
        threads = sorted(_threads.items())
    for ident, st in threads:
        stack = list(st.stack)
        if stack:
            s = stack[-1]
            out.append(f"{st.name}: {s.site} ({(now - s.start) / 1e9:.1f}s)")
    return out


def recent(thread_ident: Optional[int] = None) -> List[str]:
    """Last span openings of one thread (default: current).
    Parity: process::TraceHistory ring buffer."""
    st = _threads.get(thread_ident or threading.current_thread().ident)
    if st is None:
        return []
    return [f"{s.site} @{s.start / 1e9:.3f}" for s in list(st.history)]
