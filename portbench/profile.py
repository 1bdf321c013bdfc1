"""Reading the profiler's record of the traced windows.

A traced run profiles the same whole streams twice with ``torch.profiler``
and reads both in memory, with no trace file:

* the device window: the profiler's CUDA activity alone, which records
  no host operator (with the CPU activity's recording of each one a
  bench5 stream took 1.56 times as long; with the CUDA activity alone it
  still takes 1.24-1.29 times, so the idle share takes the streams'
  length from the same streams unprofiled). It gives every device operation (kernel, copy,
  set) with its start and end. The harness marks the window's ends and
  each query's start on the device's own timeline with a tiny kernel
  (``mark``: ``torch.cuda._sleep``'s ``spin_kernel``), so the window and
  each idle stretch's query need no host clock. The device's idle share
  and its launches are read here. Without a card (the CPU tests) the
  window is the ``portbench.window`` range and each query's the
  ``portbench.query:<name>`` range that the harness opens.
* the layer window: the same streams under the CPU and CUDA activities
  and ``stack_ranges``, which reads
  the Python stack at each torch call the program makes on the harness's
  thread: the innermost frame of ``velox_tpu_torch`` names a module
  (``exec/join.py``), and the call runs inside a profiler range
  ``portbench.layer:<module>:<function>``. A device event names the host
  operator that launched it (``linked_correlation_id``), and the
  innermost ``portbench.layer`` range around that operator names the
  module; ``layers.json`` maps modules to layers, and names the
  hand-written kernels, which are launched through ``ctypes`` and are
  attributed by their kernel names. The host operators' recording and
  the stack walks slow the host, so this window gives the layers' shares
  of device-busy time and nothing that depends on the host's pace. (The profiler's own Python tracer,
  ``with_stack``, records every Python call: it slowed a traced power22
  stream threefold and took minutes to read.)
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench import stats

WINDOW = "portbench.window"
LAYER = "portbench.layer:"
QUERY = "portbench.query:"
MARK = "spin_kernel"
_MARK_CYCLES = 100


def mark(cuda: bool) -> None:
    """A mark on the device's timeline: a kernel that spins for a few
    cycles."""
    if cuda:
        import torch
        torch.cuda._sleep(_MARK_CYCLES)
LAYERS = json.loads((Path(__file__).resolve().parent / "metrics"
                     / "layers.json").read_text())
_PACKAGE = "velox_tpu_torch/"

Frame = Tuple[float, float, str, str]  # start, end, where, what


def stack_ranges():
    """A torch function mode that runs each torch call made from the
    program inside a range named after the innermost frame of
    ``velox_tpu_torch`` on the Python stack."""
    import sys

    import torch
    from torch.overrides import TorchFunctionMode
    ranged = torch._C._profiler._RecordFunctionFast
    names: Dict[object, Optional[str]] = {}

    class StackRanges(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            f = sys._getframe(1)
            while f is not None:
                code = f.f_code
                if code not in names:
                    i = code.co_filename.find(_PACKAGE)
                    names[code] = (None if i < 0 else LAYER
                                   + code.co_filename[i + len(_PACKAGE):]
                                   + ":" + code.co_name)
                if names[code] is not None:
                    with ranged(names[code]):
                        return func(*args, **(kwargs or {}))
                f = f.f_back
            return func(*args, **(kwargs or {}))

    return StackRanges()


@dataclass
class DeviceOp:
    name: str
    kernel: bool  # False for a copy or a set
    start: float  # seconds
    end: float
    layer: str


@dataclass
class Trace:
    ops: List[DeviceOp]
    window: Tuple[float, float]
    idle_labels: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self, layer: Optional[str] = None) -> float:
        return stats.covered((o.start, o.end) for o in self.ops
                             if layer is None or o.layer == layer)

    def kernels(self) -> int:
        return sum(o.kernel for o in self.ops)


def layer_of(module: Optional[str], name: str) -> str:
    """The layer of a device operation: hand-written kernels by name, the
    rest by the module that launched them."""
    if any(k in name for k in LAYERS["handwritten_kernels"]):
        return "kernels"
    for layer, prefixes in LAYERS["modules"].items():
        if module is not None and any(module.startswith(p)
                                      for p in prefixes):
            return layer
    return "other"


class _Last:
    """The last of the host's calls begun at or before each of a rising
    sequence of times."""

    def __init__(self, frames: List[Frame]):
        self.frames, self.i = sorted(frames), 0

    def at(self, t: float) -> Optional[Frame]:
        while self.i < len(self.frames) and self.frames[self.i][0] <= t:
            self.i += 1
        return self.frames[self.i - 1] if self.i else None


def build_trace(device: List[Tuple[str, float, float, Optional[str]]],
                window: Tuple[float, float],
                main_frames: List[Frame]) -> Trace:
    """A Trace from (name, start, end, launching module) of each device
    operation, the window, and the host's calls on the harness's thread
    (start, end, where, what); an idle stretch is labelled by the last
    call begun before it."""
    ops = [DeviceOp(name, not name.startswith(("Memcpy", "Memset")),
                    start, end, layer_of(module, name))
           for name, start, end, module in device]
    last = _Last(main_frames)
    labels = []
    for lo, hi in stats.gaps(((o.start, o.end) for o in ops), *window):
        f = last.at(lo)
        labels.append(("harness" if f is None else
                       f"{f[2]}: {f[3]}" if f[3] else f[2], hi - lo))
    return Trace(ops, window, labels)


def marked_trace(device: List[Tuple[str, float, float, Optional[str]]],
                 queries: List[str]) -> Trace:
    """The Trace of a window whose device operations hold the harness's
    marks: one at each end and one before each of ``queries``, in order.
    The marks are no operations of the program."""
    marks = sorted(start for name, start, _, _ in device if MARK in name)
    if len(marks) != len(queries) + 2:
        raise RuntimeError(f"{len(marks)} marks on the device's timeline "
                           f"for {len(queries)} queries")
    window = (marks[0], max(end for name, _, end, _ in device
                            if MARK in name))
    starts = [(t, t, q, "") for t, q in zip(marks[1:-1], queries)]
    return build_trace([d for d in device if MARK not in d[0]], window,
                       starts)


def from_profiler(result, queries: Optional[List[str]] = None) -> Trace:
    """The Trace of a finished profiler's results
    (``profile().profiler.kineto_results``): over ``stack_ranges`` each
    device operation has its module and each idle stretch the program's
    function. Where the device's timeline holds the harness's marks (the
    device window), they give the window and each idle stretch's query,
    one of ``queries``; without a card, the harness's ranges do."""
    from torch._C._profiler import _EventType
    from torch.autograd import DeviceType
    op_module: Dict[int, str] = {}
    calls: Dict[int, List[Frame]] = {}
    window, main = None, None
    # (event, innermost layer module, query, directly inside a query range)
    todo = [(e, None, None, False) for e in result.experimental_event_tree()]
    while todo:
        e, module, query, top = todo.pop()
        inner = False
        if e.tag == _EventType.TorchOp:
            if e.name.startswith(LAYER):
                module, _, function = e.name[len(LAYER):].rpartition(":")
                calls.setdefault(e.start_tid, []).append(
                    (e.start_time_ns * 1e-9, e.end_time_ns * 1e-9, module,
                     function))
            elif e.name.startswith(QUERY):
                query, inner = e.name[len(QUERY):], True
            elif e.name == WINDOW:
                window = (e.start_time_ns * 1e-9, e.end_time_ns * 1e-9)
                main = e.start_tid
            elif module is not None:
                op_module[e.correlation_id] = module
            elif top:
                calls.setdefault(e.start_tid, []).append(
                    (e.start_time_ns * 1e-9, e.end_time_ns * 1e-9, query,
                     e.name))
        todo.extend((c, module, query, inner) for c in e.children)
    # the device's events but the harness's ranges, which the profiler
    # mirrors onto the device's timeline
    device = [(k.name(), k.start_ns() * 1e-9, k.end_ns() * 1e-9,
               op_module.get(k.linked_correlation_id()))
              for k in result.events()
              if k.device_type() == DeviceType.CUDA
              and not k.name().startswith("portbench.")
              and not k.is_user_annotation()]
    if any(MARK in d[0] for d in device):
        return marked_trace(device, queries or [])
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW} range")
    return build_trace(device, window, calls.get(main, []))


def breakdown(trace: Trace) -> Dict:
    """The ten device operations that took most time, by name, and the
    ten longest idle stretches with what the host was doing."""
    by_name: Dict[str, float] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_labels, key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
