"""The program's spans set against the device's timeline.

The program records spans (``velox_tpu_torch.common.process_trace``)
while ``start_recording()`` is on: each has its thread, its start and end
on the clock that ``torch.profiler`` stamps its host records with, its
layer and its name. A *span window* runs whole streams under the
profiler's CUDA activity alone, as the harness's device window does, and
records the program's spans over it; its ends and each query's start are
stamped on the same host clock. The CUDA activity records each CUDA
runtime call (the launch of a kernel, a copy or a set) with its host
time, its thread and the correlation id that its device operation
carries. So:

* each device operation goes to the innermost span that was open on the
  launching thread when it was launched, and takes that span's layer; the
  hand-written kernels B1-B5, launched through ``ctypes``, keep the
  ``kernels`` layer by name (``metrics/layers.json``), as in the layer
  window. An operation launched outside every span goes to ``harness``;
* each idle stretch of the window goes to the innermost span open on the
  harness's thread when the stretch began, or to ``harness`` outside
  every span (between queries, before the first). The stretch's start is
  set on the host's clock by the launches around it (``BUCKET_NS``).

The readers ``metrics/<layer>.device_share_by_span.py`` and
``metrics/<layer>.idle_share.py`` read ``reading.spans`` (a ``SpanTrace``)
and return None where a reading carries none.

    python -m portbench.spans --workload <cell> --seed <n> [--seconds <s>]

runs one cell on the card: its set-up, the harness's traced window (the
device window and the layer window, with its stack-read shares), then
span windows with recording off and on in turns (off, on, on, off), and
prints one JSON object: the span metrics beside the stack-read shares,
the share of busy time launched inside a program span, the idle stretches
labelled by query and span, the windows' walls per stream with recording
on and off, the clock check, and the check of every answer against the
plain reference. A window whose kernels a query fall short of the device
window's count by more than 1% lost records (CUPTI drops a stretch of
them now and then) and is left out of the span metrics.
"""

from __future__ import annotations

import bisect
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import profile as P
from portbench import stats
from portbench.harness import Reading

HARNESS = "harness"
KERNELS = "kernels"
# A CUDA runtime record names its launching thread by the low 32 bits of
# ``threading.get_ident()`` (pthread_self), or, once a profiler session
# in the process has had the CPU activity, by the system's thread id: a
# span's thread is known by both.
THREAD_BITS = 0xFFFFFFFF
SPAN_LAYERS = ("task", "scan", "expr", "agg", "join", "sort")
CLOCK_NS = 50_000  # the clock check's tolerance
# The profiler's device timestamps can run ahead of its host ones by a
# few milliseconds for a stretch of a window (operations that start
# before their own launch). An idle stretch is set on the host's clock by
# the least lead of an operation's start over its launch in its 10 ms
# (and the neighbouring ones): that operation was launched into an idle
# device, so its lead is the offset, give or take the launch latency.
BUCKET_NS = 10_000_000


@dataclass
class DeviceOp:
    name: str
    start: int  # ns, on the profiler's clock
    end: int
    correlation: int


@dataclass
class Launch:
    thread: int  # the launching thread's id (THREAD_BITS)
    at: int  # ns


class Innermost:
    """The innermost of one thread's spans open at a time: spans on one
    thread nest, so it is the open span begun last."""

    def __init__(self, spans: Iterable):
        # (start, end, span), outer first where two begin together
        spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.times: List[int] = []
        self.spans: List[Optional[object]] = []
        stack: List = []

        def close_until(t):
            while stack and stack[-1].end <= t:
                end = stack.pop().end
                self._step(end, stack[-1] if stack else None)

        for s in spans:
            close_until(s.start)
            stack.append(s)
            self._step(s.start, s)
        close_until(float("inf"))

    def _step(self, t, span) -> None:
        if self.times and self.times[-1] == t:
            self.spans[-1] = span
        else:
            self.times.append(t)
            self.spans.append(span)

    def at(self, t: int):
        i = bisect.bisect_right(self.times, t) - 1
        return self.spans[i] if i >= 0 else None


def _label(span) -> str:
    return f"{span.layer}:{span.name}"


@dataclass
class SpanTrace:
    """A span window: each device operation's interval and layer, and
    each idle stretch with its layer and label."""
    window: Tuple[int, int]
    ops: List[Tuple[int, int, str, bool]]  # start, end, layer, in a span
    idle: List[Tuple[int, int, str, str]]  # start, end, layer, label
    # the most that an operation started before the span it was put down
    # to opened, in ns (0 when none did): the clock check
    early_ns: int = 0
    # the operations that did so by more than CLOCK_NS: (by how much,
    # before their own launch by how much, name, span label, duration)
    early: List[Tuple[int, int, str, str, int]] = field(default_factory=list)
    # shares of the operations whose launch record was found, and of
    # those whose launching thread recorded spans
    launches_found: float = 0.0
    threads_matched: float = 0.0
    kernels: int = 0  # kernels in the window (copies and sets are not)
    # (start, end, name) of the CUDA runtime calls on the harness's thread
    calls: List[Tuple[int, int, str]] = field(default_factory=list)

    def busy_s(self, layer: Optional[str] = None) -> float:
        return 1e-9 * stats.covered((a, b) for a, b, lay, _ in self.ops
                                    if layer is None or lay == layer)

    def in_span_share(self) -> float:
        """The share of busy time launched inside a program span, in %."""
        busy = self.busy_s()
        if busy <= 0:
            return 0.0
        return 100.0 * 1e-9 * stats.covered(
            (a, b) for a, b, _, inside in self.ops if inside) / busy

    def idle_s(self, layer: Optional[str] = None) -> float:
        return 1e-9 * sum(b - a for a, b, lay, _ in self.idle
                          if layer is None or lay == layer)

    def idle_shares(self) -> Dict[str, float]:
        """Each layer's share of the window's idle time, ``harness``
        included, in %."""
        total = self.idle_s()
        return {lay: 100.0 * self.idle_s(lay) / total if total else 0.0
                for lay in SPAN_LAYERS + (HARNESS,)}

    def idle_gaps(self, top: int = 10) -> List[List]:
        """The longest idle stretches, each with its label."""
        return [[label, 1e-9 * (b - a)] for a, b, _, label in
                sorted(self.idle, key=lambda g: g[0] - g[1])[:top]]

    def gap_calls(self, top: int = 10) -> List[List]:
        """The longest idle stretches, each with its label, its seconds,
        and the CUDA runtime call that the harness's thread was in when
        it began (None outside one) with that call's seconds."""
        starts = [c[0] for c in self.calls]
        out = []
        for a, b, _, label in sorted(self.idle,
                                     key=lambda g: g[0] - g[1])[:top]:
            i = bisect.bisect_right(starts, a) - 1
            c = self.calls[i] if i >= 0 and self.calls[i][1] > a else None
            out.append([label, 1e-9 * (b - a), c and c[2],
                        c and 1e-9 * (c[1] - c[0])])
        return out


def attribute(ops: Sequence[DeviceOp], launches: Dict[int, Launch],
              spans: Sequence, window: Tuple[int, int], harness_thread: int,
              query_marks: Sequence[Tuple[int, str]] = ()) -> SpanTrace:
    """Put each device operation and each idle stretch of ``window`` down
    to a span. ``spans`` have ``thread``, ``tid``, ``start``, ``end``,
    ``layer`` and ``name``; ``launches`` maps an operation's correlation
    id to its launch; ``query_marks`` are (time, query) of each query's
    start, which lead each idle stretch's label."""
    by_thread: Dict[int, List] = {}
    for s in spans:
        for key in {s.thread & THREAD_BITS, s.tid} - {None}:
            by_thread.setdefault(key, []).append(s)
    index = {t: Innermost(ss) for t, ss in by_thread.items()}
    kernels = P.LAYERS["handwritten_kernels"]
    out, early, found, matched, early_ops = [], 0, 0, 0, []
    lead: Dict[int, int] = {}  # 10 ms stretch -> least start - launch
    for o in ops:
        launch = launches.get(o.correlation)
        span = None
        if launch is not None:
            found += 1
            b = o.start // BUCKET_NS
            lead[b] = min(lead.get(b, o.start - launch.at),
                          o.start - launch.at)
            inner = index.get(launch.thread & THREAD_BITS)
            if inner is not None:
                matched += 1
                span = inner.at(launch.at)
        if span is not None:
            early = max(early, span.start - o.start)
            if span.start - o.start > CLOCK_NS:
                early_ops.append((span.start - o.start, launch.at - o.start,
                                  o.name, _label(span), o.end - o.start))
        layer = KERNELS if any(k in o.name for k in kernels) else (
            span.layer if span is not None else HARNESS)
        out.append((o.start, o.end, layer, span is not None))
    def host(lo, hi):
        near = [lead[b] for b in range(lo // BUCKET_NS - 1,
                                       hi // BUCKET_NS + 2) if b in lead]
        return lo - min(near) if near else lo

    main = index.get(harness_thread & THREAD_BITS, Innermost(()))
    mark_times = [t for t, _ in query_marks]
    idle = []
    for lo, hi in stats.gaps(((a, b) for a, b, _, _ in out), *window):
        at = host(lo, hi)
        span = main.at(at)
        i = bisect.bisect_right(mark_times, at) - 1
        query = query_marks[i][1] + " " if i >= 0 else ""
        if span is None:
            idle.append((lo, hi, HARNESS, query + HARNESS))
        else:
            idle.append((lo, hi, span.layer, query + _label(span)))
    return SpanTrace(window, out, idle, early,
                     sorted(early_ops, reverse=True),
                     found / len(ops) if ops else 0.0,
                     matched / found if found else 0.0)


def from_profiler(result, spans: Sequence, window: Tuple[int, int],
                  query_starts: Sequence[Tuple[int, str]],
                  harness_thread: int) -> SpanTrace:
    """The SpanTrace of a finished span window's profiler results
    (``profile().profiler.kineto_results``): ``window`` and the
    (time, query) of each query's start are host-clock stamps, on the
    clock of the spans and of the profiler's records. The harness's marks
    (``profile.mark``) are no operations of the program."""
    from torch.autograd import DeviceType
    ops, launches, calls = [], {}, []
    for k in result.events():
        name = k.name()
        if k.device_type() == DeviceType.CUDA:
            if P.MARK not in name and not name.startswith("portbench.") \
                    and not k.is_user_annotation():
                ops.append(DeviceOp(name, k.start_ns(), k.end_ns(),
                                    k.correlation_id()))
        elif name.startswith("cu") and k.device_resource_id():
            # a CUDA runtime or driver call: its resource is its thread
            launches[k.correlation_id()] = Launch(k.device_resource_id(),
                                                  k.start_ns())
            calls.append((k.start_ns(), k.end_ns(), name,
                          k.device_resource_id() & THREAD_BITS))
    trace = attribute(ops, launches, spans, window, harness_thread,
                      query_starts)
    trace.kernels = sum(not o.name.startswith(("Memcpy", "Memset"))
                        for o in ops)
    me = {harness_thread & THREAD_BITS} | {
        s.tid for s in spans if s.thread == harness_thread}
    trace.calls = sorted(c[:3] for c in calls if c[3] in me)
    return trace


@dataclass
class SpanReading(Reading):
    """A harness Reading that carries a span window's ``SpanTrace``."""
    spans: Optional[SpanTrace] = None


def span_window(run, n: int, record: bool):
    """``n`` whole streams under the profiler's CUDA activity, each
    query's start stamped on the host's clock, with the program's spans
    recorded or not: (answers, the window's host seconds, SpanTrace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from velox_tpu_torch.common import process_trace as PT
    got, starts = [], []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = PT.clock()
        if record:
            PT.start_recording()
        try:
            for _ in range(n):
                for i, (q, _) in enumerate(run.stream):
                    starts.append((PT.clock(), q))
                    got.append(run.query(i))
            torch.cuda.synchronize()
        finally:
            spans = PT.stop_recording() if record else []
        t1 = PT.clock()
    trace = from_profiler(prof.profiler.kineto_results, spans, (t0, t1),
                          starts, threading.get_ident())
    return got, 1e-9 * (t1 - t0), trace


def main(argv=None) -> int:
    import argparse

    import torch

    from portbench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the streams' unprofiled seconds (default: the "
                    "mix's trace_seconds)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA card", file=sys.stderr)
        return 2
    bench, cell, cfg, mix = harness.load_cell(args.workload)
    run = harness.Run(cell, cfg, mix, args.seed, "cuda:0")
    run.setup()
    seconds = args.seconds or mix.get("trace_seconds", 3)
    for attempt in range(3):
        try:
            answers, reading = run.traced_window(seconds)
            break
        except RuntimeError as e:  # its device window lost a mark
            if attempt == 2:
                raise
            print(f"portbench.spans: {e}; the traced window again",
                  file=sys.stderr)
    # the same number of whole streams unprofiled and in each window
    n = len(answers) // (3 * len(run.plans))
    names = [m["name"] for m in bench["per_layer"]]
    out = {"workload": args.workload, "seed": args.seed, "streams": n,
           "device": harness.device_info(True, 1),
           "stack_read": {m: harness.read_metric(m, reading)
                          for m in names}}
    walls: Dict[str, List[float]] = {"off": [], "on": []}
    plain: Dict[str, List[float]] = {"off": [], "on": []}
    traces, kernels = [], []
    from velox_tpu_torch.common import process_trace as PT
    for record in (False, True, True, False):
        key = "on" if record else "off"
        got, window_s, trace = span_window(run, n, record)
        answers += got
        walls[key].append(window_s / n)
        kernels.append(trace.kernels / len(got))
        if record:
            traces.append(trace)
        # the same streams unprofiled, recording as in this window
        if record:
            PT.start_recording()
        t0 = time.perf_counter()
        answers += run.streams(n)
        torch.cuda.synchronize()
        plain[key].append((time.perf_counter() - t0) / n)
        PT.stop_recording()
    # a window that lost records (see the module docstring) is left out
    want = reading.device.kernels() / reading.queries
    complete = [abs(k - want) <= 1e-2 * want for k in kernels]
    out["complete"] = complete
    traces = [t for t, ok in zip(traces, complete[1:3]) if ok] or traces
    trace = traces[0]
    span_metrics = sorted(
        p.stem for p in (harness.HERE / "metrics").glob("*.py")
        if p.stem.endswith(("_by_span", ".idle_share"))
        and p.stem != "device.idle_share")
    out["spans"] = [{m: harness.read_metric(m, SpanReading(
        reading.device, reading.layers, reading.counters, reading.queries,
        reading.plain_s, t)) for m in span_metrics} for t in traces]
    out["in_span_share"] = [t.in_span_share() for t in traces]
    out["idle_shares"] = [t.idle_shares() for t in traces]
    out["idle_share_sum"] = [sum(t.idle_shares().values()) for t in traces]
    out["early_us"] = [1e-3 * t.early_ns for t in traces]
    out["early_ops"] = [[len(t.early), t.early[:3]] for t in traces]
    out["launches_found"] = [t.launches_found for t in traces]
    out["threads_matched"] = [t.threads_matched for t in traces]
    out["idle_gaps"] = trace.gap_calls()
    out["window_s_per_stream"] = walls
    out["kernels_per_query"] = kernels
    out["plain_s_per_stream"] = plain
    numbers = run.check(answers)
    lim = cfg["correct_limits"]
    out["correct"] = all(numbers[k] <= lim[k] for k in numbers) and all(
        a.table is not None for a in answers)
    out["check"] = numbers
    out["answers"] = len(answers)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
