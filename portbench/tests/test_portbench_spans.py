"""portbench/spans.py on synthetic device operations, launch records and
spans with known attributions, and the span readers."""

from types import SimpleNamespace

import pytest

from portbench_support import REPO  # noqa: F401  (puts the repo on the path)
from portbench import harness, spans as S

MAIN, PRODUCER = 0x7F00_1234_5678, 0x7F00_9999_0000
TIDS = {MAIN: 118, PRODUCER: 131}  # the system's thread ids


def span(name, layer, start, end, thread=MAIN):
    return SimpleNamespace(name=name, layer=layer, start=start, end=end,
                           thread=thread, tid=TIDS[thread])


def _spans():
    """Two queries on the harness's thread, 10-40 and 60-90, and a scan
    producer's read on another thread."""
    return [
        span("query", "task", 10, 40),
        span("Aggregation[2].add_input", "agg", 12, 30),
        span("group_reduce", "agg", 14, 20),
        span("radix_sort", "sort", 15, 18),
        span("query", "task", 60, 90),
        span("HashJoin[5].get_output", "join", 62, 80),
        span("TableScan[0].produce", "scan", 61, 70, PRODUCER),
    ]


def _trace(ops, launches):
    return S.attribute(
        [S.DeviceOp(n, a, b, c) for n, a, b, c in ops],
        {c: S.Launch(t & S.THREAD_BITS, at) for c, (t, at) in
         launches.items()},
        _spans(), (0, 100), MAIN, [(5, "q1"), (55, "q3")])


def test_an_operation_goes_to_the_innermost_span_at_its_launch():
    t = _trace([("where", 20, 24, 1), ("scan_kernel", 25, 27, 2),
                ("cummax", 64, 70, 3), ("Memcpy HtoD", 70, 72, 4)],
               {1: (MAIN, 16), 2: (MAIN, 19), 3: (MAIN, 63),
                4: (PRODUCER, 65)})
    assert [o[2] for o in t.ops] == ["sort", "agg", "join", "scan"]
    assert t.in_span_share() == pytest.approx(100.0)
    assert t.launches_found == 1.0 and t.threads_matched == 1.0
    # each operation starts after its span opened
    assert t.early_ns == 0 and t.early == []


def test_the_clock_check_names_an_operation_begun_before_its_span():
    ms = 1_000_000
    t = _trace([("early", 16 * ms, 17 * ms, 1)], {1: (MAIN, 16 * ms)})
    # the launch at 16 ms falls in no span (the spans are in ns): harness
    assert t.early == []
    spans = [span("query", "task", 10 * ms, 40 * ms)]
    t = S.attribute([S.DeviceOp("k", 9 * ms, 11 * ms, 1)],
                    {1: S.Launch(MAIN & S.THREAD_BITS, 12 * ms)}, spans,
                    (0, 50 * ms), MAIN)
    assert t.early_ns == ms
    assert t.early == [(ms, 3 * ms, "k", "task:query", 2 * ms)]


def test_a_launch_may_name_the_system_thread_id():
    t = _trace([("where", 20, 24, 1), ("Memcpy HtoD", 70, 72, 4)],
               {1: (TIDS[MAIN], 16), 4: (TIDS[PRODUCER], 65)})
    assert [o[2] for o in t.ops] == ["sort", "scan"]
    assert t.threads_matched == 1.0


def test_handwritten_kernels_keep_their_layer_by_name():
    t = _trace([("void radix_hist_kernel<int>(...)", 20, 22, 1)],
               {1: (MAIN, 16)})
    assert t.ops[0][2] == "kernels" and t.ops[0][3]


def test_an_operation_without_a_span_goes_to_the_harness():
    t = _trace([("marked", 50, 52, 1), ("lost", 53, 54, 2)],
               {1: (MAIN, 45)})
    assert [o[2] for o in t.ops] == ["harness", "harness"]
    assert t.in_span_share() == 0.0
    assert t.launches_found == 0.5


def test_idle_stretches_between_queries_go_to_the_harness():
    t = _trace([("a", 16, 50, 1), ("b", 61, 63, 2)],
               {1: (MAIN, 15), 2: (MAIN, 61)})
    # idle: 0-16 (before any query), 50-61 (q1 over, q3 not made) from
    # the harness; 63-100 opens inside the join's get_output
    gaps = {label: sec for label, sec in t.idle_gaps()}
    assert gaps == pytest.approx({"harness": 16e-9, "q1 harness": 11e-9,
                                  "q3 join:HashJoin[5].get_output": 37e-9})
    shares = t.idle_shares()
    assert shares["harness"] == pytest.approx(100.0 * 27 / 64)
    assert shares["join"] == pytest.approx(100.0 * 37 / 64)


def test_idle_shares_and_the_harness_add_up_to_100():
    t = _trace([("a", 11, 13, 1), ("b", 21, 22, 2), ("c", 31, 35, 3),
                ("d", 62, 64, 4)],
               {1: (MAIN, 11), 2: (MAIN, 19), 3: (MAIN, 31), 4: (MAIN, 62)})
    shares = t.idle_shares()
    assert set(shares) == set(S.SPAN_LAYERS) | {"harness"}
    assert sum(shares.values()) == pytest.approx(100.0)
    reading = S.SpanReading(None, None, {}, 2, 1.0, t)
    read = {lay: harness.read_metric(f"{lay}.idle_share", reading)
            for lay in S.SPAN_LAYERS}
    assert sum(read.values()) + shares["harness"] == pytest.approx(100.0)
    assert read == pytest.approx({k: shares[k] for k in S.SPAN_LAYERS})


def test_device_shares_by_span():
    t = _trace([("w", 20, 24, 1), ("x", 22, 26, 2), ("y", 64, 68, 3)],
               {1: (MAIN, 16), 2: (MAIN, 21), 3: (MAIN, 63)})
    reading = S.SpanReading(None, None, {}, 2, 1.0, t)
    # busy: 20-26 and 64-68 (10); sort 20-24, agg 22-26, join 64-68
    assert harness.read_metric("sort.device_share_by_span", reading) \
        == pytest.approx(40.0)
    assert harness.read_metric("agg.device_share_by_span", reading) \
        == pytest.approx(40.0)
    assert harness.read_metric("join.device_share_by_span", reading) \
        == pytest.approx(40.0)
    assert harness.read_metric("expr.device_share_by_span", reading) == 0.0


SPAN_METRICS = [f"{lay}.device_share_by_span"
                for lay in ("expr", "agg", "join", "sort")] + [
    f"{lay}.idle_share" for lay in S.SPAN_LAYERS]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_run_without_spans_reads_none(name):
    """The harness's own Reading has no spans: the readers return None,
    not 0, and so does a span reading whose window recorded none."""
    plain = harness.Reading(None, None, {}, 2, 1.0)
    assert harness.read_metric(name, plain) is None
    assert harness.read_metric(name, S.SpanReading(
        None, None, {}, 2, 1.0, None)) is None


class _Event:
    def __init__(self, name, device, start, end, corr, resource=0,
                 annotation=False):
        self._v = (name, device, start, end, corr, resource, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_from_profiler_reads_launches_and_leaves_out_marks():
    from torch.autograd import DeviceType
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    tid = MAIN & S.THREAD_BITS
    events = [
        _Event(mark, cuda, 0, 1, 90), _Event(mark, cuda, 5, 6, 91),
        _Event("cudaLaunchKernel", cpu, 16, 17, 7, tid),
        _Event("Lazy Function Loading", cpu, 16, 17, 7),
        _Event("where", cuda, 20, 24, 7),
        _Event("cudaMemcpyAsync", cpu, 65, 66, 8, PRODUCER & S.THREAD_BITS),
        _Event("Memcpy HtoD", cuda, 70, 72, 8),
        _Event("portbench.query:q3", cuda, 56, 90, 0, annotation=True),
        # a host read on the harness's thread, by its system thread id
        _Event("cudaStreamSynchronize", cpu, 23, 30, 9, TIDS[MAIN]),
    ]
    t = S.from_profiler(SimpleNamespace(events=lambda: events), _spans(),
                        (0, 100), [(5, "q1"), (55, "q3")], MAIN)
    assert t.window == (0, 100)
    assert [o[2] for o in t.ops] == ["sort", "scan"]
    assert t.kernels == 1
    calls = {label: (call, sec) for label, _, call, sec in t.gap_calls()}
    assert calls["q1 agg:Aggregation[2].add_input"] == (
        "cudaStreamSynchronize", pytest.approx(7e-9))
    assert calls["harness"] == (None, None)
    # idle: 0-20, 24-70 (from inside q1's add_input), 72-100 (q3's join)
    assert dict(t.idle_gaps()) == pytest.approx({
        "harness": 20e-9, "q1 agg:Aggregation[2].add_input": 46e-9,
        "q3 join:HashJoin[5].get_output": 28e-9})


def test_the_programs_own_spans_attribute():
    """Spans recorded from a real query on the CPU: an operation launched
    in the middle of each operator-phase span goes to that span's layer."""
    import threading

    from velox_tpu_torch.common import process_trace as PT
    from velox_tpu_torch.exec.task import QueryCtx, Task
    from velox_tpu_torch.testing.plan_builder import PlanBuilder
    import numpy as np
    import pyarrow as pa
    t = pa.table({"g": np.arange(400, dtype="int64") % 3,
                  "v": np.arange(400, dtype="int64")})
    plan = (PlanBuilder().values([t.slice(0, 200), t.slice(200)])
            .filter("v > 10").single_aggregation(["g"], ["sum(v) as s"])
            .plan())
    PT.start_recording()
    try:
        Task(plan, QueryCtx("cpu")).run()
    finally:
        recorded = PT.stop_recording()
    phases = [s for s in recorded if "].add_input" in s.name]
    assert phases
    me = threading.get_ident()
    ops = [S.DeviceOp(s.name, (s.start + s.end) // 2, s.end, i)
           for i, s in enumerate(phases)]
    launches = {i: S.Launch(me & S.THREAD_BITS, (s.start + s.end) // 2)
                for i, s in enumerate(phases)}
    q = next(s for s in recorded if s.name == "query")
    trace = S.attribute(ops, launches, recorded, (q.start, q.end), me)
    inner = S.Innermost(recorded)
    assert [o[2] for o in trace.ops] == [
        inner.at((s.start + s.end) // 2).layer for s in phases]
    assert {o[2] for o in trace.ops} <= {"agg", "expr"}
    assert sum(trace.idle_shares().values()) == pytest.approx(100.0)


def test_an_idle_stretch_is_set_on_the_hosts_clock():
    """The device's timestamps run 3 ms ahead of the host's (each
    operation starts before its own launch): the stretch between them
    began, on the host's clock, inside the aggregation's add_input."""
    ms = 1_000_000
    spans = [span("query", "task", 5 * ms, 40 * ms),
             span("Aggregation[2].add_input", "agg", 10 * ms, 20 * ms)]
    ops = [S.DeviceOp("a", 9 * ms, 9 * ms + ms // 2, 1),
           S.DeviceOp("b", 24 * ms, 24 * ms + ms // 5, 2)]
    launches = {1: S.Launch(MAIN & S.THREAD_BITS, 12 * ms),
                2: S.Launch(MAIN & S.THREAD_BITS, 27 * ms)}
    t = S.attribute(ops, launches, spans, (9 * ms, 25 * ms), MAIN)
    assert t.idle_gaps()[0] == ["agg:Aggregation[2].add_input",
                                pytest.approx(14.5e-3)]
    assert [o[2] for o in t.ops] == ["agg", "task"]
    assert t.early_ns == ms and len(t.early) == 1
