"""The port's spans (common/process_trace.py) on the CPU: recording is off
unless started; a query's spans nest in its query span, share its id and
carry their layers; the layers' self times add up to the query; the span
clock is the profiler's; and the operator walls are their spans."""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from velox_tpu_torch.common import process_trace as PT
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.connectors.tpch import TpchConnector
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan

torch.set_num_threads(1)

CONNECTOR = "tpch-spans"
# the layer of each operator class the TPC-H plans below drive
OPERATOR_LAYERS = {
    "TableScan": "scan", "FilterProject": "expr", "Limit": "expr",
    "Aggregation": "agg", "StreamingAggregation": "agg", "FilterSum": "agg",
    "HashJoin": "join", "MergeJoin": "join", "NestedLoopJoin": "join",
    "OrderBy": "sort", "TopN": "sort",
}
PHASES = ("add_input", "get_output", "finish", "build_input", "build_finish")


@pytest.fixture(scope="module", autouse=True)
def _connector():
    register_connector(TpchConnector(CONNECTOR, 0.01, 1 << 14))


def _recorded(plan, config=None):
    Task(plan, QueryCtx("cpu", config)).run()  # warm: the scan cache fills
    PT.start_recording()
    try:
        task = Task(plan, QueryCtx("cpu", config))
        task.run()
    finally:
        spans = PT.stop_recording()
    return task, spans


def _self_ns(span, children):
    """The span's length less the part its children cover."""
    covered, end = 0, span.start
    for c in sorted(children, key=lambda c: c.start):
        lo, hi = max(c.start, end), min(c.end, span.end)
        if hi > lo:
            covered += hi - lo
            end = hi
    return span.end - span.start - covered


def test_recording_is_off_by_default():
    assert not PT.recording()
    Task(tpch_plan(6, connector_id=CONNECTOR), QueryCtx("cpu")).run()
    assert PT.stop_recording() == []


@pytest.mark.parametrize("q", [1, 3], ids=["q1_aggregation", "q3_join"])
def test_spans_nest_in_their_query_and_carry_their_layers(q):
    _, spans = _recorded(tpch_plan(q, connector_id=CONNECTOR))
    queries = [s for s in spans if s.name == "query"]
    assert len(queries) == 1
    (query,) = queries
    assert query.layer == "task" and query.query == query.id
    assert query.parent is None
    assert (query.thread, query.tid) == (threading.get_ident(),
                                         threading.get_native_id())
    by_id = {s.id: s for s in spans}
    kinds = set()
    for s in spans:
        assert s.query == query.id, s
        assert query.start <= s.start <= s.end <= query.end, s
        if s is not query:
            parent = by_id[s.parent]
            assert parent.start <= s.start and s.end <= parent.end, s
        kind, _, phase = s.name.partition("[")
        if phase:
            assert phase.split(".")[-1] in PHASES, s
            assert s.layer == OPERATOR_LAYERS[kind], s
            assert s.node_id and f"[{s.node_id}]" in s.name
            kinds.add(kind)
    assert {"TableScan", "Aggregation"} <= kinds
    if q == 3:
        assert "HashJoin" in kinds
        assert any(s.name.endswith(".build_finish") for s in spans)

    # the layers' self times add up to the query's span
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    by_layer = {}
    for s in spans:
        by_layer[s.layer] = by_layer.get(s.layer, 0) + _self_ns(
            s, children.get(s.id, []))
    total = query.end - query.start
    assert abs(sum(by_layer.values()) - total) <= 0.01 * total
    assert by_layer["agg"] > 0 and by_layer["scan"] > 0


def test_calls_into_other_layers_open_their_own_spans():
    """The group-by's reduce (agg) and the expressions (expr) run inside
    the aggregation's phases; Q3's sort keys reach the radix sort."""
    _, spans = _recorded(tpch_plan(3, connector_id=CONNECTOR))
    layer = {s.name: s.layer for s in spans}
    assert layer.get("group_reduce") == "agg"
    assert layer.get("eval") == "expr"
    assert layer.get("chain") == "expr"
    assert layer.get("radix_sort") == "sort"


def test_the_scan_producer_spans_carry_the_query():
    _, spans = _recorded(tpch_plan(1, connector_id=CONNECTOR),
                         {QC.SCAN_PREFETCH_DEPTH: 2})
    (query,) = [s for s in spans if s.name == "query"]
    produced = [s for s in spans if s.name.endswith(".produce")]
    waits = [s for s in spans if s.name.endswith(".wait")]
    assert produced and waits
    assert all(s.thread != query.thread and s.parent == query.id
               and s.query == query.id and s.layer == "scan"
               for s in produced)
    assert all(s.thread == query.thread for s in waits)


def test_span_clock_is_the_profilers():
    """A profiler range opened inside a span lies within it on the
    profiler's timeline, to 50 microseconds."""
    spans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with PT.Span(PT.site("query")) as s:
                with record_function(f"spans.clock.{i}"):
                    torch.ones(64).sum()
            spans.append(s)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("spans.clock.")}
    assert len(ranges) == 5
    for i, s in enumerate(spans):
        e = ranges[f"spans.clock.{i}"]
        assert s.start - 50_000 <= e.start_ns() <= e.end_ns() \
            <= s.end + 50_000, (s.start, s.end, e.start_ns(), e.end_ns())


def test_operator_walls_are_their_spans():
    task, spans = _recorded(tpch_plan(3, connector_id=CONNECTOR))
    length = {}
    for s in spans:
        length[s.name] = length.get(s.name, 0) + s.end - s.start
    for op in task.operators:
        st = op.stats
        kind = st.operator_type.removesuffix("Operator")
        stem = f"{kind}[{st.plan_node_id}]"
        assert st.add_input_wall_ns == length.get(f"{stem}.add_input", 0)
        assert st.get_output_wall_ns == length.get(f"{stem}.get_output", 0)
        assert st.finish_wall_ns == length.get(f"{stem}.finish", 0)
        assert st.build_wall_ns == length.get(f"{stem}.build_finish", 0)
    assert any(op.stats.build_wall_ns for op in task.operators)


def test_sites_are_built_per_operator_not_per_call(monkeypatch):
    """With recording off the driver builds no label per call: as many
    sites for 24 batches as for 2."""
    made = []
    init = PT.Site.__init__

    def counting(self, *args, **kwargs):
        made.append(args[0])
        init(self, *args, **kwargs)
    monkeypatch.setattr(PT.Site, "__init__", counting)
    rng = np.random.RandomState(3)
    t = pa.table({"g": rng.randint(0, 4, 2400).astype("int64"),
                  "v": rng.randint(0, 100, 2400).astype("int64")})

    def sites(n):
        made.clear()
        step = t.num_rows // n
        Task(PlanBuilder().values([t.slice(i * step, step)
                                   for i in range(n)])
             .filter("v > 10")
             .single_aggregation(["g"], ["sum(v) as s"]).plan(),
             QueryCtx("cpu")).run()
        return sorted(made)
    assert sites(24) == sites(2)


def test_threads_record_without_losing_a_span():
    """More threads than cores open nested spans while recording, with a
    short switch interval: every span is recorded once, with a unique id
    and its thread's parent, and every stack ends empty."""
    import sys
    outer, inner = PT.site("Aggregation", "1", "add_input"), \
        PT.site("group_reduce")
    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    PT.start_recording()
    try:
        def work():
            for _ in range(n_spans):
                with PT.Span(outer):
                    with PT.Span(inner):
                        pass
            assert PT.current() is None
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        spans = PT.stop_recording()
        sys.setswitchinterval(interval)
    assert len(spans) == 2 * n_threads * n_spans
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "group_reduce":
            assert by_id[s.parent].thread == s.thread
            assert by_id[s.parent].name == outer.name
        else:
            assert s.parent is None
    assert not [ln for ln in PT.status_lines() if "group_reduce" in ln]
