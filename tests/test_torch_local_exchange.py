"""The port's multi-driver local exchange against the JAX reference, on
the CPU.

Counterparts of tests/test_local_exchange.py and of the four
local-exchange and prefetch tests of tests/test_threaded_faults.py; the
reference's build-side fault under a LocalPartition, shown and not
copied; LocalMerge; the launch counters under concurrent threads.
"""

import threading
import time

import pytest
import torch

from velox_tpu.connectors.connector import (
    register_connector as jregister_connector,
)
from velox_tpu.connectors.tpch import TpchConnector as JTpchConnector
from velox_tpu.core.config import QueryConfig as JQC
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu_torch.common import testvalue as TV
from velox_tpu_torch.connectors.connector import register_connector
from velox_tpu_torch.connectors.tpch import TpchConnector
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.ops import count_launch
from velox_tpu_torch.testing.plan_builder import PlanBuilder

torch.set_num_threads(1)


def _tpch(rows_per_split):
    """Both engines' "tpch" connectors at SF 0.01 with this split size."""
    jregister_connector(JTpchConnector("tpch", 0.01, rows_per_split))
    register_connector(TpchConnector("tpch", 0.01, rows_per_split))


@pytest.fixture()
def conn8k():
    _tpch(8192)


@pytest.fixture()
def conn4k():
    _tpch(4096)


@pytest.fixture()
def _tv():
    TV.enable()
    yield
    TV.disable()


def _threads():
    return {t.name for t in threading.enumerate()}


def _wait_no_new_threads(before):
    deadline = time.time() + 10
    while time.time() < deadline and _threads() - before:
        time.sleep(0.05)
    assert not (_threads() - before), "leaked threads"


def _run(build, n_drivers, **cfg):
    """(reference rows, port rows) of ``build(builder)`` with ``n_drivers``
    local exchange drivers."""
    want = JTask(build(JPlanBuilder), JQueryCtx(
        {JQC.LOCAL_EXCHANGE_DRIVERS: n_drivers, **cfg})).run()
    got = Task(build(PlanBuilder), QueryCtx(
        "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: n_drivers, **cfg})).run()
    return want, got


def _q1_style(B):
    b = B()
    b.table_scan("lineitem", ["l_returnflag", "l_quantity"])
    b.partial_aggregation(["l_returnflag"],
                          ["sum(l_quantity) as sq", "count() as c"])
    b.local_partition()
    b.final_aggregation()
    return b.plan()


def _sorted(t, key):
    return t.sort_by(key).to_pylist()


# ---------------------------------------------------------------------------
# tests/test_local_exchange.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3])
def test_multi_driver_matches_inline(conn8k, n):
    want, got = _run(_q1_style, n)
    inline = Task(_q1_style(PlanBuilder), QueryCtx(
        "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 0})).run()
    assert _sorted(got, "l_returnflag") == _sorted(inline, "l_returnflag")
    assert _sorted(got, "l_returnflag") == _sorted(want, "l_returnflag")


def test_abandoned_consumer_does_not_hang(conn8k):
    """A Limit over a multi-driver exchange: producers stop at the queue's
    stop signal instead of blocking forever."""
    before = _threads()
    want, got = _run(lambda B: B().table_scan("lineitem", ["l_orderkey"])
                     .local_partition().limit(100).plan(), 2)
    assert got.num_rows == want.num_rows == 100
    _wait_no_new_threads(before)


def test_producer_error_propagates(conn8k):
    def build(B):
        return (B().table_scan("lineitem", ["l_orderkey", "l_quantity"])
                .project(["l_orderkey % 0 as boom"])  # checked division
                .local_partition().plan())
    with pytest.raises(Exception):
        JTask(build(JPlanBuilder),
              JQueryCtx({JQC.LOCAL_EXCHANGE_DRIVERS: 2})).run()
    with pytest.raises(Exception, match="checked operation"):
        Task(build(PlanBuilder),
             QueryCtx("cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 2})).run()


# ---------------------------------------------------------------------------
# tests/test_threaded_faults.py
# ---------------------------------------------------------------------------

class Boom(Exception):
    pass


def _scan_partition_plan(n_drivers):
    b = PlanBuilder()
    b.table_scan("lineitem", ["l_orderkey", "l_quantity"])
    b.local_partition()
    b.single_aggregation([], ["count() as c"])
    return b.plan(), QueryCtx("cpu", {QC.LOCAL_EXCHANGE_DRIVERS: n_drivers})


def test_producer_fails_while_sibling_blocked(conn4k, _tv):
    """Producer 1 raises while producer 0 is held at the injection point:
    the consumer raises the error (no hang) once it has joined both
    drivers, and no thread outlives the task. Five trials, each holding
    producer 0 for at most 1 s (the reference holds it 10 s): the join
    waits out the hold, which is the point, since a driver that outlived
    its task would launch work during the next query."""
    for trial in range(5):
        release = threading.Event()
        state = {"held": False}

        def cb(payload):
            i, _ = payload
            if i == 0 and not state["held"]:
                state["held"] = True
                release.wait(1)
            if i == 1:
                raise Boom(f"trial {trial}")

        TV.set_callback("LocalPartition::produce", cb)
        plan, ctx = _scan_partition_plan(2)
        before = _threads()
        t0 = time.time()
        with pytest.raises(Boom, match=f"trial {trial}"):
            try:
                Task(plan, ctx).run()
            finally:
                release.set()
        assert time.time() - t0 < 30, "consumer hung"
        TV.clear_callback("LocalPartition::produce")
        _wait_no_new_threads(before)


def test_consumer_cancel_releases_blocked_producers(conn4k):
    """A Limit abandons the exchange while producers are mid-stream; the
    queue's stop signal releases them. Five trials."""
    for _ in range(5):
        b = PlanBuilder()
        b.table_scan("lineitem", ["l_orderkey"])
        b.local_partition()
        b.limit(10)
        before = _threads()
        out = Task(b.plan(), QueryCtx(
            "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 3})).run()
        assert out.num_rows == 10
        _wait_no_new_threads(before)


def test_prefetch_fault_surfaces_cleanly(conn4k, _tv):
    """A failure inside the scan's prefetch thread surfaces as the query's
    error, not a hang. Three trials."""
    for trial in range(3):
        fired = {"n": 0}

        def cb(split):
            fired["n"] += 1
            if fired["n"] == 2:  # fail on the second split
                raise Boom("prefetch")

        TV.set_callback("TableScan::prefetch", cb)
        b = PlanBuilder()
        b.table_scan("lineitem", ["l_orderkey"])
        b.single_aggregation([], ["count() as c"])
        t0 = time.time()
        with pytest.raises(Boom, match="prefetch"):
            Task(b.plan(), QueryCtx(
                "cpu", {QC.SCAN_PREFETCH_DEPTH: 2})).run()
        assert time.time() - t0 < 30
        TV.clear_callback("TableScan::prefetch")


def test_prefetch_abandoned_by_limit(conn4k):
    """A Limit abandons the scan; its prefetch producer stops instead of
    blocking on the full queue."""
    before = _threads()
    b = PlanBuilder()
    b.table_scan("lineitem", ["l_orderkey"])
    b.limit(5)
    out = Task(b.plan(), QueryCtx("cpu", {QC.SCAN_PREFETCH_DEPTH: 2})).run()
    assert out.num_rows == 5
    _wait_no_new_threads(before)


# ---------------------------------------------------------------------------
# The reference's build-side fault under a LocalPartition (ROADMAP C)
# ---------------------------------------------------------------------------

def _join_count(B):
    b = B()
    orders = b.new_builder().table_scan("orders", ["o_orderkey"])
    return (b.table_scan("lineitem", ["l_orderkey"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["l_orderkey"])
            .local_partition()
            .single_aggregation([], ["count() as n"]).plan())


def test_join_under_local_partition_reads_every_build_split(conn8k):
    """Each driver probes its slice of lineitem against every order: the
    count is lineitem's 60,213 rows with 2 and 3 drivers as with 0. The
    reference builds each driver from its slice of orders too: 33,773
    rows with 2 drivers, and with 3 (orders has 2 splits) a driver with
    no build split raises."""
    inline = Task(_join_count(PlanBuilder), QueryCtx(
        "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 0})).run().to_pylist()
    assert inline == [{"n": 60213}]
    for n in (2, 3):
        got = Task(_join_count(PlanBuilder), QueryCtx(
            "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: n})).run().to_pylist()
        assert got == inline
    want = JTask(_join_count(JPlanBuilder), JQueryCtx(
        {JQC.LOCAL_EXCHANGE_DRIVERS: 2})).run().to_pylist()
    assert want == [{"n": 33773}]
    with pytest.raises(RuntimeError, match="empty build side"):
        JTask(_join_count(JPlanBuilder), JQueryCtx(
            {JQC.LOCAL_EXCHANGE_DRIVERS: 3})).run()


def test_drivers_share_one_build(conn8k):
    """The drivers of a join under a LocalPartition build once: the build
    side's splits are read once in all."""
    from velox_tpu_torch.common import metrics as M

    def splits_read():
        return M.reporter().snapshot()["counters"].get(M.K_SCAN_SPLITS, 0)
    conn = TpchConnector("tpch", 0.01, 8192)
    n_split = {t: len(conn.default_splits(t))
               for t in ("lineitem", "orders")}
    before = splits_read()
    Task(_join_count(PlanBuilder), QueryCtx(
        "cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 3})).run()
    assert splits_read() - before == n_split["lineitem"] + n_split["orders"]


def test_right_join_under_many_drivers_raises(conn8k):
    """A right join emits its unmatched build rows once; with a shared
    build and several probers that needs one prober to see every match,
    so the port raises instead of emitting them once per driver."""
    b = PlanBuilder()
    orders = b.new_builder().table_scan("orders", ["o_orderkey"])
    plan = (b.table_scan("lineitem", ["l_orderkey"])
            .hash_join(["l_orderkey"], ["o_orderkey"], orders,
                       output=["o_orderkey"], join_type="right")
            .local_partition()
            .single_aggregation([], ["count() as n"]).plan())
    with pytest.raises(NotImplementedError, match="right join"):
        Task(plan, QueryCtx("cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 2})).run()
    one = Task(plan, QueryCtx("cpu", {QC.LOCAL_EXCHANGE_DRIVERS: 1})).run()
    assert one.to_pylist() == [{"n": 60213}]


@pytest.mark.parametrize("n", [0, 2])
def test_local_merge_equals_reference(conn8k, n):
    """A LocalMerge over a multi-driver exchange restores the order."""
    def build(B):
        return (B().table_scan("orders", ["o_orderkey", "o_custkey"])
                .local_partition()
                .local_merge(["o_custkey", "o_orderkey DESC"]).plan())
    want, got = _run(build, n)
    assert got.num_rows == 15000
    assert got.to_pylist() == want.cast(got.schema).to_pylist()


def test_count_launch_is_atomic():
    def wrapper():
        pass
    wrapper.launches = 0

    def work():
        for _ in range(20000):
            count_launch(wrapper)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrapper.launches == 160000
