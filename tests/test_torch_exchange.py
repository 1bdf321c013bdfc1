"""The port's multi-fragment exchange against the JAX reference, on the CPU.

Counterparts of every test of tests/test_exchange.py and
tests/test_exchange_net.py, of test_approx_percentile_merge.py's split
through an exchange and of test_threaded_faults.py's socket teardown:
several Tasks in one process (or two processes over TCP) wired by task
ids, each plan run in both engines over the same seeded inputs, each
destination's rows compared (the two engines' hashes are equal bit for
bit, so a row lands on the same destination in both). Also: a
``hive_bucket`` destination holds the rows of the port's Hive bucket file
of the same number, TPC-H Q1 as two fragments with the producer's
dictionaries, and a producer Task on a thread feeding consumer Tasks.
"""

import glob
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from velox_tpu import types as JT
from velox_tpu.core import expressions as Jex
from velox_tpu.core import plan as JP
from velox_tpu.exec import exchange as JX
from velox_tpu.exec.task import QueryCtx as JQueryCtx
from velox_tpu.exec.task import Task as JTask
from velox_tpu.serializers import PageSerde as JPageSerde
from velox_tpu.testing.plan_builder import PlanBuilder as JPlanBuilder
from velox_tpu.tpch import tpch_plan as jax_tpch_plan
from velox_tpu.vector.device import to_arrow as jto_arrow
from velox_tpu_torch import types as T
from velox_tpu_torch.common import testvalue as TV
from velox_tpu_torch.common.errors import VeloxError
from velox_tpu_torch.core import expressions as ex
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.exec import exchange as X
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.serializers import PageSerde
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.vector.device import to_arrow

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent

REF = SimpleNamespace(
    T=JT, ex=Jex, P=JP, X=JX, PB=JPlanBuilder, to_arrow=jto_arrow,
    serde=JPageSerde, task=lambda plan, cfg: JTask(plan, JQueryCtx(cfg)))
PORT = SimpleNamespace(
    T=T, ex=ex, P=P, X=X, PB=PlanBuilder, to_arrow=to_arrow,
    serde=lambda: PageSerde(device="cpu"),
    task=lambda plan, cfg: Task(plan, QueryCtx("cpu", cfg)))
ENGINES = {"ref": REF, "port": PORT}


def _rows(t: pa.Table, keys):
    return t.to_pandas().sort_values(keys).reset_index(drop=True)


def _pages(E, task_id, dest):
    """Every page of a destination, as one pandas frame per page."""
    pages, at_end = E.X.OutputBufferManager.instance().get(task_id).get(
        dest, 0)
    serde = E.serde()
    return [E.to_arrow(serde.deserialize(p)).to_pandas() for p in pages], \
        at_end


def _shuffle_agg(E, tag, dfs, aggs, inter_names, final_aggs):
    """Two producers (PARTIAL aggregation -> PartitionedOutput by g) and
    two consumers (Exchange -> FINAL): each consumer's rows."""
    n_producers, n_consumers = 2, 2
    producer_ids = []
    for p in range(n_producers):
        b = E.PB()
        b.values([pa.table(d) for d in dfs[p::n_producers]])
        b.partial_aggregation(["g"], aggs)
        pout = E.P.PartitionedOutputNode(
            f"pout-{p}", source=b.plan(), kind="partitioned",
            keys=(E.ex.field("g", E.T.BIGINT),),
            num_partitions=n_consumers)
        tid = f"{tag}-producer-{p}"
        producer_ids.append(tid)
        assert E.task(pout, {"task.id": tid}).run().num_rows == 0  # sink
    inter = E.T.row(["g"] + inter_names,
                    [E.T.BIGINT] * (1 + len(inter_names)))
    results = []
    for dst in range(n_consumers):
        exch = E.P.ExchangeNode("ex", row_type=inter)
        final = E.P.AggregationNode(
            "fin", source=exch, step=E.P.AggregationStep.FINAL,
            grouping_keys=(E.ex.field("g", E.T.BIGINT),),
            aggregate_names=tuple(n for n, _ in final_aggs),
            aggregates=tuple(E.P.AggregateCall(*c(E)) for _, c in final_aggs))
        results.append(E.task(final, {"exchange.ex.tasks": producer_ids,
                                      "task.destination": dst}).run())
    for tid in producer_ids:
        E.X.OutputBufferManager.instance().remove(tid)
    return results


def test_partitioned_shuffle_two_stage_aggregation():
    rng = np.random.RandomState(4)
    dfs = [pd.DataFrame({
        "g": rng.randint(0, 40, 800).astype("int64"),
        "v": rng.randint(0, 100, 800).astype("int64")})
        for _ in range(4)]
    final = [("s", lambda E: ("sum", (E.ex.field("v", E.T.BIGINT),),
                              E.T.BIGINT)),
             ("c", lambda E: ("count", (), E.T.BIGINT))]
    out = {k: _shuffle_agg(E, f"shuffle-{k}", dfs,
                           ["sum(v) as s", "count() as c"], ["s", "c"],
                           final)
           for k, E in ENGINES.items()}
    # each destination holds the same groups in both engines
    for want, got in zip(out["ref"], out["port"]):
        assert _rows(got, ["g"]).equals(_rows(want, ["g"]))
    got = pd.concat([t.to_pandas() for t in out["port"]]) \
        .sort_values("g").reset_index(drop=True)
    exp = pd.concat(dfs).groupby("g").v.agg(["sum", "size"]).reset_index()
    np.testing.assert_array_equal(got.g, exp.g)
    np.testing.assert_array_equal(got.s, exp["sum"])
    np.testing.assert_array_equal(got.c, exp["size"])
    gs = [set(r.column("g").to_pylist()) for r in out["port"]]
    assert not (gs[0] & gs[1])


def test_distributed_split_through_exchange():
    """Knot summaries survive the page serde across fragments: PARTIAL
    approx_percentile -> partitioned shuffle -> FINAL, in both engines
    (tests/test_approx_percentile_merge.py)."""
    rng = np.random.RandomState(9)
    dfs = [pd.DataFrame({
        "g": rng.randint(0, 12, 3000).astype("int64"),
        "x": rng.randint(0, 1_000_000, 3000).astype("int64")})
        for _ in range(4)]
    final = [("q", lambda E: (
        "approx_percentile", (E.ex.field("x", E.T.BIGINT),
                              E.ex.lit(0.25, E.T.DOUBLE)), E.T.BIGINT))]
    out = {k: _shuffle_agg(E, f"pct-{k}", dfs,
                           ["approx_percentile(x, 0.25) as q"],
                           ["q$v", "q$w"], final)
           for k, E in ENGINES.items()}
    for want, got in zip(out["ref"], out["port"]):
        assert _rows(got, ["g"]).equals(_rows(want, ["g"]))
    got = pd.concat([t.to_pandas() for t in out["port"]]) \
        .sort_values("g").reset_index(drop=True)

    def exact(s):
        v = np.sort(s.to_numpy())
        return v[int(np.ceil(0.25 * len(v))) - 1]
    exp = pd.concat(dfs).groupby("g").x.apply(exact).reset_index()
    np.testing.assert_array_equal(got.g, exp.g)
    # per-group W ~ 1000 < K=1024 on each producer: exact
    np.testing.assert_array_equal(got.q, exp.x)


def _broadcast(E, tag, df):
    src = E.PB().values([pa.table(df)]).plan()
    pout = E.P.PartitionedOutputNode("b0", source=src, kind="broadcast",
                                     keys=(), num_partitions=3)
    E.task(pout, {"task.id": tag}).run()
    outs = []
    for dst in range(3):
        exch = E.P.ExchangeNode("ex", row_type=src.output_type())
        outs.append(E.task(exch, {"exchange.ex.tasks": [tag],
                                  "task.destination": dst}).run())
    E.X.OutputBufferManager.instance().remove(tag)
    return outs


def test_broadcast_output():
    df = pd.DataFrame({"a": np.arange(100, dtype="int64")})
    want = _broadcast(REF, "bcast-ref", df)
    got = _broadcast(PORT, "bcast-port", df)
    for w, g in zip(want, got):
        assert g.to_pylist() == w.to_pylist()
        np.testing.assert_array_equal(np.sort(g.column("a").to_numpy()),
                                      df.a)


def _spec_pages(E, tag, tables, keys, spec, n, **kw):
    src = E.PB().values(tables).plan()
    pout = E.P.PartitionedOutputNode(
        "pp", source=src, kind="partitioned",
        keys=tuple(E.ex.field(k, E.T.BIGINT) for k in keys),
        num_partitions=n, partition_spec=spec, **kw)
    E.task(pout, {"task.id": tag}).run()
    out = [_pages(E, tag, d) for d in range(n)]
    E.X.OutputBufferManager.instance().remove(tag)
    return out


def test_round_robin_partition_function():
    """round_robin spreads rows evenly regardless of keys, continuing the
    ordinal across batches (parity: RoundRobinPartitionFunction)."""
    dfs = [pd.DataFrame({"v": np.arange(i * 100, (i + 1) * 100,
                                        dtype="int64")})
           for i in range(3)]
    tables = [pa.table(d) for d in dfs]
    want = _spec_pages(REF, "rr-ref", tables, [], "round_robin", 4)
    got = _spec_pages(PORT, "rr-port", tables, [], "round_robin", 4)
    sizes = []
    for (wp, _), (gp, _) in zip(want, got):
        assert [p.v.tolist() for p in gp] == [p.v.tolist() for p in wp]
        sizes.append(sum(len(p) for p in gp))
    assert sizes == [75, 75, 75, 75]  # 300 rows, perfectly balanced
    allv = pd.concat([p for pages, _ in got for p in pages]).sort_values("v")
    np.testing.assert_array_equal(allv.v, np.arange(300))


def test_hive_bucket_partition_function_matches_writes(tmp_path):
    """hive_bucket routes a row to the destination owning its write
    bucket: destination d holds exactly the rows the port's Hive
    connector writes to bucket file d, and the reference's destination d
    the same rows."""
    from velox_tpu_torch.connectors.hive import _np_murmur3, register_hive
    register_hive("hive")
    rng = np.random.RandomState(2)
    k = rng.randint(0, 1000, 500).astype("int64")
    df = pd.DataFrame({"k": k, "v": np.arange(500, dtype="int64")})
    nb = 4
    want = _spec_pages(REF, "hb-ref", [pa.table(df)], ["k"], "hive_bucket",
                       nb, bucket_count=nb)
    got = _spec_pages(PORT, "hb-port", [pa.table(df)], ["k"], "hive_bucket",
                      nb, bucket_count=nb)
    Task(PlanBuilder().values([pa.table(df)]).table_write(
        str(tmp_path), bucket_count=nb, bucket_keys=["k"]).plan(),
        QueryCtx("cpu")).run()
    import pyarrow.parquet as pq
    exp_bucket = _np_murmur3([k]).view(np.int32) % nb
    for d, ((wp, _), (gp, _)) in enumerate(zip(want, got)):
        rows = pd.concat(gp) if gp else pd.DataFrame({"k": [], "v": []})
        assert sorted(rows.v) == sorted(pd.concat(wp).v if wp else [])
        assert set(exp_bucket[rows.v.to_numpy()]) <= {d}
        path = tmp_path / f"{d:05d}_0_part.parquet"
        written = pq.read_table(path).to_pandas() if path.exists() \
            else pd.DataFrame({"v": []})
        assert sorted(rows.v) == sorted(written.v)
    assert len(glob.glob(str(tmp_path / "*.parquet"))) > 1


@pytest.mark.parametrize("E", [REF, PORT], ids=["ref", "port"])
def test_output_buffer_flow_control(E):
    """Ack/credit protocol: consumed pages free memory; past max_bytes
    unacked pages overflow to disk; memory stays bounded (parity:
    exec/OutputBuffer.h acknowledge/delete + maxSize). Both engines'
    buffers go through the same sequence."""
    buf = E.X.OutputBuffer(1, max_bytes=10_000)
    page = b"x" * 1000
    for _ in range(50):
        buf.enqueue(0, page)
    assert buf.bytes_in_memory == 10_000  # the rest overflowed to disk
    got, seq, trail = 0, 0, []
    while got < 50:
        pages, _ = buf.get(0, seq)
        assert pages, (got, seq)
        take = pages[:7]
        got += len(take)
        seq += len(take)
        assert all(p == page for p in take)
        trail.append(buf.bytes_in_memory)
    buf.get(0, seq)  # final ack
    assert buf.bytes_in_memory == 0
    assert trail == [10_000, 3_000, 0, 0, 0, 0, 0, 0]


@pytest.mark.parametrize("E", [REF, PORT], ids=["ref", "port"])
def test_output_buffer_reread_before_ack(E):
    """Unacked pages can be fetched again (at-least-once delivery until
    acknowledged); acked pages are gone."""
    buf = E.X.OutputBuffer(1)
    for i in range(5):
        buf.enqueue(0, bytes([i]))
    p1, _ = buf.get(0, 0)
    p2, _ = buf.get(0, 0)
    assert p1 == p2 and len(p1) == 5
    p3, _ = buf.get(0, 3)       # acks 0..2
    assert p3 == [bytes([3]), bytes([4])]
    assert buf.get(0, 3)[0] == p3


@pytest.mark.parametrize("E", [REF, PORT], ids=["ref", "port"])
def test_output_buffer_max_bytes_credit(E):
    """get(max_bytes) bounds the response but returns at least one
    available page (parity: ExchangeSource::request(maxBytes))."""
    buf = E.X.OutputBuffer(1)
    for i in range(10):
        buf.enqueue(0, bytes([i]) * 100)
    assert len(buf.get(0, 0, max_bytes=250)[0]) == 2
    assert len(buf.get(0, 0, max_bytes=1)[0]) == 1


def _failing(E, tag):
    df = pd.DataFrame({"a": np.arange(50, dtype="int64")})
    src = E.PB().values([pa.table(df)]).project(["a % 0 as boom"])
    pout = E.P.PartitionedOutputNode(
        "p0", source=src.plan(), kind="partitioned",
        keys=(E.ex.field("boom", E.T.BIGINT),), num_partitions=2)
    with pytest.raises(Exception, match="row"):
        E.task(pout, {"task.id": tag}).run()
    exch = E.P.ExchangeNode("ex", row_type=E.T.row(["boom"], [E.T.BIGINT]))
    try:
        E.task(exch, {"exchange.ex.tasks": [tag],
                      "task.destination": 0}).run()
    finally:
        E.X.OutputBufferManager.instance().remove(tag)


def test_failed_producer_poisons_consumers():
    """Task::terminate parity: a failing producer fragment aborts its
    consumers instead of leaving them on a finished-empty stream
    (exec/Task.cpp:1934 clears output buffers), in both engines."""
    from velox_tpu.common.errors import VeloxError as JVeloxError
    with pytest.raises(JVeloxError, match="producer task failed"):
        _failing(REF, "failing-ref")
    with pytest.raises(VeloxError, match="producer task failed"):
        _failing(PORT, "failing-port")


def _merge_exchange(E, tag, dfs):
    ids = []
    for p, df in enumerate(dfs):
        src = E.PB().values([pa.table(df)]).plan()
        pout = E.P.PartitionedOutputNode(
            f"mx-{p}", source=src, kind="partitioned",
            keys=(E.ex.field("k", E.T.BIGINT),), num_partitions=1)
        ids.append(f"{tag}-{p}")
        E.task(pout, {"task.id": ids[-1]}).run()
    mx = E.P.MergeExchangeNode(
        "mx", row_type=E.T.row(["k", "v"], [E.T.BIGINT, E.T.BIGINT]),
        keys=(E.ex.field("k", E.T.BIGINT),),
        orders=(E.P.SortOrder.ASC_NULLS_LAST,))
    out = E.task(mx, {"exchange.mx.tasks": ids,
                      "task.destination": 0}).run()
    for t in ids:
        E.X.OutputBufferManager.instance().remove(t)
    return out


def test_merge_exchange_ordered_consume():
    """MergeExchangeNode: consumers see a total order over every
    producer's sorted pages (one device sort over the drained pages)."""
    rng = np.random.RandomState(17)
    dfs = [pd.DataFrame({
        "k": np.sort(rng.randint(0, 1000, 300)).astype("int64"),
        "v": rng.randint(0, 100, 300).astype("int64")}) for _ in range(3)]
    want = _merge_exchange(REF, "mx-ref", dfs)
    got = _merge_exchange(PORT, "mx-port", dfs)
    assert got.to_pylist() == want.to_pylist()
    np.testing.assert_array_equal(
        got.column("k").to_numpy(), np.sort(pd.concat(dfs).k.to_numpy()))


def test_local_merge_restores_order():
    """LocalMergeNode over interleaved sorted runs."""
    rng = np.random.RandomState(19)
    tables = [pa.table(pd.DataFrame({
        "k": np.sort(rng.randint(0, 500, 200)).astype("int64")}))
        for _ in range(4)]
    want = JTask(JPlanBuilder().values(tables).local_merge(["k"]).plan()) \
        .run()
    got = Task(PlanBuilder().values(tables).local_merge(["k"]).plan(),
               QueryCtx("cpu")).run()
    assert got.to_pylist() == want.to_pylist()
    np.testing.assert_array_equal(got.column("k").to_numpy(), np.sort(
        np.concatenate([t.column("k").to_numpy() for t in tables])))


def test_bucketize_preserves_order_within_destination():
    """PartitionedOutput groups rows by destination and keeps each
    destination's rows in input order (a stable sort), in both engines
    page for page."""
    df = pd.DataFrame({"k": np.arange(1000, dtype="int64") * 11 % 97,
                       "v": np.arange(1000, dtype="int64")})
    want = _spec_pages(REF, "order-ref", [pa.table(df)], ["k"], "hash", 4)
    got = _spec_pages(PORT, "order-port", [pa.table(df)], ["k"], "hash", 4)
    seen = []
    for (wp, _), (gp, at_end) in zip(want, got):
        assert at_end
        assert [p.to_dict("list") for p in gp] == \
            [p.to_dict("list") for p in wp]
        for t in gp:
            assert (np.diff(t.v) > 0).all()
            seen.append(t)
    allrows = pd.concat(seen).sort_values("v")
    np.testing.assert_array_equal(allrows.v, df.v)
    np.testing.assert_array_equal(allrows.k, df.k)


PRODUCER = r"""
import sys
import numpy as np, pyarrow as pa
from velox_tpu_torch import types as T
from velox_tpu_torch.core import expressions as ex, plan as P
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.exec.exchange_net import serve_exchange
from velox_tpu_torch.testing.plan_builder import PlanBuilder

t = pa.table({"g": np.arange(300, dtype="int64") % 7,
              "v": np.arange(300, dtype="int64")})
src = PlanBuilder().values([t]).plan()
pout = P.PartitionedOutputNode(
    "p0", source=src, kind="partitioned",
    keys=(ex.field("g", T.BIGINT),), num_partitions=2)
Task(pout, QueryCtx("cpu", {"task.id": "nettask"})).run()
host, port = serve_exchange()
print(f"{host}:{port}", flush=True)
sys.stdin.readline()  # the parent closes stdin when done
"""


def test_two_process_socket_exchange():
    """A producer Task in a child process serves its OutputBuffer over
    TCP; this process's Exchange pulls each destination's pages through
    SocketExchangeSource with a small credit (several request rounds).
    Each destination holds the rows the reference's in-process fragments
    give it."""
    from velox_tpu_torch.exec.exchange_net import SocketExchangeSource
    want = _spec_pages(REF, "net-ref", [pa.table({
        "g": np.arange(300, dtype="int64") % 7,
        "v": np.arange(300, dtype="int64")})], ["g"], "hash", 2)
    proc = subprocess.Popen(
        [sys.executable, "-c", PRODUCER], cwd=REPO,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        addr = proc.stdout.readline().strip()
        assert ":" in addr, addr
        prev = X._SOURCE_FACTORY
        X.register_exchange_source_factory(SocketExchangeSource)
        try:
            rt = T.row(["g", "v"], [T.BIGINT, T.BIGINT])
            parts = []
            for dst in range(2):
                exch = P.ExchangeNode("ex", row_type=rt)
                parts.append(Task(exch, QueryCtx("cpu", {
                    "exchange.ex.tasks": [f"{addr}/nettask"],
                    "task.destination": dst,
                    "exchange.max_queue_bytes": 2048,
                })).run().to_pandas())
        finally:
            X.register_exchange_source_factory(prev)
        for (wp, _), got in zip(want, parts):
            assert sorted(got.v) == sorted(pd.concat(wp).v)
        got = pd.concat(parts).sort_values("v").reset_index(drop=True)
        np.testing.assert_array_equal(got.v, np.arange(300))
        np.testing.assert_array_equal(got.g, got.v % 7)
        assert not (set(parts[0].g) & set(parts[1].g))
    finally:
        proc.stdin.close()
        proc.wait(timeout=30)


class _Boom(Exception):
    pass


def test_tcp_exchange_server_teardown_mid_stream():
    """The TCP exchange client raises a clean VeloxError when the server
    dies mid-response, and an OSError when it is gone between fetches,
    not a hang (tests/test_threaded_faults.py)."""
    from velox_tpu_torch.exec.exchange_net import (
        SocketExchangeSource, serve_exchange, shutdown_exchange_servers,
    )
    mgr = X.OutputBufferManager.instance()
    buf = mgr.create("t-teardown", 1)
    for i in range(3):
        buf.enqueue(0, f"page-{i}".encode())
    before = {t.name for t in threading.enumerate()}
    host, port = serve_exchange()
    src = SocketExchangeSource(f"{host}:{port}/t-teardown", 0)
    pages, at_end = src.next(max_bytes=8)
    assert pages == [b"page-0"] and not at_end

    def cb(payload):
        raise _Boom("server dying mid-response")

    TV.enable()
    TV.set_callback("ExchangeNet::respond", cb)
    try:
        t0 = time.time()
        with pytest.raises(VeloxError):
            src.next(max_bytes=8)
        assert time.time() - t0 < 30
    finally:
        TV.clear_callback("ExchangeNet::respond")
        TV.disable()
    shutdown_exchange_servers()
    with pytest.raises(OSError):
        SocketExchangeSource(f"{host}:{port}/t-teardown", 0).next()
    mgr.remove("t-teardown")
    deadline = time.time() + 10
    while time.time() < deadline and \
            {t.name for t in threading.enumerate()} - before:
        time.sleep(0.05)
    assert not ({t.name for t in threading.enumerate()} - before)


def _q1_fragments(E, tag, conn_dicts, cfg_of):
    """TPC-H Q1 as two fragments: PARTIAL -> PartitionedOutput(hash on
    the flags, 4 partitions) -> 4 consumers (Exchange -> FINAL)."""
    plan = (jax_tpch_plan if E is REF else tpch_plan)(1)
    orderby = plan
    final = orderby.source
    partial = final.source
    pout = E.P.PartitionedOutputNode(
        "q1-out", source=partial, kind="partitioned",
        keys=tuple(final.grouping_keys), num_partitions=4)
    E.task(pout, {"task.id": tag}).run()
    outs = []
    for dst in range(4):
        exch = E.P.ExchangeNode("q1-in", row_type=partial.output_type())
        plan_d = E.P.AggregationNode(
            final.id, source=exch, step=final.step,
            grouping_keys=final.grouping_keys,
            aggregate_names=final.aggregate_names,
            aggregates=final.aggregates)
        outs.append(E.task(plan_d, {"exchange.q1-in.tasks": [tag],
                                    "task.destination": dst,
                                    **cfg_of(conn_dicts)}).run())
    E.X.OutputBufferManager.instance().remove(tag)
    return outs


def test_q1_two_fragments_with_producer_dictionaries():
    """Q1's flags leave the producer as Arrow strings and come back under
    the producer's dictionaries (``exchange.<id>.dictionaries``): each
    destination's groups equal the reference's, and all of them Q1."""
    from velox_tpu.connectors.tpch import register_tpch as jregister
    from velox_tpu_torch.connectors.tpch import register_tpch
    jconn, conn = jregister(0.01), register_tpch(0.01)
    cfg = (lambda d: {"exchange.q1-in.dictionaries": d})
    want = _q1_fragments(REF, "q1-ref", jconn.gen.dictionaries("lineitem"),
                         cfg)
    got = _q1_fragments(PORT, "q1-port", conn.gen.dictionaries("lineitem"),
                        cfg)
    keys = ["l_returnflag", "l_linestatus"]
    for w, g in zip(want, got):
        assert _rows(g, keys).to_dict("list") == \
            _rows(w, keys).to_dict("list")
    whole = Task(tpch_plan(1), QueryCtx("cpu")).run()
    assert pa.concat_tables(got).sort_by(
        [(k, "ascending") for k in keys]).to_pylist() == whole.to_pylist()


def test_producer_thread_feeds_consumers():
    """A producer Task on a thread and two consumer Tasks on others share
    one OutputBuffer: every row arrives once."""
    rng = np.random.RandomState(3)
    tables = [pa.table({"g": rng.randint(0, 50, 4000).astype("int64"),
                        "v": np.arange(i * 4000, (i + 1) * 4000,
                                       dtype="int64")}) for i in range(6)]
    src = PlanBuilder().values(tables).plan()
    pout = P.PartitionedOutputNode(
        "tp", source=src, kind="partitioned",
        keys=(ex.field("g", T.BIGINT),), num_partitions=2)
    tid = "thread-producer"
    X.OutputBufferManager.instance().create(tid, 2)  # consumers may start
    results, errors = {}, []

    def produce():
        try:
            Task(pout, QueryCtx("cpu", {"task.id": tid})).run()
        except BaseException as e:
            errors.append(e)

    def consume(dst):
        try:
            exch = P.ExchangeNode("ex", row_type=src.output_type())
            results[dst] = Task(exch, QueryCtx("cpu", {
                "exchange.ex.tasks": [tid], "task.destination": dst,
                "exchange.max_queue_bytes": 4096})).run()
        except BaseException as e:
            errors.append(e)
    threads = [threading.Thread(target=consume, args=(d,))
               for d in range(2)] + [threading.Thread(target=produce)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    X.OutputBufferManager.instance().remove(tid)
    assert not errors, errors
    v = np.sort(np.concatenate([results[d].column("v").to_numpy()
                                for d in range(2)]))
    np.testing.assert_array_equal(v, np.arange(24000))
    assert not (set(results[0].column("g").to_pylist())
                & set(results[1].column("g").to_pylist()))
