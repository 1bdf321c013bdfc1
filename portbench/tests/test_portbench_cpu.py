"""The benchmark on the CPU at SF 0.01: the frozen plans through the
program against the plain reference for several seeds, the parameter
draws, the Parquet manifest, the metric arithmetic, the trace reader, a
cell added by files alone, and no result without a card."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench_support import REPO, TINY_SF, add_cell, root  # noqa: F401
from portbench import datasets, harness, profile, stats, traffic
from portbench.reference import tpchgen


def _run(root, cell, seed, trace=False, seconds=0.2):
    return harness.run_cell(cell, seed, seconds, trace, "cpu", time.time(),
                            root=root)


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 987654321987, 40])
def test_power22_differs_only_in_string_order(root, seed):
    """The 22-query mix is no cell yet: the program orders a
    dictionary-encoded string key by its dictionary ids, so Q9's rows
    (ORDER BY nation) come out of order on every seed, and Q7's where the
    two nations' ids run against their names (seed 40: CHINA, INDIA;
    seed 2 ** 31 + 11 too).
    Every answer equals the reference's as a multiset, and every other
    answer in order too."""
    from portbench.reference import compare
    add_cell(root, "tpch_sf10.power22", "tpch_sf10", "power22")
    _, cell, cfg, mix = harness.load_cell("tpch_sf10.power22", root)
    run = harness.Run(cell, cfg, mix, seed, "cpu")
    run.setup()
    want = run.answers(range(len(run.stream)))
    lim = cfg["correct_limits"]
    out_of_order = set()
    for a in run.streams(1):
        q = run.stream[a.query][0]
        got = compare.rows_of(a.table)
        bad, widest = compare.gaps(got, want[a.query])
        assert bad == 0 and (widest or 0.0) <= lim["double_rel_gap"], q
        if compare.gaps(got, want[a.query], harness.ORDER_BY[q])[0]:
            out_of_order.add(q)
    assert "q9" in out_of_order and out_of_order <= {"q7", "q9"}
    n1, n2 = (dict(run.stream)["q7"][k] for k in ("nation1", "nation2"))
    by_id = tpchgen.NATIONS.index(n1) < tpchgen.NATIONS.index(n2)
    assert ("q7" in out_of_order) == ((n1 < n2) != by_id)


@pytest.mark.parametrize("seed", [5, 6])
def test_bench5_equals_the_reference(root, seed):
    out = _run(root, "tpch_sf10.bench5", seed)
    assert out["correct"], out["check"]
    assert out["attempted"] % 5 == 0
    assert "query_p95_ms" in out["metrics"]


@pytest.mark.parametrize("seed", [7, 8])
def test_parquet_bench4_equals_the_reference(root, seed):
    out = _run(root, "tpch_sf10_parquet.bench4", seed)
    assert out["correct"], out["check"]
    assert out["attempted"] % 4 == 0


def test_traced_run_reports_the_per_layer_metrics(root):
    out = _run(root, "tpch_sf10.bench5", 9, trace=True)
    assert out["correct"]
    # no device on the CPU: only the counters and the window's idle share
    assert out["metrics"]["scan.cache_hit_share"]["value"] == 100.0
    assert out["device"]["window_s"] > 0
    assert list(out)[-1] == "check"


def test_draws_stay_in_the_spec_ranges():
    mix = {"queries": [f"q{q}" for q in range(1, 23)]}
    for seed in range(40):
        s = traffic.stream(mix, seed, 10)
        assert sorted(q for q, _ in s) == sorted(mix["queries"])
        p = dict(s)
        assert 60 <= p["q1"]["delta"] <= 120
        assert "1995-03-01" <= p["q3"]["date"] <= "1995-03-31"
        assert 1993 <= p["q6"]["year"] <= 1997
        assert p["q6"]["discount"] in [x / 100 for x in range(2, 10)]
        assert p["q6"]["quantity"] in (24, 25)
        assert p["q7"]["nation1"] != p["q7"]["nation2"]
        assert p["q11"]["fraction"] == pytest.approx(0.0001 / 10)
        assert 312 <= p["q18"]["threshold"] <= 315
        assert p["q8"]["p_type"] in tpchgen.P_TYPES
        assert p["q17"]["container"] in tpchgen.P_CONTAINERS
        assert p["q19"]["b1"] in tpchgen.P_BRANDS
        region = tpchgen.REGIONS[tpchgen.NATION_REGION[
            tpchgen.NATIONS.index(p["q8"]["nation"])]]
        assert p["q8"]["region"] == region
    assert traffic.stream(mix, 3, 10) == traffic.stream(mix, 3, 10)
    assert traffic.stream(mix, 3, 10) != traffic.stream(mix, 4, 10)


def test_parquet_manifest_detects_a_changed_file(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets, "DATA_DIR", tmp_path)
    cfg = json.loads((REPO / "portbench/configs/tpch_sf10_parquet.json")
                     .read_text())
    cfg.update(scale_factor=TINY_SF, name="manifest")
    root = datasets.parquet_files(cfg)
    files = sorted(root.rglob("*.parquet"))
    assert len(files) == 8 + 8 + 5
    kept = {f: f.stat().st_mtime_ns for f in files}
    assert datasets.parquet_files(cfg) == root
    assert {f: f.stat().st_mtime_ns for f in files} == kept  # not rewritten
    victim = files[3]
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0xFF  # same size, other bytes
    victim.write_bytes(bytes(data))
    datasets.parquet_files(cfg)
    manifest = json.loads((root / "manifest.json").read_text())
    assert manifest["files"] == datasets._files(root)
    assert victim.read_bytes() != bytes(data)  # written anew


def test_parquet_files_hold_the_generator_arrays(tmp_path, monkeypatch):
    import pyarrow.parquet as pq
    monkeypatch.setattr(datasets, "DATA_DIR", tmp_path)
    cfg = json.loads((REPO / "portbench/configs/tpch_sf10_parquet.json")
                     .read_text())
    cfg.update(scale_factor=TINY_SF, name="arrays")
    root = datasets.parquet_files(cfg)
    gen = tpchgen.TpchGen(TINY_SF)
    li = pq.read_table(root / "lineitem")
    want = gen.table("lineitem", ["l_orderkey", "l_extendedprice"])
    assert li.num_rows == gen.num_rows("lineitem")
    got = li.column("l_extendedprice").to_pylist()
    assert [int(v.scaleb(2)) for v in got[:1000]] == \
        want["l_extendedprice"][:1000].tolist()
    assert np.array_equal(li.column("l_orderkey").to_numpy(),
                          want["l_orderkey"])


def test_interval_arithmetic():
    ivs = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union(ivs) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(ivs) == 3.0
    assert stats.gaps(ivs, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                          (4.0, 5.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_geomean_and_p95():
    assert stats.geomean([1.0, 100.0]) == pytest.approx(10.0)
    assert stats.geomean([7.0] * 5) == pytest.approx(7.0)
    # a tenfold slower short query moves it as much as a tenfold slower
    # long one: TPC-H's power form
    assert stats.geomean([50.0, 500.0]) == pytest.approx(
        stats.geomean([5.0, 5000.0]))
    values = list(range(1, 101))  # 1..100
    assert stats.p95(values) == 95
    assert stats.p95([3.0]) == 3.0
    assert stats.p95([5, 1, 4, 2, 3] * 4) == 5


def _trace():
    """A hand-made record: the program's calls on the harness's thread,
    a kernel launched inside join.py, a hand-written kernel launched
    through ctypes (no operator), a kernel and a copy launched inside
    radix.py and task.py, and the window."""
    frames = [(0.5, 3.5, "exec/task.py", "run"),
              (1.0, 2.0, "exec/join.py", "build_table"),
              (6.0, 8.0, "ops/radix.py", "sort_perm")]
    device = [("cummax_kernel", 2.0, 3.0, "exec/join.py"),
              ("void radix_hist_kernel<int>(...)", 7.0, 8.0, None),
              ("elementwise", 7.5, 8.5, "ops/radix.py"),
              ("Memcpy DtoH", 2.5, 3.5, "exec/task.py")]
    return profile.build_trace(device, (0.0, 10.0), frames)


def test_trace_reader_attributes_device_time():
    t = _trace()
    layers = {o.name: o.layer for o in t.ops}
    assert layers == {"cummax_kernel": "join",
                      "void radix_hist_kernel<int>(...)": "kernels",
                      "elementwise": "sort", "Memcpy DtoH": "other"}
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s() == pytest.approx(3.0)  # [2, 3.5] and [7, 8.5]
    assert t.kernels() == 3
    reading = harness.Reading(t, t, {}, 2, 10.0)
    assert harness.read_metric("device.idle_share", reading) \
        == pytest.approx(70.0)
    assert harness.read_metric("join.device_share", reading) \
        == pytest.approx(100.0 / 3)
    assert harness.read_metric("kernels.handwritten_share", reading) \
        == pytest.approx(100.0 / 3)
    assert harness.read_metric("sort.device_share", reading) \
        == pytest.approx(100.0 / 3)
    assert harness.read_metric("device.launches_per_query", reading) == 1.5
    assert harness.read_metric("device.busy_ms_per_query", reading) \
        == pytest.approx(1500.0)
    b = profile.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(1.0)
    gaps = dict(b["idle_gaps"])
    # idle: 0-2 before any call into the program, 3.5-7 after join.py's
    # call (the last begun), 8.5-10 after radix.py's
    assert gaps == pytest.approx({"harness": 2.0,
                                  "exec/join.py: build_table": 3.5,
                                  "ops/radix.py: sort_perm": 1.5})


def test_marks_give_the_window_and_each_gap_its_query():
    """The device window's marks (tiny kernels at its ends and before each
    query) set the window and label the idle stretches; they are no
    operations of the program."""
    mark = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
    device = [(mark, 1.0, 1.001, None), (mark, 2.0, 2.001, None),
              ("cummax_kernel", 2.5, 4.0, None), (mark, 5.0, 5.001, None),
              ("Memcpy DtoH", 5.5, 6.0, None), (mark, 9.0, 9.5, None)]
    t = profile.marked_trace(device, ["q3", "q1"])
    assert t.window == (1.0, 9.5)
    assert t.kernels() == 1 and t.busy_s() == pytest.approx(2.0)
    # each idle stretch goes to the query marked last before it begins
    assert dict(t.idle_labels) == pytest.approx(
        {"harness": 1.5, "q3": 1.5, "q1": 3.5})
    with pytest.raises(RuntimeError):
        profile.marked_trace(device, ["q3"])


def test_a_cell_added_by_files_alone(root):
    """A new mix, configuration and per-layer metric are new files and
    new entries of BENCHMARK.json; no existing file changes."""
    (root / "portbench/mixes/throwaway.json").write_text(json.dumps(
        {"queries": ["q14", "q6", "q12"], "trace_seconds": 0.1}))
    cfg = json.loads((root / "portbench/configs/tpch_sf10.json")
                     .read_text())
    cfg.update(name="throwaway_sf001")
    (root / "portbench/configs/throwaway_sf001.json").write_text(
        json.dumps(cfg))
    (root / "portbench/metrics/throwaway.queries.py").write_text(
        "def read(reading):\n    return float(reading.queries)\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0],
                                 name="throwaway_sf001",
                                 file="portbench/configs/"
                                      "throwaway_sf001.json"))
    bench["workloads"].append({"name": "throwaway_sf001.throwaway",
                               "config": "throwaway_sf001",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.queries", "unit": "1",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "test", "moves": "queries_per_s",
                               "workloads": ["throwaway_sf001.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, "throwaway_sf001.throwaway", 3)
    assert out["correct"] and out["attempted"] % 3 == 0
    out = _run(root, "throwaway_sf001.throwaway", 3, trace=True)
    assert out["metrics"]["throwaway.queries"]["value"] >= 3


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, str(REPO / "portbench/run.py"), "--workload",
         "tpch_sf10.bench5", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_rows_compare_in_their_order_by_order():
    from portbench.reference import compare
    want = (["k", "v"], [(3, "a"), (2, "b"), (2, "c"), (1, "d")])
    desc = [["k", "desc"]]
    # rows of equal keys may trade places
    swapped = [(3, "a"), (2, "c"), (2, "b"), (1, "d")]
    assert compare.gaps((want[0], swapped), want, desc) == (0, None)
    # a row out of place counts
    moved = [(2, "b"), (3, "a"), (2, "c"), (1, "d")]
    assert compare.gaps((want[0], moved), want, desc)[0] > 0
    reverse = list(reversed(want[1]))
    assert compare.gaps((want[0], reverse), want, desc)[0] == 2
    # no ORDER BY: a multiset
    assert compare.gaps((want[0], reverse), want) == (0, None)
    # a missing row, and the reference out of its own order
    assert compare.gaps((want[0], want[1][:3]), want, desc)[0] == 1
    with pytest.raises(AssertionError):
        compare.gaps(want, (want[0], reverse), desc)


@pytest.mark.parametrize("seed", [31, 32])
def test_reference_rows_come_in_the_spec_order(seed):
    """Every query's reference answer at SF 0.01 comes out in the order
    that its ORDER BY states, and every query has an ORDER BY entry."""
    from portbench.reference import compare, oracles
    mix = {"queries": sorted(oracles.ANSWERS)}
    assert set(harness.ORDER_BY) - {"_doc"} == set(oracles.ANSWERS)
    tables = oracles.Tables(tpchgen.TpchGen(TINY_SF))
    for q, params in traffic.stream(mix, seed, TINY_SF):
        names, rows = oracles.ANSWERS[q](tables, **params)
        keys = [(names.index(c), d == "desc") for c, d in harness.ORDER_BY[q]]
        assert compare.ordered(rows, keys), q
