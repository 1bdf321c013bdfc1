"""The power-test cell, tpch_sf10.power22, on the CPU at SF 0.01: every
answer of the 22-query stream equals the plain reference's in its ORDER
BY order, and the cell's two per-layer readers (the program's counters
present, absent as on a program without them, and on a traced run)."""

import time

import pytest

from portbench_support import root  # noqa: F401
from portbench import harness

CELL = "tpch_sf10.power22"
RANKED = "velox_tpu.sort.dictionary_ranked_keys"
BY_ID = "velox_tpu.sort.dictionary_id_keys"
ROWS = "velox_tpu.join.merge_rank_rows"


def _read(name, counters, queries=22):
    return harness.read_metric(
        name, harness.Reading(None, None, counters, queries, 1.0))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 11, 987654321987, 40])
def test_power22_equals_the_reference_in_order(root, seed):
    """Seeds 2 ** 31 + 11 and 40 draw Q7 nation pairs whose dictionary ids
    run against their names (40: CHINA, INDIA); Q9 orders by nation on
    every seed."""
    out = harness.run_cell(CELL, seed, 0.2, False, "cpu", time.time(),
                           root=root)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] % 22 == 0
    assert out["check"]["mismatched_rows"]["value"] == 0
    assert set(out["metrics"]) == {"queries_per_s", "geomean_ms",
                                   "setup_s"}


def test_traced_power22_reads_both_counters(root):
    """Q2, Q7 and Q9 sort the TPC-H connector's n_name, which is in key
    order; the two-column joins of Q2, Q5, Q9 and Q20 take the
    merge-rank."""
    out = harness.run_cell(CELL, 3, 0.2, True, "cpu", time.time(),
                           root=root)
    assert out["correct"], out["check"]
    share = out["metrics"]["sort.dictionary_rank_share"]
    rows = out["metrics"]["join.merge_rank_rows_per_query"]
    assert share["unit"] == "%" and 0 < share["value"] < 100
    assert rows["unit"] == "rows/query" and rows["value"] > 0


@pytest.mark.parametrize("counters,want", [
    ({RANKED: 3.0, BY_ID: 9.0}, 25.0),
    ({RANKED: 2.0}, 100.0),
    ({BY_ID: 5.0}, 0.0),
    ({RANKED: 0.0, BY_ID: 0.0}, None),
    ({}, None),
    ({ROWS: 10.0}, None),
])
def test_dictionary_rank_share_reader(counters, want):
    assert _read("sort.dictionary_rank_share", counters) == want


@pytest.mark.parametrize("counters,queries,want", [
    ({ROWS: 4400.0}, 22, 200.0),
    ({ROWS: 1024.0}, 4, 256.0),
    ({ROWS: 0.0}, 22, None),
    ({}, 22, None),
    ({RANKED: 3.0}, 22, None),
    ({ROWS: 1024.0}, 0, None),
])
def test_merge_rank_rows_per_query_reader(counters, queries, want):
    assert _read("join.merge_rank_rows_per_query", counters,
                 queries) == want
