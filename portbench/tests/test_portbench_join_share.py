"""join.array_mode_share's reader: the program's counters present,
absent (a program without them) and with no hash-join build, and a
traced run on the CPU at SF 0.01 that reads it."""

import time

import pytest

from portbench_support import root  # noqa: F401
from portbench import harness

ARRAY_MODE = "velox_tpu.join.array_mode_builds"
MERGE_RANK = "velox_tpu.join.merge_rank_builds"


def _read(counters):
    reading = harness.Reading(None, None, counters, 4, 1.0)
    return harness.read_metric("join.array_mode_share", reading)


@pytest.mark.parametrize("counters,want", [
    ({ARRAY_MODE: 16.0, MERGE_RANK: 0.0}, 100.0),
    ({ARRAY_MODE: 12.0}, 100.0),
    ({ARRAY_MODE: 3.0, MERGE_RANK: 1.0}, 75.0),
    ({MERGE_RANK: 4.0}, 0.0),
    ({}, None),
    ({"velox_tpu.cache.device_hits": 8.0}, None),
    ({ARRAY_MODE: 0.0, MERGE_RANK: 0.0}, None),
])
def test_array_mode_share_reader(counters, want):
    assert _read(counters) == want


def test_traced_bench5_reads_every_build_in_array_mode(root):
    """bench5's joins take array mode from the TPC-H connector's stats."""
    out = harness.run_cell("tpch_sf10.bench5", 11, 0.2, True, "cpu",
                           time.time(), root=root)
    assert out["correct"]
    assert out["metrics"]["join.array_mode_share"] == {"value": 100.0,
                                                       "unit": "%"}
