#!/usr/bin/env python3
"""Smoke run of velox_tpu_torch on one CUDA card.

Usage: python3 chip_smoke.py [--sf N]   (default SF 10: 60M lineitem rows)

Phases, each printing one line; any failure raises and exits non-zero:

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels (velox_tpu_torch/csrc) and the native
   TPC-H generator from the sources in this checkout.
3. kernel: the filter-sum kernel (B1) against its plain PyTorch version
   on the card, exact equality over many shapes, every kernel instance
   (each layout of range and product columns), every 16-byte offset of the
   columns (alike and mixed) and a running total carried across calls;
   median times at 6.7M and 60M rows, in the Q6 shape (adding into a
   running total, as the operator does) and in a shape where every row
   loads every column (the one whose bytes are known, for the bandwidth
   figure), and at 6.7M rows also from a captured CUDA graph.
4. q6: TPC-H Q6 through Task.batches(), through the kernel; the result
   must equal a numpy oracle over the same generated columns exactly.
   Like every path phase below, it runs the query three times: cold (the
   scan cache cleared), warm (every split from the cache) and cold with
   the scan's producer thread off (SCAN_PREFETCH_DEPTH 0). Each run is
   exact with the same launch counts (reset just before the run, read
   just after); cold runs miss the cache once a split their scans read
   and hit nothing, the warm run hits as often and misses nothing, and a
   checksum of every cached tensor is the same after the warm run as
   after the cold one. The line gives the three walls.
   eviction: Q6 three times with a cache budget of half one run's scan,
   so entries are evicted (and their device blocks reused by the next
   uploads) while the query runs: exact every time, evictions above 0.
5. heads: the scan+filter+project heads of Q6 and Q1 without their
   aggregations; active-row counts and column sums, reduced on the card,
   must equal numpy exactly.
   scan: one lineitem split of Q1's seven columns uploaded in the earlier
   host form (zeros, astype and a slice copy, then a pageable copy) and
   in the data source's (one pass into pinned memory, then an
   asynchronous copy on its own stream), in turns: host ms, copy ms and
   GB/s of each, and the data source's whole upload; equal device bytes.
   It runs before q6, so its first call of each form is the process's
   first (pinned) upload.
6. radix_kernels: the counting-sort pass kernels (histogram B4 from int32
   digits, from the int64 sort state and from an int32 sort word at every
   digit width 1-8; B2's rank form and its rank-and-scatter form, with and
   without the word lane; B3's positions and scatter forms) through the
   wrappers the paths call, against their plain PyTorch versions on the
   card, exact, over row counts from 1 to 60M, skewed, narrow, sorted and
   reversed digits, states whose upper bits (row id and key) fill all 64
   bits, and words with bit 31 set; median times of each mode, its plain
   version and its bound at 6.7M and 60M rows, uniform and one-digit, and
   at 6.7M rows also from a captured CUDA graph of the same calls (the
   host's launch rate out of the window); one whole pass of each sort
   branch in its two-launch form and its earlier glue form, in turns; and
   whole radix_sort_perm calls on the orderBy and full-sort keys against
   a stable torch.sort of the same packed lane.
7. q1: TPC-H Q1 (array-mode partial/final aggregation, DECIMAL(38)
   sums, half-up avgs, the final OrderBy); every output value must equal
   a numpy oracle exactly.
8. topn: the orderBy config (ORDER BY l_shipdate, l_orderkey LIMIT 1000,
   run as a TopN): equal to the first 1000 rows of np.lexsort; B4 and B3
   launch once per radix pass per batch, B2 never.
9. sort_full: ORDER BY l_shipdate, l_orderkey, l_linenumber over all of
   lineitem: the row order must be np.lexsort's; the key and row ids do
   not fit 64 bits, so the classic loop runs: B4 and B2's rank-and-scatter
   form once a pass, B5 once for each key word after the first.
   spill: six paths, each run cold (scan cache cleared) and warm with
   equal launches and equal offload counters, each exact, with budgets
   computed from this run's batches and a fresh temporary SPILL_DIR that
   must be empty after every run, as must the query pool:
   spill_sort (the full sort with SORT_OFFLOAD_BYTES of 3 lineitem batches
   and OFFLOAD_HOST_BUDGET_BYTES of 3.5: 3 batches end in each tier; rows
   equal np.lexsort's), spill_join (Q3 with JOIN_BUILD_OFFLOAD_BYTES 0
   and a host budget of 1.5 orders build batches: no build batch stays on
   the device, the orders build writes a spill file; the Q3 oracle),
   spill_merge_join (the analytic merge_join plan, its presorted orders
   build through host and disk with the same budgets: it must come back
   in key order; its oracle), spill_agg (Q18 with AGG_HOST_OFFLOAD and
   AGG_COMPACT_THRESHOLD 2: at least 4 compacted runs in host RAM; the
   Q18 oracle), spill_arbitration (the full sort under a
   QUERY_HBM_CAP_BYTES of 3 batches and no budget: the arbitrator
   reclaims for each batch past the cap; np.lexsort's rows) and spill_ssd
   (Q6 through a fresh scan cache of half one run's scan bytes with the
   SSD tier: a cold run demotes, a rerun and a second cache over the same
   directory, as after a restart, hit it; the Q6 oracle). Each line: the
   walls and peaks beside the same plan's without spill in this run, the
   batches and bytes that reached host RAM and disk, the host and copy
   milliseconds of the offloads and those of the disk writes and reads,
   peak device memory, the query pool's peak and used, the launches.
10. q6_generic: Q6 with a filter the kernel matcher rejects, through the
   generic aggregation: the Q6 value, and no filter-sum launch.
11. gather_kernel: the flat-gather kernel (B5) against its plain PyTorch
   version on the card, bit for bit, over data lengths 1 to 60,000,001,
   index lengths 1 to 6.7M, 4- and 8-byte data, int32 and int64 indices,
   uniform, sorted, reversed and constant indices, and indices that start
   off the 16-byte boundary; the multi-column form (gather_rows) with 1-8
   columns of mixed widths. Median times of the kernel, its plain version
   and torch.index_select (one a column), beside the bound that counts
   each data sector the indices touch once, at the shapes the path gives
   it: uniform indices into 2^20 and 60,000,001 int32 rows, the q3/q18
   probe's monotone indices (one SF10 lineitem split's l_orderkey into the
   orders domain), three orders columns through the build rows in one
   launch, and the full sort's permutation of 60,000,401 rows; CUDA-graph
   times at 6.7M indices.
12. q3: TPC-H Q3 (two array-mode joins, a sort-mode group-by with a
   DECIMAL(38) sum, a TopN on it): the 10 rows must equal a numpy oracle
   with direct-address joins over the generator's own columns. B5 runs
   every gather of both join probes (the build columns through one index
   in one multi-column launch) and the TopN's word gathers; B2 runs every
   pass of the TopN's classic loop; the launch counts must be the ones
   the plan gives.
13. q18: TPC-H Q18 (threshold 300): the rows must equal a numpy oracle
   (np.bincount of l_quantity by l_orderkey, joins, the top 100), with
   B5's (both forms) and B2's launch counts derived from the plan as in
   q3.
14. tpch_rest: the 18 other TPC-H queries (Q2, Q4, Q5, Q7, Q8, Q9, Q10,
   Q11, Q12, Q13, Q14, Q15, Q16, Q17, Q19, Q20, Q21, Q22: semi and anti
   joins with filters, casts, CASE, division, dictionary-string
   LIKE/substr, date parts, a DECIMAL(38) max, EnforceSingleRow and the
   nested-loop join) through Task.batches(), each cold (scan cache
   cleared) and warm: the two runs must give the same rows with the same
   launch counts and the same dynamic filters pushed (each line prints
   them). Q4, Q5, Q10, Q11, Q12, Q13, Q14, Q15, Q17, Q19, Q21 and Q22 must
   equal numpy oracles over the generator's columns (doubles within the
   reference
   oracle's relative tolerance; Q11's fixed fraction, 0.0001, selects no
   part at SF10, which its oracle confirms, so Q11 is held to an empty
   result there); Q2, Q7, Q8, Q9, Q16 and Q20 must give rows, the same
   cold and warm. The nested-loop joins of Q11 and Q22 must launch B5
   for their gathers, and Q15's DECIMAL(38) max must run through the
   radix sort (B4). The host time of the dictionary-string passes (the
   pass and the enqueue of its gather, no sync) is timed per query.
   Then each query runs at SF 1 on the card and on the CPU in this
   process: equal rows, doubles within the relative tolerance.
15. analytic: six paths of the analytic operators, each cold and warm,
   each exact against a numpy oracle over the generator's columns (on
   the card, column by column, for the large outputs): win_lineitem (a
   window over all of lineitem: row_number, rank, dense_rank, a running
   DECIMAL sum, lag), win_orders_frames (ROWS 2 PRECEDING min/max/avg,
   ntile, percent_rank, cume_dist, first/last_value over orders, then a
   RANGE 90 PRECEDING sum), topn_row_number (the top 3 orders by price
   a customer), row_number_hash (RowNumber by l_orderkey, limit 2: the
   hash table grows past its first 2^24 slots), distinct_rollup (two
   MarkDistinct counts per l_returnflag; Q1's aggregates over a GroupId
   ROLLUP) and merge_join (lineitem merge-joined with orders,
   AssignUniqueId, an aggregation per priority; a streaming aggregation
   over an OrderBy). Each prints its walls, its peak device memory, its
   launches (B4 and B5 on every path, B2 or B3 on the window, TopN and
   RowNumber paths) and the hash table's probe rounds and rehashes.
16. aggregates: seven paths, each cold and warm with equal rows and
   launches, each held to its oracle: agg_moments (count_if, bool_and,
   bool_or, arbitrary, the variance and stddev names, skewness and
   kurtosis per (l_returnflag, l_linestatus), against numpy's float64
   power sums in the reference's formulas; then stddev_samp per
   l_suppkey), agg_sketches (approx_distinct per l_returnflag, global
   and per l_linenumber: a numpy HyperLogLog over the same 32-bit hash,
   exact, and within 3 x 4.6% of the distinct count), agg_percentile
   (approx_percentile and mode per (l_returnflag, l_linestatus), exact;
   a PARTIAL/FINAL approx_percentile per l_shipmode within 2/1024 of the
   normalized rank), agg_min_by (min_by, max_by and first per
   l_orderkey), agg_abandon (a PARTIAL step over unique keys that
   abandons; the switch is printed), dyn_filter (lineitem joined to
   filtered partsupp on two keys: a pushed BETWEEN, and with an empty
   build the early finish, which reads no lineitem split) and wide_join
   (eight key words through the merge-rank). Each prints its walls, peak
   device memory, launches (B4 and B5 on every path, B2 on agg_percentile
   and wide_join) and dynamic filters.
17. types: raw (byte-matrix) strings, TIMESTAMP and DECIMAL(38) x short
   decimal, each path cold and warm with equal launches and exact against
   numpy and pyarrow oracles. The raw tables are made from the SF10
   orders and customer columns and --seed: o_cust_name and c_name
   ('Customer#%09d', class 32) and o_text (seeded ASCII text of 10-79
   bytes, class 128, a 1% of rows carrying 'special ... requests'), fed
   to Values with string_encoding "raw". Paths: raw_group (group by
   o_cust_name), raw_join (o_cust_name = c_name, then per c_nationkey),
   raw_topn (o_text, o_orderkey LIMIT 1000), raw_sort (the full sort of
   o_text), raw_filter (Q13's LIKE, then length, substr, strpos, upper,
   trim, concat and an ordered compare), raw_functions (the functions
   over every row, summed); over the lineitem scan dt_month
   (date_trunc/date_diff), dt_week_hour (a TIMESTAMP built by date_add,
   grouped by week and hour with min/max and to_unixtime), dt_zone
   (timezone_hour and at_timezone in America/New_York against Python's
   zoneinfo) and decimal_mul (a DECIMAL(38) sum of products and that sum
   times 3, against Python integers). Each prints its walls, peak device
   memory, launches (B2, B4 and B5 on the raw sort, group and join paths)
   and the rows upper/lower/trim sent to the host. Each cold run ingests
   (the Values ingest cache cleared first); each warm run takes its
   tables' batches from the cache. Then ingest_cache: raw_group twice, the
   second run one ingest-cache hit, the device root holding exactly the
   cached batch's bytes; a capped pool's reserve makes the arbitrator
   evict it; under a root cap below its bytes nothing is cached.
18. complex: ARRAY and MAP columns over the lineitem and orders scans,
   each plan cold and warm with equal launches, exact against numpy
   oracles over the generator's columns (integers only): cx_array_agg
   (array_agg of l_partkey and l_suppkey per l_orderkey, then
   cardinality, element_at, array_max, array_sort, array_distinct,
   reduce over transform, filter and any_match folded into sums; B4 and
   B2 or B3 must launch), cx_unnest (the arrays unnested with their
   ordinality: the count, sum(l_partkey), sum(l_partkey * l_linenumber)
   and 7; B5 must launch), cx_maps (histogram, set_agg, map_agg,
   multimap_agg and approx_most_frequent per l_suppkey, then map_keys,
   map_values, transform_values, map_filter, flatten and reduce folded
   into sums) and cx_map_union (map_union of the per-supplier histograms:
   each ship mode's count at the first supplier holding it; map_union
   keeps one arbitrary value of a repeated key, here the first), cx_join
   (the per-order arrays joined to the orders before 1995-03-15:
   cardinality, element_at and contains(p, o_custkey); B5 must launch)
   and cx_join_topn (its top 100 by o_totalprice DESC carrying the
   arrays, which the join and the TopN give explicit starts, out through
   to_arrow), cx_bloom (bloom_filter_agg(o_orderkey) of each
   o_orderpriority, as five filtered global aggregates, each sketch
   equal bit for bit to a numpy form of bloom_hashes). Each prints its
   walls, peak device memory and launches.
19. spark: Spark functions at the connector's scale, each plan cold and
   warm with equal launches, exact against oracles written here in
   numpy, re, hashlib and str (no port code): spark_shuffle_hash
   (pmod(hash(l_orderkey), 200), xxhash64(l_orderkey, l_linenumber,
   l_shipmode) and hash(l_extendedprice, cast(l_discount as double),
   l_shipdate) over lineitem, then per partition the count, min and max
   of the xxhash64 and the sum of the hash: murmur3_x86_32 and XXH64 in
   numpy), spark_runtime_filter (bloom_filter_agg of the orders before
   1993, EnforceSingleRow, a nested-loop join with lineitem, the filter
   might_contain, the inner join with those orders, per priority the
   count and revenue; and its pass-count plan, equal to a numpy bloom's:
   no false negative, the false-positive share printed), spark_strings
   (over part: regexp_extract as the group key, size, array_contains
   and sort_array of split(p_name, ' '), levenshtein, and a murmur3
   checksum of element_at, sha2 and substring_index), spark_remote (a remote
   function through a timed loopback transport over all o_custkey,
   summed; the host round trips and their seconds printed) and
   spark_string_hash (hash and xxhash64 of (l_orderkey, l_comment), the
   string under per-row seeds: its peak device memory beside the bytes
   of the reference's (rows x blocks) matrices a batch). Each prints its
   walls, peak device memory and launches; B5 must launch on every plan
   but spark_remote's, B4 and B2 or B3 on spark_shuffle_hash and
   spark_strings.

Every number a phase prints is measured in this run, on this card; bounds
are bytes over the H100's 3.35 TB/s.

Each path phase sets every kernel's launch count to 0 just before each
run of its query and reads the counts just after; the kernels line
reports the cold run's. Every phase line carries "offloads": the batches
an OrderBy, a join build and an aggregation moved to host RAM since the
line before. The line before the last is a
JSON object describing each kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from velox_tpu_torch import types as T
from velox_tpu_torch.common import metrics as M
from velox_tpu_torch.connectors.cache import DataCache
from velox_tpu_torch.connectors.tpch import (
    register_tpch, stage_column, storage_dtype,
)
from velox_tpu_torch.core import plan as P
from velox_tpu_torch.core.config import QueryConfig as QC
from velox_tpu_torch.core.plan import SortOrder
from velox_tpu_torch.core.stats import resolve_column_stats
from velox_tpu_torch.exec import groupby
from velox_tpu_torch.exec import hashtable as H
from velox_tpu_torch.exec import misc_ops
from velox_tpu_torch.exec.aggregation import AggregationOperator
from velox_tpu_torch.exec.join import HashJoinOperator
from velox_tpu_torch.exec.memory import MemoryPool
from velox_tpu_torch.exec.operator import IngestCache
from velox_tpu_torch.exec.orderby import OrderByOperator
from velox_tpu_torch.exec.sort import (
    _word_bits, num_value_words, pack_words_u64, radix_sort_perm, sort_words,
)
from velox_tpu_torch.exec.task import QueryCtx, Task
from velox_tpu_torch.exec.window import BoundType, FrameType, WindowFrame
from velox_tpu_torch.expression.eval import EvalValue
from velox_tpu_torch.functions import scalar as S
from velox_tpu_torch.native import build
from velox_tpu_torch.ops import radix as R
from velox_tpu_torch.ops import gather as G
from velox_tpu_torch.ops.filter_reduce import (
    MAX_COLS, filtered_sum_product,
    filtered_sum_product_reference, kernel_layout,
)
from velox_tpu_torch.ops.gather import (
    flat_gather, flat_gather_reference, gather_rows,
)
from velox_tpu_torch.testing.plan_builder import PlanBuilder
from velox_tpu_torch.tpch import tpch_plan
from velox_tpu_torch.tpch.queries import q18
from velox_tpu_torch.vector.device import to_arrow

D94, D95, D950315, D980902 = 8766, 9131, 9204, 10471  # days since 1970
HBM_BYTES_PER_S = 3.35e12  # H100 SXM spec sheet
L2_BYTES = 50e6
SECTOR = 32  # bytes of device memory a random read moves
Q6_FILTER = ("l_shipdate >= date '1994-01-01' and "
             "l_shipdate < date '1995-01-01' and "
             "l_discount between 0.05 and 0.07 and "
             "l_quantity < 24.0")
Q6_COLS = ["l_shipdate", "l_extendedprice", "l_quantity", "l_discount"]
Q1_COLS = ["l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
           "l_discount", "l_tax", "l_shipdate"]
SORT_COLS = ["l_shipdate", "l_orderkey", "l_linenumber"]
Q18_THRESHOLD = 300  # the spec's quantity threshold
LI_COLS = sorted(set(Q1_COLS + Q6_COLS + SORT_COLS
                     + ["l_suppkey", "l_partkey"]))
RADIX_KERNELS = (R.radix_hist, R.radix_rank, R.radix_pos)
Q1_PROJECT = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_extendedprice * (1.0 - l_discount) as l_sum_disc_price",
    "l_extendedprice * (1.0 - l_discount) * (1.0 + l_tax) as l_sum_charge",
    "l_discount"]


def topn_plan():
    """The orderBy config: ORDER BY l_shipdate, l_orderkey LIMIT 1000."""
    return (PlanBuilder().table_scan("lineitem", SORT_COLS[:2])
            .order_by(SORT_COLS[:2]).limit(1000).plan())


def sort_full_plan():
    return (PlanBuilder().table_scan("lineitem", SORT_COLS)
            .order_by(SORT_COLS).plan())


def q6_generic_plan():
    """Q6 with a filter the filter-sum matcher rejects."""
    return (PlanBuilder().table_scan(
        "lineitem", Q6_COLS, filter=f"({Q6_FILTER}) or l_quantity < 0.0")
        .project(["l_extendedprice * l_discount as revenue"])
        .single_aggregation([], ["sum(revenue) as revenue"]).plan())


# the TPC-H queries of the tpch_rest phase: all but the path phases'
REST_QUERIES = (2, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 19, 20,
                21, 22)
# tpch_rest's card-vs-CPU scale: the 18 queries took 163-198 s of CPU at
# SF 1 on an 8-core H100 host (PERF.md)
COMPARE_SF = 1.0
# relative tolerance of DOUBLE results: the reference oracle's
# (tests/tpch_sql.py TOLERANCES), 1e-9 unless listed
DOUBLE_REL_TOL = {17: 1e-6}

# the plan of each query path phase, by name (tools/profile_port_paths.py
# profiles the same plans); tpch_rest's queries as q2, q7, ...
PATH_PLANS = {
    "q1": lambda: tpch_plan(1),
    "topn": topn_plan,
    "sort_full": sort_full_plan,
    "q6": lambda: tpch_plan(6),
    "q6_generic": q6_generic_plan,
    "q3": lambda: tpch_plan(3),
    "q18": lambda: q18(threshold=float(Q18_THRESHOLD)),
}
PATH_PLANS.update({f"q{q}": (lambda q=q: tpch_plan(q))
                   for q in REST_QUERIES})


# the offload counters every phase line carries: batches moved to host RAM
# since the line before, by an OrderBy, a join build or an aggregation
OFFLOAD_KEYS = {"sort": M.K_SORT_OFFLOADS,
                "join_build": M.K_JOIN_BUILD_OFFLOADS,
                "agg": M.K_AGG_HOST_OFFLOADS}
_offloads_seen = dict.fromkeys(OFFLOAD_KEYS, 0)


def phase(name: str, **fields) -> None:
    counters = M.reporter().snapshot()["counters"]
    offloads = {}
    for k, key in OFFLOAD_KEYS.items():
        now = int(counters.get(key, 0))
        offloads[k], _offloads_seen[k] = now - _offloads_seen[k], now
    print(json.dumps({"phase": name, **fields, "offloads": offloads}),
          flush=True)


def time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: CUDA events around `calls` back-to-back
    calls, divided by `calls`; the median of `reps` such windows, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call with the host out of the window: `calls`
    calls captured into one CUDA graph (the wrappers launch on the current
    stream, which is the capture stream), each replay timed by CUDA
    events, divided by `calls`; the median of `reps` replays."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def device_phase() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, count=torch.cuda.device_count())
    return smi


def build_phase() -> None:
    build.load_kernels()
    if build.load_dbgen() is None:
        raise RuntimeError("no C++ compiler: the native TPC-H generator "
                           "did not build")
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in build.BUILD_LOG.items() if name != "dbgen"}
    # the place kernel (B2, B3) takes its shared memory dynamically, which
    # ptxas does not report: resident blocks per SM and bytes of each
    # instance from the occupancy API
    occupancy = {form: dict(zip(("blocks_per_sm", "dynamic_smem_bytes"),
                                R.place_occupancy(form)))
                 for form in R.PLACE_FORMS}
    phase("build", seconds=dict(build.BUILD_SECONDS), ptxas=ptxas,
          place_occupancy=occupancy)


def _case(rng, n: int, k: int, n_active: int, empty: bool):
    """k random int32 columns (negative values included), up to 3
    ranges, and the (a, b) product columns."""
    cols = [torch.from_numpy(rng.integers(-50_000, 50_000, n,
                                          dtype=np.int32)).cuda()
            for _ in range(k)]
    ranges = []
    for i in range(min(k, 3)):
        lo = int(rng.integers(-40_000, 0))
        ranges.append((i, lo, lo + int(rng.integers(0, 80_000))))
    if empty:
        ranges.append((0, 10, -10))  # lo > hi keeps nothing
    return cols, tuple(ranges), k - 1, 0, n_active


def _layout_case(rng, n: int, nr: int, np_: int):
    """A call whose kernel layout is (nr range columns, np_ product
    columns outside every range), over nr + np_ + 1 columns (the last one
    read by nothing): ranges keep about half of each column's values, `a`
    and `b` are the product columns, or range columns where there are
    fewer than two."""
    k = nr + np_
    cols = [torch.from_numpy(rng.integers(-50_000, 50_000, n,
                                          dtype=np.int32)).cuda()
            for _ in range(k + (k < MAX_COLS))]
    ranges = tuple((i, -30_000 + 1000 * i, 20_000) for i in range(nr))
    if np_ == 2:
        ai, bi = nr, nr + 1
    elif np_ == 1:  # b a range column, or a * a without ranges
        ai, bi = nr, 0 if nr else nr
    else:
        ai, bi = 0, nr - 1
    return cols, ranges, ai, bi


def _check_filter_sum(cols, ranges, ai, bi, na, what: str) -> int:
    got = filtered_sum_product(cols, ranges, ai, bi, na)
    ref = filtered_sum_product_reference(cols, ranges, ai, bi, na)
    err = abs(int(got.item()) - int(ref.item()))
    if err:
        raise AssertionError(f"kernel {got.item()} != plain {ref.item()} "
                             f"at {what}")
    return err


# B1's checked row counts, those of its layout and offset sweeps, and
# its timed ones (one SF10 lineitem batch, all of lineitem)
FILTER_SIZES = (1, 1000, 131089, 6_700_000, 60_000_000)
FILTER_SWEEP_SIZES = (1003, 131089, 6_700_000)
FILTER_TIMED = (6_700_000, 60_000_000)


def kernel_phase(rng) -> dict:
    cases = 0
    max_err = 0
    for n in FILTER_SIZES:
        for n_active in sorted({0, max(0, n - 17), n}):
            for k in ((1, 4, MAX_COLS) if n <= 131089 else (4,)):
                for empty in (False, True):
                    cols, ranges, ai, bi, na = _case(rng, n, k, n_active,
                                                     empty)
                    max_err = max(max_err, _check_filter_sum(
                        cols, ranges, ai, bi, na,
                        f"n={n} k={k} n_active={na} ranges={ranges}"))
                    cases += 1
    # every kernel instance: each (range columns, product columns outside
    # every range) layout a call over at most MAX_COLS columns can have
    layouts = [(nr, np_) for np_ in range(3)
               for nr in range(MAX_COLS + 1 - np_) if nr + np_]
    for nr, np_ in layouts:
        for n in FILTER_SWEEP_SIZES:
            cols, ranges, ai, bi = _layout_case(rng, n, nr, np_)
            if kernel_layout(ranges, ai, bi).instance != (nr, np_):
                raise AssertionError(f"layout case {nr, np_} maps to "
                                     f"{kernel_layout(ranges, ai, bi)}")
            for na in (n - 17, n):
                max_err = max(max_err, _check_filter_sum(
                    cols, ranges, ai, bi, na,
                    f"layout {nr, np_} n={n} n_active={na}"))
                cases += 1
    # every 16-byte offset of the columns, all alike (a scalar head and
    # tail around the 16-byte body) and all different (the scalar loop)
    for n in FILTER_SWEEP_SIZES[1:]:
        base, ranges, ai, bi, _ = _case(rng, n + 3, 4, 0, False)
        for offs in ((0,) * 4, (1,) * 4, (2,) * 4, (3,) * 4, (0, 1, 2, 3),
                     (3, 1, 0, 2)):
            cols = [c[o:o + n] for c, o in zip(base, offs)]
            for na in (n - 17, n - 2, n):
                max_err = max(max_err, _check_filter_sum(
                    cols, ranges, ai, bi, na, f"offsets {offs} n={n} "
                    f"n_active={na}"))
                cases += 1
    # a running total carried across calls, as FilterSumOperator does
    total = torch.zeros((), dtype=torch.int64, device="cuda")
    want = 0
    for i, n in enumerate(FILTER_SWEEP_SIZES + (4097,)):
        cols, ranges, ai, bi, _ = _case(rng, n, 4, n - i, i == 3)
        na = torch.tensor(n - i, dtype=torch.int32, device="cuda")
        filtered_sum_product(cols, ranges, ai, bi, na, out=total)
        want += int(filtered_sum_product_reference(cols, ranges, ai, bi,
                                                   na).item())
        err = abs(int(total.item()) - want)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"running total {total.item()} != {want} "
                                 f"after {i + 1} calls")
        cases += 1
    timings = {}
    for n in FILTER_TIMED:
        # the Q6 shape: 4 columns, 3 ranges, `a` outside every range (so it
        # is loaded only for groups where some row passes), n_active on the
        # device, the sum added into a running total as on the path
        cols, ranges, ai, bi, _ = _case(rng, n, 4, n, False)
        na = torch.tensor(n - 17, dtype=torch.int32, device="cuda")
        acc = torch.zeros((), dtype=torch.int64, device="cuda")
        # every column a range that keeps every row: each row loads all
        # 4 columns, 16 bytes, the count the bandwidth figure divides by
        full = tuple((i, -50_000, 50_000) for i in range(4))
        for rs, what in ((ranges, "the Q6 shape"),
                         (full, "every column a range")):
            max_err = max(max_err, _check_filter_sum(
                cols, rs, ai, bi, na, f"timed n={n}, {what}"))
            cases += 1
        t = {
            "ms": time_ms(lambda: filtered_sum_product(cols, ranges, ai, bi,
                                                       na, out=acc)),
            "plain_ms": time_ms(lambda: filtered_sum_product_reference(
                cols, ranges, ai, bi, na)),
            "all_read_ms": time_ms(lambda: filtered_sum_product(
                cols, full, ai, bi, na, out=acc)),
        }
        if n == FILTER_TIMED[0]:
            t["graph_ms"] = graph_ms(lambda: filtered_sum_product(
                cols, ranges, ai, bi, na, out=acc))
        t["all_read_bytes_per_s"] = 16 * (n - 17) / (t["all_read_ms"] / 1e3)
        # least bytes of the Q6 shape: each range column over the active
        # rows, a product column outside every range only where all pass,
        # and the 8-byte sum
        keep = torch.ones(n - 17, dtype=torch.bool, device="cuda")
        for c, lo, hi in ranges:
            keep &= (cols[c][:n - 17] >= lo) & (cols[c][:n - 17] <= hi)
        n_pass = int(keep.sum().item())
        full = {c for c, _, _ in ranges}
        t["bytes"] = (4 * len(full) * (n - 17)
                      + 4 * len({ai, bi} - full) * n_pass + 8)
        t["bound_ms"] = bound_ms(t["bytes"])
        timings[n] = t
        del cols
    phase("kernel", cases=cases, max_abs_err=max_err,
          layouts=[list(x) for x in layouts],
          times={str(n): t for n, t in timings.items()})
    return {"max_abs_err": max_err, "timings": timings}


def q6_oracle(li) -> int:
    m = ((li["l_shipdate"] >= D94) & (li["l_shipdate"] < D95)
         & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
         & (li["l_quantity"] < 2400))
    return int((li["l_extendedprice"][m].astype(np.int64)
                * li["l_discount"][m].astype(np.int64)).sum())


def q6_value(out) -> int:
    """Q6's revenue from its one output batch, both limbs checked."""
    col = out[0].columns["revenue"]
    value = int(col.data[0].item())
    hi = int(col.children[0].data[0].item())
    if hi != (-1 if value < 0 else 0):
        raise AssertionError(f"Q6 high limb {hi} for {value}")
    return value


def q6_phase(conn, ctx, li) -> dict:
    rows = conn.gen.num_rows("lineitem")
    n_splits = len(conn.default_splits("lineitem"))
    expect = q6_oracle(li)
    counter = M.K_FILTER_SUM_KERNEL
    fired0 = M.reporter().snapshot()["counters"].get(counter, 0)

    def check(out, counts):
        got = q6_value(out)
        if got != expect:
            raise AssertionError(f"Q6 {got} != numpy oracle {expect}")
        _expect_launches("q6", counts, {"filter_sum": n_splits,
                                        "flat_gather": 0, "gather_rows": 0})

    runs = path_runs(PATH_PLANS["q6"](), conn, ctx, check)
    fired = M.reporter().snapshot()["counters"].get(counter, 0) - fired0
    if fired != len(runs):
        raise AssertionError(f"K_FILTER_SUM_KERNEL fired {fired} times, "
                             "expected once per run")
    phase("q6", sf=conn.scale_factor, lineitem_rows=rows, splits=n_splits,
          revenue_scaled_e4=expect, **_runs_fields(runs),
          rows_per_s={r: rows / v["wall_s"] for r, v in runs.items()})
    return runs["cold"]["launches"]


def eviction_phase(conn, ctx, li) -> None:
    """Q6 three times with the default prefetch and a cache budget of half
    one run's scan (at least its largest batch): every run evicts entries
    while the query still reads earlier batches, and the freed device
    blocks go back to the allocator for the next uploads. Every run must
    stay exact."""
    cache = DataCache.instance()
    expect = q6_oracle(li)
    cache.clear()
    _run(PATH_PLANS["q6"](), ctx)
    run_bytes = cache.used
    small = max(run_bytes // 2, max(b.nbytes for _, b in cache.entries()))
    budget = cache.budget
    evicted0 = M.reporter().snapshot()["counters"].get(
        M.K_SCAN_CACHE_EVICTIONS, 0)
    cache.clear()
    cache.budget = small
    walls = []
    try:
        for _ in range(3):
            out, wall, counts = _run(PATH_PLANS["q6"](), ctx)
            got = q6_value(out)
            if got != expect:
                raise AssertionError(f"Q6 under evictions: {got} != numpy "
                                     f"oracle {expect}")
            walls.append(wall)
    finally:
        cache.budget = budget
        cache.clear()
    evicted = M.reporter().snapshot()["counters"].get(
        M.K_SCAN_CACHE_EVICTIONS, 0) - evicted0
    if evicted <= 0:
        raise AssertionError("no cache entry was evicted")
    phase("eviction", run_scan_bytes=run_bytes, budget=small,
          evictions=evicted, wall_s=walls)


def _head_sums(plan, ctx):
    """Active-row count and per-column sums of a plan's batches, reduced
    on the card, plus the wall of the run."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = Task(plan, ctx)
    count = torch.zeros((), dtype=torch.int64, device=ctx.device)
    sums = {}
    for b in task.batches():
        count += b.mask.sum()
        for name, c in b.columns.items():
            s = torch.where(b.mask, c.data.long(), 0).sum()
            sums[name] = s if name not in sums else sums[name] + s
    task.check_errors()
    out = {k: int(v.item()) for k, v in sums.items()}
    return int(count.item()), out, time.perf_counter() - t0


def heads_phase(ctx, li) -> None:
    q6 = (PlanBuilder().table_scan("lineitem", Q6_COLS, filter=Q6_FILTER)
          .project(["l_extendedprice * l_discount as revenue"]).plan())
    m6 = ((li["l_shipdate"] >= D94) & (li["l_shipdate"] < D95)
          & (li["l_discount"] >= 5) & (li["l_discount"] <= 7)
          & (li["l_quantity"] < 2400))
    want6 = {"revenue": (li["l_extendedprice"] * li["l_discount"])[m6].sum()}

    q1 = (PlanBuilder().table_scan("lineitem", Q1_COLS,
                                   filter="l_shipdate <= date '1998-09-02'")
          .project(Q1_PROJECT).plan())
    m1 = li["l_shipdate"] <= D980902
    disc = li["l_extendedprice"] * (100 - li["l_discount"])
    cols1 = {c: li[c] for c in ("l_returnflag", "l_linestatus", "l_quantity",
                                "l_extendedprice", "l_discount")}
    cols1["l_sum_disc_price"] = disc
    cols1["l_sum_charge"] = disc * (100 + li["l_tax"])
    want1 = {k: v[m1].sum() for k, v in cols1.items()}

    for name, plan, mask, want in (("q6_head", q6, m6, want6),
                                   ("q1_head", q1, m1, want1)):
        count, got, wall = _head_sums(plan, ctx)
        want = {k: int(v) for k, v in want.items()}
        if count != int(mask.sum()) or got != want:
            raise AssertionError(f"{name}: rows {count} vs {int(mask.sum())}"
                                 f", sums {got} vs {want}")
        phase(name, active_rows=count, columns=sorted(got), wall_s=wall)


def _old_host_form(arrays, dtypes, cap) -> dict:
    """The data source's host form before the one-pass staging: zeros,
    astype, a slice copy, into pageable memory."""
    out = {}
    for c, arr in arrays.items():
        np_dt = torch.empty(0, dtype=dtypes[c]).numpy().dtype
        data = np.zeros((cap,), np_dt)
        data[:len(arr)] = arr.astype(np_dt)
        out[c] = data
    return out


def scan_phase(conn) -> dict:
    """One SF10 lineitem split of Q1's seven columns, uploaded in the
    earlier form (zeros, astype and a slice copy on the host, then a
    pageable ``.to``, which the driver stages through its own buffer) and
    in the data source's form (one pass into pinned memory, then a
    ``non_blocking`` copy on a stream of its own), in turns: host ms, copy
    ms (host clock to the copies' end) and GB/s of each, and the whole
    ``_to_batch`` of the source, which overlaps a column's narrowing with
    the previous column's copy. The device bytes must be equal."""
    dev = torch.device("cuda")
    split = conn.default_splits("lineitem")[0]
    arrays = conn.gen.generate("lineitem", split.lo, split.hi, Q1_COLS)
    src = conn.create_data_source("lineitem", Q1_COLS, QueryCtx(dev))
    cap = src._capacity
    dtypes = {c: storage_dtype("lineitem", c) for c in Q1_COLS}
    nbytes = sum(cap * torch.empty(0, dtype=d).element_size()
                 for d in dtypes.values())
    stream = torch.cuda.Stream(dev)

    def old_form():
        t0 = time.perf_counter()
        host = _old_host_form(arrays, dtypes, cap)
        t1 = time.perf_counter()
        out = {c: torch.from_numpy(h).to(dev) for c, h in host.items()}
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1, out

    def new_form():
        t0 = time.perf_counter()
        host = {c: stage_column(a, dtypes[c], cap, pin=True)
                for c, a in arrays.items()}
        t1 = time.perf_counter()
        with torch.cuda.stream(stream):
            out = {c: h.to(dev, non_blocking=True) for c, h in host.items()}
        stream.synchronize()
        return t1 - t0, time.perf_counter() - t1, out

    def to_batch():
        t0 = time.perf_counter()
        src._to_batch(arrays)
        return time.perf_counter() - t0

    # the process's first pinned buffers (the phase runs before any
    # query); the host allocator caches them from here on
    first = {"new": new_form()[:2], "old": old_form()[:2]}
    times = {"old": [], "new": [], "to_batch": []}
    for i in range(6):
        for form in (("old", "new") if i % 2 == 0 else ("new", "old")):
            host_s, copy_s, _ = old_form() if form == "old" else new_form()
            times[form].append((host_s, copy_s))
        times["to_batch"].append(to_batch())
    _, _, old = old_form()
    _, _, new = new_form()
    for c in Q1_COLS:
        if old[c].dtype != new[c].dtype or not torch.equal(old[c], new[c]):
            raise AssertionError(f"scan: {c} differs between the forms")
    forms = {}
    for form in ("old", "new"):
        host_ms = statistics.median(h for h, _ in times[form]) * 1e3
        copy_ms = statistics.median(c for _, c in times[form]) * 1e3
        forms[form] = {"host_ms": host_ms, "copy_ms": copy_ms,
                       "total_ms": host_ms + copy_ms,
                       "h2d_gb_per_s": nbytes / copy_ms / 1e6,
                       "first_call_ms": [x * 1e3 for x in first[form]]}
    forms["new"]["to_batch_ms"] = statistics.median(
        times["to_batch"]) * 1e3
    phase("scan", rows=len(arrays[Q1_COLS[0]]), capacity=cap,
          columns=len(Q1_COLS), device_bytes=nbytes, forms=forms)
    DataCache.instance().clear()
    return forms


def lineitem_columns(conn):
    """Every lineitem column the oracles read, for the whole table, as
    int64 host arrays (the generator the connector uses)."""
    n_orders = conn.gen.num_rows("orders")
    return {k: v.astype(np.int64) for k, v in conn.gen.gen_lineitem(
        0, n_orders, LI_COLS).items()}


def reset_launches() -> None:
    filtered_sum_product.launches = 0
    flat_gather.launches = 0
    gather_rows.launches = 0
    for k in RADIX_KERNELS:
        k.launches = 0


def read_launches() -> dict:
    out = {"filter_sum": filtered_sum_product.launches,
           "flat_gather": flat_gather.launches,
           "gather_rows": gather_rows.launches}
    out.update({k.__name__: k.launches for k in RADIX_KERNELS})
    return out


def bound_ms(nbytes: float) -> float:
    """Least time to move `nbytes` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# radix_kernels: B2, B3, B4 against their plain versions
# ---------------------------------------------------------------------------

RADIX_SIZES = (1, 255, 4097, 131089, 6_700_000, 60_000_000)
TIMED_SIZES = (6_700_000, 60_000_000)  # one SF10 batch, all of lineitem
RADIX_DISTS = ("uniform", "one_digit", "w1", "w2", "w7", "sorted",
               "reversed")
TIMED_DISTS = ("uniform", "one_digit")
ORDERBY_KEY_BITS = 39  # the orderBy key's width at SF10 (1 + 12 + 26)


def _digits(dist: str, n: int, gen) -> torch.Tensor:
    if dist == "one_digit":
        return torch.full((n,), 173, dtype=torch.int32, device="cuda")
    width = int(dist[1:]) if dist.startswith("w") else 8
    d = torch.randint(0, 1 << width, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    if dist == "sorted":
        d = torch.sort(d).values
    elif dist == "reversed":
        d = torch.sort(d, descending=True).values
    return d.contiguous()


def _states(d: torch.Tensor, gen):
    """Int64 sort states whose low 8 bits are the digits `d`: (name,
    state) with random upper bits, the sign bit included, and a packed one
    as the scatter branch builds it, row id high and key low, the two
    filling all 64 bits."""
    n = d.shape[0]
    hi = torch.randint(-2 ** 63, 2 ** 63 - 1, (n,), generator=gen,
                       device="cuda", dtype=torch.int64)
    yield "random_high", (hi & ~255) | d.long()
    key_bits = 64 - max(1, n - 1).bit_length()
    key = (hi & ((1 << key_bits) - 1)) & ~255 | d.long()
    yield "row_id_and_key_64", (torch.arange(n, device="cuda")
                                << key_bits) | key


def _words(d: torch.Tensor, gen):
    """An int32 sort word whose low 8 bits are the digits `d` under random
    upper bits, bit 31 included, and a random int32 permutation."""
    n = d.shape[0]
    hi = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=gen,
                       device="cuda", dtype=torch.int32)
    perm = torch.randperm(n, generator=gen, device="cuda")
    return ((hi & ~255) | d).contiguous(), perm.to(torch.int32)


def _modes(d: torch.Tensor):
    """(name, kernel call, plain call) of each digit mode, on one digit
    tensor; the tables B2 and B3 read come from the kernel histogram's
    scan."""
    table = R.radix_hist(d)
    offset = R._tile_offsets(table)[0].contiguous()
    tile_base = R._destinations(table)
    return (
        ("radix_hist", lambda: R.radix_hist(d),
         lambda: R.radix_hist_reference(d)),
        ("radix_rank", lambda: R.radix_rank(d, offset),
         lambda: R.radix_rank_reference(d, offset)),
        ("radix_pos", lambda: R.radix_pos(d, tile_base),
         lambda: R.radix_pos_reference(d, tile_base)),
    )


def _state_modes(state: torch.Tensor, width: int):
    """(name, kernel call, plain call) of the histogram and B3's scatter
    form over an int64 state at one digit width."""
    dest = R._destinations(R.radix_hist_reference(state, width))
    return (
        ("radix_hist_state", lambda: R.radix_hist(state, width),
         lambda: R.radix_hist_reference(state, width)),
        ("radix_scatter_pass",
         lambda: R.radix_scatter_pass(state, width, dest),
         lambda: R.radix_scatter_pass_reference(state, width, dest)),
    )


def _word_modes(word: torch.Tensor, perm: torch.Tensor, width: int):
    """(name, kernel call, plain call) of the histogram and B2's
    rank-and-scatter form over an int32 word and permutation at one digit
    width, with the word lane and without it (a word's last pass)."""
    dest = R._destinations(R.radix_hist_reference(word, width))
    return (
        ("radix_hist_word", lambda: R.radix_hist(word, width),
         lambda: R.radix_hist_reference(word, width)),
        ("radix_rank_scatter",
         lambda: R.radix_rank_scatter(word, width, perm, dest),
         lambda: R.radix_rank_scatter_reference(word, width, perm, dest)),
        ("radix_rank_scatter_last",
         lambda: R.radix_rank_scatter(word, width, perm, dest, False),
         lambda: R.radix_rank_scatter_reference(word, width, perm, dest,
                                                False)),
    )


def classic_pass(word: torch.Tensor, perm: torch.Tensor, width: int):
    """One pass of the classic loop as exec/sort.py runs it: two launches
    and a scan, the word carried beside the permutation."""
    table = R.radix_hist(word, width)
    return R.radix_rank_scatter(word, width, perm, R._destinations(table))


def classic_glue_pass(word: torch.Tensor, perm: torch.Tensor,
                      width: int) -> torch.Tensor:
    """The same pass in its earlier form, over the int64 word in row order
    and the int64 permutation: the word gathered through the permutation,
    the digit extracted, B4, the per-digit scan, B2's rank form, the
    256-entry gather, and an index_put of the permutation."""
    d = (word[perm] & ((1 << width) - 1)).to(torch.int32)
    pos = R.radix_pass_positions(d, d.shape[0])
    nxt = torch.empty_like(perm)
    nxt[pos] = perm
    return nxt


def fused_pass(state: torch.Tensor, width: int) -> torch.Tensor:
    """One scatter-branch pass as exec/sort.py runs it: two launches and
    a scan."""
    table = R.radix_hist(state, width)
    return R.radix_scatter_pass(state, width, R._destinations(table))


def glue_pass(state: torch.Tensor, width: int) -> torch.Tensor:
    """The same pass in its earlier form: digit extraction, the
    histogram, the scan, B2's place kernel given the destinations (the
    kernel B3 used to launch), the shift, and an index_put."""
    d = R.low_digits(state, width)
    pos = R.radix_rank(d, R._destinations(R.radix_hist(d)))
    nxt = torch.empty_like(state)
    nxt[pos] = (state >> width) & ((1 << (64 - width)) - 1)
    return nxt


def _max_err(a, b) -> int:
    if isinstance(a, tuple):  # B2's rank-and-scatter: (word or None, perm)
        if len(a) != len(b) or any((x is None) != (y is None)
                                   for x, y in zip(a, b)):
            raise AssertionError(f"kernel lanes {a} vs plain lanes {b}")
        return max(_max_err(x, y) for x, y in zip(a, b) if x is not None)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"kernel {a.dtype} {tuple(a.shape)} vs plain "
                             f"{b.dtype} {tuple(b.shape)}")
    if torch.equal(a, b):
        return 0
    # int64 states differ by more than an int64 holds: a difference
    # counts at least 1
    return max(1, int((a.long() - b.long()).abs().max().item()))


def _sort_keys(li, n: int, cols, conn):
    """sort_words of the first n lineitem rows by `cols` (ascending),
    narrowed by the connector's stats, on the card."""
    cap = max(1024, -(-n // 1024) * 1024)
    vals = []
    for c in cols:
        data = np.zeros(cap, np.int32 if c != "l_orderkey" else np.int64)
        data[:n] = li[c][:n]
        dt = {"l_shipdate": T.DATE, "l_orderkey": T.BIGINT,
              "l_linenumber": T.INTEGER}[c]
        vals.append(EvalValue(torch.from_numpy(data).cuda(), None, dt))
    active = torch.arange(cap, device="cuda") < n
    ranges = [conn.column_stats("lineitem", c) for c in cols]
    words, bits = sort_words(vals, [SortOrder.ASC_NULLS_LAST] * len(cols),
                             cap, active, ranges)
    return words, bits, cap


def _check_modes(modes, max_err, what: str) -> None:
    for name, kernel, plain in modes:
        err = _max_err(kernel(), plain())
        max_err[name] = max(max_err.get(name, 0), err)
        if err:
            raise AssertionError(f"{name} differs from its plain version by "
                                 f"{err} at {what}")


def _time_modes(modes, calls: int, bytes_per_row: dict, n: int,
                table_bytes: int, hostless: bool) -> dict:
    """ms, plain_ms and bound_ms of each mode: the bound moves each row's
    bytes once, and the table once. With `hostless`, also the kernel's
    time from a captured CUDA graph (graph_ms) beside the event
    window's."""
    out = {}
    for name, kernel, plain in modes:
        out[name] = {"ms": time_ms(kernel, calls),
                     "plain_ms": time_ms(plain, calls),
                     "bound_ms": bound_ms(bytes_per_row[name] * n
                                          + table_bytes),
                     "library_ms": None}
        if hostless:
            out[name]["graph_ms"] = graph_ms(kernel, calls)
    return out


# bytes a row each kernel must move: B4 reads digits or a word (4) or the
# state (8); B2's rank form and B3's positions read digits and write
# positions; B3's scatter reads the state and writes the next one; B2's
# rank-and-scatter reads the word and the permutation and writes both
# (the permutation alone on a word's last pass)
ROW_BYTES = {"radix_hist": 4, "radix_hist_state": 8, "radix_hist_word": 4,
             "radix_rank": 8, "radix_pos": 8, "radix_scatter_pass": 16,
             "radix_rank_scatter": 16, "radix_rank_scatter_last": 12}


def radix_phase(seed: int, conn, li) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    max_err = {}
    cases = 0
    for n in RADIX_SIZES:
        for dist in RADIX_DISTS:
            d = _digits(dist, n, gen)
            _check_modes(_modes(d), max_err, f"n={n} digits={dist}")
            for kind, state in _states(d, gen):
                for width in range(1, 9):
                    _check_modes(_state_modes(state, width), max_err,
                                 f"n={n} digits={dist} state={kind} "
                                 f"width={width}")
                    cases += 1
                del state
            word, perm = _words(d, gen)
            for width in range(1, 9):
                _check_modes(_word_modes(word, perm, width), max_err,
                             f"n={n} digits={dist} word width={width}")
                cases += 1
            del word, perm
            want = R.radix_pass_positions_reference(d, n)
            for fn in (R.radix_pass_positions,
                       R.radix_pass_positions_nogather):
                if _max_err(fn(d, n), want):
                    raise AssertionError(f"{fn.__name__} is not the stable "
                                         f"counting-sort order at n={n} "
                                         f"digits={dist}")
            cases += 1
            del d
    torch.cuda.synchronize()
    timings = {}
    for n in TIMED_SIZES:
        calls = 20 if n < 10_000_000 else 5
        table_bytes = 4 * R.RADIX * (-(-n // R.TILE_ROWS))
        t = {}
        for dist in TIMED_DISTS:
            d = _digits(dist, n, gen)
            state = next(_states(d, gen))[1]
            word, perm = _words(d, gen)
            modes = (_modes(d) + _state_modes(state, 8)
                     + _word_modes(word, perm, 8))
            t[dist] = _time_modes(modes, calls, ROW_BYTES, n, table_bytes,
                                  hostless=n < 10_000_000)
            # a plain copy of the bytes B2 and B3 read and write (digits in
            # and positions out; the state, or the word and permutation, in
            # and out): what a streaming pass over them takes on this card
            copies = {}
            for src_ in (d, state):
                dst = torch.empty_like(src_)
                copies[2 * src_.element_size()] = time_ms(
                    lambda: dst.copy_(src_), calls)
                del dst
            for name, v in t[dist].items():
                if not name.startswith("radix_hist") \
                        and ROW_BYTES[name] in copies:
                    v["copy_ms"] = copies[ROW_BYTES[name]]
            # B4's one-call equivalent: torch.bincount of the (digit, tile)
            # cell keys, computed before the timed window
            cells = R._cell_keys(d)
            lib = time_ms(lambda: torch.bincount(
                cells, minlength=table_bytes // 4), calls)
            for name in ("radix_hist", "radix_hist_state",
                         "radix_hist_word"):
                t[dist][name]["library_ms"] = lib
            del d, state, word, perm, cells, modes
        # one whole scatter-branch pass over the orderBy key's state, in
        # both forms, back to back (fused, glue, glue, fused)
        key = torch.randint(0, 1 << ORDERBY_KEY_BITS, (n,), generator=gen,
                            device="cuda", dtype=torch.int64)
        state = (torch.arange(n, device="cuda") << ORDERBY_KEY_BITS) | key
        if _max_err(fused_pass(state, 8), glue_pass(state, 8)):
            raise AssertionError(f"the fused pass differs from the glue "
                                 f"pass at n={n}")
        fused = [time_ms(lambda: fused_pass(state, 8), calls)]
        glue = [time_ms(lambda: glue_pass(state, 8), calls)]
        glue.append(time_ms(lambda: glue_pass(state, 8), calls))
        fused.append(time_ms(lambda: fused_pass(state, 8), calls))
        t["pass_39_bit_state"] = {"fused_ms": fused, "glue_ms": glue}
        # one whole classic-loop pass over a 32-bit word, in both forms,
        # in turns (new, old, old, new); the new form's word is the int32
        # bits of the old form's, already in the permutation's order
        word64 = torch.randint(0, 1 << 32, (n,), generator=gen,
                               device="cuda", dtype=torch.int64)
        perm64 = torch.randperm(n, generator=gen, device="cuda")
        word, perm = _word_bits(word64)[perm64], perm64.to(torch.int32)
        if _max_err(classic_pass(word, perm, 8)[1].long(),
                    classic_glue_pass(word64, perm64, 8)):
            raise AssertionError(f"the classic pass differs from its glue "
                                 f"form at n={n}")
        new = [time_ms(lambda: classic_pass(word, perm, 8), calls)]
        old = [time_ms(lambda: classic_glue_pass(word64, perm64, 8), calls)]
        old.append(time_ms(lambda: classic_glue_pass(word64, perm64, 8),
                           calls))
        new.append(time_ms(lambda: classic_pass(word, perm, 8), calls))
        t["classic_pass"] = {"ms": new, "glue_ms": old}
        del word64, perm64, word, perm
        d = R.low_digits(state, 8)
        t["pass_nogather"] = {
            "ms": time_ms(lambda: R.radix_pass_positions_nogather(d, n),
                          calls),
            "plain_ms": time_ms(
                lambda: R.radix_pass_positions_reference(d, n), calls)}
        timings[n] = t
        del key, state, d
    # whole sorts: the orderBy key over one batch and the full-sort key
    # over the table, against a stable torch.sort of the packed lane
    sorts = {}
    n_all = len(li["l_orderkey"])
    for name, cols, n in (("orderby_key", SORT_COLS[:2], 6_700_000),
                          ("full_sort_key", SORT_COLS, n_all)):
        n = min(n, n_all)
        words, bits, cap = _sort_keys(li, n, cols, conn)
        lanes = pack_words_u64(words, bits)
        if len(lanes) != 1 or sum(bits) >= 64:
            raise AssertionError(f"{name}: {sum(bits)} key bits, "
                                 f"{len(lanes)} lanes")
        perm = radix_sort_perm(words, bits, cap)
        ref = torch.sort(lanes[0], stable=True).indices
        if _max_err(perm, ref):
            raise AssertionError(f"{name}: radix permutation differs from "
                                 "the stable torch.sort permutation")
        calls = 5 if n < 10_000_000 else 2
        sorts[name] = {
            "rows": n, "key_bits": sum(bits),
            "radix_sort_perm_ms": time_ms(
                lambda: radix_sort_perm(words, bits, cap), calls, 3),
            "torch_sort_ms": time_ms(
                lambda: torch.sort(lanes[0], stable=True).indices, calls, 3)}
        del words, lanes, perm, ref
    phase("radix_kernels", cases=cases, max_abs_err=max_err,
          times={str(n): t for n, t in timings.items()}, sorts=sorts)
    return {"max_abs_err": max_err, "timings": timings, "sorts": sorts}


# ---------------------------------------------------------------------------
# Query paths of this slice
# ---------------------------------------------------------------------------

def _host_rows(batches, names):
    """Active rows of output batches on the host: {name: python ints or
    strings}, long decimals through both limbs."""
    out = {n: [] for n in names}
    for b in batches:
        mask = b.mask.cpu().numpy()
        for n in names:
            col = b.columns[n]
            data = col.data.cpu().numpy()[mask]
            if col.validity is not None \
                    and not col.validity.cpu().numpy()[mask].all():
                raise AssertionError(f"unexpected NULL in {n}")
            if col.dtype.is_long_decimal:
                hi = col.children[0].data.cpu().numpy()[mask]
                vals = [(int(h) << 64) | (int(lo) & (2 ** 64 - 1))
                        for lo, h in zip(data, hi)]
            elif col.dictionary is not None:
                # take() formats a VirtualDictionary's values (c_name)
                vals = list(col.dictionary.take(data))
            else:
                vals = [int(x) for x in data]
            out[n].extend(vals)
    return out


def _psum(a: np.ndarray) -> int:
    """Exact sum of an int64 array as a Python int (chunked, no int64
    overflow)."""
    return sum(int(a[i:i + (1 << 20)].sum()) for i in range(0, len(a),
                                                           1 << 20))


def _half_up(s: int, c: int) -> int:
    q = (abs(s) + c // 2) // c
    return -q if s < 0 else q


def q1_oracle(li) -> dict:
    flags, status = np.array(["A", "N", "R"]), np.array(["F", "O"])
    m = li["l_shipdate"] <= D980902
    q, p = li["l_quantity"], li["l_extendedprice"]
    d, t = li["l_discount"], li["l_tax"]
    out = {k: [] for k in ("l_returnflag", "l_linestatus", "sum_qty",
                           "sum_base_price", "sum_disc_price",
                           "sum_charge", "avg_qty", "avg_price", "avg_disc",
                           "count_order")}
    for fi in range(3):
        for si in range(2):
            sel = m & (li["l_returnflag"] == fi) & (li["l_linestatus"] == si)
            c = int(sel.sum())
            if not c:
                continue
            disc_price = p[sel] * (100 - d[sel])
            out["l_returnflag"].append(str(flags[fi]))
            out["l_linestatus"].append(str(status[si]))
            out["sum_qty"].append(_psum(q[sel]))
            out["sum_base_price"].append(_psum(p[sel]))
            out["sum_disc_price"].append(_psum(disc_price))
            out["sum_charge"].append(_psum(disc_price * (100 + t[sel])))
            out["avg_qty"].append(_half_up(_psum(q[sel]), c))
            out["avg_price"].append(_half_up(_psum(p[sel]), c))
            out["avg_disc"].append(_half_up(_psum(d[sel]), c))
            out["count_order"].append(c)
    return out


def _run(plan, ctx, tasks=None):
    """(output batches, wall, launch counts) of one query; the counts are
    reset just before it and read just after. The Task goes into
    ``tasks`` when given."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = Task(plan, ctx)
    out = list(task.batches())
    task.check_errors()
    torch.cuda.synchronize()
    if tasks is not None:
        tasks.append(task)
    return out, time.perf_counter() - t0, read_launches()


def scan_splits(conn, plan) -> int:
    """Splits the plan's scans read: each TableScan reads every split of
    its table."""
    n = len(conn.default_splits(plan.table)) \
        if isinstance(plan, P.TableScanNode) else 0
    return n + sum(scan_splits(conn, s) for s in plan.sources)


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """A position-weighted int64 sum of a tensor's values (wrapping), on
    the card: any changed, moved or swapped value changes it."""
    w = torch.arange(t.numel(), device=t.device) % 65521 + 1
    return (t.reshape(-1).long() * w).sum()


def cache_checksums() -> dict:
    """One checksum a tensor of every scan-cache entry."""
    sums = {}
    for key, b in DataCache.instance().entries():
        ts = [b.mask]
        for c in b.columns.values():
            ts += [c.data] + ([c.validity] if c.validity is not None
                              else []) + [ch.data for ch in c.children]
        sums[key] = torch.stack([_checksum(t) for t in ts]).tolist()
    return sums


def path_runs(plan, conn, ctx, check) -> dict:
    """Three runs of a path, each exact (``check(out, launch counts)``):
    cold (the scan cache cleared just before), warm (every split from the
    cache), and cold again with the scan's producer thread off
    (SCAN_PREFETCH_DEPTH 0). Cold runs must miss once a split their scans
    read and hit nothing; the warm run must hit as often and miss
    nothing; the cache's entries must be unchanged across the warm run."""
    cache = DataCache.instance()
    n = scan_splits(conn, plan)
    serial = QueryCtx(ctx.device, {QC.SCAN_PREFETCH_DEPTH: 0})
    runs = {}
    for run, c in (("cold", ctx), ("warm", ctx), ("prefetch_0", serial)):
        if run != "warm":
            cache.clear()
        hits, misses = cache.hits, cache.misses
        out, wall, counts = _run(plan, c)
        check(out, counts)
        got = (cache.hits - hits, cache.misses - misses)
        want = (n, 0) if run == "warm" else (0, n)
        if got != want:
            raise AssertionError(f"{run} run: cache (hits, misses) {got}, "
                                 f"expected {want}")
        if run == "cold":
            sums = cache_checksums()
        elif run == "warm" and cache_checksums() != sums:
            raise AssertionError("the warm run changed a cached batch")
        runs[run] = {"wall_s": wall, "cache_hits": got[0],
                     "cache_misses": got[1], "launches": counts}
    if runs["warm"]["launches"] != runs["cold"]["launches"]:
        raise AssertionError("warm and cold runs launched differently")
    return runs


def _runs_fields(runs) -> dict:
    """A path phase's line: the walls and cache lookups of its runs and
    the cold run's launch counts."""
    return {"wall_s": {r: v["wall_s"] for r, v in runs.items()},
            "cache": {r: [v["cache_hits"], v["cache_misses"]]
                      for r, v in runs.items()},
            "cached_entries": len(DataCache.instance().entries()),
            "launches": runs["cold"]["launches"]}


def _expect_launches(name, got, want):
    for k, v in want.items():
        if got[k] != v:
            raise AssertionError(f"{name}: {k} launched {got[k]} times, "
                                 f"expected {v}")


def q1_phase(conn, ctx, li) -> dict:
    want = q1_oracle(li)

    def check(out, counts):
        got = _host_rows(out, list(want))
        if got != want:
            raise AssertionError(f"Q1 {got} != numpy oracle {want}")
        # the final OrderBy: 4 key bits, the scatter branch, one pass
        _expect_launches("q1", counts, {"radix_hist": 1, "radix_pos": 1,
                                        "radix_rank": 0, "filter_sum": 0,
                                        "flat_gather": 0, "gather_rows": 0})

    runs = path_runs(PATH_PLANS["q1"](), conn, ctx, check)
    phase("q1", groups=len(want["count_order"]),
          count_order=want["count_order"], **_runs_fields(runs),
          rows_per_s={r: len(li["l_orderkey"]) / v["wall_s"]
                      for r, v in runs.items()})
    return runs["cold"]["launches"]


def _words_of(bits: int) -> list:
    """Bit widths of the 32-bit words sort_words packs `bits` key bits
    into."""
    return [32] * (bits // 32) + ([bits % 32] if bits % 32 else [])


def _passes(words) -> int:
    """8-bit radix passes over those words, least significant first."""
    return sum(-(-w // 8) for w in words)


def _topn_words(plan, nullable=()) -> list:
    """Bit widths of the words of the plan's TopN key (the plan's root),
    derived from the plan as sort_words derives them: the active bit, a
    null bit for each key in `nullable` (an aggregate's output), and each
    key's width: the span of the stats the plan resolves for it, else 32
    for each of its value words."""
    if not isinstance(plan, P.TopNNode):
        raise AssertionError(f"{type(plan).__name__} is not a TopN")
    row = plan.source.output_type()
    bits = 1
    for k in plan.keys:
        dt = row.children[row.names.index(k.name)]
        rng = resolve_column_stats(plan.source, k.name)
        bits += k.name in nullable
        bits += ((int(rng[1]) - int(rng[0])).bit_length()
                 if rng is not None and not dt.is_long_decimal
                 else 32 * num_value_words(dt))
    return _words_of(bits)


def _key_bits(conn, cols) -> int:
    """1 active bit + each column's width, narrowed by the connector's
    stats."""
    bits = 1
    for c in cols:
        lo, hi = conn.column_stats("lineitem", c)
        bits += (hi - lo).bit_length()
    return bits


def topn_phase(conn, ctx, li, order) -> dict:
    plan = topn_plan()
    bits = _key_bits(conn, SORT_COLS[:2])
    n_batches = len(conn.default_splits("lineitem"))
    passes = -(-bits // 8)
    top = order[:1000]

    def check(out, counts):
        _expect_launches("topn", counts, {
            "radix_hist": passes * n_batches,
            "radix_pos": passes * n_batches, "radix_rank": 0,
            "filter_sum": 0, "flat_gather": 0, "gather_rows": 0})
        got = _host_rows(out, SORT_COLS[:2])
        for c in SORT_COLS[:2]:
            if got[c] != [int(x) for x in li[c][top]]:
                raise AssertionError(f"TopN {c} differs from np.lexsort's "
                                     "first 1000 rows")

    runs = path_runs(plan, conn, ctx, check)
    phase("topn", key_bits=bits, batches=n_batches, passes=passes,
          **_runs_fields(runs))
    return runs["cold"]["launches"]


def check_sorted(out, li, order, what: str) -> int:
    """The rows of a full sort's output are np.lexsort's, column by
    column; returns the row count."""
    rows = 0
    for b in out:
        m = b.mask
        n = int(m.sum().item())
        for c in SORT_COLS:
            got = b.columns[c].data[m].cpu().numpy()
            if not np.array_equal(got, li[c][order[rows:rows + n]]):
                raise AssertionError(f"{what}: {c} is not in np.lexsort "
                                     "order")
        rows += n
    if rows != len(order):
        raise AssertionError(f"{what} gave {rows} rows, not {len(order)}")
    return rows


def sort_full_phase(conn, ctx, li, order) -> dict:
    plan = sort_full_plan()
    bits = _key_bits(conn, SORT_COLS)
    shape = {}

    def check(out, counts):
        cap = sum(b.capacity for b in out)
        # key + row-id bits past 64: the classic loop, B4 + B2's
        # rank-and-scatter form a pass over the key's 32-bit words, B5
        # once for each word after the first; at SF10, 42 key bits + 26
        # row-id bits
        classic = bits + max(1, cap - 1).bit_length() > 64
        if conn.scale_factor >= 10 and not classic:
            raise AssertionError(f"full sort of {cap} rows and {bits} key "
                                 "bits would not take the classic loop")
        if classic:
            words = _words_of(bits)
            passes = _passes(words)
            want = {"radix_hist": passes, "radix_rank": passes,
                    "radix_pos": 0, "flat_gather": len(words) - 1}
        else:
            passes = -(-bits // 8)
            want = {"radix_hist": passes, "radix_rank": 0,
                    "radix_pos": passes, "flat_gather": 0}
        _expect_launches("sort_full", counts, dict(want, filter_sum=0,
                                                   gather_rows=0))
        rows = check_sorted(out, li, order, "full sort")
        shape.update(rows=rows, capacity=cap, classic_loop=classic,
                     passes=passes)

    runs = path_runs(plan, conn, ctx, check)
    phase("sort_full", key_bits=bits, **shape, **_runs_fields(runs),
          rows_per_s={r: shape["rows"] / v["wall_s"]
                      for r, v in runs.items()})
    return runs["cold"]["launches"]


def q6_generic_phase(conn, ctx, li) -> dict:
    plan = q6_generic_plan()
    expect = q6_oracle(li)
    fired0 = M.reporter().snapshot()["counters"].get(M.K_FILTER_SUM_KERNEL,
                                                     0)

    def check(out, counts):
        _expect_launches("q6_generic", counts, {"filter_sum": 0,
                                                "flat_gather": 0,
                                                "gather_rows": 0})
        got = _host_rows(out, ["revenue"])["revenue"]
        if got != [expect]:
            raise AssertionError(f"generic Q6 {got} != numpy oracle "
                                 f"{expect}")

    runs = path_runs(plan, conn, ctx, check)
    fired = M.reporter().snapshot()["counters"].get(M.K_FILTER_SUM_KERNEL,
                                                    0) - fired0
    if fired:
        raise AssertionError("the filter-sum matcher took the generic plan")
    phase("q6_generic", revenue_scaled_e4=expect, **_runs_fields(runs))
    return runs["cold"]["launches"]


# ---------------------------------------------------------------------------
# spill: host offload and disk spill of OrderBy, join builds and
# aggregation; arbitration under a query cap; the scan cache's SSD tier
# ---------------------------------------------------------------------------

# counters and timing sums a spill run reports, as deltas over the run
SPILL_COUNTERS = dict(
    OFFLOAD_KEYS, host_bytes=M.K_OFFLOAD_HOST_BYTES,
    disk_writes=M.K_SPILL_DISK_WRITES,
    disk_write_bytes=M.K_SPILL_DISK_WRITE_BYTES,
    disk_read_bytes=M.K_SPILL_DISK_READ_BYTES,
    ssd_writes=M.K_SSD_CACHE_WRITES, ssd_write_bytes=M.K_SSD_CACHE_WRITE_BYTES,
    ssd_hits=M.K_SSD_CACHE_HITS, ssd_misses=M.K_SSD_CACHE_MISSES,
    reclaims=M.K_MEM_RECLAIMS, reclaimed_bytes=M.K_MEM_RECLAIMED_BYTES,
    ingest_hits=M.K_VALUES_INGEST_HITS)
SPILL_MS = {"host_ms": M.K_OFFLOAD_HOST_MS, "copy_ms": M.K_OFFLOAD_COPY_MS,
            "disk_write_ms": M.K_SPILL_DISK_WRITE_MS,
            "disk_read_ms": M.K_SPILL_DISK_READ_MS}
# what must be equal cold and warm
SPILL_EQUAL = tuple(OFFLOAD_KEYS) + ("disk_writes",)


def spill_metrics() -> dict:
    snap = M.reporter().snapshot()
    out = {k: int(snap["counters"].get(key, 0))
           for k, key in SPILL_COUNTERS.items()}
    out.update({k: snap["histograms"].get(key, {}).get("sum", 0.0)
                for k, key in SPILL_MS.items()})
    return out


def split_nbytes(conn, table: str, cols) -> int:
    """Device bytes of the table's first split over `cols`, read through
    the data source (and so the scan cache) at run time."""
    src = conn.create_data_source(table, cols, QueryCtx("cuda"))
    return src.next(conn.default_splits(table)[0]).nbytes


def spill_run(plan, config: dict, check, spill_dir=None) -> dict:
    """One run of `plan` in a fresh QueryCtx with `config`, checked by
    ``check(out, task)``: wall, launches, the spill counters' deltas and
    timing sums, peak device memory (reset just before), the query pool's
    peak and its used after the run (which must be 0), and the spill
    directory empty after it."""
    ctx = QueryCtx("cuda", config)
    before = spill_metrics()
    cache = DataCache.instance()
    lookups = (cache.hits, cache.misses)
    torch.cuda.reset_peak_memory_stats()
    tasks = []
    out, wall, launches = _run(plan, ctx, tasks)
    peak = torch.cuda.max_memory_allocated()
    moved = {k: v - before[k] for k, v in spill_metrics().items()}
    moved["cache"] = [cache.hits - lookups[0], cache.misses - lookups[1]]
    check(out, tasks[0])
    del out
    pool = ctx.memory_pool
    if pool.used != 0:
        raise AssertionError(f"the query pool holds {pool.used} bytes "
                             "after the run")
    if spill_dir is not None and os.listdir(spill_dir):
        raise AssertionError(f"spill files left: {os.listdir(spill_dir)}")
    return {"wall_s": wall, "launches": launches,
            "max_memory_allocated": peak, "pool_peak": pool.peak,
            "pool_used": pool.used, **moved}


def baseline_walls(plan, ctx) -> tuple:
    """The plan's cold and warm walls and peak device memory without
    spill settings (the 4 GiB defaults), and the cold run's Task."""
    DataCache.instance().clear()
    tasks = []
    base = {"wall_s": {}, "max_memory_allocated": {}}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        _, wall, _ = _run(plan, ctx, tasks)
        base["wall_s"][run] = wall
        base["max_memory_allocated"][run] = torch.cuda.max_memory_allocated()
    return base, tasks[0]


def spill_path(name: str, plan, config: dict, check, must, base: dict,
               spill_dir=None, **fields) -> dict:
    """A spill path cold (scan cache cleared) and warm: both exact, both
    meeting ``must(run)`` (the tiers the path must reach), with equal
    launches and offload counters; prints its line and returns the cold
    run's launches."""
    runs = {}
    for run in ("cold", "warm"):
        if run == "cold":
            DataCache.instance().clear()
        runs[run] = spill_run(plan, config, check, spill_dir)
        must(runs[run])
    cold, warm = runs["cold"], runs["warm"]
    for k in ("launches",) + SPILL_EQUAL:
        if cold[k] != warm[k]:
            raise AssertionError(f"{name}: {k} cold {cold[k]} != warm "
                                 f"{warm[k]}")
    keys = [k for k in cold if k not in ("wall_s", "launches")]
    phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
          no_spill=base,
          launches={k: v for k, v in cold["launches"].items() if v},
          **{k: {r: v[k] for r, v in runs.items()} for k in keys}, **fields)
    return cold["launches"]


def _operators(task, cls) -> list:
    return [op for op in task.operators if isinstance(op, cls)]


def spill_phase(conn, ctx, li, order) -> dict:
    """The spill paths at the connector's scale, each cold and warm, each
    exact against its oracle, with budgets computed from this run's
    batches: spill_sort (OrderBy through all three tiers), spill_join (Q3
    with every build batch off the device), spill_merge_join (a presorted
    build through host and disk: its order must survive), spill_agg (Q18's
    compacted runs in host RAM), spill_arbitration (a query cap and no
    budget: the arbitrator moves sort state) and spill_ssd (Q6 through a
    small scan cache with the SSD tier, then after a restart). Returns
    each path's cold launches."""
    t0 = time.perf_counter()
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_totalprice", "o_orderpriority"])
    q3_want = q3_oracle(conn, li)
    q18_want = q18_oracle(conn, li, Q18_THRESHOLD)
    q6_want = q6_oracle(li)
    per_prio, _ = merge_join_oracle(conn, li, od)
    del od
    phase("spill_oracles", seconds=time.perf_counter() - t0)
    by_path = {}
    dirs = []

    def new_dir() -> str:
        dirs.append(tempfile.mkdtemp(prefix="chip_smoke_spill_"))
        return dirs[-1]

    def rows_equal(want):
        def check(out, task):
            got = _host_rows(out, list(want))
            if got != want:
                raise AssertionError(f"{got} != numpy oracle {want}")
        return check

    n_li = len(conn.default_splits("lineitem"))

    # spill_sort: 3 batches on the device, the next to host RAM, whose
    # budget of 3.5 batches sends all but the newest 3 of them to disk (at
    # SF10, 9 splits: 3 batches end in each tier)
    sort_plan = sort_full_plan()
    batch = split_nbytes(conn, "lineitem", SORT_COLS)
    sort_base, _ = baseline_walls(sort_plan, ctx)
    buffered = []

    def check_sort(out, task):
        check_sorted(out, li, order, "spilled sort")
        op, = _operators(task, OrderByOperator)
        buffered.append(op.stats.input_batches)

    def must_sort(run):
        n = buffered[-1]
        on_device = min(3, n)
        want = (n - on_device, max(0, n - on_device - 3))
        if (run["sort"], run["disk_writes"]) != want:
            raise AssertionError(f"spill_sort: (to host, to disk) "
                                 f"{(run['sort'], run['disk_writes'])} "
                                 f"for {n} batches, expected {want}")
        if run["pool_peak"] != on_device * batch:
            raise AssertionError(f"spill_sort: pool peak {run['pool_peak']}")
        run["tier_batches"] = {"device": on_device,
                               "host": want[0] - want[1], "disk": want[1]}

    d = new_dir()
    by_path["spill_sort"] = spill_path(
        "spill_sort", sort_plan,
        {QC.SORT_OFFLOAD_BYTES: 3 * batch,
         QC.OFFLOAD_HOST_BUDGET_BYTES: 7 * batch // 2, QC.SPILL_DIR: d},
        check_sort, must_sort, sort_base, d, batch_nbytes=batch)

    # spill_join: Q3 with a device budget of 0 for every build batch and a
    # host budget of 1.5 orders build batches (the semi join's output)
    q3 = tpch_plan(3)
    q3_base, q3_task = baseline_walls(q3, ctx)
    semi = [op for op in _operators(q3_task, HashJoinOperator)
            if op.node.join_type is P.JoinType.LEFT_SEMI_FILTER]
    st = semi[0].stats
    build_batch = st.output_bytes // st.output_batches
    # builds: customer's one batch and the orders batches
    n_builds = 1 + st.output_batches

    def must_join(run):
        # nothing reserved: no build batch stayed on the device; only the
        # orders build holds more than 1.5 of its batches
        if not (run["pool_peak"] == 0 and run["join_build"] == n_builds
                and (run["disk_writes"] >= 1 or st.output_batches < 2)):
            raise AssertionError(f"spill_join: pool peak "
                                 f"{run['pool_peak']}, {run['join_build']} "
                                 f"of {n_builds} build batches offloaded, "
                                 f"{run['disk_writes']} spill files")

    d = new_dir()
    by_path["spill_join"] = spill_path(
        "spill_join", q3,
        {QC.JOIN_BUILD_OFFLOAD_BYTES: 0,
         QC.OFFLOAD_HOST_BUDGET_BYTES: 3 * build_batch // 2,
         QC.SPILL_DIR: d},
        rows_equal(q3_want), must_join, q3_base, d,
        orders_build_batch_nbytes=build_batch,
        orders_build_batches=st.output_batches)

    # spill_merge_join: the orders build (2 batches, presorted) with the
    # same budgets: one batch ends on disk and one in host RAM, and the
    # build must come back in key order
    mj = merge_join_plan()
    mj_base, _ = baseline_walls(mj, ctx)
    mj_batch = split_nbytes(conn, "orders", ["o_orderkey",
                                             "o_orderpriority"])
    n_od = len(conn.default_splits("orders"))
    d = new_dir()

    def check_mj(out, task):
        _same_rows(_host_table(out), per_prio, 1e-9, "spilled merge join")

    def must_mj(run):
        # every build batch to host RAM, all but the newest to disk
        if (run["join_build"], run["disk_writes"]) != (n_od, n_od - 1):
            raise AssertionError(f"spill_merge_join: {run['join_build']} "
                                 f"to host, {run['disk_writes']} to disk "
                                 f"of {n_od} build batches")
    by_path["spill_merge_join"] = spill_path(
        "spill_merge_join", mj,
        {QC.JOIN_BUILD_OFFLOAD_BYTES: 0,
         QC.OFFLOAD_HOST_BUDGET_BYTES: 3 * mj_batch // 2, QC.SPILL_DIR: d},
        check_mj, must_mj, mj_base, d, build_batch_nbytes=mj_batch,
        build_batches=n_od)

    # spill_agg: Q18's group-by compacts every 2 batches into a run in
    # host RAM
    q18_plan = PATH_PLANS["q18"]()
    q18_base, _ = baseline_walls(q18_plan, ctx)

    def must_agg(run):
        # the lineitem group-by folds a run every 2 of its batches
        if run["agg"] < n_li // 2:
            raise AssertionError(f"spill_agg: {run['agg']} host runs")
    by_path["spill_agg"] = spill_path(
        "spill_agg", q18_plan,
        {QC.AGG_HOST_OFFLOAD: True, QC.AGG_COMPACT_THRESHOLD: 2},
        rows_equal(q18_want), must_agg, q18_base)

    # spill_arbitration: the full sort under a query cap of 3 batches and
    # the default budgets: each batch past the cap makes the arbitrator
    # reclaim (the scan cache first, then the OrderBy's oldest batch)

    def check_arb(out, task):
        check_sorted(out, li, order, "capped sort")

    def must_arb(run):
        n = buffered[-1]
        if n > 3 and not (run["reclaims"] > 0 and run["sort"] == n - 3):
            raise AssertionError(f"spill_arbitration: {run['reclaims']} "
                                 f"reclaims, {run['sort']} offloads")
        if run["pool_peak"] > 3 * batch:
            raise AssertionError("spill_arbitration: the pool passed its "
                                 "cap")
    by_path["spill_arbitration"] = spill_path(
        "spill_arbitration", sort_plan, {QC.QUERY_HBM_CAP_BYTES: 3 * batch},
        check_arb, must_arb, sort_base, query_cap=3 * batch)

    # spill_ssd: Q6 through a scan cache of half one run's scan bytes with
    # the SSD tier: a cold run demotes, a rerun promotes, and so does a
    # second cache over the same directory, as after a restart
    q6 = PATH_PLANS["q6"]()
    q6_base, _ = baseline_walls(q6, ctx)
    cache = DataCache.instance()
    run_bytes = cache.used
    small = max(run_bytes // 2, max(b.nbytes for _, b in cache.entries()))
    cache.clear()
    ssd_dir = new_dir()

    def check_q6(out, task):
        if q6_value(out) != q6_want:
            raise AssertionError(f"Q6 through the SSD tier: "
                                 f"{q6_value(out)} != {q6_want}")
    runs = {}
    try:
        for run in ("cold", "rerun", "restart"):
            if run != "rerun":
                if DataCache._instance is not cache:
                    DataCache._instance.clear()
                DataCache._instance = DataCache(small)
                DataCache._instance.enable_ssd(ssd_dir)
            runs[run] = spill_run(q6, {}, check_q6)
            runs[run]["ssd_entries"] = DataCache._instance._ssd.stats()[
                "entries"]
        DataCache._instance.clear()
    finally:
        DataCache._instance = cache
    if not runs["cold"]["ssd_writes"] > 0:
        raise AssertionError("spill_ssd: the cold run demoted nothing")
    for run in ("rerun", "restart"):
        if not runs[run]["ssd_hits"] > 0:
            raise AssertionError(f"spill_ssd: no SSD hit on the {run}")
        if runs[run]["launches"] != runs["cold"]["launches"]:
            raise AssertionError(f"spill_ssd: the {run} launched "
                                 "differently")
    keys = [k for k in runs["cold"] if k not in ("wall_s", "launches")]
    phase("spill_ssd", wall_s={r: v["wall_s"] for r, v in runs.items()},
          no_spill=q6_base, cache_budget=small, run_scan_bytes=run_bytes,
          launches={k: v for k, v in runs["cold"]["launches"].items() if v},
          **{k: {r: v[k] for r, v in runs.items()} for k in keys})
    by_path["spill_ssd"] = runs["cold"]["launches"]
    shutil.rmtree(ssd_dir)
    for d in dirs[:-1]:
        os.rmdir(d)  # empty: each run checked it
    phase("spill", seconds=time.perf_counter() - t0)
    return by_path


# ---------------------------------------------------------------------------
# gather_kernel: B5 against its plain version
# ---------------------------------------------------------------------------

GATHER_DATA = (1, 129, 1 << 20, 60_000_001)
GATHER_IDX = (1, 7, 6_700_000)
GATHER_PATTERNS = ("uniform", "sorted", "reversed", "constant")
# (1M-row data of the reference's gather micro-benchmark, Q3's o_orderkey
# domain table at SF10), each with one lineitem batch of indices
GATHER_TIMED = (1 << 20, 60_000_001)
GATHER_M = 6_700_000
# the orders domain at SF10 (o_orderkey's stats span 0..60,000,000) and
# the full sort's row count (all of lineitem)
ORDERS_DOMAIN = 60_000_001
SORT_ROWS = 60_000_401
ORDERS_ROWS = 15_000_000
MULTI_WIDTHS = (torch.int32, torch.int64, torch.float32, torch.float64)


def _gather_idx(pattern: str, n: int, m: int, dtype, gen) -> torch.Tensor:
    if pattern == "constant":
        return torch.full((m,), n // 2, dtype=dtype, device="cuda")
    idx = torch.randint(0, n, (m,), generator=gen, device="cuda",
                        dtype=torch.int64)
    if pattern != "uniform":
        idx = torch.sort(idx, descending=pattern == "reversed").values
    return idx.to(dtype).contiguous()


def _random_column(n: int, dtype, gen) -> torch.Tensor:
    lim = 2 ** 31 - 1 if torch.empty((), dtype=dtype).element_size() == 4 \
        else 2 ** 62
    bits = torch.randint(-lim, lim, (n,), generator=gen, device="cuda",
                         dtype=torch.int64)
    if dtype.is_floating_point:  # any bit pattern, NaNs included: raw bits
        itype = torch.int32 if dtype == torch.float32 else torch.int64
        return bits.to(itype).view(dtype)
    return bits.to(dtype)


def distinct_sectors(data: torch.Tensor, idx: torch.Tensor) -> int:
    """The 32-byte sectors of `data` that `idx` reads at least once (the
    caching allocator aligns every tensor to a sector)."""
    return int(torch.unique(idx.long() // (SECTOR // data.element_size()))
               .numel())


def gather_bytes(data: torch.Tensor, idx: torch.Tensor) -> dict:
    """Least device-memory bytes of `data[idx]` on this run's indices:
    indices in and output out once, and each data sector they touch once
    (`bytes`); beside it, the count with one sector for every random read
    of data past L2 (`bytes_sector_per_read`), a looser figure."""
    m = idx.numel()
    io = m * (idx.element_size() + data.element_size())
    sectors = distinct_sectors(data, idx)
    nbytes = data.numel() * data.element_size()
    per_read = nbytes if nbytes <= L2_BYTES else m * SECTOR
    return {"bytes": io + sectors * SECTOR, "distinct_sectors": sectors,
            "bytes_sector_per_read": io + per_read}


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (float columns may hold NaN bit
    patterns, which torch.equal calls unequal)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        itype = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.view(itype), b.view(itype)
    return torch.equal(a, b)


def _check_gather(columns, idx, what: str) -> None:
    """B5's multi-column form (or flat_gather, for one column) against the
    plain version, bit for bit."""
    if len(columns) == 1:
        got = [flat_gather(columns[0], idx)]
    else:
        got = gather_rows(columns, idx)
    for c, g in zip(columns, got):
        if not _bits_equal(g, flat_gather_reference(c, idx)):
            raise AssertionError(f"B5 differs from its plain version at "
                                 f"{what}")


def _monotone_probe(conn) -> torch.Tensor:
    """The array-mode probe's index of the first lineitem split: its
    l_orderkey minus the domain base 0 (lineitem arrives in order-key
    order), int32, as _domain_index gives it."""
    split = conn.default_splits("lineitem")[0]
    keys = conn.gen.gen_lineitem(split.lo, split.hi, ["l_orderkey"])
    return torch.from_numpy(keys["l_orderkey"].astype(np.int32)).cuda()


def _build_rows(probe: torch.Tensor) -> torch.Tensor:
    """The orders row of each of those lineitem rows: the build-column
    gathers' index (orders rows are in order-index order; the order key of
    index i is (i >> 3 << 5) | (i & 7))."""
    k = probe.long()
    return (((k >> 5) << 3) | (k & 7)).to(torch.int32)


def _time_gather(columns, idx, hostless: bool, what: str) -> dict:
    """B5 at one timed shape: first checked against its plain version bit
    for bit on these inputs, then ms, plain_ms, library_ms (one
    torch.index_select a column), the distinct-sector bound summed over
    the columns, and with `hostless` the CUDA-graph times of the kernel
    and of the library calls."""
    _check_gather(columns, idx, f"timed shape {what}")
    one = len(columns) == 1
    kernel = (lambda: flat_gather(columns[0], idx)) if one \
        else (lambda: gather_rows(columns, idx))
    t = {"ms": time_ms(kernel),
         "plain_ms": time_ms(lambda: [flat_gather_reference(c, idx)
                                      for c in columns]),
         "library_ms": time_ms(lambda: [torch.index_select(c, 0, idx)
                                        for c in columns])}
    if hostless:
        t["graph_ms"] = graph_ms(kernel)
        t["library_graph_ms"] = graph_ms(
            lambda: [torch.index_select(c, 0, idx) for c in columns])
    per = [gather_bytes(c, idx) for c in columns]
    # the index is read once for all columns
    nbytes = sum(p["bytes"] for p in per) \
        - (len(columns) - 1) * idx.numel() * idx.element_size()
    t.update({"bytes": nbytes, "bound_ms": bound_ms(nbytes),
              "distinct_sectors": [p["distinct_sectors"] for p in per],
              "bound_ms_sector_per_read": bound_ms(
                  sum(p["bytes_sector_per_read"] for p in per)
                  - (len(columns) - 1) * idx.numel() * idx.element_size()),
              "columns": len(columns), "data_rows": columns[0].numel(),
              "indices": idx.numel()})
    return t


def gather_phase(seed: int, conn) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    max_err, cases = 0, 0
    for n in GATHER_DATA:
        for dt in (torch.int32, torch.int64):
            data = _random_column(n, dt, gen)
            for m in GATHER_IDX:
                for pattern in GATHER_PATTERNS:
                    for it in (torch.int32, torch.int64):
                        idx = _gather_idx(pattern, n, m + 3, it, gen)
                        # indices that start off the 16-byte boundary
                        # (views) as well: they load one index at a time
                        for off in (0, 1, 3):
                            _check_gather([data], idx[off:off + m],
                                          f"n={n} m={m} {dt} idx {it} "
                                          f"{pattern} offset {off}")
                            cases += 1
            del data
    # the multi-column form: 1-8 columns of mixed widths through one index
    for n in (129, 1 << 20, ORDERS_ROWS):
        cols = [_random_column(n, MULTI_WIDTHS[i % 4], gen)
                for i in range(G.MAX_COLUMNS)]
        for m in GATHER_IDX:
            for pattern in ("uniform", "sorted", "constant"):
                for it in (torch.int32, torch.int64):
                    idx = _gather_idx(pattern, n, m, it, gen)
                    for k in range(1, G.MAX_COLUMNS + 1):
                        _check_gather(cols[:k], idx, f"{k} columns n={n} "
                                      f"m={m} idx {it} {pattern}")
                        cases += 1
        del cols
    torch.cuda.synchronize()
    # each timed shape is also a checked case (_time_gather checks first)
    timings = {}
    for n in GATHER_TIMED:
        data = _random_column(n, torch.int32, gen)
        idx = _gather_idx("uniform", n, GATHER_M, torch.int32, gen)
        timings[f"uniform_{n}"] = _time_gather([data], idx, True,
                                               f"uniform_{n}")
        del data, idx
    # the q3/q18 probe: one split's l_orderkey into the orders domain
    probe = _monotone_probe(conn)
    data = _random_column(ORDERS_DOMAIN, torch.int32, gen)
    timings["monotone"] = _time_gather([data], probe, True, "monotone")
    del data
    # the build-column gathers: three orders columns (o_orderdate,
    # o_shippriority, an 8-byte one) at the same lineitem rows' orders rows
    rows = _build_rows(probe)
    cols = [_random_column(ORDERS_ROWS, dt, gen)
            for dt in (torch.int32, torch.int32, torch.int64)]
    timings["multi_3_columns"] = _time_gather(cols, rows, True,
                                              "multi_3_columns")
    del cols, rows, probe
    # sort_full's word gather: a permutation of all of lineitem
    perm = torch.randperm(SORT_ROWS, generator=gen, device="cuda").to(
        torch.int32)
    data = _random_column(SORT_ROWS, torch.int32, gen)
    timings["permutation"] = _time_gather([data], perm, False,
                                          "permutation")
    del data, perm
    cases += len(timings)
    phase("gather_kernel", cases=cases, max_abs_err=max_err, times=timings)
    return {"max_abs_err": max_err, "timings": timings}


# ---------------------------------------------------------------------------
# Joins: Q3 and Q18
# ---------------------------------------------------------------------------

def table_columns(conn, table: str, cols) -> dict:
    n = conn.gen.num_rows(table)
    return {k: v.astype(np.int64)
            for k, v in conn.gen.generate(table, 0, n, cols).items()}


def q3_oracle(conn, li) -> dict:
    """Q3 in numpy: direct-address joins over the generator's columns,
    exact int64 revenue at scale 4, the plan's tie order (revenue desc,
    o_orderdate, then the group-by's l_orderkey order)."""
    cu = table_columns(conn, "customer", ["c_custkey", "c_mktsegment"])
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_shippriority"])
    seg = conn.gen.dictionaries("customer")["c_mktsegment"].id_of("BUILDING")
    building = np.zeros(int(cu["c_custkey"].max()) + 1, bool)
    building[cu["c_custkey"][cu["c_mktsegment"] == seg]] = True
    om = (od["o_orderdate"] < D950315) & building[od["o_custkey"]]
    row_of = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    row_of[od["o_orderkey"][om]] = np.nonzero(om)[0]
    r = row_of[li["l_orderkey"]]
    lm = (li["l_shipdate"] > D950315) & (r >= 0)
    rev = li["l_extendedprice"][lm] * (100 - li["l_discount"][lm])
    # float64 sums are exact: every partial sum stays below 2^53
    if rev.sum() >= 2 ** 53:
        raise AssertionError("Q3 oracle revenue exceeds float64's integers")
    n_od = len(od["o_orderkey"])
    sums = np.bincount(r[lm], weights=rev, minlength=n_od)
    cand = np.nonzero(np.bincount(r[lm], minlength=n_od))[0]
    rev_c = sums[cand].astype(np.int64)
    top = cand[np.lexsort((od["o_orderkey"][cand], od["o_orderdate"][cand],
                           -rev_c))[:10]]
    return {"l_orderkey": [int(x) for x in od["o_orderkey"][top]],
            "revenue": [int(x) for x in sums[top].astype(np.int64)],
            "o_orderdate": [int(x) for x in od["o_orderdate"][top]],
            "o_shippriority": [int(x) for x in od["o_shippriority"][top]]}


def q18_oracle(conn, li, threshold: int) -> dict:
    """Q18 in numpy: np.bincount of l_quantity by l_orderkey, above the
    threshold at scale 2, joined to orders and customer, the top 100 by
    o_totalprice desc, o_orderdate (then orders order)."""
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"])
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_totalprice"])
    okey = od["o_orderkey"]
    cand = np.nonzero(qty[okey] > threshold * 100)[0]
    top = cand[np.lexsort((okey[cand], od["o_orderdate"][cand],
                           -od["o_totalprice"][cand]))[:100]]
    return {"c_name": [f"Customer#{int(c):09d}" for c in od["o_custkey"][top]],
            "c_custkey": [int(x) for x in od["o_custkey"][top]],
            "o_orderkey": [int(x) for x in okey[top]],
            "o_orderdate": [int(x) for x in od["o_orderdate"][top]],
            "o_totalprice": [int(x) for x in od["o_totalprice"][top]],
            "quantity": [int(x) for x in qty[okey[top]].astype(np.int64)]}


def _join_phase(name, plan, want, conn, ctx, b5_launches: int,
                b5_multi: int, b2_launches: int) -> dict:
    """A join query's three runs, exact, with B5's and B2's launches as
    the plan gives them; a sort-mode group-by adds one multi-column B5
    launch for each eight of its addends each time it groups, which the
    run counts (how often it folds depends on the data)."""
    sort_gathers = [0]
    real = groupby.reduce_sort_mode

    def counted(keys, addends, *args, **kw):
        sort_gathers[0] += -(-len(addends) // G.MAX_COLUMNS)
        return real(keys, addends, *args, **kw)

    def check(out, counts):
        got = _host_rows(out, list(want))
        if got != want:
            raise AssertionError(f"{name} {got} != numpy oracle {want}")
        _expect_launches(name, counts, {"flat_gather": b5_launches,
                                        "gather_rows": b5_multi
                                        + sort_gathers[0],
                                        "radix_rank": b2_launches,
                                        "filter_sum": 0})
        sort_gathers[0] = 0
        for k in ("radix_hist", "radix_pos"):
            if counts[k] == 0:
                raise AssertionError(f"{name}: {k} never launched")

    groupby.reduce_sort_mode = counted
    try:
        runs = path_runs(plan, conn, ctx, check)
    finally:
        groupby.reduce_sort_mode = real
    phase(name, rows=len(next(iter(want.values()))), **_runs_fields(runs))
    return runs["cold"]["launches"]


def q3_phase(conn, ctx, li) -> dict:
    want = q3_oracle(conn, li)
    n_od = len(conn.default_splits("orders"))
    n_li = len(conn.default_splits("lineitem"))
    # the TopN sorts the group-by's one output batch by revenue (a sum,
    # nullable) and o_orderdate: the classic loop, B2 once a pass, B5 once
    # for each key word after the first
    plan = PATH_PLANS["q3"]()
    words = _topn_words(plan, nullable=("revenue",))
    # B5, one array a launch: two gathers in each of the two builds
    # (packed keys and key values through the permutation); one arr_row1
    # lookup per orders batch in the semi join and per lineitem batch in
    # the inner join; the TopN's word gathers. B5's multi-column form: per
    # lineitem batch, the two build columns the join outputs
    # (o_orderdate, o_shippriority) in one launch
    return _join_phase("q3", plan, want, conn, ctx,
                       4 + n_od + n_li + len(words) - 1, n_li,
                       _passes(words))


def q18_phase(conn, ctx, li) -> dict:
    """Q18 at the spec's threshold, 300."""
    want = q18_oracle(conn, li, Q18_THRESHOLD)
    if not want["o_orderkey"]:
        raise AssertionError("Q18 oracle has no rows at this scale")
    n_od = len(conn.default_splits("orders"))
    # the TopN merges each joined orders batch: one classic-loop sort each
    plan = PATH_PLANS["q18"]()
    words = _topn_words(plan)
    # B5, one array a launch: two gathers in each build; per orders
    # batch, one arr_row1 lookup in each join and the TopN's word gathers.
    # B5's multi-column form: per orders batch, in each join, the build
    # columns in one launch (quantity's two limbs; then c_name's ids and
    # c_custkey)
    return _join_phase("q18", plan, want, conn, ctx,
                       4 + n_od * (2 + len(words) - 1), 2 * n_od,
                       n_od * _passes(words))


# ---------------------------------------------------------------------------
# tpch_rest: the other 13 TPC-H queries
# ---------------------------------------------------------------------------

def _day(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - datetime.date(1970, 1, 1)).days


def _host_table(batches):
    """(column names, active rows) of output batches on the host: NULL as
    None, DOUBLE/REAL as float, long decimals through both limbs, strings
    through their dictionary."""
    if not batches:
        return [], []
    names = list(batches[0].columns)
    cols = {n: [] for n in names}
    for b in batches:
        mask = b.mask.cpu().numpy()
        for n in names:
            col = b.columns[n]
            data = col.data.cpu().numpy()[mask]
            if col.dtype.is_long_decimal:
                hi = col.children[0].data.cpu().numpy()[mask]
                vals = [(int(h) << 64) | (int(lo) & (2 ** 64 - 1))
                        for lo, h in zip(data, hi)]
            elif col.dictionary is not None:
                vals = list(col.dictionary.take(data))
            elif col.dtype.is_floating:
                vals = [float(x) for x in data]
            else:
                vals = [int(x) for x in data]
            if col.validity is not None:
                ok = col.validity.cpu().numpy()[mask]
                vals = [v if k else None for v, k in zip(vals, ok)]
            cols[n].extend(vals)
    return names, list(zip(*(cols[n] for n in names)))


def _row_key(row):
    return tuple((v is None, 0 if v is None or isinstance(v, float) else v)
                 for v in row)


def _same_rows(got, want, rel_tol: float, what: str) -> None:
    """Equal multisets of rows: exact but for floats, which agree within
    ``rel_tol`` (NaN equals NaN)."""
    if got[0] != want[0] or len(got[1]) != len(want[1]):
        raise AssertionError(f"{what}: columns/rows {got[0]} x "
                             f"{len(got[1])} != {want[0]} x "
                             f"{len(want[1])}")
    for g, w in zip(sorted(got[1], key=_row_key),
                    sorted(want[1], key=_row_key)):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (math.isclose(a, b, rel_tol=rel_tol, abs_tol=0.0)
                        or (math.isnan(a) and math.isnan(b))):
                    raise AssertionError(f"{what}: {g} != {w}")
            elif a != b:
                raise AssertionError(f"{what}: {g} != {w}")


def q12_oracle(conn, li) -> tuple:
    """Q12 in numpy: MAIL/SHIP lines received in 1994 after their commit
    date, shipped before it, joined to their order's priority by a
    direct-address table; high = 1-URGENT or 2-HIGH."""
    n_orders = conn.gen.num_rows("orders")
    lx = {k: v.astype(np.int64) for k, v in conn.gen.gen_lineitem(
        0, n_orders, ["l_shipmode", "l_commitdate", "l_receiptdate"]
    ).items()}
    od = table_columns(conn, "orders", ["o_orderkey", "o_orderpriority"])
    modes = conn.gen.dictionaries("lineitem")["l_shipmode"]
    prios = conn.gen.dictionaries("orders")["o_orderpriority"]
    sm, cd, rd = lx["l_shipmode"], lx["l_commitdate"], lx["l_receiptdate"]
    m = ((cd < rd) & (li["l_shipdate"] < cd) & (rd >= D94) & (rd < D95))
    prio_of = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    prio_of[od["o_orderkey"]] = od["o_orderpriority"]
    high_ids = [prios.id_of("1-URGENT"), prios.id_of("2-HIGH")]
    rows = []
    for name in ("MAIL", "SHIP"):
        sel = m & (sm == modes.id_of(name))
        high = np.isin(prio_of[li["l_orderkey"][sel]], high_ids)
        rows.append((name, int(high.sum()), int((~high).sum())))
    return ["l_shipmode", "high_line_count", "low_line_count"], rows


def q11_oracle(conn) -> tuple:
    """Q11 in numpy: German suppliers' partsupp value (supplycost x
    availqty, scale 2) per part against 0.0001 of their total, as the
    plan's doubles compare them; the top 1000 by value. At SF10 the fixed
    fraction selects no part (the spec scales it by 1/SF)."""
    ps = table_columns(conn, "partsupp", ["ps_partkey", "ps_suppkey",
                                          "ps_availqty", "ps_supplycost"])
    su = table_columns(conn, "supplier", ["s_suppkey", "s_nationkey"])
    na = table_columns(conn, "nation", ["n_nationkey", "n_name"])
    names = conn.gen.dictionaries("nation")["n_name"]
    germany = na["n_nationkey"][na["n_name"] == names.id_of("GERMANY")]
    german = su["s_suppkey"][np.isin(su["s_nationkey"], germany)]
    m = np.isin(ps["ps_suppkey"], german)
    parts = ps["ps_partkey"][m]
    pv = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    value = np.bincount(parts, weights=pv)  # exact: sums stay below 2^53
    total = _psum(pv)
    if total >= 2 ** 53:
        raise AssertionError("Q11 oracle total exceeds float64's integers")
    cand = np.nonzero(np.bincount(parts))[0]
    keep = cand[value[cand] / 100.0 > (total / 100.0) * 0.0001]
    top = keep[np.argsort(-value[keep], kind="stable")[:1000]]
    return ["ps_partkey", "value"], [(int(k), int(value[k])) for k in top]


def q14_oracle(conn, li) -> tuple:
    """Q14 in numpy: revenue of PROMO parts over all revenue shipped in
    1995-09, exact int sums at scale 4, then the plan's double ops."""
    n_orders = conn.gen.num_rows("orders")
    pk = conn.gen.gen_lineitem(0, n_orders, ["l_partkey"])["l_partkey"]
    pt = table_columns(conn, "part", ["p_partkey", "p_type"])
    types = conn.gen.dictionaries("part")["p_type"]
    promo_ids = [i for i, v in enumerate(types.values)
                 if v.startswith("PROMO")]
    type_of = np.full(int(pt["p_partkey"].max()) + 1, -1, np.int64)
    type_of[pt["p_partkey"]] = pt["p_type"]
    sd = li["l_shipdate"]
    m = (sd >= _day("1995-09-01")) & (sd < _day("1995-10-01"))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    promo = np.isin(type_of[pk[m].astype(np.int64)], promo_ids)
    p, t = _psum(rev[promo]), _psum(rev)
    return ["promo_pct"], [((p / 1e4) * 100.0 / (t / 1e4),)]


def _half_up_avg(s: np.ndarray, c: np.ndarray) -> np.ndarray:
    """avg of a non-negative short decimal at its own scale: the sum over
    the count, rounded half up (c > 0)."""
    return (2 * s + c) // (2 * c)


def q13_oracle(conn) -> tuple:
    """Q13 in numpy: each customer's count of orders whose comment has
    no 'special' followed by 'requests' (0 for a customer without one,
    the left join), then customers per count."""
    od = table_columns(conn, "orders", ["o_custkey", "o_comment"])
    cu = table_columns(conn, "customer", ["c_custkey"])
    comments = conn.gen.dictionaries("orders")["o_comment"].values

    def special(v: str) -> bool:
        i = v.find("special")
        return i >= 0 and v.find("requests", i + len("special")) >= 0

    bad = np.array([special(v) for v in comments], bool)
    keep = ~bad[od["o_comment"]]
    per = np.bincount(od["o_custkey"][keep],
                      minlength=int(cu["c_custkey"].max()) + 1)
    c_count = per[cu["c_custkey"]]
    dist = np.bincount(c_count)
    return ["c_count", "custdist"], [(int(k), int(dist[k]))
                                     for k in np.nonzero(dist)[0]]


def q15_oracle(conn, li) -> tuple:
    """Q15 in numpy: each supplier's revenue shipped in 1996-Q1, exact at
    scale 4; the suppliers whose revenue is the maximum, with their name,
    address and phone from the generator's dictionaries."""
    n_orders = conn.gen.num_rows("orders")
    sk = conn.gen.gen_lineitem(0, n_orders,
                               ["l_suppkey"])["l_suppkey"].astype(np.int64)
    sd = li["l_shipdate"]
    m = (sd >= _day("1996-01-01")) & (sd < _day("1996-04-01"))
    rev = li["l_extendedprice"][m] * (100 - li["l_discount"][m])
    if _psum(rev) >= 2 ** 53:
        raise AssertionError("Q15 oracle revenue exceeds float64's integers")
    total = np.bincount(sk[m], weights=rev).astype(np.int64)
    top = np.nonzero(total == total.max())[0]
    cols = ["s_suppkey", "s_name", "s_address", "s_phone"]
    su = table_columns(conn, "supplier", cols)
    row_of = np.full(int(su["s_suppkey"].max()) + 1, -1, np.int64)
    row_of[su["s_suppkey"]] = np.arange(len(su["s_suppkey"]))
    r = row_of[top]
    dicts = conn.gen.dictionaries("supplier")
    strs = {c: list(dicts[c].take(su[c][r])) for c in cols[1:]}
    return cols + ["total_revenue"], [
        (int(su["s_suppkey"][x]), strs["s_name"][i], strs["s_address"][i],
         strs["s_phone"][i], int(total[k]))
        for i, (x, k) in enumerate(zip(r, top))]


def q17_oracle(conn, li) -> tuple:
    """Q17 in numpy: each part's average quantity over all of lineitem
    (half up, scale 2); the Brand#23 MED BOX lines whose quantity is
    under 0.2 of it, compared in doubles as the plan casts them; their
    price total over 7."""
    n_orders = conn.gen.num_rows("orders")
    pk = conn.gen.gen_lineitem(0, n_orders,
                               ["l_partkey"])["l_partkey"].astype(np.int64)
    qty = li["l_quantity"]
    s = np.bincount(pk, weights=qty).astype(np.int64)  # exact: < 2^53
    c = np.bincount(pk)
    aq = _half_up_avg(s, np.maximum(c, 1))
    pt = table_columns(conn, "part", ["p_partkey", "p_brand", "p_container"])
    dicts = conn.gen.dictionaries("part")
    wanted = pt["p_partkey"][
        (pt["p_brand"] == dicts["p_brand"].id_of("Brand#23"))
        & (pt["p_container"] == dicts["p_container"].id_of("MED BOX"))]
    m = np.isin(pk, wanted)
    m[m] = (qty[m].astype(np.float64) / 100.0
            < 0.2 * (aq[pk[m]].astype(np.float64) / 100.0))
    total = _psum(li["l_extendedprice"][m])
    return ["avg_yearly"], [((total / 100.0) / 7.0,)]


def q22_oracle(conn) -> tuple:
    """Q22 in numpy: customers whose phone starts with one of the seven
    codes and whose balance is above the average positive balance of
    those customers (half up, scale 2; compared in doubles), with no
    order; count and balance total by code."""
    codes = ("13", "31", "23", "29", "30", "18", "17")
    cu = table_columns(conn, "customer", ["c_custkey", "c_phone",
                                          "c_acctbal"])
    phones = conn.gen.dictionaries("customer")["c_phone"].take(cu["c_phone"])
    code = np.array([p[:2] for p in phones], dtype=object)
    sel = np.isin(code, codes)
    bal = cu["c_acctbal"]
    pos = bal[sel & (bal > 0)]
    ab = _half_up_avg(_psum(pos), len(pos))
    sel &= bal.astype(np.float64) / 100.0 > np.float64(ab) / 100.0
    od = table_columns(conn, "orders", ["o_custkey"])
    has = np.bincount(od["o_custkey"],
                      minlength=int(cu["c_custkey"].max()) + 1) > 0
    sel &= ~has[cu["c_custkey"]]
    return ["cntrycode", "numcust", "totacctbal"], [
        (k, int((sel & (code == k)).sum()), _psum(bal[sel & (code == k)]))
        for k in sorted(codes) if (sel & (code == k)).any()]


def _row_of(keys: np.ndarray) -> np.ndarray:
    """A direct-address table: key -> its row (-1 where absent)."""
    out = np.full(int(keys.max()) + 1, -1, np.int64)
    out[keys] = np.arange(len(keys))
    return out


def _names(conn, table: str, col: str, ids: np.ndarray) -> list:
    return list(conn.gen.dictionaries(table)[col].take(ids))


def _li_extra(conn, cols) -> dict:
    """lineitem columns the shared ``li`` does not hold."""
    n_orders = conn.gen.num_rows("orders")
    return {k: v.astype(np.int64) for k, v in conn.gen.gen_lineitem(
        0, n_orders, cols).items()}


def q4_oracle(conn, li) -> tuple:
    """Q4 in numpy: orders of 1993-Q3 with a line received after its
    commit date, counted by priority."""
    lx = _li_extra(conn, ["l_commitdate", "l_receiptdate"])
    od = table_columns(conn, "orders", ["o_orderkey", "o_orderdate",
                                        "o_orderpriority"])
    late = np.zeros(int(od["o_orderkey"].max()) + 1, bool)
    late[li["l_orderkey"][lx["l_commitdate"] < lx["l_receiptdate"]]] = True
    od_d = od["o_orderdate"]
    m = (od_d >= _day("1993-07-01")) & (od_d < _day("1993-10-01")) \
        & late[od["o_orderkey"]]
    counts = np.bincount(od["o_orderpriority"][m])
    prios = conn.gen.dictionaries("orders")["o_orderpriority"]
    return ["o_orderpriority", "order_count"], [
        (str(prios.values[i]), int(c)) for i, c in enumerate(counts) if c]


def q5_oracle(conn, li) -> tuple:
    """Q5 in numpy: 1994 orders of customers in an ASIA nation, lines
    whose supplier is of the customer's nation, revenue (scale 4) by
    nation."""
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate"])
    cu = table_columns(conn, "customer", ["c_custkey", "c_nationkey"])
    su = table_columns(conn, "supplier", ["s_suppkey", "s_nationkey"])
    na = table_columns(conn, "nation", ["n_nationkey", "n_name",
                                        "n_regionkey"])
    rg = table_columns(conn, "region", ["r_regionkey", "r_name"])
    asia = rg["r_regionkey"][rg["r_name"] == conn.gen.dictionaries(
        "region")["r_name"].id_of("ASIA")]
    asia_n = na["n_nationkey"][np.isin(na["n_regionkey"], asia)]
    c_nat = np.full(int(cu["c_custkey"].max()) + 1, -1, np.int64)
    c_nat[cu["c_custkey"]] = cu["c_nationkey"]
    m = (od["o_orderdate"] >= D94) & (od["o_orderdate"] < D95)
    o_nat = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    o_nat[od["o_orderkey"][m]] = c_nat[od["o_custkey"][m]]
    s_nat = np.full(int(su["s_suppkey"].max()) + 1, -1, np.int64)
    s_nat[su["s_suppkey"]] = su["s_nationkey"]
    on, sn = o_nat[li["l_orderkey"]], s_nat[li["l_suppkey"]]
    sel = (on >= 0) & (on == sn) & np.isin(sn, asia_n)
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    nat = sn[sel]
    rows = []
    for n in asia_n:
        if (nat == n).any():
            name = _names(conn, "nation", "n_name",
                          na["n_name"][_row_of(na["n_nationkey"])[[n]]])
            rows.append((name[0], _psum(rev[nat == n])))
    return ["n_name", "revenue"], rows


def q10_oracle(conn, li) -> tuple:
    """Q10 in numpy: returned lines of 1993-Q4 orders, revenue (scale 4)
    by customer, the top 20 by revenue desc, c_custkey, with the
    customer's columns from the generator's dictionaries."""
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate"])
    m = (od["o_orderdate"] >= _day("1993-10-01")) \
        & (od["o_orderdate"] < D94)
    o_cust = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    o_cust[od["o_orderkey"][m]] = od["o_custkey"][m]
    r_id = conn.gen.dictionaries("lineitem")["l_returnflag"].id_of("R")
    c = o_cust[li["l_orderkey"]]
    sel = (li["l_returnflag"] == r_id) & (c >= 0)
    rev = li["l_extendedprice"][sel] * (100 - li["l_discount"][sel])
    if _psum(rev) >= 2 ** 53:
        raise AssertionError("Q10 oracle revenue exceeds float64's integers")
    sums = np.bincount(c[sel], weights=rev)
    cand = np.nonzero(np.bincount(c[sel]))[0]
    rev_c = sums[cand].astype(np.int64)
    top = cand[np.lexsort((cand, -rev_c))[:20]]
    cols = ["c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey",
            "c_address", "c_comment"]
    cu = table_columns(conn, "customer", cols)
    r = _row_of(cu["c_custkey"])[top]
    strs = {k: _names(conn, "customer", k, cu[k][r])
            for k in ("c_name", "c_phone", "c_address", "c_comment")}
    na = table_columns(conn, "nation", ["n_nationkey", "n_name"])
    nation = _names(conn, "nation", "n_name", na["n_name"][
        _row_of(na["n_nationkey"])[cu["c_nationkey"][r]]])
    return ["c_custkey", "c_name", "c_acctbal", "c_phone", "n_name",
            "c_address", "c_comment", "revenue"], [
        (int(top[i]), strs["c_name"][i], int(cu["c_acctbal"][r[i]]),
         strs["c_phone"][i], nation[i], strs["c_address"][i],
         strs["c_comment"][i], int(sums[top[i]]))
        for i in range(len(top))]


def q19_oracle(conn, li) -> tuple:
    """Q19 in numpy: AIR / REG AIR lines delivered in person, joined to
    their part, inside one of the three brand / container / quantity /
    size brackets; revenue at scale 4."""
    lx = _li_extra(conn, ["l_shipmode", "l_shipinstruct"])
    ld = conn.gen.dictionaries("lineitem")
    m = (np.isin(lx["l_shipmode"], [ld["l_shipmode"].id_of("AIR"),
                                     ld["l_shipmode"].id_of("REG AIR")])
         & (lx["l_shipinstruct"]
            == ld["l_shipinstruct"].id_of("DELIVER IN PERSON")))
    pt = table_columns(conn, "part", ["p_partkey", "p_brand",
                                      "p_container", "p_size"])
    pd_ = conn.gen.dictionaries("part")
    r = _row_of(pt["p_partkey"])[li["l_partkey"][m]]
    brand, cont = pt["p_brand"][r], pt["p_container"][r]
    size, qty = pt["p_size"][r], li["l_quantity"][m]
    hit = np.zeros(len(r), bool)
    for b, kind, q, top in (("Brand#12", "SM", 1, 5),
                            ("Brand#23", "MED", 10, 10),
                            ("Brand#34", "LG", 20, 15)):
        boxes = {"SM": ("CASE", "BOX", "PACK", "PKG"),
                 "MED": ("BAG", "BOX", "PKG", "PACK"),
                 "LG": ("CASE", "BOX", "PACK", "PKG")}[kind]
        ids = [pd_["p_container"].id_of(f"{kind} {x}") for x in boxes]
        hit |= ((brand == pd_["p_brand"].id_of(b)) & np.isin(cont, ids)
                & (qty >= q * 100) & (qty <= (q + 10) * 100)
                & (size >= 1) & (size <= top))
    price = li["l_extendedprice"][m][hit]
    rev = price * (100 - li["l_discount"][m][hit])
    return ["revenue"], [(_psum(rev) if len(rev) else None,)]


def q21_oracle(conn, li) -> tuple:
    """Q21 in numpy: late lines of SAUDI ARABIA suppliers in 'F' orders
    where another supplier has a line and no other supplier has a late
    one; counted by supplier name, the top 100 by count desc, name. An
    order's lines are contiguous in the generator's order (at most 7),
    so each candidate line looks at its neighbours."""
    lx = _li_extra(conn, ["l_commitdate", "l_receiptdate"])
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    if (np.diff(ok) < 0).any():
        raise AssertionError("lineitem is not in order key order")
    late = lx["l_receiptdate"] > lx["l_commitdate"]
    su = table_columns(conn, "supplier", ["s_suppkey", "s_name",
                                          "s_nationkey"])
    na = table_columns(conn, "nation", ["n_nationkey", "n_name"])
    saudi = na["n_nationkey"][na["n_name"] == conn.gen.dictionaries(
        "nation")["n_name"].id_of("SAUDI ARABIA")]
    s_row = _row_of(su["s_suppkey"])
    od = table_columns(conn, "orders", ["o_orderkey", "o_orderstatus"])
    f_id = conn.gen.dictionaries("orders")["o_orderstatus"].id_of("F")
    is_f = np.zeros(int(od["o_orderkey"].max()) + 1, bool)
    is_f[od["o_orderkey"][od["o_orderstatus"] == f_id]] = True
    cand = np.nonzero(late & np.isin(su["s_nationkey"][s_row[sk]], saudi)
                      & is_f[ok])[0]
    other, other_late = np.zeros(len(cand), bool), np.zeros(len(cand), bool)
    n = len(ok)
    for d in range(-6, 7):
        j = cand + d
        ins = (j >= 0) & (j < n)
        j = np.clip(j, 0, n - 1)
        same_order_other = ins & (ok[j] == ok[cand]) & (sk[j] != sk[cand])
        other |= same_order_other
        other_late |= same_order_other & late[j]
    keep = cand[other & ~other_late]
    counts = np.bincount(sk[keep])
    supp = np.nonzero(counts)[0]
    names = _names(conn, "supplier", "s_name", su["s_name"][s_row[supp]])
    rows = sorted(((nm, int(counts[k])) for nm, k in zip(names, supp)),
                  key=lambda r: (-r[1], r[0]))[:100]
    return ["s_name", "numwait"], rows


class _Probe:
    """Within a ``with`` block, counts, during one query, B5 launches
    inside the nested-loop join's gathers, radix kernel launches inside
    the collect aggregates' (min/max over DECIMAL(38)) sorts, and the host
    seconds of the dictionary-string passes by function (the host pass and
    the enqueue of its one device gather; no device sync is added). The
    wrappers call the originals unchanged; leaving the block puts the
    originals back."""

    def __init__(self):
        self.reset()

    def __enter__(self):
        self._saved = take, collect, dict_map, dict_lookup = (
            misc_ops.take_columns_rows,
            AggregationOperator._collect_min_max_by,
            S._dict_map, S._dict_lookup)
        probe = self

        def b5() -> int:
            return flat_gather.launches + gather_rows.launches

        def radix() -> dict:
            return {k.__name__: k.launches for k in RADIX_KERNELS}

        def nlj_take(columns, idx):
            before = b5()
            out = take(columns, idx)
            probe.nlj_b5 += b5() - before
            return out

        def collect_sort(self_, *args, **kw):
            before = radix()
            out = collect(self_, *args, **kw)
            for k, v in radix().items():
                probe.collect_radix[k] += v - before[k]
            return out

        def timed(fn):
            def wrapper(v, f, *rest, **kw):
                fname = rest[0] if fn is dict_map else rest[1]
                t0 = time.perf_counter()
                out = fn(v, f, *rest, **kw)
                d = probe.dict_s.setdefault(fname, {"s": 0.0, "calls": 0,
                                                    "values": 0})
                d["s"] += time.perf_counter() - t0
                d["calls"] += 1
                d["values"] += len(v.dictionary)
                return out
            return wrapper

        misc_ops.take_columns_rows = nlj_take
        AggregationOperator._collect_min_max_by = collect_sort
        S._dict_map, S._dict_lookup = timed(dict_map), timed(dict_lookup)
        return self

    def __exit__(self, *exc):
        (misc_ops.take_columns_rows, AggregationOperator._collect_min_max_by,
         S._dict_map, S._dict_lookup) = self._saved

    def reset(self):
        self.nlj_b5 = 0
        self.collect_radix = {k.__name__: 0 for k in RADIX_KERNELS}
        self.dict_s = {}


def _dyn_filters() -> int:
    """The dynamic filters pushed so far in this process."""
    return int(M.reporter().snapshot()["counters"].get(
        M.K_JOIN_DYN_FILTERS, 0))


def tpch_rest_phase(conn, ctx, li, compare_sf: float = COMPARE_SF) -> dict:
    t0 = time.perf_counter()
    oracles = {4: q4_oracle(conn, li), 5: q5_oracle(conn, li),
               10: q10_oracle(conn, li), 11: q11_oracle(conn),
               12: q12_oracle(conn, li), 13: q13_oracle(conn),
               14: q14_oracle(conn, li), 15: q15_oracle(conn, li),
               17: q17_oracle(conn, li), 19: q19_oracle(conn, li),
               21: q21_oracle(conn, li), 22: q22_oracle(conn)}
    phase("tpch_rest_oracles", seconds=time.perf_counter() - t0)
    cache = DataCache.instance()
    probe = _Probe()
    queries, by_query = {}, {}
    for q in REST_QUERIES:
        plan = PATH_PLANS[f"q{q}"]()
        tol = DOUBLE_REL_TOL.get(q, 1e-9)
        runs = {}
        for run in ("cold", "warm"):
            if run == "cold":
                cache.clear()
            hits, misses = cache.hits, cache.misses
            probe.reset()
            dyn = _dyn_filters()
            with probe:
                out, wall, counts = _run(plan, ctx)
            runs[run] = {"wall_s": wall, "rows": _host_table(out),
                         "launches": counts,
                         "dyn_filters": _dyn_filters() - dyn,
                         "cache": [cache.hits - hits,
                                   cache.misses - misses],
                         "nlj_b5": probe.nlj_b5,
                         "collect_radix": dict(probe.collect_radix),
                         "dict_host": probe.dict_s}
        cold, warm = runs["cold"], runs["warm"]
        if not cold["rows"][1] and q not in oracles:
            raise AssertionError(f"Q{q} gave no rows")
        _same_rows(warm["rows"], cold["rows"], tol, f"Q{q} warm vs cold")
        if warm["launches"] != cold["launches"] \
                or warm["dyn_filters"] != cold["dyn_filters"]:
            raise AssertionError(f"Q{q}: warm launches {warm['launches']} "
                                 f"!= cold {cold['launches']}, or dynamic "
                                 "filters differ")
        if q in oracles:
            _same_rows(cold["rows"], oracles[q], tol, f"Q{q} vs numpy")
        if q in (11, 22) and not cold["nlj_b5"] > 0:
            raise AssertionError(f"Q{q}: the nested-loop join launched no B5")
        if q == 15 and not cold["collect_radix"]["radix_hist"] > 0:
            raise AssertionError("Q15: the DECIMAL(38) max sorted without B4")
        by_query[f"q{q}"] = cold["launches"]
        queries[q] = line = {
            "rows": len(cold["rows"][1]),
            "wall_s": {"cold": cold["wall_s"], "warm": warm["wall_s"]},
            "cache": {"cold": cold["cache"], "warm": warm["cache"]},
            "launches": {k: v for k, v in cold["launches"].items()
                         if k != "filter_sum"},
            "dyn_filters": cold["dyn_filters"],
            "nlj_b5": cold["nlj_b5"],
            "collect_radix": cold["collect_radix"],
            "dict_host": {"cold": cold["dict_host"],
                          "warm": warm["dict_host"]},
        }
        phase("tpch_rest_query", q=q, **line)
    cache.clear()
    # the same plans at a smaller scale on the card and on the CPU
    register_tpch(compare_sf, connector_id="tpch_cmp")
    cpu = QueryCtx("cpu")
    compare = {}
    for q in REST_QUERIES:
        plan = tpch_plan(q, connector_id="tpch_cmp")
        out, card_wall, _ = _run(plan, ctx)
        card = _host_table(out)
        t0 = time.perf_counter()
        task = Task(plan, cpu)
        host = _host_table(list(task.batches()))
        task.check_errors()
        cpu_wall = time.perf_counter() - t0
        _same_rows(card, host, DOUBLE_REL_TOL.get(q, 1e-9),
                   f"Q{q} card vs CPU at SF {compare_sf}")
        compare[q] = {"rows": len(card[1]), "card_wall_s": card_wall,
                      "cpu_wall_s": cpu_wall}
        phase("tpch_rest_compare", q=q, **compare[q])
    cache.clear()
    phase("tpch_rest", sf_compare=compare_sf, queries=queries,
          oracles_checked=sorted(oracles), compare=compare,
          cpu_total_s=sum(c["cpu_wall_s"] for c in compare.values()))
    return by_query


# ---------------------------------------------------------------------------
# analytic: Window, RowNumber, TopNRowNumber, MarkDistinct, GroupId,
# MergeJoin, AssignUniqueId and streaming aggregation at SF10
# ---------------------------------------------------------------------------

LI_WINDOW_COLS = ["l_suppkey", "l_shipdate", "l_orderkey", "l_linenumber",
                  "l_quantity", "l_extendedprice"]
Q1_ROLLUP_SETS = (("l_returnflag", "l_linestatus"), ("l_returnflag",), ())
Q1_AGGS = ["sum(l_quantity) as sum_qty",
           "sum(l_extendedprice) as sum_base_price",
           "sum(l_sum_disc_price) as sum_disc_price",
           "sum(l_sum_charge) as sum_charge",
           "avg(l_quantity) as avg_qty", "avg(l_extendedprice) as avg_price",
           "avg(l_discount) as avg_disc", "count() as count_order"]


def _aggregate(source: P.PlanNode, keys, aggs) -> P.PlanNode:
    """A single-step aggregation over a plan node the builder has no
    method for (GroupId)."""
    b = PlanBuilder()
    b._node = source
    return b.single_aggregation(keys, aggs).plan()


def win_lineitem_plan():
    return (PlanBuilder().table_scan("lineitem", LI_WINDOW_COLS)
            .window(["l_suppkey"],
                    ["l_shipdate", "l_orderkey", "l_linenumber"],
                    ["row_number() as rn", "rank() as rk",
                     "dense_rank() as dr", "sum(l_quantity) as sq",
                     "lag(l_extendedprice, 1) as lg"]).plan())


def win_orders_frames_plan():
    rows2 = WindowFrame(FrameType.ROWS, BoundType.PRECEDING, 2,
                        BoundType.CURRENT_ROW, 0)
    range90 = WindowFrame(FrameType.RANGE, BoundType.PRECEDING, 90,
                          BoundType.CURRENT_ROW, 0)
    return (PlanBuilder().table_scan("orders", ["o_custkey", "o_orderdate",
                                                "o_orderkey", "o_totalprice"])
            .window(["o_custkey"], ["o_orderdate", "o_orderkey"],
                    ["min(o_totalprice) as mn", "max(o_totalprice) as mx",
                     "avg(o_totalprice) as av", "ntile(4) as nt",
                     "percent_rank() as pr", "cume_dist() as cd",
                     "first_value(o_totalprice) as fv",
                     "last_value(o_totalprice) as lv"], frame=rows2)
            # RANGE k takes one ORDER BY key
            .window(["o_custkey"], ["o_orderdate"],
                    ["sum(o_totalprice) as s90"], frame=range90).plan())


def topn_row_number_plan():
    """TPC-DS q67's rank() <= N shape: the top 3 orders by price a
    customer."""
    return (PlanBuilder().table_scan("orders", ["o_custkey", "o_totalprice",
                                                "o_orderkey"])
            .top_n_row_number(["o_custkey"], ["o_totalprice DESC",
                                              "o_orderkey"], 3, "rn")
            .plan())


def row_number_hash_plan():
    return (PlanBuilder().table_scan("lineitem", ["l_orderkey"])
            .row_number(["l_orderkey"], "rn", limit=2).plan())


def distinct_counts_plan():
    """Two count(DISTINCT ...) per l_returnflag, as Presto plans them:
    MarkDistinct per distinct key tuple, then sums of the markers."""
    return (PlanBuilder().table_scan("lineitem", ["l_returnflag",
                                                  "l_orderkey", "l_partkey"])
            .mark_distinct("m1", ["l_returnflag", "l_orderkey"])
            .mark_distinct("m2", ["l_returnflag", "l_partkey"])
            .project(["l_returnflag", "if(m1, 1, 0) as c1",
                      "if(m2, 1, 0) as c2"])
            .single_aggregation(["l_returnflag"], ["sum(c1) as d1",
                                                   "sum(c2) as d2"]).plan())


def q1_rollup_plan():
    """Q1's aggregates over ROLLUP(l_returnflag, l_linestatus): GroupId,
    then one aggregation over 3x the rows."""
    head = (PlanBuilder()
            .table_scan("lineitem", Q1_COLS,
                        filter="l_shipdate <= date '1998-09-02'")
            .project(Q1_PROJECT).plan())
    gid = P.GroupIdNode(
        "q1_rollup_gid", source=head, grouping_sets=Q1_ROLLUP_SETS,
        aggregation_inputs=("l_quantity", "l_extendedprice",
                            "l_sum_disc_price", "l_sum_charge",
                            "l_discount"))
    return _aggregate(gid, ["l_returnflag", "l_linestatus", "group_id"],
                      Q1_AGGS)


def merge_join_plan():
    """lineitem merge-joined with orders (its build side, in key order as
    generated), a unique id a joined row, then per o_orderpriority."""
    b = PlanBuilder()
    orders = b.new_builder().table_scan("orders", ["o_orderkey",
                                                   "o_orderpriority"])
    return (b.table_scan("lineitem", ["l_orderkey", "l_extendedprice"])
            .merge_join(["l_orderkey"], ["o_orderkey"], orders,
                        output=["l_extendedprice", "o_orderpriority"])
            .assign_unique_id("uid")
            .single_aggregation(["o_orderpriority"],
                                ["sum(l_extendedprice) as revenue",
                                 "count() as n", "max(uid) as last_uid"])
            .plan())


def streaming_agg_plan():
    return (PlanBuilder().table_scan("orders", ["o_custkey", "o_totalprice"])
            .order_by(["o_custkey"])
            .single_aggregation(["o_custkey"], ["sum(o_totalprice) as s"])
            .plan())


# path -> its plans, run one after the other
ANALYTIC_PLANS = {
    "win_lineitem": (win_lineitem_plan,),
    "win_orders_frames": (win_orders_frames_plan,),
    "topn_row_number": (topn_row_number_plan,),
    "row_number_hash": (row_number_hash_plan,),
    "distinct_rollup": (distinct_counts_plan, q1_rollup_plan),
    "merge_join": (merge_join_plan, streaming_agg_plan),
}
PATH_PLANS.update({
    "win_lineitem": win_lineitem_plan,
    "win_orders_frames": win_orders_frames_plan,
    "topn_row_number": topn_row_number_plan,
    "row_number_hash": row_number_hash_plan,
    "distinct_counts": distinct_counts_plan,
    "q1_rollup": q1_rollup_plan,
    "merge_join": merge_join_plan,
    "streaming_agg": streaming_agg_plan,
})
# the paths whose sorts are a window's, RowNumber's or TopNRowNumber's
# (B2 or B3 must run there)
ANALYTIC_SORTS = ("win_lineitem", "win_orders_frames", "topn_row_number",
                  "row_number_hash")


def _active_cols(batches, name):
    """(data, validity or None, high limb or None) of a column's active
    rows over output batches, concatenated on the card."""
    parts = ([], [], [])
    for b in batches:
        c = b.columns[name]
        parts[0].append(c.data[b.mask])
        if c.validity is not None:
            parts[1].append(c.validity[b.mask])
        if c.children:
            parts[2].append(c.children[0].data[b.mask])
    return tuple(torch.cat(p) if p else None for p in parts)


def _expect(got: torch.Tensor, want: np.ndarray, what: str,
            rel_tol: float = 0.0) -> None:
    """A column on the card equals a numpy oracle (doubles within
    ``rel_tol`` relative)."""
    w = torch.from_numpy(np.ascontiguousarray(want)).to(got.device)
    if got.shape != w.shape:
        raise AssertionError(f"{what}: {tuple(got.shape)} rows, expected "
                             f"{tuple(w.shape)}")
    if w.dtype.is_floating_point:
        ok = torch.isclose(got.to(w.dtype), w, rtol=rel_tol, atol=0.0)
    else:
        ok = got.to(w.dtype) == w
    if not bool(ok.all()):
        i = int((~ok).nonzero()[0])
        raise AssertionError(f"{what}: row {i} is {got[i].item()}, "
                             f"expected {want[i]}")


def _check_columns(batches, want: dict, what: str) -> None:
    """Every column of ``want`` (name -> data, or (data, validity)) equals
    the output's active rows; a long decimal's high limb is the sign of
    its (int64) value."""
    for name, w in want.items():
        data, validity, hi = _active_cols(batches, name)
        wd, wv = w if isinstance(w, tuple) else (w, None)
        if wv is None and validity is not None \
                and not bool(validity.all()):
            raise AssertionError(f"{what} {name}: unexpected NULL")
        if wv is not None:
            _expect(validity, wv, f"{what} {name} validity")
            data = torch.where(validity, data, torch.zeros_like(data))
            wd = np.where(wv, wd, 0)
        _expect(data, wd, f"{what} {name}",
                rel_tol=1e-9 if wd.dtype.kind == "f" else 0.0)
        if hi is not None:
            _expect(hi, (wd < 0).astype(np.int64) * -1, f"{what} {name} hi")


def _partitions(sorted_keys: np.ndarray):
    """(start, end, position) of each row's run of equal sorted keys."""
    n = len(sorted_keys)
    iota = np.arange(n)
    new = np.r_[True, sorted_keys[1:] != sorted_keys[:-1]]
    start = np.maximum.accumulate(np.where(new, iota, 0))
    last = np.r_[new[1:], True]
    end = np.minimum.accumulate(np.where(last, iota, n)[::-1])[::-1]
    return start, end, iota - start


def _before(prefix: np.ndarray, i: np.ndarray) -> np.ndarray:
    """Inclusive prefix sums at i - 1 (0 before row 0)."""
    return np.where(i > 0, prefix[np.maximum(i - 1, 0)], 0)


def win_lineitem_oracle(li) -> dict:
    """The window over lineitem sorted by one unique composite of
    (l_suppkey, l_shipdate, l_orderkey, l_linenumber), whose widths at
    SF10 (17, 14, 26, 3 bits) fit 60: every row is its own peer group, so
    rank and dense_rank equal row_number."""
    key = ((li["l_suppkey"] << 14 | li["l_shipdate"]) << 26
           | li["l_orderkey"]) << 3 | li["l_linenumber"]
    order = np.argsort(key)
    start, _, pos = _partitions(li["l_suppkey"][order])
    q = np.cumsum(li["l_quantity"][order])
    p = li["l_extendedprice"][order]
    rn = pos + 1
    return {"l_orderkey": li["l_orderkey"][order],
            "l_linenumber": li["l_linenumber"][order],
            "rn": rn, "rk": rn, "dr": rn, "sq": q - _before(q, start),
            "lg": (np.r_[0, p[:-1]], pos > 0)}


def win_orders_frames_oracle(od) -> dict:
    """Both windows over orders sorted by the unique composite
    (o_custkey, o_orderdate, o_orderkey) (21, 15, 26 bits at SF10): the
    second window's stable sort by (o_custkey, o_orderdate) keeps that
    order. ROWS 2 PRECEDING frames from shifts; the RANGE 90 PRECEDING
    sums from binary searches over (o_custkey, o_orderdate)."""
    comp = od["o_custkey"] << 15 | od["o_orderdate"]
    order = np.argsort(comp << 26 | od["o_orderkey"])
    comp = comp[order]
    tp = od["o_totalprice"][order]
    start, end, pos = _partitions(od["o_custkey"][order])
    size = end - start + 1
    mn, mx, s, c = tp.copy(), tp.copy(), tp.copy(), np.ones_like(tp)
    for d in (1, 2):
        prev = np.r_[np.zeros(d, np.int64), tp[:-d]]
        ok = pos >= d
        mn = np.where(ok, np.minimum(mn, prev), mn)
        mx = np.where(ok, np.maximum(mx, prev), mx)
        s, c = s + np.where(ok, prev, 0), c + ok
    half = c // 2
    avg = np.where(s >= 0, (s + half) // c, -((-s + half) // c))
    small, rem = size // 4, size % 4
    cut = rem * (small + 1)
    nt = np.where(pos < cut, pos // np.maximum(small + 1, 1),
                  rem + (pos - cut) // np.maximum(small, 1)) + 1
    pr = np.where(size == 1, 0.0, pos / np.maximum(size - 1, 1))
    lo = np.searchsorted(comp, comp - 90, side="left")
    hi = np.searchsorted(comp, comp, side="right") - 1
    cs = np.cumsum(tp)
    return {"o_orderkey": od["o_orderkey"][order], "mn": mn, "mx": mx,
            "av": avg, "nt": nt, "pr": pr, "cd": (pos + 1) / size,
            "fv": tp[np.maximum(start, np.arange(len(tp)) - 2)], "lv": tp,
            "s90": cs[hi] - _before(cs, lo)}


def topn_row_number_oracle(od) -> dict:
    order = np.lexsort((od["o_orderkey"], -od["o_totalprice"],
                        od["o_custkey"]))
    _, _, pos = _partitions(od["o_custkey"][order])
    keep = pos < 3
    return {"o_orderkey": od["o_orderkey"][order][keep],
            "rn": pos[keep] + 1}


def row_number_hash_oracle(li) -> dict:
    """Each line's occurrence number of its l_orderkey in the stream,
    the first two kept."""
    k = li["l_orderkey"]
    order = np.argsort(k, kind="stable")
    _, _, pos = _partitions(k[order])
    rn = np.empty(len(k), np.int64)
    rn[order] = pos + 1
    keep = rn <= 2
    return {"l_orderkey": k[keep], "rn": rn[keep]}


def distinct_rollup_oracle(conn, li) -> tuple:
    """(distinct counts, Q1 rollup) as (names, rows) tables: distinct
    (flag, key) pairs from bincounts; the rollup's sums exact in Python
    ints, averages half-up."""
    flags = conn.gen.dictionaries("lineitem")["l_returnflag"]
    status = conn.gen.dictionaries("lineitem")["l_linestatus"]
    rf = li["l_returnflag"]
    counts = []
    for f in range(len(flags)):
        sel = rf == f
        if sel.any():
            counts.append((flags.values[f],
                           int(np.count_nonzero(np.bincount(
                               li["l_orderkey"][sel]))),
                           int(np.count_nonzero(np.bincount(
                               li["l_partkey"][sel])))))
    m = li["l_shipdate"] <= D980902
    q, p = li["l_quantity"], li["l_extendedprice"]
    d, t = li["l_discount"], li["l_tax"]
    cells = {}
    for f in range(len(flags)):
        for s in range(len(status)):
            sel = m & (rf == f) & (li["l_linestatus"] == s)
            if sel.any():
                dp = p[sel] * (100 - d[sel])
                cells[f, s] = np.array(
                    [_psum(q[sel]), _psum(p[sel]), _psum(dp),
                     _psum(dp * (100 + t[sel])), _psum(d[sel]),
                     int(sel.sum())], dtype=object)
    rows = []
    for gid, key_of in enumerate((lambda f, s: (f, s), lambda f, s: (f,),
                                  lambda f, s: ())):
        groups = {}
        for (f, s), v in cells.items():
            k = key_of(f, s)
            groups[k] = groups.get(k, 0) + v
        for k, (sq, sp, sdp, sc, sd, n) in groups.items():
            rows.append((flags.values[k[0]] if k else None,
                         status.values[k[1]] if len(k) > 1 else None,
                         gid, sq, sp, sdp, sc, _half_up(sq, n),
                         _half_up(sp, n), _half_up(sd, n), n))
    names = (["l_returnflag", "l_linestatus", "group_id"]
             + [a.split(" as ")[1] for a in Q1_AGGS])
    return (["l_returnflag", "d1", "d2"], counts), (names, rows)


def merge_join_oracle(conn, li, od) -> tuple:
    """(per-priority table, streaming sums): every line joins its order;
    the unique id is the line's position in the stream."""
    prios = conn.gen.dictionaries("orders")["o_orderpriority"]
    prio_of = np.full(int(od["o_orderkey"].max()) + 1, -1, np.int64)
    prio_of[od["o_orderkey"]] = od["o_orderpriority"]
    pl = prio_of[li["l_orderkey"]]
    rows = []
    for i in range(len(prios)):
        sel = pl == i
        if sel.any():
            rows.append((prios.values[i], _psum(li["l_extendedprice"][sel]),
                         int(sel.sum()), int(np.flatnonzero(sel)[-1])))
    order = np.argsort(od["o_custkey"], kind="stable")
    ck = od["o_custkey"][order]
    first = np.flatnonzero(np.r_[True, ck[1:] != ck[:-1]])
    sums = np.add.reduceat(od["o_totalprice"][order], first)
    return ((["o_orderpriority", "revenue", "n", "last_uid"], rows),
            {"o_custkey": ck[first], "s": sums})


def analytic_phase(conn, ctx, li) -> dict:
    """The six analytic paths at SF10, each run cold (scan cache cleared)
    and warm, each exact against its numpy oracle; per path the walls,
    the peak device memory, the kernels' launches and the hash table's
    rounds and rehashes. Returns each path's cold launch counts."""
    t0 = time.perf_counter()
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_orderdate", "o_totalprice",
                                        "o_orderpriority"])
    distinct, rollup = distinct_rollup_oracle(conn, li)
    per_prio, stream_sums = merge_join_oracle(conn, li, od)

    def table_check(want, what):
        return lambda out: _same_rows(_host_table(out), want, 1e-9,
                                      f"{what} vs numpy")
    checks = {
        "win_lineitem": (lambda out, w=win_lineitem_oracle(li):
                         _check_columns(out, w, "win_lineitem"),),
        "win_orders_frames": (lambda out, w=win_orders_frames_oracle(od):
                              _check_columns(out, w, "win_orders_frames"),),
        "topn_row_number": (lambda out, w=topn_row_number_oracle(od):
                            _check_columns(out, w, "topn_row_number"),),
        "row_number_hash": (lambda out, w=row_number_hash_oracle(li):
                            _check_columns(out, w, "row_number_hash"),),
        "distinct_rollup": (table_check(distinct, "distinct counts"),
                            table_check(rollup, "q1 rollup")),
        "merge_join": (table_check(per_prio, "merge join"),
                       lambda out: _check_columns(out, stream_sums,
                                                  "streaming")),
    }
    phase("analytic_oracles", seconds=time.perf_counter() - t0)
    cache = DataCache.instance()
    by_path = {}
    for name, plans in ANALYTIC_PLANS.items():
        runs = {}
        for run in ("cold", "warm"):
            if run == "cold":
                cache.clear()
            H.insert.rounds = H.reserve.rehashes = 0
            torch.cuda.reset_peak_memory_stats()
            wall, counts = 0.0, {}
            for make, check in zip(plans, checks[name]):
                out, w, c = _run(make(), ctx)
                check(out)
                del out
                wall += w
                counts = {k: counts.get(k, 0) + v for k, v in c.items()}
            runs[run] = {"wall_s": wall, "launches": counts,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(),
                         "hash_rounds": H.insert.rounds,
                         "rehashes": H.reserve.rehashes}
        cold, warm = runs["cold"], runs["warm"]
        if warm["launches"] != cold["launches"]:
            raise AssertionError(f"{name}: warm launches {warm['launches']}"
                                 f" != cold {cold['launches']}")
        got = cold["launches"]
        if not (got["radix_hist"] > 0
                and got["flat_gather"] + got["gather_rows"] > 0):
            raise AssertionError(f"{name}: B4 or B5 never launched: {got}")
        if name in ANALYTIC_SORTS and not (got["radix_rank"]
                                           + got["radix_pos"] > 0):
            raise AssertionError(f"{name}: neither B2 nor B3 launched")
        if name == "row_number_hash" and not cold["rehashes"] > 0:
            raise AssertionError("row_number_hash: the table never grew")
        by_path[name] = got
        phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
              max_memory_allocated={r: v["max_memory_allocated"]
                                    for r, v in runs.items()},
              launches={k: v for k, v in got.items() if k != "filter_sum"},
              hash_rounds={r: v["hash_rounds"] for r, v in runs.items()},
              rehashes={r: v["rehashes"] for r, v in runs.items()})
    cache.clear()
    return by_path


# ---------------------------------------------------------------------------
# aggregates: the scalar aggregates, vector (HLL) states, the collect kinds,
# abandonment, dynamic filters and the early finish, wide join keys
# ---------------------------------------------------------------------------

AGG_MOMENTS = ["count_if(disc_hi) as ci", "bool_and(late) as ba",
               "bool_or(late) as bo", "arbitrary(l_linenumber) as an",
               "variance(l_extendedprice) as v",
               "var_pop(l_extendedprice) as vp",
               "stddev(l_extendedprice) as sd",
               "stddev_pop(l_extendedprice) as sp",
               "skewness(l_discount) as sk", "kurtosis(l_tax) as ku"]
D950617 = 9298  # 1995-06-17
# relative tolerance of skewness and kurtosis against the oracle's
# correctly rounded power sums: their central moments cancel about five
# digits (l_discount's skewness is near 0). Measured on an H100 at SF10:
# 2.2e-10 (skewness), 1.8e-14 (kurtosis); held to 1e-8. Variance and
# stddev to 1e-9 (measured 1.3e-11).
MOMENT_REL_TOL = 1e-8
WIDE_KEYS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
             "l_shipdate"]
HLL_M = 512


def agg_moments_plan():
    return (PlanBuilder().table_scan(
        "lineitem", ["l_returnflag", "l_linestatus", "l_discount",
                     "l_shipdate", "l_linenumber", "l_extendedprice",
                     "l_tax"])
        .project(["l_returnflag", "l_linestatus",
                  "l_discount > 0.05 as disc_hi",
                  "l_shipdate > date '1995-06-17' as late", "l_linenumber",
                  "l_extendedprice", "l_discount", "l_tax"])
        .single_aggregation(["l_returnflag", "l_linestatus"], AGG_MOMENTS)
        .plan())


def agg_stddev_supp_plan():
    return (PlanBuilder().table_scan("lineitem", ["l_suppkey", "l_quantity"])
            .single_aggregation(["l_suppkey"],
                                ["stddev_samp(l_quantity) as sd"]).plan())


def _ad_plan(key, col):
    return (PlanBuilder().table_scan("lineitem", ([key] if key else [])
                                     + [col])
            .single_aggregation([key] if key else [],
                                [f"approx_distinct({col}) as ad"]).plan())


def agg_pct_single_plan():
    return (PlanBuilder().table_scan(
        "lineitem", ["l_returnflag", "l_linestatus", "l_extendedprice",
                     "l_quantity"])
        .single_aggregation(["l_returnflag", "l_linestatus"], [
            "approx_percentile(l_extendedprice, 0.5) as p50",
            "mode(l_quantity) as mq"]).plan())


def agg_pct_split_plan():
    return (PlanBuilder().table_scan("lineitem", ["l_shipmode",
                                                  "l_extendedprice"])
            .partial_aggregation(["l_shipmode"], [
                "approx_percentile(l_extendedprice, 0.9) as p90"])
            .final_aggregation().plan())


def agg_min_by_plan():
    return (PlanBuilder().table_scan("lineitem", ["l_orderkey",
                                                  "l_linenumber",
                                                  "l_shipdate"])
            .single_aggregation(["l_orderkey"], [
                "min_by(l_linenumber, l_shipdate) as mb",
                "max_by(l_shipdate, l_linenumber) as xb",
                "first(l_linenumber) as f"]).plan())


def agg_abandon_plan():
    return (PlanBuilder().table_scan("lineitem", ["l_orderkey",
                                                  "l_linenumber",
                                                  "l_quantity"])
            .partial_aggregation(["l_orderkey", "l_linenumber"],
                                 ["sum(l_quantity) as s", "count() as c"])
            .final_aggregation().plan())


def dyn_filter_plan(limit: int):
    b = PlanBuilder()
    ps = b.new_builder().table_scan(
        "partsupp", ["ps_partkey", "ps_suppkey", "ps_availqty"],
        filter=f"ps_availqty < {limit}")
    return (b.table_scan("lineitem", ["l_partkey", "l_suppkey",
                                      "l_extendedprice"])
            .hash_join(["l_partkey", "l_suppkey"],
                       ["ps_partkey", "ps_suppkey"], ps,
                       output=["l_extendedprice"])
            .single_aggregation([], ["count() as n",
                                     "sum(l_extendedprice) as s"]).plan())


def wide_join_plan():
    """lineitem joined to its 'R' lines on five keys, eight value words
    (three BIGINT, an INTEGER and a DATE)."""
    b = PlanBuilder()
    ret = (b.new_builder().table_scan("lineitem",
                                      WIDE_KEYS + ["l_returnflag"],
                                      filter="l_returnflag = 'R'")
           .project([f"{k} as r{k[1:]}" for k in WIDE_KEYS]))
    return (b.table_scan("lineitem", WIDE_KEYS + ["l_extendedprice"])
            .hash_join(WIDE_KEYS, [f"r{k[1:]}" for k in WIDE_KEYS], ret,
                       output=["l_extendedprice"])
            .single_aggregation([], ["count() as n",
                                     "sum(l_extendedprice) as s"]).plan())


# path -> its plans, run one after the other
AGG_PLANS = {
    "agg_moments": (agg_moments_plan, agg_stddev_supp_plan),
    "agg_sketches": (lambda: _ad_plan("l_returnflag", "l_partkey"),
                     lambda: _ad_plan(None, "l_orderkey"),
                     lambda: _ad_plan("l_linenumber", "l_partkey")),
    "agg_percentile": (agg_pct_single_plan, agg_pct_split_plan),
    "agg_min_by": (agg_min_by_plan,),
    "agg_abandon": (agg_abandon_plan,),
    # the empty build first: its cold run reads partsupp's splits only
    "dyn_filter": (lambda: dyn_filter_plan(0),
                   lambda: dyn_filter_plan(100)),
    "wide_join": (wide_join_plan,),
}
PATH_PLANS.update({
    "agg_moments": agg_moments_plan,
    "agg_stddev_supp": agg_stddev_supp_plan,
    "agg_sketch_flag": AGG_PLANS["agg_sketches"][0],
    "agg_sketch_global": AGG_PLANS["agg_sketches"][1],
    "agg_sketch_linenumber": AGG_PLANS["agg_sketches"][2],
    "agg_pct_single": agg_pct_single_plan,
    "agg_pct_split": agg_pct_split_plan,
    "agg_min_by": agg_min_by_plan,
    "agg_abandon": agg_abandon_plan,
    "dyn_filter_empty": AGG_PLANS["dyn_filter"][0],
    "dyn_filter": AGG_PLANS["dyn_filter"][1],
    "wide_join": wide_join_plan,
})
# the paths whose sorts take the classic loop (B2 must run there)
AGG_CLASSIC = ("agg_percentile", "wide_join")


def _powers(x, k: int) -> list:
    """x^1..x^k in float64, formed as the engine forms them (x2 = x*x,
    x3 = x2*x, x4 = x2*x2)."""
    x2 = x * x
    return [x, x2, x2 * x, x2 * x2][:k]


def _power_sums(gid: np.ndarray, x: np.ndarray, k: int, groups: int):
    """Per group: n and the float64 sums of x^1..x^k."""
    return [np.bincount(gid, minlength=groups).astype(np.int64)] + [
        np.bincount(gid, weights=p, minlength=groups)
        for p in _powers(x, k)]


def _exact_power_sums(gid: np.ndarray, raw: np.ndarray, scale: int, k: int,
                      groups: int):
    """Per group: n and the sums of x^1..x^k, x = raw / 10^scale in
    float64, each sum exact and then rounded once: a column of few values
    (l_discount, l_tax), summed as count x power per value in rationals.
    Skewness and kurtosis cancel 4-5 digits of these sums, so a rounded
    running sum over 15M rows would decide their last digits."""
    from fractions import Fraction
    vals, idx = np.unique(raw, return_inverse=True)
    counts = np.bincount(gid * len(vals) + idx,
                         minlength=groups * len(vals)).reshape(groups, -1)
    pw = _powers(vals.astype(np.float64) / 10.0 ** scale, k)
    sums = [np.array([float(sum(Fraction(int(c)) * Fraction(float(p[v]))
                                for v, c in enumerate(counts[g])))
                      for g in range(groups)]) for p in pw]
    return [counts.sum(1).astype(np.int64)] + sums


def _variance(name: str, n, s, ss):
    """The reference's variance / stddev formulas (NaN where NULL)."""
    nf = n.astype(np.float64)
    m2 = ss - s * s / np.maximum(nf, 1.0)
    pop = name.endswith("_pop")
    out = np.maximum(m2 / np.maximum(nf if pop else nf - 1.0, 1.0), 0.0)
    if name.startswith("stddev"):
        out = np.sqrt(out)
    return np.where(n >= (1 if pop else 2), out, np.nan)


def _moment(name: str, n, s1, s2, s3, s4):
    """The reference's skewness / kurtosis formulas (NaN where NULL)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return _moment_values(name, n, s1, s2, s3, s4)


def _moment_values(name: str, n, s1, s2, s3, s4):
    nf = np.maximum(n.astype(np.float64), 1.0)
    m2 = np.maximum(s2 - s1 * s1 / nf, 0.0)
    if name == "skewness":
        m3 = s3 - 3.0 * s2 * s1 / nf + 2.0 * s1 ** 3 / (nf * nf)
        out = np.sqrt(nf) * m3 / np.maximum(m2, 1e-300) ** 1.5
        return np.where((n >= 3) & (m2 > 0), out, np.nan)
    m4 = (s4 - 4.0 * s3 * s1 / nf + 6.0 * s2 * s1 * s1 / (nf * nf)
          - 3.0 * s1 ** 4 / nf ** 3)
    denom = np.maximum((nf - 2.0) * (nf - 3.0), 1.0)
    out = ((nf - 1.0) * nf * (nf + 1.0)) / denom * m4 \
        / np.maximum(m2 * m2, 1e-300) - 3.0 * (nf - 1.0) ** 2 / denom
    return np.where((n >= 4) & (m2 > 0), out, np.nan)


def agg_moments_oracle(conn, li) -> tuple:
    """Per (l_returnflag, l_linestatus): the count_if and bool results
    exact, arbitrary as the group's min (the reference's), variance and
    stddev from float64 power sums; then stddev_samp(l_quantity) per
    l_suppkey."""
    d = conn.gen.dictionaries("lineitem")
    n_ls = len(d["l_linestatus"].values)
    gid = li["l_returnflag"] * n_ls + li["l_linestatus"]
    groups = len(d["l_returnflag"].values) * n_ls
    n = np.bincount(gid, minlength=groups)
    late = li["l_shipdate"] > D950617
    ci = np.bincount(gid, weights=li["l_discount"] > 5, minlength=groups)
    n_late = np.bincount(gid, weights=late, minlength=groups)
    arb = np.full(groups, 99, np.int64)
    np.minimum.at(arb, gid, li["l_linenumber"])
    _, s, ss = _power_sums(gid, li["l_extendedprice"] / 100.0, 2, groups)
    var = {k: _variance(k, n, s, ss) for k in ("var_samp", "var_pop",
                                               "stddev_samp", "stddev_pop")}
    sk = _moment("skewness", *_exact_power_sums(gid, li["l_discount"], 2,
                                                4, groups))
    ku = _moment("kurtosis", *_exact_power_sums(gid, li["l_tax"], 2, 4,
                                                groups))
    rows = []
    for g in np.nonzero(n)[0]:
        rows.append((str(d["l_returnflag"].values[g // n_ls]),
                     str(d["l_linestatus"].values[g % n_ls]), int(ci[g]),
                     bool(n_late[g] == n[g]), bool(n_late[g] > 0),
                     int(arb[g]), float(var["var_samp"][g]),
                     float(var["var_pop"][g]), float(var["stddev_samp"][g]),
                     float(var["stddev_pop"][g]), float(sk[g]),
                     float(ku[g])))
    per = (["l_returnflag", "l_linestatus", "ci", "ba", "bo", "an", "v",
            "vp", "sd", "sp", "sk", "ku"], rows)
    sk_ = li["l_suppkey"]
    n2, s2, ss2 = _power_sums(sk_, li["l_quantity"] / 100.0, 2,
                              int(sk_.max()) + 1)
    sd2 = _variance("stddev_samp", n2, s2, ss2)
    supp = np.nonzero(n2)[0]
    return per, (["l_suppkey", "sd"], [(int(k), float(sd2[k]))
                                       for k in supp])


def _np_hash(v: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """exec/hashtable.py ``hash_rows`` of one non-null column in numpy
    (uint64 holding 32-bit values): the column's order-preserving words,
    as its storage dtype gives them, through the 32-bit finalizer."""
    m32 = np.uint64(0xFFFFFFFF)
    v = v.astype(np.int64)
    if dtype == torch.int64:
        words = [((v >> 32) + (1 << 31)).astype(np.uint64),
                 v.astype(np.uint64) & m32]
    else:
        words = [(v + (1 << 31)).astype(np.uint64)]
    h = np.full(len(v), 0x9E3779B9, np.uint64)
    for w in words:
        h = h ^ w
        h = ((h ^ (h >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & m32
        h = ((h ^ (h >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & m32
        h = h ^ (h >> np.uint64(16))
    return h


def _np_hll(gid: np.ndarray, v: np.ndarray, dtype, groups: int):
    """(estimate, exact distinct count) per group: HyperLogLog registers
    with exact bit lengths, and a bitmap count of the distinct values."""
    h = _np_hash(v, dtype)
    reg = (h & np.uint64(HLL_M - 1)).astype(np.int64)
    w = (h >> np.uint64(9)).astype(np.int64)
    rho = 23 - np.frexp(w.astype(np.float64))[1] + 1  # exact below 2^53
    regs = np.zeros((groups, HLL_M), np.int64)
    flat = regs.reshape(-1)
    key = gid * HLL_M + reg
    for r in range(1, 25):  # ascending: the last write is the max
        flat[key[rho == r]] = r
    m = float(HLL_M)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    est = alpha * m * m / np.exp2(-regs.astype(np.float64)).sum(1)
    zeros = (regs == 0).sum(1).astype(np.float64)
    lin = m * np.log(m / np.maximum(zeros, 1.0))
    out = np.round(np.where((est <= 2.5 * m) & (zeros > 0), lin, est))
    seen = np.zeros((groups, int(v.max()) + 1), bool)
    seen[gid, v] = True
    return out.astype(np.int64), seen.sum(1)


def agg_sketches_oracle(conn, li) -> list:
    """Per plan of the agg_sketches path: (column names, rows with the
    numpy HLL's estimate, each group's exact distinct count)."""
    flags = conn.gen.dictionaries("lineitem")["l_returnflag"].values
    out = []
    for key, col, groups, gname in (
            ("l_returnflag", "l_partkey", len(flags), lambda g: str(flags[g])),
            (None, "l_orderkey", 1, None),
            ("l_linenumber", "l_partkey", 8, int)):
        gid = (li[key] if key else np.zeros(len(li[col]), np.int64))
        est, exact = _np_hll(gid, li[col], storage_dtype("lineitem", col),
                             groups)
        present = np.nonzero(exact)[0]
        if key is None:
            out.append((["ad"], [(int(est[0]),)], exact[present]))
        else:
            out.append(([key, "ad"], [(gname(g), int(est[g]))
                                      for g in present], exact[present]))
    return out


def _host_arrays(batches, names) -> dict:
    """Active rows of output columns as host numpy arrays (data only)."""
    return {n: np.concatenate([b.columns[n].data[b.mask].cpu().numpy()
                               for b in batches]) for n in names}


def aggregates_phase(conn, ctx, li) -> dict:
    """The seven aggregate and join paths at SF10, each cold (the scan
    cache cleared) and warm with equal rows and launches, each held to its
    oracle; per path the walls, the peak device memory, the launches, the
    dynamic filters pushed, and where it applies the abandonment point
    and the splits read. Returns each path's cold launch counts."""
    t0 = time.perf_counter()
    d = conn.gen.dictionaries("lineitem")
    moments, supp = agg_moments_oracle(conn, li)
    sketches = agg_sketches_oracle(conn, li)
    phase("aggregates_oracles", seconds=time.perf_counter() - t0)
    n_li = len(li["l_orderkey"])
    n_ps_splits = len(conn.default_splits("partsupp"))

    def rel_close(got, want, what):
        """Rows equal but for the doubles; each double column's worst
        relative error, held to 1e-9 (variance, stddev) or
        MOMENT_REL_TOL (skewness, kurtosis)."""
        gr = {(r[0], r[1]): r for r in got[1]}
        if got[0] != want[0] or sorted(gr) != sorted(
                (w[0], w[1]) for w in want[1]):
            raise AssertionError(f"{what}: groups {got} != {want}")
        worst = {}
        for w in want[1]:
            g = gr[(w[0], w[1])]
            if g[:6] != w[:6]:
                raise AssertionError(f"{what}: {g} != {w}")
            for i in range(6, 12):
                e = 0.0 if g[i] == w[i] else abs(g[i] - w[i]) / abs(w[i])
                worst[got[0][i]] = max(worst.get(got[0][i], 0.0), e)
        for col, e in worst.items():
            if e > (MOMENT_REL_TOL if col in ("sk", "ku") else 1e-9):
                raise AssertionError(f"{what}: {col} off by {e} relative "
                                     f"(all: {worst})")
        return worst

    def check_moments(outs, info):
        info["max_rel_err"] = rel_close(_host_table(outs[0]), moments,
                                        "agg_moments vs numpy")
        _same_rows(_host_table(outs[1]), supp, 1e-9, "stddev per supplier")

    def check_sketches(outs, info):
        info["distinct"] = []
        for out, (names, want, exact) in zip(outs, sketches):
            got = _host_table(out)
            _same_rows(got, (names, want), 0.0, f"approx_distinct {names}")
            est = np.array([r[-1] for r in want], np.float64)
            rel = np.abs(est - exact) / exact
            if not (rel <= 3 * 0.046).all():
                raise AssertionError(f"approx_distinct {names}: {rel}")
            info["distinct"].append({"estimate": est.astype(int).tolist(),
                                     "exact": exact.tolist()})

    def check_percentile(outs, info):
        got = _host_arrays(outs[0], ["l_returnflag", "l_linestatus", "p50",
                                     "mq"])
        n_ls = len(d["l_linestatus"].values)
        gid = li["l_returnflag"] * n_ls + li["l_linestatus"]
        fl, st = (outs[0][0].columns[c].dictionary
                  for c in ("l_returnflag", "l_linestatus"))
        for f, s_, p50, mq in zip(*got.values()):
            g = d["l_returnflag"].id_of(fl.values[f]) * n_ls \
                + d["l_linestatus"].id_of(st.values[s_])
            x = li["l_extendedprice"][gid == g]
            k = math.ceil(0.5 * len(x)) - 1
            if p50 != np.partition(x, k)[k]:
                raise AssertionError(f"approx_percentile group {g}: {p50}")
            cnt = np.bincount(li["l_quantity"][gid == g])
            if mq != int(np.argmax(cnt)):
                raise AssertionError(f"mode group {g}: {mq}")
        sm = _li_extra(conn, ["l_shipmode"])["l_shipmode"]
        got = _host_arrays(outs[1], ["l_shipmode", "p90"])
        md = outs[1][0].columns["l_shipmode"].dictionary
        worst = 0.0
        for m_, q in zip(got["l_shipmode"], got["p90"]):
            x = li["l_extendedprice"][sm == d["l_shipmode"].id_of(
                md.values[m_])]
            r = math.ceil(0.9 * len(x))
            lo, hi = int((x < q).sum()) + 1, int((x <= q).sum())
            err = 0 if lo <= r <= hi else min(abs(lo - r), abs(hi - r))
            worst = max(worst, err / len(x))
        if worst > 2.0 / 1024:
            raise AssertionError(f"split approx_percentile: rank error "
                                 f"{worst} > 2/1024")
        info["split_rank_err"] = worst

    def check_min_by(outs, info):
        got = _host_arrays(outs[0], ["l_orderkey", "mb", "xb", "f"])
        order = np.argsort(got["l_orderkey"])
        ok = li["l_orderkey"]
        starts = np.flatnonzero(np.r_[True, ok[1:] != ok[:-1]])
        keys = ok[starts]
        if not np.array_equal(got["l_orderkey"][order], keys):
            raise AssertionError("agg_min_by: group keys differ")
        ln, sd = li["l_linenumber"], li["l_shipdate"]
        mb = np.minimum.reduceat(sd * 8 + ln, starts) % 8
        xb = np.maximum.reduceat(ln * (1 << 16) + sd, starts) % (1 << 16)
        lines = np.diff(np.r_[starts, len(ok)])
        for name, want in (("mb", mb), ("xb", xb)):
            if not np.array_equal(got[name][order], want):
                raise AssertionError(f"agg_min_by {name} differs")
        f = got["f"][order]
        if not ((f >= 1) & (f <= lines)).all():
            raise AssertionError("agg_min_by: first() not a group value")
        info["groups"] = len(keys)

    def check_abandon(outs, info):
        got = _host_arrays(outs[0], ["l_orderkey", "l_linenumber", "s",
                                     "c"])
        if len(got["c"]) != n_li or not (got["c"] == 1).all():
            raise AssertionError(f"agg_abandon: {len(got['c'])} groups")
        if _psum(got["s"]) != _psum(li["l_quantity"]):
            raise AssertionError("agg_abandon: sum(l_quantity) differs")
        sel = got["l_orderkey"] % 60 == 0
        o = np.lexsort((got["l_linenumber"][sel], got["l_orderkey"][sel]))
        want = li["l_orderkey"] % 60 == 0  # lineitem is in key order
        if not (np.array_equal(got["l_orderkey"][sel][o],
                               li["l_orderkey"][want])
                and np.array_equal(got["l_linenumber"][sel][o],
                                   li["l_linenumber"][want])
                and np.array_equal(got["s"][sel][o],
                                   li["l_quantity"][want])):
            raise AssertionError("agg_abandon: the sample differs")
        info["sample_groups"] = int(want.sum())
        ops = [op for op in info.pop("tasks")[0].operators
               if isinstance(op, AggregationOperator)
               and op.abandoned_at is not None]
        if len(ops) != 1:
            raise AssertionError("agg_abandon: the partial step never "
                                 "abandoned")
        rows, groups, batches = ops[0].abandoned_at
        info["abandoned_at"] = {"input_rows": rows, "groups": groups,
                                "batches": batches}
        info["passthrough_batches"] = ops[0].passthrough_batches

    ps = table_columns(conn, "partsupp", ["ps_partkey", "ps_suppkey",
                                          "ps_availqty"])
    pair = li["l_partkey"] * (1 << 20) + li["l_suppkey"]
    build = ps["ps_partkey"] * (1 << 20) + ps["ps_suppkey"]
    dyn_sel = np.isin(pair, build[ps["ps_availqty"] < 100])
    dyn_want = (["n", "s"], [(int(dyn_sel.sum()),
                              _psum(li["l_extendedprice"][dyn_sel]))])
    r_sel = li["l_returnflag"] == d["l_returnflag"].id_of("R")
    wide_want = (["n", "s"], [(int(r_sel.sum()),
                               _psum(li["l_extendedprice"][r_sel]))])

    def check_dyn(outs, info):
        _same_rows(_host_table(outs[0]), (["n", "s"], [(0, None)]), 0.0,
                   "dyn_filter, empty build")
        _same_rows(_host_table(outs[1]), dyn_want, 0.0, "dyn_filter")
        if any(type(op).__name__ == "HashJoinOperator"
               for op in info.pop("tasks")[0].operators):
            raise AssertionError("dyn_filter: the empty build ran a probe")

    def check_wide(outs, info):
        _same_rows(_host_table(outs[0]), wide_want, 0.0, "wide_join")

    checks = {"agg_moments": check_moments, "agg_sketches": check_sketches,
              "agg_percentile": check_percentile,
              "agg_min_by": check_min_by, "agg_abandon": check_abandon,
              "dyn_filter": check_dyn, "wide_join": check_wide}
    cache = DataCache.instance()
    by_path = {}
    for name, plans in AGG_PLANS.items():
        runs = {}
        for run in ("cold", "warm"):
            info = {"tasks": []}
            torch.cuda.reset_peak_memory_stats()
            wall, counts, outs, per_plan = 0.0, {}, [], []
            dyn = _dyn_filters()
            for i, make in enumerate(plans):
                if run == "cold" and i == 0:
                    cache.clear()
                hits, misses = cache.hits, cache.misses
                out, w, c = _run(make(), ctx, info["tasks"])
                outs.append(out)
                per_plan.append({"wall_s": w, "cache": [
                    cache.hits - hits, cache.misses - misses]})
                wall += w
                counts = {k: counts.get(k, 0) + v for k, v in c.items()}
            checks[name](outs, info)
            info.pop("tasks", None)
            del outs
            runs[run] = {"wall_s": wall, "plans": per_plan,
                         "launches": counts, "dyn_filters":
                             _dyn_filters() - dyn,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(), **info}
        cold, warm = runs["cold"], runs["warm"]
        if warm["launches"] != cold["launches"]:
            raise AssertionError(f"{name}: warm launches {warm['launches']}"
                                 f" != cold {cold['launches']}")
        got = cold["launches"]
        if not (got["radix_hist"] > 0
                and got["flat_gather"] + got["gather_rows"] > 0):
            raise AssertionError(f"{name}: B4 or B5 never launched: {got}")
        if name in AGG_CLASSIC and not got["radix_rank"] > 0:
            raise AssertionError(f"{name}: B2 never launched: {got}")
        if name == "dyn_filter":
            # every split the empty build's run reads misses cold and hits
            # warm: partsupp's, and no lineitem split
            for r, want in (("cold", [0, n_ps_splits]),
                            ("warm", [n_ps_splits, 0])):
                if runs[r]["plans"][0]["cache"] != want:
                    raise AssertionError(
                        f"dyn_filter, empty build, {r}: cache (hits, "
                        f"misses) {runs[r]['plans'][0]['cache']}, expected "
                        f"{want}: partsupp's splits only")
            if cold["dyn_filters"] != 1:
                raise AssertionError("dyn_filter: expected one dynamic "
                                     f"filter, got {cold['dyn_filters']}")
        by_path[name] = got
        extra = {k: v for k, v in cold.items()
                 if k not in ("wall_s", "launches", "max_memory_allocated",
                              "plans")}
        phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
              plans={r: v["plans"] for r, v in runs.items()},
              max_memory_allocated={r: v["max_memory_allocated"]
                                    for r, v in runs.items()},
              launches={k: v for k, v in got.items() if k != "filter_sum"},
              **extra)
    cache.clear()
    return by_path


# ---------------------------------------------------------------------------
# types: raw strings, TIMESTAMP and the datetime functions, DECIMAL(38) x
# short decimal, at SF10
# ---------------------------------------------------------------------------

NAME_PREFIX = b"Customer#"
TEXT_ALPHA = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", np.uint8)
TEXT_LEN = (10, 79)  # TPC-H's O_COMMENT is at most 79 characters
NAME_CUT = "Customer#000500000"
NY = "America/New_York"


def _arrow_strings(data: np.ndarray, offsets: np.ndarray):
    """A pyarrow string array over a uint8 data buffer and int32
    offsets."""
    import pyarrow as pa
    return pa.Array.from_buffers(pa.string(), len(offsets) - 1, [
        None, pa.py_buffer(offsets.astype(np.int32).tobytes()),
        pa.py_buffer(data.tobytes())])


def customer_names(keys: np.ndarray):
    """'Customer#%09d' % key for every key, as a pyarrow string array
    (18 bytes each), built with numpy."""
    n = len(keys)
    mat = np.empty((n, 18), np.uint8)
    mat[:, :9] = np.frombuffer(NAME_PREFIX, np.uint8)
    k = keys.astype(np.int64)
    for j in range(9):
        mat[:, 17 - j] = 48 + (k // 10 ** j) % 10
    return _arrow_strings(mat.reshape(-1), np.arange(n + 1) * 18)


def order_texts(n: int, rng):
    """Seeded ASCII text of lengths uniform in TEXT_LEN; a seeded 1% of
    rows start with 'special' and end with 'requests' (Q13's pattern).
    Returns (pyarrow array, lengths, the special rows)."""
    lens = rng.integers(TEXT_LEN[0], TEXT_LEN[1] + 1, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    data = TEXT_ALPHA[rng.integers(0, len(TEXT_ALPHA), int(offs[-1]),
                                   dtype=np.uint8)]
    special = np.flatnonzero(rng.random(n) < 0.01)
    special = special[lens[special] >= 16]
    for j, ch in enumerate(b"special"):
        data[offs[special] + j] = ch
    for j, ch in enumerate(b"requests"):
        data[offs[special + 1] - 8 + j] = ch
    return _arrow_strings(data, offs), lens, special


def _raw_rows(batches, name):
    """A raw string column's active rows as a host (rows, W) byte matrix
    and lengths (the widest size class of the batches)."""
    from velox_tpu_torch.vector import strings as VS
    mats, lens = [], []
    w = max(b.columns[name].data.shape[1] for b in batches)
    for b in batches:
        col = b.columns[name]
        if not VS.is_raw(col):
            raise AssertionError(f"{name}: not a raw string column")
        m = b.mask
        mats.append(VS.pad_width(col.data[m], w).cpu().numpy())
        lens.append(VS.lens_of(col)[m].cpu().numpy())
    return np.concatenate(mats), np.concatenate(lens)


def _name_keys(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The key of each 'Customer#%09d' row of a byte matrix."""
    if not ((lens == 18).all() and (mat[:, :9] == np.frombuffer(
            NAME_PREFIX, np.uint8)).all()):
        raise AssertionError("a customer name is malformed")
    digits = mat[:, 9:18].astype(np.int64) - 48
    return digits @ (10 ** np.arange(8, -1, -1, dtype=np.int64))


def _nondecreasing(mat: np.ndarray) -> bool:
    """Adjacent rows of a zero-padded byte matrix in byte order (no text
    holds a zero byte, so equal padded rows are equal strings)."""
    w = mat.view(">u8") if mat.shape[1] % 8 == 0 else mat
    a, b = w[:-1], w[1:]
    ne = a != b
    first = ne.argmax(axis=1)
    rows = np.arange(len(a))
    return bool((~ne.any(axis=1) | (a[rows, first] < b[rows, first])).all())


def _ny_offsets(lo_us: int, hi_us: int):
    """America/New_York's UTC offset (seconds) at every UTC hour from
    lo_us to hi_us, from Python's zoneinfo (the zone changes offset on
    whole UTC hours): (first hour, offsets)."""
    from zoneinfo import ZoneInfo
    h0, h1 = lo_us // 3_600_000_000, hi_us // 3_600_000_000 + 1
    tz = ZoneInfo(NY)
    epoch = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
    offs = np.array([int((epoch + datetime.timedelta(hours=int(h)))
                          .astimezone(tz).utcoffset().total_seconds())
                     for h in range(h0, h1 + 1)], np.int64)
    return h0, offs


def types_paths(conn, seed: int):
    """(the raw-string tables, the string paths' plans and oracle inputs)
    at the connector's scale: orders (o_orderkey, o_custkey, o_totalprice
    in cents) with the raw o_cust_name and o_text, and customer's c_name
    (raw) and c_nationkey."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_totalprice"])
    cu = table_columns(conn, "customer", ["c_custkey", "c_nationkey"])
    text, text_lens, special = order_texts(len(od["o_orderkey"]), rng)
    orders = pa.table({"o_orderkey": od["o_orderkey"],
                       "o_custkey": od["o_custkey"],
                       "price": od["o_totalprice"],
                       "o_cust_name": customer_names(od["o_custkey"]),
                       "o_text": text})
    customer = pa.table({"c_custkey": cu["c_custkey"],
                         "c_nationkey": cu["c_nationkey"],
                         "c_name": customer_names(cu["c_custkey"])})
    return od, cu, orders, customer, text_lens, special


RAW_ORDERS = {"o_cust_name": "raw", "o_text": "raw"}


def types_plans(orders, customer):
    """name -> plan of the types phase's string paths, in run order."""
    def vo():
        return PlanBuilder().values([orders], string_encoding=RAW_ORDERS)

    b = PlanBuilder()
    cust = b.new_builder().values([customer],
                                  string_encoding={"c_name": "raw"})
    join = (b.values([orders], string_encoding=RAW_ORDERS)
            .hash_join(["o_cust_name"], ["c_name"], cust,
                       output=["c_nationkey", "price"])
            .single_aggregation(["c_nationkey"], ["count(*) as n",
                                                  "sum(price) as s"])
            .plan())
    return {
        "raw_group": vo().single_aggregation(
            ["o_cust_name"], ["count(*) as n", "sum(price) as s"]).plan(),
        "raw_join": join,
        "raw_topn": vo().top_n(["o_text", "o_orderkey"], 1000).plan(),
        "raw_sort": vo().project(["o_text", "o_orderkey"])
        .order_by(["o_text"]).plan(),
        "raw_filter": vo().filter("o_text like '%special%requests%'")
        .project(["o_orderkey", "length(o_text) as ln",
                  "substr(o_text, 3, 10) as sb",
                  "strpos(o_text, 'ab') as sp",
                  "upper(o_text) as up", "trim(o_text) as tr",
                  "concat(o_cust_name, '/', o_text) as cc",
                  f"o_cust_name < '{NAME_CUT}' as lt"]).plan(),
        "raw_functions": vo().project([
            "length(o_text) as ln", "strpos(o_text, 'ab') as sp",
            "length(trim(o_text)) as lt",
            "length(upper(substr(o_text, 5))) as lu",
            f"o_cust_name < '{NAME_CUT}' as cut"])
        .single_aggregation([], ["sum(ln) as ln", "sum(sp) as sp",
                                 "sum(lt) as lt", "sum(lu) as lu",
                                 "count_if(cut) as cut"]).plan(),
    }


def datetime_plans():
    """name -> plan of the types phase's datetime and decimal paths over
    the lineitem scan."""
    li = PlanBuilder().table_scan
    ts = ("date_add('second', l_orderkey % 86400, "
          "cast(l_shipdate as timestamp))")
    return {
        "dt_month": li("lineitem", ["l_shipdate", "l_receiptdate"])
        .project(["date_trunc('month', l_shipdate) as m",
                  "date_diff('day', l_shipdate, l_receiptdate) as dd"])
        .single_aggregation(["m"], ["count(*) as n", "sum(dd) as dd"])
        .plan(),
        "dt_week_hour": li("lineitem", ["l_orderkey", "l_shipdate"])
        .project([f"{ts} as ts"])
        .project(["week(ts) as w", "hour(ts) as h", "ts",
                  "to_unixtime(ts) as u"])
        .single_aggregation(["w", "h"], [
            "count(*) as n", "min(ts) as lo", "max(ts) as hi",
            "sum(u) as u"]).plan(),
        "dt_zone": li("lineitem", ["l_orderkey", "l_shipdate"])
        .project([f"{ts} as ts"])
        .project([f"timezone_hour(ts, '{NY}') as th",
                  f"hour(at_timezone(ts, '{NY}')) as lh"])
        .single_aggregation([], ["sum(th) as th", "sum(lh) as lh"])
        .plan(),
        "decimal_mul": li("lineitem", ["l_returnflag", "l_linestatus",
                                       "l_extendedprice", "l_quantity"])
        .project(["l_returnflag", "l_linestatus",
                  "cast(l_extendedprice as decimal(38,2)) * l_quantity "
                  "as pq"])
        .single_aggregation(["l_returnflag", "l_linestatus"],
                            ["sum(pq) as s"])
        .project(["l_returnflag", "l_linestatus", "s", "s * 3 as s3"])
        .plan(),
    }


@functools.lru_cache(maxsize=1)
def _types_tables(seed: int = 0):
    """The raw-string tables of the registered "tpch" connector (for the
    profile tool's plans)."""
    from velox_tpu_torch.connectors.connector import get_connector
    _, _, orders, customer, _, _ = types_paths(get_connector("tpch"), seed)
    return orders, customer


TYPES_STRING_PATHS = ("raw_group", "raw_join", "raw_topn", "raw_sort",
                      "raw_filter", "raw_functions")
PATH_PLANS.update({n: (lambda n=n: types_plans(*_types_tables())[n])
                   for n in TYPES_STRING_PATHS})
PATH_PLANS.update({n: (lambda n=n: datetime_plans()[n])
                   for n in ("dt_month", "dt_week_hour", "dt_zone",
                             "decimal_mul")})


def types_phase(conn, ctx, li, seed: int) -> dict:
    """The types paths at the connector's scale, each cold and warm with
    equal launches, exact against numpy and pyarrow oracles (doubles
    within 1e-9 relative): raw-string group-by, join, TopN and full sort
    keys, a filter and projection of every string function family, the
    datetime functions over the lineitem scan and DECIMAL(38) x short
    decimal. Each line: walls, peak device memory, launches, and the rows
    sent to the host by upper/lower/trim (non-ASCII rows; 0 here)."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from velox_tpu_torch.vector import strings as VS
    t0 = time.perf_counter()
    od, cu, orders, customer, text_lens, special = types_paths(conn, seed)
    seconds = time.perf_counter() - t0
    # one Values ingest of the orders table: the host pass into pinned
    # memory, the uploads and the device pack (every orders path below
    # pays it on its cold run; its warm run takes the batch from the
    # Values ingest cache)
    from velox_tpu_torch.vector.device import from_arrow
    ingest = {}
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        batch = from_arrow(orders, string_encoding=RAW_ORDERS,
                           device=ctx.device)
        torch.cuda.synchronize()
        ingest[run] = time.perf_counter() - t1
        nbytes = batch.nbytes
        del batch
    phase("types_tables", orders=orders.num_rows,
          customers=customer.num_rows,
          raw_bytes_on_card=orders.num_rows * (32 + 128)
          + customer.num_rows * 32, orders_batch_bytes=nbytes,
          ingest_s=ingest, seconds=seconds)
    t0 = time.perf_counter()
    # per-key and per-nation price sums stay far below 2^53: exact in
    # bincount's float64
    keys, price = od["o_custkey"], od["o_totalprice"]
    counts = np.bincount(keys)
    ukeys = np.flatnonzero(counts)
    group_price = np.bincount(keys, weights=price)[ukeys].astype(np.int64)
    counts = counts[ukeys]
    nation = np.zeros(cu["c_custkey"].max() + 1, np.int64)
    nation[cu["c_custkey"]] = cu["c_nationkey"]
    on = nation[keys]
    join_n = np.bincount(on, minlength=25)
    join_s = np.bincount(on, weights=price, minlength=25).astype(np.int64)
    text_col = orders.column("o_text")
    like = pc.match_like(text_col, "%special%requests%").to_numpy(
        zero_copy_only=False)
    sel = np.flatnonzero(like)
    sub = orders.take(pa.array(sel))
    stx, sname = sub.column("o_text"), sub.column("o_cust_name")
    filt_want = {
        "o_orderkey": sub.column("o_orderkey").to_pylist(),
        "ln": pc.utf8_length(stx).to_pylist(),
        "sb": pc.utf8_slice_codeunits(stx, 2, 12).to_pylist(),
        "sp": [x + 1 for x in pc.find_substring(stx, "ab").to_pylist()],
        "up": pc.utf8_upper(stx).to_pylist(),
        "tr": pc.utf8_trim_whitespace(stx).to_pylist(),
        "cc": pc.binary_join_element_wise(sname, stx, "/").to_pylist(),
        "lt": pc.less(sname, NAME_CUT).to_pylist(),
    }
    fn_want = {
        "ln": int(text_lens.sum()),
        "sp": int(pc.sum(pc.add(pc.find_substring(text_col, "ab"), 1))
                  .as_py()),
        "lt": int(pc.sum(pc.utf8_length(pc.utf8_trim_whitespace(
            text_col))).as_py()),
        "lu": int(np.maximum(text_lens - 4, 0).sum()),
        "cut": int(pc.sum(pc.less(orders.column("o_cust_name"),
                                  NAME_CUT)).as_py()),
    }
    topn_idx = pc.select_k_unstable(
        orders.select(["o_text", "o_orderkey"]), 1000,
        [("o_text", "ascending"), ("o_orderkey", "ascending")])
    topn_keys = orders.column("o_orderkey").take(topn_idx).to_numpy()
    # datetime and decimal oracles over the same generated lineitem
    extra = _li_extra(conn, ["l_receiptdate"])
    ship, rcpt = li["l_shipdate"], extra["l_receiptdate"]
    month = ship.astype("datetime64[D]").astype("datetime64[M]") \
        .astype(np.int64)
    mi = month - month.min()
    n_m = np.bincount(mi)
    used = np.flatnonzero(n_m)
    first_days = (used + month.min()).astype("datetime64[M]") \
        .astype("datetime64[D]").astype(np.int64)
    dt_month = {"m": first_days, "n": n_m[used],
                "dd": np.bincount(mi, weights=rcpt - ship)[used]
                .astype(np.int64)}
    ts_us = ship * 86_400_000_000 + (li["l_orderkey"] % 86400) * 1_000_000
    days = ts_us // 86_400_000_000
    thu = days - (days + 3) % 7 + 3
    year = thu.astype("datetime64[D]").astype("datetime64[Y]")
    jan1 = year.astype("datetime64[D]").astype(np.int64)
    week = (thu - jan1) // 7 + 1
    hour = (ts_us // 3_600_000_000) % 24
    agg = pa.table({"w": week, "h": hour, "ts": ts_us,
                    "u": ts_us / 1e6}).group_by(["w", "h"]).aggregate(
        [("ts", "count"), ("ts", "min"), ("ts", "max"), ("u", "sum")])
    h0, ny = _ny_offsets(int(ts_us.min()), int(ts_us.max()))
    off = ny[ts_us // 3_600_000_000 - h0]
    local = ts_us + off * 1_000_000
    zone_want = (int(_psum(np.where(off < 0, -(np.abs(off) // 3600),
                                    off // 3600))),
                 int(_psum((local // 3_600_000_000) % 24)))
    fs = li["l_returnflag"] * 8 + li["l_linestatus"]
    prod = li["l_extendedprice"] * li["l_quantity"]
    dec_want = {(int(g) // 8, int(g) % 8): _psum(prod[fs == g])
                for g in np.flatnonzero(np.bincount(fs))}
    phase("types_oracles", seconds=time.perf_counter() - t0,
          groups=len(ukeys), filtered=len(sel), special_rows=len(special))

    def check_group(outs, info):
        mat, lens = _raw_rows(outs, "o_cust_name")
        got = _host_arrays(outs, ["n", "s"])
        k = _name_keys(mat, lens)
        o = np.argsort(k)
        if not (np.array_equal(k[o], ukeys)
                and np.array_equal(got["n"][o], counts)
                and np.array_equal(got["s"][o], group_price)):
            raise AssertionError("raw_group differs from numpy")
        info["groups"] = len(k)

    def check_join(outs, info):
        got = _host_arrays(outs, ["c_nationkey", "n", "s"])
        o = np.argsort(got["c_nationkey"])
        want = np.flatnonzero(join_n)
        if not (np.array_equal(got["c_nationkey"][o], want)
                and np.array_equal(got["n"][o], join_n[want])
                and [int(x) for x in got["s"][o]]
                == [int(join_s[k]) for k in want]):
            raise AssertionError("raw_join differs from numpy")

    def check_topn(outs, info):
        got = _host_arrays(outs, ["o_orderkey"])["o_orderkey"]
        mat, lens = _raw_rows(outs, "o_text")
        if not np.array_equal(got, topn_keys):
            raise AssertionError("raw_topn differs from pyarrow")
        pos = np.searchsorted(od["o_orderkey"], got)
        want = VS.pack_arrow(text_col.take(pa.array(pos)), len(got),
                             mat.shape[1])
        if not (np.array_equal(mat, want[0]) and np.array_equal(lens,
                                                                want[1])):
            raise AssertionError("raw_topn: the texts differ")

    def check_sort(outs, info):
        mat, lens = _raw_rows(outs, "o_text")
        keys_out = _host_arrays(outs, ["o_orderkey"])["o_orderkey"]
        if not (len(keys_out) == len(od["o_orderkey"])
                and np.array_equal(np.sort(keys_out),
                                   np.sort(od["o_orderkey"]))):
            raise AssertionError("raw_sort: not a permutation")
        if not _nondecreasing(mat):
            raise AssertionError("raw_sort: not in byte order")
        # every row's length, and a seeded sample's bytes, are its key's
        pos = np.searchsorted(od["o_orderkey"], keys_out)
        if not np.array_equal(lens, text_lens[pos]):
            raise AssertionError("raw_sort: lengths moved apart from keys")
        sample = np.random.default_rng(seed).choice(len(pos), 100_000)
        want = VS.pack_arrow(text_col.take(pa.array(pos[sample])),
                             len(sample), mat.shape[1])
        if not np.array_equal(mat[sample], want[0]):
            raise AssertionError("raw_sort: rows moved apart from keys")
        info["sampled_rows"] = len(sample)

    def check_filter(outs, info):
        got = {}
        for name in filt_want:
            col = outs[0].columns[name]
            if VS.is_raw(col):
                mat, lens = _raw_rows(outs, name)
                got[name] = VS.unpack_numpy(mat, lens)
            else:
                got[name] = [x.item() if hasattr(x, "item") else x
                             for x in _host_arrays(outs, [name])[name]]
        o = np.argsort(got["o_orderkey"])
        for name, want in filt_want.items():
            g = [got[name][i] for i in o]
            if g != want:
                raise AssertionError(f"raw_filter {name} differs")
        info["rows"] = len(o)

    def check_functions(outs, info):
        got = _host_arrays(outs, list(fn_want))
        for name, want in fn_want.items():
            if int(got[name][0]) != want:
                raise AssertionError(f"raw_functions {name}: "
                                     f"{got[name][0]} != {want}")

    def check_month(outs, info):
        got = _host_arrays(outs, ["m", "n", "dd"])
        o = np.argsort(got["m"])
        if not (np.array_equal(got["m"][o], dt_month["m"])
                and np.array_equal(got["n"][o], dt_month["n"])
                and np.array_equal(got["dd"][o], dt_month["dd"])):
            raise AssertionError("dt_month differs from numpy")
        info["groups"] = len(o)

    def check_week_hour(outs, info):
        got = _host_arrays(outs, ["w", "h", "n", "lo", "hi", "u"])
        want = {tuple(r[:2]): r[2:] for r in zip(
            *(agg.column(c).to_numpy() for c in
              ("w", "h", "ts_count", "ts_min", "ts_max", "u_sum")))}
        if len(got["w"]) != len(want):
            raise AssertionError("dt_week_hour: group count differs")
        worst = 0.0
        for w_, h_, n_, lo, hi, u in zip(*got.values()):
            wn, wlo, whi, wu = want[(int(w_), int(h_))]
            if (n_, lo, hi) != (wn, wlo, whi):
                raise AssertionError(f"dt_week_hour ({w_}, {h_}) differs")
            worst = max(worst, abs(u - wu) / abs(wu))
        if worst > 1e-9:
            raise AssertionError(f"dt_week_hour: sum(u) off by {worst}")
        info["groups"], info["max_rel_err"] = len(want), worst

    def check_zone(outs, info):
        got = _host_arrays(outs, ["th", "lh"])
        if (int(got["th"][0]), int(got["lh"][0])) != zone_want:
            raise AssertionError(f"dt_zone: {got} != {zone_want}")

    def check_decimal(outs, info):
        got = _host_rows(outs, ["l_returnflag", "l_linestatus", "s", "s3"])
        gd = conn.gen.dictionaries("lineitem")
        seen = {}
        for f, st, s_, s3 in zip(*got.values()):
            k = (gd["l_returnflag"].id_of(f), gd["l_linestatus"].id_of(st))
            seen[k] = (s_, s3)
        want = {k: (v, 3 * v) for k, v in dec_want.items()}
        if seen != want:
            raise AssertionError(f"decimal_mul: {seen} != {want}")
        info["groups"] = len(seen)

    def host_case_rows_now():
        return M.reporter().snapshot()["counters"].get(VS.K_HOST_ROWS, 0)

    checks = {"raw_group": check_group, "raw_join": check_join,
              "raw_topn": check_topn, "raw_sort": check_sort,
              "raw_filter": check_filter,
              "raw_functions": check_functions, "dt_month": check_month,
              "dt_week_hour": check_week_hour, "dt_zone": check_zone,
              "decimal_mul": check_decimal}
    plans = dict(types_plans(orders, customer))
    plans.update(datetime_plans())
    cache = DataCache.instance()
    ingest = IngestCache.instance()
    by_path = {}
    for name, plan in plans.items():
        runs = {}
        for run in ("cold", "warm"):
            if run == "cold":
                cache.clear()
                ingest.clear()
            info = {}
            torch.cuda.reset_peak_memory_stats()
            host0 = host_case_rows_now()
            out, wall, launched = _run(plan, ctx)
            checks[name](out, info)
            del out
            runs[run] = {"wall_s": wall, "launches": launched,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(),
                         "host_case_rows": host_case_rows_now() - host0,
                         **info}
        cold, warm = runs["cold"], runs["warm"]
        if warm["launches"] != cold["launches"]:
            raise AssertionError(f"{name}: warm launches {warm['launches']}"
                                 f" != cold {cold['launches']}")
        got = cold["launches"]
        if name.startswith("raw_") and name not in ("raw_filter",
                                                    "raw_functions"):
            if not (got["radix_hist"] > 0 and got["radix_rank"] > 0
                    and got["flat_gather"] + got["gather_rows"] > 0):
                raise AssertionError(f"{name}: B2, B4 or B5 never "
                                     f"launched: {got}")
        by_path[name] = got
        extra = {k: v for k, v in cold.items()
                 if k not in ("wall_s", "launches", "max_memory_allocated")}
        phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
              max_memory_allocated={r: v["max_memory_allocated"]
                                    for r, v in runs.items()},
              launches={k: v for k, v in got.items() if k != "filter_sum"},
              **extra)
    cache.clear()
    by_path["ingest_cache"] = ingest_cache_path(
        plans["raw_group"], lambda out: check_group(out, {}), ctx)
    return by_path


def ingest_cache_path(plan, check, ctx) -> dict:
    """The Values ingest cache over the types phase's raw_group: the
    first run ingests and caches the orders batch, reserved in the device
    root; the second takes it from the cache (one K_VALUES_INGEST_HITS);
    a capped pool's reserve makes the arbitrator evict it and the root
    gets its bytes back; under a root cap below the batch's bytes a run
    ingests and caches nothing. Every run exact; returns the first run's
    launches."""
    ingest = IngestCache.instance()
    root = MemoryPool.device_root()
    DataCache.instance().clear()
    ingest.clear()
    base = root.used
    runs = {}

    def one(run):
        hits = spill_metrics()["ingest_hits"]
        torch.cuda.reset_peak_memory_stats()
        out, wall, launched = _run(plan, ctx)
        check(out)
        del out
        runs[run] = {"wall_s": wall, "launches": launched,
                     "ingest_hits": spill_metrics()["ingest_hits"] - hits,
                     "max_memory_allocated":
                         torch.cuda.max_memory_allocated(),
                     "cached_bytes": ingest.used,
                     "root_used_above_base": root.used - base}

    one("ingest")
    one("cached")
    cached = ingest.used
    if not (cached > 0 and root.used - base == cached
            and runs["ingest"]["ingest_hits"] == 0
            and runs["cached"]["ingest_hits"] == 1):
        raise AssertionError(f"ingest cache: {runs}")
    if runs["cached"]["launches"] != runs["ingest"]["launches"]:
        raise AssertionError("ingest cache: the cached run launched "
                             "differently")
    # a query pool's reserve over a capped root: the arbitrator evicts it
    pool = MemoryPool("capped", parent=root)
    try:
        MemoryPool.set_device_cap(root.used)
        if not pool.reserve_or_reclaim(1):
            raise AssertionError("ingest cache: nothing was reclaimed")
    finally:
        MemoryPool.set_device_cap(None)
        pool.release(pool.used)
    if ingest.stats()["entries"] or root.used != base:
        raise AssertionError("ingest cache: the reclaimed entry kept its "
                             "bytes")
    try:
        MemoryPool.set_device_cap(base + cached - 1)
        one("capped_root")
        one("capped_root_again")
    finally:
        MemoryPool.set_device_cap(None)
    if (ingest.stats()["entries"], root.used,
            runs["capped_root_again"]["ingest_hits"]) != (0, base, 0):
        raise AssertionError("ingest cache: an entry was kept over the "
                             "root's cap")
    phase("ingest_cache", entry_bytes=cached,
          **{k: {r: v[k] for r, v in runs.items()}
             for k in runs["ingest"] if k != "launches"},
          launches={k: v for k, v in runs["ingest"]["launches"].items()
                    if v})
    return runs["ingest"]["launches"]


# ---------------------------------------------------------------------------
# complex: ARRAY/MAP columns, the array and map functions, Unnest, the
# ARRAY/MAP aggregates and map_union, at the connector's scale
# ---------------------------------------------------------------------------

CX_PRIORITY_ITEMS = 3_000_000  # bloom sizing: ~8 bits an item, 2^23 bits
CX_FOLD = ["cardinality(p) as n", "element_at(p, 1) as f",
           "element_at(p, -1) as l", "array_max(p) as mx",
           "element_at(array_sort(p), 1) as so",
           "cardinality(array_distinct(s)) as ds",
           "reduce(transform(p, x -> x % 7), 0, (a, x) -> a + x, a -> a) "
           "as r",
           "cardinality(filter(p, x -> x > 1000000)) as fc",
           "any_match(p, x -> x < 100) as am"]
CX_FOLD_SUMS = ["sum(n) as n", "sum(f) as f", "sum(l) as l", "sum(mx) as mx",
                "sum(so) as so", "sum(ds) as ds", "sum(r) as r",
                "sum(fc) as fc", "count_if(am) as am", "count(*) as rows"]
CX_MAPS_AGGS = ["histogram(l_shipmode) as h", "set_agg(l_returnflag) as rf",
                "map_agg(l_linenumber, l_partkey) as m",
                "multimap_agg(l_returnflag, l_linenumber) as mm",
                "approx_most_frequent(2, l_shipmode, 16) as f"]
CX_MAPS_FOLD = [
    "cardinality(h) as hn", "cardinality(map_keys(h)) as hk",
    "reduce(map_values(h), 0, (a, x) -> a + x, a -> a) as hv",
    "reduce(map_values(transform_values(h, (k, v) -> v * 2)), 0, "
    "(a, x) -> a + x, a -> a) as tv",
    "cardinality(map_filter(h, (k, v) -> v > 80)) as mf",
    "cardinality(rf) as rfn", "cardinality(m) as mn",
    "reduce(map_values(m), 0, (a, x) -> a + x, a -> a) as mv",
    "cardinality(mm) as mmn",
    "cardinality(flatten(map_values(mm))) as mmv",
    "cardinality(f) as fn",
    "reduce(map_values(f), 0, (a, x) -> a + x, a -> a) as fv"]


def _order_arrays():
    """lineitem folded into one row an order: l_partkey's and
    l_suppkey's arrays, in scan order."""
    return (PlanBuilder().table_scan("lineitem", ["l_orderkey", "l_partkey",
                                                  "l_suppkey"])
            .single_aggregation(["l_orderkey"],
                                ["array_agg(l_partkey) as p",
                                 "array_agg(l_suppkey) as s"]))


def complex_plans():
    """name -> plan of the complex phase's paths, in run order (cx_maps
    has a second plan, cx_map_union)."""
    unnest = (PlanBuilder().table_scan("lineitem", ["l_orderkey",
                                                    "l_partkey"])
              .single_aggregation(["l_orderkey"],
                                  ["array_agg(l_partkey) as p"])
              .unnest("p", element_name="e", ordinality="o")
              .single_aggregation([], ["count(*) as n", "sum(e) as s",
                                       "sum(e * o) as w", "max(o) as m"]))
    b = _order_arrays()
    orders = b.new_builder().table_scan(
        "orders", ["o_orderkey", "o_custkey", "o_totalprice",
                   "o_orderdate"]).filter("o_orderdate < date '1995-03-15'")
    joined = b.hash_join(["l_orderkey"], ["o_orderkey"], orders,
                         output=["l_orderkey", "p", "o_custkey",
                                 "o_totalprice"])
    b2 = _order_arrays()
    orders2 = b2.new_builder().table_scan(
        "orders", ["o_orderkey", "o_custkey", "o_totalprice",
                   "o_orderdate"]).filter("o_orderdate < date '1995-03-15'")
    top = (b2.hash_join(["l_orderkey"], ["o_orderkey"], orders2,
                        output=["l_orderkey", "p", "o_totalprice"])
           .top_n(["o_totalprice DESC", "l_orderkey"], 100))
    prios = [f"bloom_filter_agg(o_orderkey, {CX_PRIORITY_ITEMS}) filter "
             f"(where o_orderpriority = '{p}') as b{i}"
             for i, p in enumerate(CX_PRIORITIES)]
    li_maps = PlanBuilder().table_scan(
        "lineitem", ["l_suppkey", "l_shipmode", "l_returnflag",
                     "l_linenumber", "l_partkey"])
    return {
        "cx_array_agg": _order_arrays().project(CX_FOLD)
        .single_aggregation([], CX_FOLD_SUMS).plan(),
        "cx_unnest": unnest.plan(),
        "cx_maps": li_maps.single_aggregation(["l_suppkey"], CX_MAPS_AGGS)
        .project(CX_MAPS_FOLD)
        .single_aggregation([], [f"sum({c}) as {c}" for c in (
            "hn", "hk", "hv", "tv", "mf", "rfn", "mn", "mv", "mmn", "mmv",
            "fn", "fv")]).plan(),
        "cx_map_union": PlanBuilder().table_scan(
            "lineitem", ["l_suppkey", "l_shipmode"])
        .single_aggregation(["l_suppkey"], ["histogram(l_shipmode) as h"])
        .single_aggregation([], ["map_union(h) as u"]).plan(),
        "cx_join": joined.project([
            "cardinality(p) as n", "element_at(p, 1) as f",
            "contains(p, o_custkey) as c"])
        .single_aggregation([], ["count(*) as rows", "sum(n) as n",
                                 "sum(f) as f", "count_if(c) as c"]).plan(),
        "cx_join_topn": top.plan(),
        "cx_bloom": PlanBuilder().table_scan(
            "orders", ["o_orderkey", "o_orderpriority"])
        .single_aggregation([], prios).plan(),
    }


CX_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                 "5-LOW")
PATH_PLANS.update({n: (lambda n=n: complex_plans()[n])
                   for n in ("cx_array_agg", "cx_unnest", "cx_maps",
                             "cx_map_union", "cx_join", "cx_join_topn",
                             "cx_bloom")})


def _runs_of(keys: np.ndarray):
    """(first row of each run, run lengths) of a grouped key array."""
    first = np.flatnonzero(np.diff(keys, prepend=keys[0] - 1))
    return first, np.diff(np.append(first, len(keys)))


def _np_bloom(keys: np.ndarray, m: int, k: int = 3) -> np.ndarray:
    """exec/hashtable.py ``bloom_hashes`` and the aggregate's packing in
    numpy: int32 words, bit j of word w set for bit 32 w + j."""
    h1 = _np_hash(keys, torch.int64)
    m32 = np.uint64(0xFFFFFFFF)
    h = h1 ^ np.uint64(0xB5297A4D)
    h = ((h ^ (h >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & m32
    h = ((h ^ (h >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & m32
    h2 = h ^ (h >> np.uint64(16))
    bits = np.zeros(m, np.uint8)
    for i in range(k):
        bits[((h1 + np.uint64(i) * h2) & np.uint64(m - 1)).astype(
            np.int64)] = 1
    words = np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1)
    words = words.view(">u4").reshape(-1).astype(np.int64)
    return ((words ^ (1 << 31)) - (1 << 31)).astype(np.int32)


def complex_oracles(conn, li) -> dict:
    """Every complex path's expected values, from the generator's
    columns (lineitem in order-key order, an order's lines in line-number
    order)."""
    ok, pk, sk = li["l_orderkey"], li["l_partkey"], li["l_suppkey"]
    ln, rf = li["l_linenumber"], li["l_returnflag"]
    sm = _li_extra(conn, ["l_shipmode"])["l_shipmode"]
    first, lens = _runs_of(ok)
    last = first + lens - 1
    order_of = np.repeat(np.arange(len(first)), lens)
    mx = np.maximum.reduceat(pk, first)
    mn = np.minimum.reduceat(pk, first)
    # distinct suppliers an order: its (at most 7) suppkeys sorted in a row
    supp = np.full((len(first), 7), -1, np.int64)
    supp[order_of, np.arange(len(pk)) - np.repeat(first, lens)] = sk
    supp.sort(axis=1)
    ds = int(((supp[:, 1:] != supp[:, :-1]) & (supp[:, 1:] >= 0)).sum()
             + (supp[:, 0] >= 0).sum())
    small = np.bincount(order_of[pk < 100], minlength=len(first)) > 0
    fold = {"n": len(pk), "f": _psum(pk[first]), "l": _psum(pk[last]),
            "mx": _psum(mx), "so": _psum(mn), "ds": ds,
            "r": _psum(pk % 7), "fc": int((pk > 1_000_000).sum()),
            "am": int(small.sum()), "rows": len(first)}
    unnest = {"n": len(pk), "s": _psum(pk), "w": _psum(pk * ln), "m": 7}
    # per supplier
    n_sm = int(sm.max()) + 1
    hist = np.bincount(sk * n_sm + sm, minlength=(int(sk.max()) + 1)
                       * n_sm).reshape(-1, n_sm)
    hist = hist[np.flatnonzero(hist.sum(1))]  # the suppliers, in key order
    n_rf = int(rf.max()) + 1
    supp_rf = int((np.bincount(sk * n_rf + rf) > 0).sum())
    # map_agg keeps the first row (in scan order) of each (supplier, line)
    _, first_ln = np.unique(sk * 8 + ln, return_index=True)
    top2 = -np.sort(-hist, axis=1)[:, :2]
    maps = {"hn": int((hist > 0).sum()), "hk": int((hist > 0).sum()),
            "hv": len(sk), "tv": 2 * len(sk), "mf": int((hist > 80).sum()),
            "rfn": supp_rf, "mn": len(first_ln), "mv": _psum(pk[first_ln]),
            "mmn": supp_rf, "mmv": len(sk),
            "fn": int((top2 > 0).sum()), "fv": _psum(top2)}
    # map_union: the first supplier (by key) holding each ship mode
    supp = np.unique(sk)
    union = {}
    for mode in range(n_sm):
        i = int(np.flatnonzero(hist[:, mode])[0])
        union[mode] = (int(supp[i]), int(hist[i, mode]))
    # orders joined on o_orderdate < 1995-03-15
    od = table_columns(conn, "orders", ["o_orderkey", "o_custkey",
                                        "o_totalprice", "o_orderdate",
                                        "o_orderpriority"])
    sel = od["o_orderdate"] < _day("1995-03-15")
    keys = od["o_orderkey"]
    cust = np.zeros(int(keys.max()) + 1, np.int64)
    cust[keys] = od["o_custkey"]
    live = np.zeros(int(keys.max()) + 1, bool)
    live[keys[sel]] = True
    o_first = ok[first]
    hit = np.bincount(order_of[pk == cust[ok]], minlength=len(first)) > 0
    js = live[o_first]
    join = {"rows": int(js.sum()), "n": int(lens[js].sum()),
            "f": _psum(pk[first][js]), "c": int((hit & js).sum())}
    price = od["o_totalprice"][sel]
    topk = np.lexsort([keys[sel], -price])[:100]
    top_keys = keys[sel][topk]
    row_of = np.searchsorted(o_first, top_keys)
    top_arrays = [pk[first[r]:first[r] + lens[r]].tolist() for r in row_of]
    prio = od["o_orderpriority"]
    pd_ = conn.gen.dictionaries("orders")["o_orderpriority"]
    # the aggregate's size from its item count: 8 bits an item, rounded
    # up to a power of two in [2^10, 2^23]
    m = max(1 << 10, min(1 << 23, 1 << (8 * CX_PRIORITY_ITEMS
                                         - 1).bit_length()))
    bloom = [_np_bloom(keys[prio == pd_.id_of(p)], m)
             for p in CX_PRIORITIES]
    modes = conn.gen.dictionaries("lineitem")["l_shipmode"]
    return {"fold": fold, "unnest": unnest, "maps": maps, "union": union,
            "modes": modes, "join": join, "top_keys": top_keys,
            "top_arrays": top_arrays, "bloom": bloom}


def _one_row(outs) -> dict:
    rows = [r for b in outs for r in to_arrow(b).to_pylist()]
    if len(rows) != 1:
        raise AssertionError(f"expected one row, got {len(rows)}")
    return rows[0]


def complex_phase(conn, ctx, li) -> dict:
    """The complex paths at the connector's scale, each cold (the scan
    cache cleared) and warm with equal launches, exact against numpy
    oracles over the generator's columns (integers only). Each line:
    walls, peak device memory and launches."""
    t0 = time.perf_counter()
    want = complex_oracles(conn, li)
    phase("complex_oracles", seconds=time.perf_counter() - t0,
          orders=want["fold"]["rows"], lineitems=want["fold"]["n"])

    def check_fold(outs, info):
        got = _one_row(outs)
        if got != want["fold"]:
            raise AssertionError(f"cx_array_agg: {got} != {want['fold']}")
        info["orders"] = got["rows"]

    def check_unnest(outs, info):
        got = _one_row(outs)
        if got != want["unnest"]:
            raise AssertionError(f"cx_unnest: {got} != {want['unnest']}")
        info["elements"] = got["n"]

    def check_maps(outs, info):
        got = _one_row(outs)
        if got != want["maps"]:
            raise AssertionError(f"cx_maps: {got} != {want['maps']}")

    def check_union(outs, info):
        got = dict(_one_row(outs)["u"])
        modes = want["modes"]
        exp = {modes.values[m]: c for m, (_, c) in want["union"].items()}
        if got != exp:
            raise AssertionError(f"cx_map_union: {got} != {exp}")
        info["keys"] = len(got)

    def check_join(outs, info):
        got = _one_row(outs)
        if got != want["join"]:
            raise AssertionError(f"cx_join: {got} != {want['join']}")
        info["rows"] = got["rows"]

    def check_topn(outs, info):
        rows = [r for b in outs for r in to_arrow(b).to_pylist()]
        keys = [r["l_orderkey"] for r in rows]
        if keys != want["top_keys"].tolist():
            raise AssertionError("cx_join_topn: the order keys differ")
        if [r["p"] for r in rows] != want["top_arrays"]:
            raise AssertionError("cx_join_topn: the arrays differ")
        info["rows"] = len(rows)

    def check_bloom(outs, info):
        got = _one_row(outs)
        for i, w in enumerate(want["bloom"]):
            if not np.array_equal(np.asarray(got[f"b{i}"], np.int32), w):
                raise AssertionError(f"cx_bloom: sketch {i} differs")
        info["bits_set"] = [int(np.unpackbits(w.view(np.uint8)).sum())
                            for w in want["bloom"]]

    checks = {"cx_array_agg": check_fold, "cx_unnest": check_unnest,
              "cx_maps": check_maps, "cx_map_union": check_union,
              "cx_join": check_join, "cx_join_topn": check_topn,
              "cx_bloom": check_bloom}
    cache = DataCache.instance()
    by_path = {}
    for name, plan in complex_plans().items():
        runs = {}
        for run in ("cold", "warm"):
            if run == "cold":
                cache.clear()
            info = {}
            torch.cuda.reset_peak_memory_stats()
            out, wall, launched = _run(plan, ctx)
            checks[name](out, info)
            del out
            runs[run] = {"wall_s": wall, "launches": launched,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(), **info}
        cold, warm = runs["cold"], runs["warm"]
        if warm["launches"] != cold["launches"]:
            raise AssertionError(f"{name}: warm launches {warm['launches']}"
                                 f" != cold {cold['launches']}")
        got = cold["launches"]
        if name == "cx_array_agg" and not (
                got["radix_hist"] > 0
                and got["radix_rank"] + got["radix_pos"] > 0):
            raise AssertionError(f"{name}: B4 or B2/B3 never launched: "
                                 f"{got}")
        if name in ("cx_unnest", "cx_join") \
                and got["flat_gather"] + got["gather_rows"] == 0:
            raise AssertionError(f"{name}: B5 never launched: {got}")
        by_path[name] = got
        extra = {k: v for k, v in cold.items()
                 if k not in ("wall_s", "launches", "max_memory_allocated")}
        phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
              max_memory_allocated={r: v["max_memory_allocated"]
                                    for r, v in runs.items()},
              launches={k: v for k, v in got.items() if k != "filter_sum"},
              **extra)
    cache.clear()
    return by_path


# ---------------------------------------------------------------------------
# spark: Spark's shuffle partitioning, its runtime bloom filter, the string
# functions and a remote function at the connector's scale, each held to an
# oracle written here (numpy, re, hashlib, str), none of it port code
# ---------------------------------------------------------------------------

SP_PARTITIONS = 200
SP_BLOOM_ITEMS = 3_000_000
SP_BLOOM_CUTOFF = "1993-01-01"
SP_REMOTE = "spark_remote_affine"
SP_PATHS = ("spark_shuffle_hash", "spark_runtime_filter", "spark_strings",
            "spark_remote")
_M32 = 0xFFFFFFFF
_XP = [np.uint64(c) for c in (0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F,
                              0x165667B19E3779F9, 0x85EBCA77C2B2AE63,
                              0x27D4EB2F165667C5)]


class TimedLoopback:
    """The remote function's server: the port's LoopbackTransport, its
    send() (the host round trip: framing, the served function, the reply)
    timed and counted."""

    def __init__(self):
        from velox_tpu_torch.functions.remote import LoopbackTransport
        self.inner = LoopbackTransport()
        self.inner.serve(SP_REMOTE, lambda a, valid: (a * 3 + 1, valid))
        self.seconds = 0.0
        self.calls = 0

    def send(self, fn_name: str, payload: bytes) -> bytes:
        t0 = time.perf_counter()
        out = self.inner.send(fn_name, payload)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


_SP_TRANSPORT = []


def spark_transport() -> TimedLoopback:
    """The remote function's transport, registered once a process."""
    if not _SP_TRANSPORT:
        from velox_tpu_torch.functions.remote import register_remote_function
        _SP_TRANSPORT.append(TimedLoopback())
        register_remote_function(SP_REMOTE, [T.BIGINT], T.BIGINT,
                                 _SP_TRANSPORT[0])
    return _SP_TRANSPORT[0]


def spark_plans():
    """name -> plan of the spark phase's paths, in run order
    (spark_runtime_filter has a second plan, the bloom's pass count)."""
    shuffle = (PlanBuilder().table_scan("lineitem", [
        "l_orderkey", "l_linenumber", "l_shipmode", "l_extendedprice",
        "l_discount", "l_shipdate"])
        .project([f"pmod(hash(l_orderkey), {SP_PARTITIONS}) as p",
                  "xxhash64(l_orderkey, l_linenumber, l_shipmode) as x",
                  "hash(l_extendedprice, cast(l_discount as double), "
                  "l_shipdate) as hd"])
        .single_aggregation(["p"], ["count(*) as n", "min(x) as mn",
                                    "max(x) as mx", "sum(hd) as s"]))
    cutoff = f"o_orderdate < date '{SP_BLOOM_CUTOFF}'"

    def probe(b):
        bloom = b.new_builder().table_scan(
            "orders", ["o_orderkey", "o_orderdate"]).filter(cutoff) \
            .single_aggregation([], [f"bloom_filter_agg(o_orderkey, "
                                     f"{SP_BLOOM_ITEMS}) as bf"]) \
            .enforce_single_row()
        return (b.table_scan("lineitem", ["l_orderkey", "l_extendedprice",
                                          "l_discount"])
                .nested_loop_join(bloom, output=[
                    "l_orderkey", "l_extendedprice", "l_discount", "bf"])
                .filter("might_contain(bf, l_orderkey)"))
    b = PlanBuilder()
    orders = b.new_builder().table_scan(
        "orders", ["o_orderkey", "o_orderdate", "o_orderpriority"]) \
        .filter(cutoff)
    runtime = (probe(b).hash_join(["l_orderkey"], ["o_orderkey"], orders,
                                  output=["o_orderpriority",
                                          "l_extendedprice", "l_discount"])
               .single_aggregation(["o_orderpriority"], [
                   "count(*) as n",
                   "sum(l_extendedprice * (1 - l_discount)) as rev"]))
    words = "split(p_name, ' ')"
    strings = (PlanBuilder().table_scan("part", ["p_name", "p_type",
                                                 "p_brand", "p_mfgr"])
               .project([
                   "regexp_extract(p_type, '^(\\w+) (\\w+)', 2) as g",
                   f"size({words}) as n",
                   f"array_contains({words}, 'green') as green",
                   "levenshtein(p_brand, 'Brand#23') as lev",
                   f"hash(element_at(sort_array({words}), 1), "
                   "sha2(p_brand, 256), substring_index(p_mfgr, '#', -1)) "
                   "as ck"])
               .single_aggregation(["g"], [
                   "count(*) as c", "sum(n) as words",
                   "count_if(green) as green", "max(lev) as lev",
                   "sum(ck) as ck"]))
    spark_transport()
    remote = (PlanBuilder().table_scan("orders", ["o_custkey"])
              .project([f"{SP_REMOTE}(o_custkey) as r"])
              .single_aggregation([], ["sum(r) as s", "count(*) as n"]))
    string_hash = (PlanBuilder().table_scan("lineitem", ["l_orderkey",
                                                        "l_comment"])
                   .project(["hash(l_orderkey, l_comment) as h",
                             "xxhash64(l_orderkey, l_comment) as x"])
                   .single_aggregation([], ["count(*) as n", "sum(h) as h",
                                            "min(x) as mn", "max(x) as mx"]))
    return {"spark_shuffle_hash": shuffle.plan(),
            "spark_runtime_filter": runtime.plan(),
            "spark_runtime_filter_pass": probe(PlanBuilder())
            .single_aggregation([], ["count(*) as passed"]).plan(),
            "spark_strings": strings.plan(), "spark_remote": remote.plan(),
            "spark_string_hash": string_hash.plan()}


PATH_PLANS.update({n: (lambda n=n: spark_plans()[n])
                   for n in SP_PATHS + ("spark_runtime_filter_pass",
                                        "spark_string_hash")})


def _np_rotl32(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _np_mm_k1(k):
    return _np_rotl32(k * np.uint32(0xCC9E2D51), 15) * np.uint32(0x1B873593)


def _np_mm_h1(h, k):
    return _np_rotl32(h ^ k, 13) * np.uint32(5) + np.uint32(0xE6546B64)


def _np_mm_fmix(h, n: int):
    h = h ^ np.uint32(n)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def np_murmur3_int(v: np.ndarray, seed) -> np.ndarray:
    """Spark's Murmur3 hashInt (murmur3_x86_32 of 4 bytes), uint32."""
    return _np_mm_fmix(_np_mm_h1(seed, _np_mm_k1(
        v.astype(np.int32).view(np.uint32))), 4)


def np_murmur3_long(v: np.ndarray, seed) -> np.ndarray:
    """Spark's Murmur3 hashLong: the low word, then the high word."""
    u = v.astype(np.int64).view(np.uint64)
    h = _np_mm_h1(seed, _np_mm_k1((u & np.uint64(_M32)).astype(np.uint32)))
    h = _np_mm_h1(h, _np_mm_k1((u >> np.uint64(32)).astype(np.uint32)))
    return _np_mm_fmix(h, 8)


def np_murmur3_bytes(b: bytes, seed: np.ndarray) -> np.ndarray:
    """hashUnsafeBytes of one string under per-row seeds (uint32)."""
    def k1(k):
        return _np_mm_k1(np.array([k & _M32], np.uint32))[0]
    cut = len(b) - len(b) % 4
    h = seed
    for i in range(0, cut, 4):
        h = _np_mm_h1(h, k1(int.from_bytes(b[i:i + 4], "little")))
    for t in b[cut:]:
        h = _np_mm_h1(h, k1(t - 256 if t >= 128 else t))
    return _np_mm_fmix(h, len(b))


def _signed32(h: np.ndarray) -> np.ndarray:
    return h.astype(np.uint32).view(np.int32).astype(np.int64)


def _np_rotl64(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _np_xx_round(k):
    return _np_rotl64(k * _XP[1], 31) * _XP[0]


def _np_xx_fmix(h):
    h = (h ^ (h >> np.uint64(33))) * _XP[1]
    h = (h ^ (h >> np.uint64(29))) * _XP[2]
    return h ^ (h >> np.uint64(32))


def np_xxhash_int(v: np.ndarray, seed) -> np.ndarray:
    """Spark's XxHash64 hashInt, uint64."""
    h = seed + _XP[4] + np.uint64(4)
    h = h ^ (v.astype(np.int32).view(np.uint32).astype(np.uint64) * _XP[0])
    return _np_xx_fmix(_np_rotl64(h, 23) * _XP[1] + _XP[2])


def np_xxhash_long(v: np.ndarray, seed) -> np.ndarray:
    h = seed + _XP[4] + np.uint64(8)
    h = h ^ _np_xx_round(v.astype(np.int64).view(np.uint64))
    return _np_xx_fmix(_np_rotl64(h, 27) * _XP[0] + _XP[3])


def np_xxhash_short_bytes(b: bytes, seed: np.ndarray) -> np.ndarray:
    """XXH64 of one string under per-row seeds; strings under 32 bytes
    (no stripes)."""
    if len(b) >= 32:
        raise ValueError("the oracle takes strings under 32 bytes")
    h = seed + _XP[4] + np.uint64(len(b))
    i = 0
    while len(b) - i >= 8:
        k = np.uint64(int.from_bytes(b[i:i + 8], "little"))
        h = _np_rotl64(h ^ _np_xx_round(k), 27) * _XP[0] + _XP[3]
        i += 8
    if len(b) - i >= 4:
        k = np.uint64(int.from_bytes(b[i:i + 4], "little"))
        h = _np_rotl64(h ^ (k * _XP[0]), 23) * _XP[1] + _XP[2]
        i += 4
    for t in b[i:]:
        h = _np_rotl64(h ^ (np.uint64(t) * _XP[4]), 11) * _XP[0]
    return _np_xx_fmix(h)


def _group_sums(gid: np.ndarray, v: np.ndarray, groups: int) -> list:
    """Exact per-group sums of int64 values under 2^47 in magnitude: two
    float64 bincounts of 24-bit halves, each exact below 2^53."""
    lo = v & 0xFFFFFF
    hi = v >> 24
    s_lo = np.bincount(gid, weights=lo, minlength=groups)
    s_hi = np.bincount(gid, weights=hi, minlength=groups)
    return [int(h) * (1 << 24) + int(lo_) for h, lo_ in zip(s_hi, s_lo)]


def _levenshtein_py(a: str, b: str) -> int:
    d = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, cb in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (ca != cb))
    return d[-1]


def spark_shuffle_oracle(conn, li) -> dict:
    """Per partition p = pmod(hash(l_orderkey), 200): the row count, the
    min and max of xxhash64(l_orderkey, l_linenumber, l_shipmode) and the
    sum of hash(l_extendedprice, cast(l_discount as double), l_shipdate),
    Spark's hashes in numpy over the generator's columns."""
    ok = li["l_orderkey"]
    sm = _li_extra(conn, ["l_shipmode"])["l_shipmode"]
    modes = list(conn.gen.dictionaries("lineitem")["l_shipmode"].values)
    seed32, seed64 = np.uint32(42), np.uint64(42)
    with np.errstate(over="ignore"):
        p = _signed32(np_murmur3_long(ok, seed32)) % SP_PARTITIONS
        x = np_xxhash_int(li["l_linenumber"], np_xxhash_long(ok, seed64))
        for i, mode in enumerate(modes):
            rows = sm == i
            x[rows] = np_xxhash_short_bytes(mode.encode(), x[rows])
        x = x.view(np.int64)
        disc = li["l_discount"].astype(np.float64) / 100.0
        hd = _signed32(np_murmur3_int(li["l_shipdate"], np_murmur3_long(
            disc.view(np.int64), np_murmur3_long(li["l_extendedprice"],
                                                 seed32))))
    counts = np.bincount(p, minlength=SP_PARTITIONS)
    order = np.argsort(p.astype(np.int16), kind="stable")
    live = np.flatnonzero(counts)
    first = (np.cumsum(counts) - counts)[live]
    xs = x[order]
    sums = _group_sums(p, hd, SP_PARTITIONS)
    return {int(g): {"n": int(counts[g]), "mn": int(mn), "mx": int(mx),
                     "s": sums[g]}
            for g, mn, mx in zip(live, np.minimum.reduceat(xs, first),
                                 np.maximum.reduceat(xs, first))}


def spark_runtime_oracle(conn, li) -> dict:
    """The orders before the cutoff joined to lineitem: per priority the
    count and the revenue (scale 4); the lineitems whose key passes the
    bloom (bloom_hashes and the sketch in numpy, exec/hashtable.py's
    layout) beside the true members."""
    od = table_columns(conn, "orders", ["o_orderkey", "o_orderdate",
                                        "o_orderpriority"])
    sel = od["o_orderdate"] < _day(SP_BLOOM_CUTOFF)
    keys = od["o_orderkey"]
    prio = np.full(int(keys.max()) + 1, -1, np.int64)
    prio[keys[sel]] = od["o_orderpriority"][sel]
    ok = li["l_orderkey"]
    lp = prio[ok]
    member = lp >= 0
    rev = li["l_extendedprice"] * (100 - li["l_discount"])
    npri = int(od["o_orderpriority"].max()) + 1
    counts = np.bincount(lp[member], minlength=npri)
    sums = _group_sums(lp[member], rev[member], npri)
    names = conn.gen.dictionaries("orders")["o_orderpriority"].values
    m = max(1 << 10, min(1 << 23, 1 << (8 * SP_BLOOM_ITEMS
                                        - 1).bit_length()))
    words = _np_bloom(keys[sel], m)
    bits = np.unpackbits(words.astype(">u4").view(np.uint8)).reshape(
        -1, 32)[:, ::-1].reshape(-1).astype(bool)
    m32 = np.uint64(0xFFFFFFFF)
    h1 = _np_hash(ok, torch.int64)
    h = h1 ^ np.uint64(0xB5297A4D)
    h = ((h ^ (h >> np.uint64(16))) * np.uint64(0x85EBCA6B)) & m32
    h = ((h ^ (h >> np.uint64(13))) * np.uint64(0xC2B2AE35)) & m32
    h2 = h ^ (h >> np.uint64(16))
    passed = np.ones(len(ok), bool)
    for i in range(3):
        passed &= bits[((h1 + np.uint64(i) * h2) & np.uint64(m - 1))
                       .astype(np.int64)]
    if (member & ~passed).any():
        raise AssertionError("the oracle's bloom drops a member")
    return {"groups": {names[g]: {"n": int(counts[g]), "rev": sums[g]}
                       for g in range(npri) if counts[g]},
            "passed": int(passed.sum()), "members": int(member.sum()),
            "lineitems": len(ok), "bits": m}


def spark_strings_oracle(conn) -> dict:
    """Per second word of p_type (Python re): the part count, the words
    of p_name, the names holding 'green', the largest Levenshtein distance
    of p_brand to 'Brand#23', and the sum of Spark's murmur3 hash of (the
    smallest word of p_name, the SHA-256 hex of p_brand, the text after
    p_mfgr's last '#') in numpy."""
    import hashlib
    import re
    cols = table_columns(conn, "part", ["p_name", "p_type", "p_brand",
                                        "p_mfgr"])
    dicts = conn.gen.dictionaries("part")
    vals = {c: list(dicts[c].values) for c in cols}
    rx = re.compile(r"^(\w+) (\w+)")
    gname = sorted({rx.search(t).group(2) for t in vals["p_type"]})
    g_of_type = np.array([gname.index(rx.search(t).group(2))
                          for t in vals["p_type"]])
    name_words = [s.split(" ") for s in vals["p_name"]]
    n_of = np.array([len(w) for w in name_words])
    green_of = np.array(["green" in w for w in name_words])
    lev_of = np.array([_levenshtein_py(s, "Brand#23")
                       for s in vals["p_brand"]])
    sha = [hashlib.sha256(s.encode()).hexdigest().encode()
           for s in vals["p_brand"]]
    mf = [s.split("#")[-1].encode() for s in vals["p_mfgr"]]
    nb, nm = len(vals["p_brand"]), len(vals["p_mfgr"])
    combo = (cols["p_name"] * nb + cols["p_brand"]) * nm + cols["p_mfgr"]
    uniq, inv = np.unique(combo, return_inverse=True)
    name, rest = np.divmod(uniq, nb * nm)
    brand, mfgr = np.divmod(rest, nm)
    # the chain hash(smallest word, sha, mfgr) over each distinct triple
    h = np.empty(len(uniq), np.uint32)
    with np.errstate(over="ignore"):
        for i, w in enumerate(name_words):
            rows = name == i
            h[rows] = np_murmur3_bytes(min(w).encode(),
                                       np.full(rows.sum(), 42, np.uint32))
        for i, b in enumerate(sha):
            rows = brand == i
            h[rows] = np_murmur3_bytes(b, h[rows])
        for i, b in enumerate(mf):
            rows = mfgr == i
            h[rows] = np_murmur3_bytes(b, h[rows])
    ck_u = _signed32(h)
    g = g_of_type[cols["p_type"]]
    k = len(gname)
    words = np.bincount(g, weights=n_of[cols["p_name"]], minlength=k)
    green = np.bincount(g, weights=green_of[cols["p_name"]], minlength=k)
    lev = lev_of[cols["p_brand"]]
    ck = _group_sums(g, ck_u[inv], k)
    return {gname[i]: {"c": int((g == i).sum()), "words": int(words[i]),
                       "green": int(green[i]),
                       "lev": int(lev[g == i].max()), "ck": ck[i]}
            for i in range(k)}


def spark_string_hash_oracle(conn, li) -> dict:
    """hash and xxhash64 of (l_orderkey, l_comment): the string second in
    the chain, so every row has its own seed. Rows grouped by comment
    (one stable radix argsort), each comment's bytes folded over its
    rows' seeds in numpy; the count, sum(h), min(x), max(x)."""
    cm = _li_extra(conn, ["l_comment"])["l_comment"]
    vals = list(conn.gen.dictionaries("lineitem")["l_comment"].values)
    order = np.argsort(cm.astype(np.int16), kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(
        cm, minlength=len(vals)))])
    okc = li["l_orderkey"][order]
    with np.errstate(over="ignore"):
        h = np_murmur3_long(okc, np.uint32(42))
        x = np_xxhash_long(okc, np.uint64(42))
        for i, v in enumerate(vals):
            lo, hi = bounds[i], bounds[i + 1]
            if lo < hi:
                h[lo:hi] = np_murmur3_bytes(v.encode(), h[lo:hi])
                x[lo:hi] = np_xxhash_short_bytes(v.encode(), x[lo:hi])
    x = x.view(np.int64)
    # the reference's form gathers a (rows x blocks) uint32 matrix for
    # hash and a (rows x words) uint64 one for xxhash64 a batch
    lens = [len(v.encode()) for v in vals]
    blocks = max(n // 4 + n % 4 for n in lens)
    words = max((n + 7) // 8 for n in lens) + 5
    words += (-words) % 4
    return {"want": {"n": len(okc), "h": int(_signed32(h).sum()),
                     "mn": int(x.min()), "mx": int(x.max())},
            "reference_form_bytes_per_row": 4 * blocks + 8 * words}


def spark_phase(conn, ctx, li) -> dict:
    """The Spark paths at the connector's scale, each cold (the scan cache
    cleared) and warm with equal launches, exact against the oracles
    above. Each line: walls, peak device memory and launches, and the
    path's own counts (the bloom's passes and false-positive share, the
    remote function's host round trips)."""
    t0 = time.perf_counter()
    want = {"spark_shuffle_hash": spark_shuffle_oracle(conn, li),
            "spark_runtime_filter": spark_runtime_oracle(conn, li),
            "spark_strings": spark_strings_oracle(conn)}
    od = table_columns(conn, "orders", ["o_custkey"])["o_custkey"]
    want["spark_remote"] = {"s": _psum(od * 3 + 1), "n": len(od)}
    sh = spark_string_hash_oracle(conn, li)
    want["spark_string_hash"] = sh["want"]
    phase("spark_oracles", seconds=time.perf_counter() - t0)
    transport = spark_transport()
    rf = want["spark_runtime_filter"]

    def rows_of(outs):
        return [r for b in outs for r in to_arrow(b).to_pylist()]

    def check_shuffle(outs, info):
        got = {r["p"]: {"n": r["n"], "mn": r["mn"], "mx": r["mx"],
                        "s": r["s"]} for r in rows_of(outs)}
        if got != want["spark_shuffle_hash"]:
            bad = sorted(k for k in set(got) | set(want["spark_shuffle_hash"])
                         if got.get(k) != want["spark_shuffle_hash"].get(k))
            raise AssertionError(f"spark_shuffle_hash: partitions {bad[:5]} "
                                 "differ from the oracle")
        info["partitions"] = len(got)
        info["rows"] = sum(v["n"] for v in got.values())

    def check_runtime(outs, info):
        got = {r["o_orderpriority"]: {"n": r["n"], "rev": int(
            r["rev"].scaleb(4))} for r in rows_of(outs)}
        if got != rf["groups"]:
            raise AssertionError(f"spark_runtime_filter: {got} != "
                                 f"{rf['groups']}")
        info["members"] = sum(v["n"] for v in got.values())

    def check_pass(outs, info):
        passed = _one_row(outs)["passed"]
        if passed != rf["passed"] or passed < rf["members"]:
            raise AssertionError(f"the bloom passed {passed} rows, the "
                                 f"oracle {rf['passed']} (members "
                                 f"{rf['members']})")
        info.update(passed=passed, members=rf["members"],
                    false_positive_share=(passed - rf["members"])
                    / (rf["lineitems"] - rf["members"]),
                    bloom_bits=rf["bits"])

    def check_strings(outs, info):
        got = {r["g"]: {k: r[k] for k in ("c", "words", "green", "lev",
                                           "ck")} for r in rows_of(outs)}
        if got != want["spark_strings"]:
            raise AssertionError(f"spark_strings: {got} != "
                                 f"{want['spark_strings']}")
        info["parts"] = sum(v["c"] for v in got.values())

    def check_remote(outs, info):
        got = _one_row(outs)
        if got != want["spark_remote"]:
            raise AssertionError(f"spark_remote: {got} != "
                                 f"{want['spark_remote']}")
        info["rows"] = got["n"]

    def check_string_hash(outs, info):
        got = _one_row(outs)
        if got != want["spark_string_hash"]:
            raise AssertionError(f"spark_string_hash: {got} != "
                                 f"{want['spark_string_hash']}")
        rows = math.ceil(len(li["l_orderkey"])
                         / len(conn.default_splits("lineitem")))
        info["reference_form_bytes_a_batch"] = \
            sh["reference_form_bytes_per_row"] * rows

    checks = {"spark_shuffle_hash": check_shuffle,
              "spark_runtime_filter": check_runtime,
              "spark_runtime_filter_pass": check_pass,
              "spark_strings": check_strings, "spark_remote": check_remote,
              "spark_string_hash": check_string_hash}
    cache = DataCache.instance()
    by_path = {}
    for name, plan in spark_plans().items():
        runs = {}
        for run in ("cold", "warm"):
            if run == "cold":
                cache.clear()
            info = {}
            calls, secs = transport.calls, transport.seconds
            torch.cuda.reset_peak_memory_stats()
            out, wall, launched = _run(plan, ctx)
            checks[name](out, info)
            del out
            if name == "spark_remote":
                info.update(round_trips=transport.calls - calls,
                            round_trip_s=transport.seconds - secs)
            runs[run] = {"wall_s": wall, "launches": launched,
                         "max_memory_allocated":
                             torch.cuda.max_memory_allocated(), **info}
        cold, warm = runs["cold"], runs["warm"]
        if warm["launches"] != cold["launches"]:
            raise AssertionError(f"{name}: warm launches {warm['launches']}"
                                 f" != cold {cold['launches']}")
        got = cold["launches"]
        if name != "spark_remote" \
                and got["flat_gather"] + got["gather_rows"] == 0:
            raise AssertionError(f"{name}: B5 never launched: {got}")
        if name in ("spark_shuffle_hash", "spark_strings") and not (
                got["radix_hist"] > 0
                and got["radix_rank"] + got["radix_pos"] > 0):
            raise AssertionError(f"{name}: B4 or B2/B3 never launched: "
                                 f"{got}")
        by_path[name] = got
        extra = {k: {r: v[k] for r, v in runs.items()} for k in cold
                 if k not in ("wall_s", "launches", "max_memory_allocated")}
        phase(name, wall_s={r: v["wall_s"] for r, v in runs.items()},
              max_memory_allocated={r: v["max_memory_allocated"]
                                    for r, v in runs.items()},
              launches={k: v for k, v in got.items() if k != "filter_sum"},
              **extra)
    cache.clear()
    phase("spark", seconds=time.perf_counter() - t0)
    return by_path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=10.0,
                    help="TPC-H scale factor (default 10)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    device_phase()
    build_phase()
    kernel = kernel_phase(np.random.default_rng(args.seed))
    conn = register_tpch(args.sf)
    ctx = QueryCtx(device="cuda")
    li = lineitem_columns(conn)
    scan_phase(conn)
    by_phase = {"q6": q6_phase(conn, ctx, li)}
    launches = by_phase["q6"]["filter_sum"]
    eviction_phase(conn, ctx, li)
    heads_phase(ctx, li)
    radix = radix_phase(args.seed, conn, li)
    t0 = time.perf_counter()
    order = np.lexsort([li[c] for c in reversed(SORT_COLS)])
    phase("oracle_lexsort", rows=len(order),
          seconds=time.perf_counter() - t0)
    by_phase.update({"q1": q1_phase(conn, ctx, li),
                     "topn": topn_phase(conn, ctx, li, order),
                     "sort_full": sort_full_phase(conn, ctx, li, order)})
    by_phase.update(spill_phase(conn, ctx, li, order))
    by_phase["q6_generic"] = q6_generic_phase(conn, ctx, li)
    del order
    gather = gather_phase(args.seed, conn)
    by_phase["q3"] = q3_phase(conn, ctx, li)
    by_phase["q18"] = q18_phase(conn, ctx, li)
    by_phase.update(tpch_rest_phase(conn, ctx, li))
    by_phase.update(analytic_phase(conn, ctx, li))
    by_phase.update(aggregates_phase(conn, ctx, li))
    by_phase.update(types_phase(conn, ctx, li, args.seed))
    by_phase.update(complex_phase(conn, ctx, li))
    by_phase.update(spark_phase(conn, ctx, li))

    main_shape = kernel["timings"][FILTER_TIMED[0]]
    kernels = [{
        "name": "filter_sum",
        "route": "cuda",
        "source": "velox_tpu_torch/csrc/filter_sum.cu",
        "replaces": "velox_tpu/ops/filter_reduce.py:45",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": "bytes",
        # no one PyTorch call filters by ranges and sums products
        "library_ms": None,
        "rows": FILTER_TIMED[0],
        "graph_ms": main_shape["graph_ms"],
        "ms_60m_rows": kernel["timings"][FILTER_TIMED[1]]["ms"],
        "plain_ms_60m_rows": kernel["timings"][FILTER_TIMED[1]]["plain_ms"],
        "bound_ms_60m_rows": kernel["timings"][FILTER_TIMED[1]]["bound_ms"],
        "all_read_ms_60m_rows":
            kernel["timings"][FILTER_TIMED[1]]["all_read_ms"],
        "redesigned": "a template instance per (range columns, product "
                      "columns) layout; 16-byte streaming loads, >= 8 in "
                      "flight a thread; persistent grid; adds into the "
                      "caller's running total",
    }]
    # (kernel, TPU kernel it replaces, the path phase whose launches are
    # reported, rows of the timed shape that phase gives it, the timed
    # mode that path launches, the other timed modes of the kernel, its
    # CUDA kernels and what changed in their design, if anything)
    for name, line, main_phase, rows, mode, extra, cuda, design in (
            ("radix_hist", 85, "topn", 6_700_000, "radix_hist_state",
             ("radix_hist", "radix_hist_word"), ["radix_hist_kernel<int64_t>",
                               "radix_hist_kernel<int32_t>"],
             "digit taken in the kernel from the int64 state, an int32 word "
             "or int32 digits; 16-byte loads; per-warp shared-atomic "
             "histograms"),
            ("radix_rank", 45, "sort_full", 60_000_000, "radix_rank_scatter",
             ("radix_rank_scatter_last", "radix_rank"),
             ["radix_place_kernel<int32_t, kRankScatter>",
              "radix_place_kernel<int32_t, kPositions>"],
             "B3's kernel: whole tile (and the permutation's) in shared "
             "memory, ballot multi-split ranks; the classic loop's pass "
             "scatters the shifted word and the permutation; the rank form "
             "is B3's positions given each tile's offset in its digit"),
            ("radix_pos", 116, "topn", 6_700_000, "radix_scatter_pass",
             ("radix_pos",),
             ["radix_place_kernel<int64_t, kScatter>",
              "radix_place_kernel<int32_t, kPositions>"],
             "whole tile in shared memory, ballot multi-split ranks, "
             "positions or the scattered next state")):
        t = radix["timings"][rows]["uniform"][mode]
        modes = (mode,) + extra
        row = {
            "name": name,
            "route": "cuda",
            "source": "velox_tpu_torch/csrc/radix_pass.cu",
            "replaces": f"velox_tpu/ops/pallas_kernels.py:{line}",
            "launches": by_phase[main_phase][name],
            "launches_by_phase": {p: c[name] for p, c in by_phase.items()},
            "max_abs_err": max(radix["max_abs_err"][m] for m in modes),
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            # B4: torch.bincount of the (digit, tile) keys; B2/B3: no one
            # call gives stable in-digit ranks
            "library_ms": t["library_ms"],
            "rows": rows, "timed_mode": mode, "cuda_kernels": cuda,
            # every timed mode at every timed size and digit distribution
            "times": {m: {str(n): {dist: radix["timings"][n][dist][m]
                                   for dist in TIMED_DISTS}
                          for n in TIMED_SIZES} for m in modes},
        }
        if design:
            row["redesigned"] = design
        kernels.append(row)
    # B5's path shape: the q3/q18 array-mode probe (monotone indices into
    # the orders domain); its launches are both wrappers' on q3
    probe = gather["timings"]["monotone"]
    kernels.append({
        "name": "flat_gather",
        "route": "cuda",
        "source": "velox_tpu_torch/csrc/flat_gather.cu",
        "replaces": "velox_tpu/ops/pallas_kernels.py:292",
        "launches": by_phase["q3"]["flat_gather"]
        + by_phase["q3"]["gather_rows"],
        "launches_by_phase": {p: {"flat_gather": c["flat_gather"],
                                  "gather_rows": c["gather_rows"]}
                              for p, c in by_phase.items()},
        "max_abs_err": gather["max_abs_err"],
        "ms": probe["ms"],
        "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"],
        "bound_by": "bytes",
        "library_ms": probe["library_ms"],
        "timed_shape": "monotone",
        # every timed shape: uniform at two data sizes, monotone, the
        # multi-column form, the full sort's permutation
        "times": gather["timings"],
        "redesigned": "all of a thread's data loads in flight; 16-byte "
                      "index loads and stores, evict-first in L2; up to 8 "
                      "columns through one index a launch",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
