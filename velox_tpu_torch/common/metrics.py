"""Process-wide metrics registry.

Role parity: ``velox/common/base/StatsReporter.h:86-202`` (macro-registered
counters/histograms recorded into a pluggable BaseStatsReporter) +
``RuntimeMetrics.h``. Operators record named metrics; a reporter hook can
export them (the default reporter just accumulates in memory).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Dict, List, Optional


class StatsReporter:
    """Pluggable sink. Parity: BaseStatsReporter."""

    def add_counter(self, name: str, value: float):
        raise NotImplementedError

    def add_histogram(self, name: str, value: float):
        raise NotImplementedError


class InMemoryReporter(StatsReporter):
    def __init__(self):
        self.counters: Dict[str, float] = defaultdict(float)
        self.histograms: Dict[str, List[float]] = defaultdict(list)
        self._lock = threading.Lock()

    def add_counter(self, name, value):
        with self._lock:
            self.counters[name] += value

    def add_histogram(self, name, value):
        with self._lock:
            self.histograms[name].append(value)

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "histograms": {k: {
                    "count": len(v),
                    "sum": sum(v),
                    "max": max(v) if v else None,
                } for k, v in self.histograms.items()},
            }


_reporter: StatsReporter = InMemoryReporter()


def set_reporter(r: StatsReporter):
    global _reporter
    _reporter = r


def reporter() -> StatsReporter:
    return _reporter


def record_counter(name: str, value: float = 1):
    """Parity: RECORD_METRIC_VALUE."""
    _reporter.add_counter(name, value)


def record_histogram(name: str, value: float):
    _reporter.add_histogram(name, value)


# predefined metric keys (parity: common/base/Counters.h)
K_TASK_BATCHES = "velox_tpu.task.batches_processed"
K_TASK_QUERIES = "velox_tpu.task.queries"
K_JOIN_DYN_FILTERS = "velox_tpu.join.dynamic_filters_pushed"
K_AGG_HOST_OFFLOADS = "velox_tpu.agg.host_offload_runs"
K_FILTER_SUM_KERNEL = "velox_tpu.agg.filter_sum_kernel_plans"
K_SKEW_SPLITS = "velox_tpu.exchange.skew_key_splits"
K_JOIN_BUILD_OFFLOADS = "velox_tpu.join.build_host_offloads"
# hash-join builds by probe route: with array mode's domain tables (from
# plan stats or the build's own key range), among those the ones whose
# range came from the build's keys, and those that probe through the
# merge-rank
K_JOIN_ARRAY_MODE_BUILDS = "velox_tpu.join.array_mode_builds"
K_JOIN_OBSERVED_RANGE_BUILDS = "velox_tpu.join.observed_range_builds"
K_JOIN_MERGE_RANK_BUILDS = "velox_tpu.join.merge_rank_builds"
# the build and probe key rows each merge-rank probe sorts together (the
# two batches' capacities)
K_JOIN_MERGE_RANK_ROWS = "velox_tpu.join.merge_rank_rows"
# dictionary-string key columns as they become sort words (exec/sort.py
# ``dictionary_keys``): by their ids (a sorted dictionary) or by the
# ranks of their values
K_SORT_DICT_ID_KEYS = "velox_tpu.sort.dictionary_id_keys"
K_SORT_DICT_RANKED_KEYS = "velox_tpu.sort.dictionary_ranked_keys"
K_SPILL_DISK_WRITES = "velox_tpu.spill.disk_writes"
K_SORT_OFFLOADS = "velox_tpu.sort.host_offloads"
K_SPLITS_PRUNED = "velox_tpu.scan.splits_pruned"
K_GROUPED_EXECUTIONS = "velox_tpu.task.grouped_executions"
K_EXCHANGE_OVERFLOWS = "velox_tpu.exchange.page_overflows"
K_EXCHANGE_PAGES = "velox_tpu.exchange.pages"
K_EXCHANGE_BYTES = "velox_tpu.exchange.bytes"
K_QUERY_WALL_MS = "velox_tpu.task.wall_ms"
K_MEM_RECLAIMS = "velox_tpu.memory.reclaims"
K_MEM_RECLAIMED_BYTES = "velox_tpu.memory.reclaimed_bytes"
K_SCAN_CACHE_HITS = "velox_tpu.cache.device_hits"
K_SCAN_CACHE_MISSES = "velox_tpu.cache.device_misses"
K_SCAN_CACHE_EVICTIONS = "velox_tpu.cache.device_evictions"
K_SSD_CACHE_HITS = "velox_tpu.cache.ssd_hits"
K_SSD_CACHE_MISSES = "velox_tpu.cache.ssd_misses"
K_SSD_CACHE_WRITES = "velox_tpu.cache.ssd_writes"
K_SSD_CACHE_WRITE_BYTES = "velox_tpu.cache.ssd_write_bytes"
K_VALUES_INGEST_HITS = "velox_tpu.values.ingest_cache_hits"
K_OUTPUT_ROWS = "velox_tpu.task.output_rows"
K_OUTPUT_BYTES = "velox_tpu.task.output_bytes"
K_SCAN_SPLITS = "velox_tpu.scan.splits_processed"
K_SCAN_PREWARMED = "velox_tpu.scan.prewarmed_operators"
K_SPILL_DISK_READ_BYTES = "velox_tpu.spill.disk_read_bytes"
K_SPILL_DISK_WRITE_BYTES = "velox_tpu.spill.disk_write_bytes"
# bytes copied to host RAM (every HostBatch: offloaded operator state and
# the SSD tier's demotions)
K_OFFLOAD_HOST_BYTES = "velox_tpu.spill.offload_host_bytes"
# offload and spill timings (histograms, ms): host time of a HostBatch
# (pinned allocation and the copies' enqueue), device time of its copies
# (CUDA events), and the file write and read of a DiskBatch
K_OFFLOAD_HOST_MS = "velox_tpu.spill.offload_host_ms"
K_OFFLOAD_COPY_MS = "velox_tpu.spill.offload_copy_ms"
K_SPILL_DISK_WRITE_MS = "velox_tpu.spill.disk_write_ms"
K_SPILL_DISK_READ_MS = "velox_tpu.spill.disk_read_ms"
