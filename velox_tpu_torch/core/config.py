"""Per-query configuration.

Role parity: ``velox/core/QueryConfig.h`` — string-keyed session properties
with typed accessors. Keys are a TPU-relevant subset: batch sizing replaces
the reference's per-operator byte budgets (static shapes make capacity the
unit of memory), spill knobs become host-offload knobs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional


class QueryConfig:
    """Typed view over a string->value session map."""

    # --- keys (documented; parity noted per key) ---
    # velox kPreferredOutputBatchRows (QueryConfig.h:164)
    BATCH_CAPACITY = "batch_capacity"
    # velox kAbandonPartialAggregationMinRows analogue: fold partial runs
    AGG_COMPACT_THRESHOLD = "agg_compact_threshold"
    # velox kMaxSpillLevel family: offload aggregation partials to host RAM
    AGG_HOST_OFFLOAD = "agg_host_offload"
    # broadcast-vs-partitioned distributed join cutover (bytes of build
    # side; parity: host engines' broadcast join threshold over
    # PartitionedOutput, exec/PartitionedOutput.h:149)
    JOIN_BROADCAST_THRESHOLD = "join_broadcast_threshold_bytes"
    # HBM byte budgets before join-build / sort buffers spill to host
    # RAM (velox Spiller kHashJoinBuild/kOrderBy analogues)
    JOIN_BUILD_OFFLOAD_BYTES = "join_build_offload_bytes"
    SORT_OFFLOAD_BYTES = "orderby_offload_bytes"
    # host-RAM byte budget per offload buffer before the DISK tier takes
    # over (spill files; parity: velox SpillConfig maxSpillBytes /
    # Spiller.h spill files). 0 = unlimited host RAM (no disk spill).
    OFFLOAD_HOST_BUDGET_BYTES = "offload_host_budget_bytes"
    # directory for spill files (velox kSpillPath analogue); empty =
    # a per-buffer temp directory
    SPILL_DIR = "spill_dir"
    # hot-destination factor for exchange skew detection (a destination
    # with > factor * (rows/n) rows triggers key splitting)
    SKEW_FACTOR = "exchange_skew_factor"
    # velox kQueryTraceEnabled / kQueryTraceDir (QueryConfig.h)
    TRACE_ENABLED = "query_trace_enabled"
    TRACE_DIR = "query_trace_dir"
    TRACE_NODE_IDS = "query_trace_node_ids"  # comma list; empty = all
    # velox kMaxOutputBatchRows
    MAX_OUTPUT_BATCH_ROWS = "max_output_batch_rows"
    # per-query HBM cap; crossing it triggers arbitration (scan-cache
    # eviction, then force-offload of operator state to host RAM) —
    # parity: MemoryArbitrator capacity (common/memory/MemoryArbitrator.h)
    QUERY_HBM_CAP_BYTES = "query_hbm_cap_bytes"
    # producer driver threads per LocalPartition boundary (parity:
    # LocalPlanner.cpp:177 per-pipeline driver counts; 0 = inline)
    LOCAL_EXCHANGE_DRIVERS = "local_exchange_drivers"
    # join build -> probe scan min/max pushdown (Driver::pushdownFilters)
    DYNAMIC_FILTERS = "dynamic_filters_enabled"
    # use StreamingAggregation when the agg input is sorted by its keys
    # (parity: velox exec/StreamingAggregation.h:29)
    STREAMING_AGG_ENABLED = "streaming_aggregation_enabled"
    # background split preload depth (0 = synchronous scans); parity:
    # velox split prefetch on the I/O executor / kMaxSplitPreloadPerDriver
    SCAN_PREFETCH_DEPTH = "scan_prefetch_depth"
    # velox kAbandonPartialAggregationMinRows / ...MinPct
    # (QueryConfig.h:137-141): partial aggregation stops grouping when
    # it is not reducing cardinality
    ABANDON_PARTIAL_AGG_MIN_ROWS = "abandon_partial_aggregation_min_rows"
    ABANDON_PARTIAL_AGG_MIN_PCT = "abandon_partial_aggregation_min_pct"
    # velox kMaxLocalExchangeBufferSize (QueryConfig.h): byte bound of
    # the in-process multi-driver exchange queue
    MAX_LOCAL_EXCHANGE_BUFFER_BYTES = "max_local_exchange_buffer_size"
    # velox kAggregationSpillEnabled / kJoinSpillEnabled /
    # kOrderBySpillEnabled: per-operator-class switches for the offload
    # (spill-analogue) machinery; disabling one keeps that operator's
    # state resident in HBM regardless of the byte budgets
    AGG_SPILL_ENABLED = "aggregation_spill_enabled"
    JOIN_SPILL_ENABLED = "join_spill_enabled"
    ORDERBY_SPILL_ENABLED = "order_by_spill_enabled"
    # velox kDebugDisableCommonSubExpressions: turn off trace-time CSE
    # in expression compilation (debugging aid)
    DEBUG_DISABLE_CSE = "debug_disable_common_sub_expressions"
    # velox kHashProbeFinishEarlyOnEmptyBuild: inner/semi probes skip
    # the probe pipeline entirely when the build has zero usable rows
    HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD = \
        "hash_probe_finish_early_on_empty_build"
    # velox kSessionTimezone + kAdjustTimestampToTimezone: default zone
    # for timezone-sensitive datetime functions
    SESSION_TIMEZONE = "session_timezone"
    ADJUST_TIMESTAMP_TO_SESSION_TIMEZONE = "adjust_timestamp_to_timezone"
    # velox kBloomFilterExpectedNumItems / kBloomFilterNumBits defaults
    # for bloom_filter_agg when the call gives no size hints
    BLOOM_FILTER_EXPECTED_NUM_ITEMS = "bloom_filter_expected_num_items"
    BLOOM_FILTER_NUM_BITS = "bloom_filter_num_bits"
    # velox kMaxSpillBytes: cap on total DISK spill bytes per buffer
    # (0 = unlimited); exceeding it raises instead of filling the disk
    MAX_SPILL_BYTES = "max_spill_bytes"
    # velox kPreferredOutputBatchBytes: advisory output batch sizing
    # (BATCH_CAPACITY covers rows; static shapes make bytes advisory)
    PREFERRED_OUTPUT_BATCH_BYTES = "preferred_output_batch_bytes"
    # synchronize the CUDA device after each operator call, so that the
    # OperatorStats walls (host time) hold the device's time: a CUDA
    # launch returns once the work is queued, and without this the work
    # lands in the wall of whatever call waits for the device next.
    # Parity intent: the reference's per-operator CPU times are real
    # because its execution is synchronous. Debug/profiling only: it
    # serializes the host and the device.
    DEBUG_SYNC_OPERATORS = "debug_sync_operators"

    _DEFAULTS: Dict[str, Any] = {
        AGG_COMPACT_THRESHOLD: 8,
        AGG_HOST_OFFLOAD: False,
        JOIN_BROADCAST_THRESHOLD: 128 << 20,
        SKEW_FACTOR: 4,
        JOIN_BUILD_OFFLOAD_BYTES: 4 << 30,
        SORT_OFFLOAD_BYTES: 4 << 30,
        OFFLOAD_HOST_BUDGET_BYTES: 0,
        SPILL_DIR: "",
        ABANDON_PARTIAL_AGG_MIN_ROWS: 100_000,
        ABANDON_PARTIAL_AGG_MIN_PCT: 0.8,
        MAX_LOCAL_EXCHANGE_BUFFER_BYTES: 32 << 20,
        AGG_SPILL_ENABLED: True,
        JOIN_SPILL_ENABLED: True,
        ORDERBY_SPILL_ENABLED: True,
        DEBUG_DISABLE_CSE: False,
        HASH_PROBE_FINISH_EARLY_ON_EMPTY_BUILD: True,
        SESSION_TIMEZONE: "",
        ADJUST_TIMESTAMP_TO_SESSION_TIMEZONE: False,
        BLOOM_FILTER_EXPECTED_NUM_ITEMS: 10_000,
        BLOOM_FILTER_NUM_BITS: 0,
        MAX_SPILL_BYTES: 0,
        PREFERRED_OUTPUT_BATCH_BYTES: 10 << 20,
        TRACE_ENABLED: False,
        TRACE_DIR: "",
        TRACE_NODE_IDS: "",
    }

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values = dict(values or {})

    def get(self, key: str, default=None):
        if key in self._values:
            return self._values[key]
        if default is not None:
            return default
        return self._DEFAULTS.get(key)

    def get_int(self, key: str, default: Optional[int] = None):
        v = self.get(key, default)
        return None if v is None else int(v)

    def get_bool(self, key: str, default: Optional[bool] = None) -> bool:
        v = self.get(key, default)
        if isinstance(v, str):
            return v.lower() in ("1", "true", "yes")
        return bool(v)

    def get_str(self, key: str, default: str = "") -> str:
        return str(self.get(key, default) or default)

    def set(self, key: str, value) -> "QueryConfig":
        self._values[key] = value
        return self

    def as_dict(self) -> Dict[str, Any]:
        out = dict(self._DEFAULTS)
        out.update(self._values)
        return out
