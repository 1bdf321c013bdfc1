"""scan.cache_hit_share: the device scan cache's hits over its lookups
in the traced window, from the program's counters
velox_tpu.cache.device_hits and velox_tpu.cache.device_misses, in
percent."""

HITS = "velox_tpu.cache.device_hits"
MISSES = "velox_tpu.cache.device_misses"


def read(reading):
    hits = reading.counters.get(HITS, 0)
    lookups = hits + reading.counters.get(MISSES, 0)
    if not lookups:
        return None
    return 100.0 * hits / lookups
