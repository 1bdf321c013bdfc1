"""join.merge_rank_rows_per_query: the build and probe key rows that the
hash joins' merge-rank probes sort in the device window (the program's
counter velox_tpu.join.merge_rank_rows: each probe batch's capacity plus
its build's) over the queries the window completed. None where the
program has no such counter, ran no merge-rank or completed no query."""

ROWS = "velox_tpu.join.merge_rank_rows"


def read(reading):
    rows = reading.counters.get(ROWS, 0)
    if not rows or not reading.queries:
        return None
    return rows / reading.queries
