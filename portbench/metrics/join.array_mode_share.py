"""join.array_mode_share: the hash-join builds in the traced window that
took array mode (dense domain tables over the build key's range, from
plan stats or from the build's own keys) over those builds and the ones
that probe through the merge-rank, from the program's counters
velox_tpu.join.array_mode_builds and velox_tpu.join.merge_rank_builds, in
percent. None where the program has no such counters or built no hash
join."""

ARRAY_MODE = "velox_tpu.join.array_mode_builds"
MERGE_RANK = "velox_tpu.join.merge_rank_builds"


def read(reading):
    array_mode = reading.counters.get(ARRAY_MODE, 0)
    builds = array_mode + reading.counters.get(MERGE_RANK, 0)
    if not builds:
        return None
    return 100.0 * array_mode / builds
