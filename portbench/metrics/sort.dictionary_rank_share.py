"""sort.dictionary_rank_share: the dictionary-string key columns that
became sort words through the rank of their values (an unsorted
dictionary) over all dictionary-string key columns that became sort
words in the device window, from the program's counters
velox_tpu.sort.dictionary_ranked_keys and velox_tpu.sort.dictionary_id_keys,
in percent. None where the program has no such counters or sorted no
dictionary string."""

RANKED = "velox_tpu.sort.dictionary_ranked_keys"
BY_ID = "velox_tpu.sort.dictionary_id_keys"


def read(reading):
    ranked = reading.counters.get(RANKED, 0)
    keys = ranked + reading.counters.get(BY_ID, 0)
    if not keys:
        return None
    return 100.0 * ranked / keys
