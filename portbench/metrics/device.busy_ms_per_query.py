"""device.busy_ms_per_query: the device window's device-busy time (the
union of its operations' intervals) over the queries it completed, in
milliseconds: the device's work a query, which the host's pace does not
move."""


def read(reading):
    if not reading.queries:
        return None
    return 1e3 * reading.device.busy_s() / reading.queries
