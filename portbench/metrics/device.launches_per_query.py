"""device.launches_per_query: kernels that ran on the device in the
device window over the queries it completed (an exact count of the
trace's kernel records; copies and sets are not kernels)."""


def read(reading):
    if not reading.queries:
        return None
    return reading.device.kernels() / reading.queries
