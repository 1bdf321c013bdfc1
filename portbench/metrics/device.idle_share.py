"""device.idle_share: the share of the streams' time in which no device
operation ran, in percent: 1 - (the union of the device window's
device-busy intervals) / (the host-clock seconds that the same whole
streams took unprofiled just before). The busy time comes from the
device's own timeline, which the profiler does not stretch; the window's
length does not, since the profiler's recording of each launch slows the
host (a bench5 stream by a quarter, ``profile.py``)."""


def read(reading):
    if reading.plain_s <= 0:
        return None
    return 100.0 * (1.0 - reading.device.busy_s() / reading.plain_s)
