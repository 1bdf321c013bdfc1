"""sort.device_share: the share of the layer window's device-busy time in
which a device operation that the 'sort' layer launched ran (the union of
those operations' intervals over the union of all), in percent."""


def read(reading):
    busy = reading.layers.busy_s()
    if busy <= 0:
        return None
    return 100.0 * reading.layers.busy_s("sort") / busy
