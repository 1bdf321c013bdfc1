"""kernels.handwritten_share: the share of the layer window's
device-busy time in which one of the hand-written kernels B1-B5 ran
(filter_sum, radix_hist, radix_place, flat_gather; by kernel name), in
percent."""


def read(reading):
    busy = reading.layers.busy_s()
    if busy <= 0:
        return None
    return 100.0 * reading.layers.busy_s("kernels") / busy
