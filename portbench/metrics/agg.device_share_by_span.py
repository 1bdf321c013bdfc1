"""agg.device_share_by_span: the share of the span window's device-busy
time in which a device operation ran that the program launched inside a
'agg' span, in percent: the union of those operations' intervals over the
union of all. It reads the program's spans (portbench/spans.py): each
operation goes to the innermost span open on its launching thread at its
launch; B1-B5 go to 'kernels' by name. None without spans."""


def read(reading):
    spans = getattr(reading, "spans", None)
    if spans is None or spans.busy_s() <= 0:
        return None
    return 100.0 * spans.busy_s("agg") / spans.busy_s()
