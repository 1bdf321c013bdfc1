"""agg.idle_share: the share of the span window's idle time (no device
operation running) that began while the harness's thread was inside a
'agg' span, innermost, in percent. It reads the program's spans
(portbench/spans.py); the six layers' shares and the share outside every
span ('harness') add up to 100. None without spans."""


def read(reading):
    spans = getattr(reading, "spans", None)
    if spans is None or spans.idle_s() <= 0:
        return None
    return 100.0 * spans.idle_s("agg") / spans.idle_s()
