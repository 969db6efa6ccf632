"""The 95th percentile of every iteration's wall time in the window, from
its start to its metrics on the host."""

from window import percentile_ms


def read(record):
    return percentile_ms(record["units"], 95)
