"""The device's idle share of the traced stretch, in percent: one minus
the union of its operations' intervals over the stretch's wall time."""

from window import idle_pct


def read(record):
    return idle_pct(record)
