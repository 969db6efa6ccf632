"""Device idle time the PPO step's glue leaves: the gaps whose midpoint has
one of the glue spans (`spans.GLUE`) as the innermost program span open on
the trainer's thread, per traced iteration, in ms."""

from spans import GLUE, idle_ms


def read(record):
    return idle_ms(record, GLUE)
