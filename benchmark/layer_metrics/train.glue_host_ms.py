"""The PPO step's glue on the host: the self time (duration less the spans
inside) of the program's glue spans (`spans.GLUE`: the rollout's prep and
state, the update's merge, advantage stats, write-back and metrics, the
step's metrics), per traced iteration, in ms."""

from spans import GLUE, self_ms


def read(record):
    return self_ms(record, GLUE)
