"""Device idle time the K1 wrapper's host work leaves: the gaps whose
midpoint has `rollout_kernel/prep` as the innermost program span open on
the evaluator's thread, per traced call, in ms."""

from spans import idle_ms


def read(record):
    return idle_ms(record, ("rollout_kernel/prep",))
