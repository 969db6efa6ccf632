"""The K1 wrapper's host work before its launch: the duration of the
program's `rollout_kernel/prep` span (argument checks, the env fields read
to the host, round keys, the parameter struct, the outputs' allocation, the
library's lookup; no span inside it), per traced call, in ms."""

from spans import self_ms


def read(record):
    return self_ms(record, ("rollout_kernel/prep",))
