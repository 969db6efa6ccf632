"""K3's stage 2 (`reduce_rows`): the device time, as a union, of the kernels
that `KERNEL_STAGES["reduce"]` of kernels/ppo_update_kernel.py names,
launched inside the program's `train_step/update/k3` spans, per traced
iteration, in ms."""

from spans import update_stage_ms


def read(record):
    return update_stage_ms(record, "reduce")
