"""K3's dW2c (`dw2c_split_f32` or `dw2c_split_bf16`, the wide path only): the
device time, as a union, of the kernels that `KERNEL_STAGES["dw2c"]` of
kernels/ppo_update_kernel.py names, launched inside the program's
`train_step/update/k3` spans, per traced iteration, in ms."""

from spans import update_stage_ms


def read(record):
    return update_stage_ms(record, "dw2c")
