"""K3's stage 1 (`wide_prep` and `ppo_grad_wide`, or `ppo_grad_tiles` on the
narrow path): the device time, as a union, of the kernels that
`KERNEL_STAGES["stage1"]` of kernels/ppo_update_kernel.py names, launched
inside the program's `train_step/update/k3` spans, per traced iteration, in
ms."""

from spans import update_stage_ms


def read(record):
    return update_stage_ms(record, "stage1")
