"""K4's call: the device time, as a union, of every kernel launched inside
the program's `train_step/rollout/k4` spans (the policy-rollout kernel, on
the wide path its weight layout and statistics, and the wrapper's merge of
the weights), per traced iteration, in ms."""

from spans import _trace, kernel_name, stage_device_us


def read(record):
    trace = _trace(record)
    if trace is None:
        return None
    names = {kernel_name(e) for e in trace.device if e.get("cat") == "kernel"}
    us = stage_device_us(trace, "train_step/rollout/k4", names)
    return None if us is None else us / 1e3 / trace.n_units
