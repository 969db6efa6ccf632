"""The engine tier in the recurrent PPO rollout: the device time, as a union,
of the kernels the program launches inside its `train_step/rollout/env`
spans (`batch.batched_step`: the env's step and auto-reset, and the step's
record; a CUDA graph's kernels where the learner replays one), per traced
iteration, in ms. The graphs' copies of whole buffers are memcpy nodes, not
kernels, and are left out."""

from spans import _per_unit_ms, _trace, kernel_name, stage_device_us


def read(record):
    trace = _trace(record)
    if trace is None:
        return None
    kernels = {kernel_name(e) for e in trace.device}
    return _per_unit_ms(trace, stage_device_us(trace, "train_step/rollout/env", kernels))
