"""The recurrent update's replay: the device time, as a union, of the kernels
the program launches inside its `train_step/update/replay` spans (the
forward of both LSTMs and heads over each minibatch's segments, and the
loss; a CUDA graph's kernels where the learner replays one), per traced
iteration, in ms."""

from spans import _per_unit_ms, _trace, kernel_name, stage_device_us


def read(record):
    trace = _trace(record)
    if trace is None:
        return None
    kernels = {kernel_name(e) for e in trace.device}
    return _per_unit_ms(trace, stage_device_us(trace, "train_step/update/replay", kernels))
