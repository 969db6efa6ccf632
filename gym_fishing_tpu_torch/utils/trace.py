"""The port's one way to mark a span of host work: `span(name)`.

Under a recording profiler (`torch.profiler.profile`, or
`torch.autograd.profiler.emit_nvtx` for Nsight) a span is a
`record_function` range: it lands in the profiler's trace as a
``user_annotation`` event on the same clock as the device operations, and
a device operation belongs to the span whose interval holds the launch
that queued it (matched by correlation id). With no profiler recording, a
span is one shared null context: building a `record_function` costs
host time on every call even then (its own op dispatch), the gate below
one flag read.

Spans nest by containment on one thread; a span belongs to the iteration
of the ``train_step`` span around it, which is the iteration's identifier
(a range's arguments do not reach the exported trace, and a number in the
name would break a match by name).
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking `name` in the profiler's trace, or the
    shared null context when no profiler is recording (checked at every
    call)."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
