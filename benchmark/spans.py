"""What the layer metrics read from the program's own spans in a traced run.

The program marks its host work with `gym_fishing_tpu_torch/utils/trace.py::
span`: ``user_annotation`` events of the profiler's trace, on the clock of
the device operations, nested by containment on one thread (a span belongs
to the iteration of the ``train_step`` span around it). A program span is
such an event on the thread that ran the units whose name is not the
harness's (``bench/...``). Everything here reads only the public fields of
`devtrace.Trace` (`host`, `device`, `launch`, `window`, `units`) and returns
None where the spans it reads are not in the trace, or no device operation
is, as in a run of a program that has no such span.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional

from devtrace import clip, merge, union_length

HARNESS = "bench/"
# the PPO step's glue: its host work around K4 and K3, as spans with no kernel
GLUE = ("train_step/rollout/prep", "train_step/rollout/state", "train_step/update/merge",
        "train_step/update/adv_stats", "train_step/update/writeback",
        "train_step/update/metrics", "train_step/metrics")


def kernel_name(event: Dict) -> str:
    """A device operation's function name without its return type,
    namespace, template arguments and parameters: ``void
    ppo_grad_wide<512, true, false>(GradParams, ...)`` -> ``ppo_grad_wide``."""
    head = event.get("name", "").split("(", 1)[0].split("<", 1)[0].split()
    return head[-1].rsplit("::", 1)[-1] if head else ""


def _end(e: Dict) -> float:
    return e["ts"] + e["dur"]


def program_spans(trace) -> List[Dict]:
    """The program's spans inside the window on the units' thread, by start."""
    if trace is None or not trace.units:
        return []
    tid, (lo, hi) = trace.units[0].get("tid"), trace.window
    return sorted((e for e in trace.host
                   if e.get("cat") == "user_annotation" and e.get("tid") == tid
                   and not e.get("name", "").startswith(HARNESS) and lo <= e["ts"] < hi),
                  key=lambda e: (e["ts"], -e["dur"]))


def _per_unit_ms(trace, us: Optional[float]) -> Optional[float]:
    return None if us is None else us / 1e3 / trace.n_units


def stage_device_us(trace, span_name: str, kernels: Iterable[str]) -> Optional[float]:
    """Device time (the union of their intervals) of the kernels named
    `kernels` whose launch, matched by correlation id, lies inside a
    `span_name` span on the same thread; None without such spans or without
    any device operation launched inside them."""
    spans = [s for s in program_spans(trace) if s["name"] == span_name]
    if not spans:
        return None
    tid = spans[0].get("tid")
    starts = [s["ts"] for s in spans]
    inside = set()
    for corr, launch in trace.launch.items():
        j = bisect.bisect_right(starts, launch["ts"]) - 1
        if launch.get("tid") == tid and j >= 0 and launch["ts"] <= _end(spans[j]):
            inside.add(corr)
    ops = [e for e in trace.device if (e.get("args") or {}).get("correlation") in inside]
    if not ops:
        return None
    names = set(kernels)
    return union_length([(e["ts"], _end(e)) for e in ops
                         if e.get("cat") == "kernel" and kernel_name(e) in names])


def self_us(trace, names: Iterable[str]) -> Optional[float]:
    """Host self time of the spans called `names`: each one's duration less
    the part of it that the spans inside it cover, summed; None without
    such spans."""
    spans = program_spans(trace)
    names = set(names)
    starts = [s["ts"] for s in spans]
    total, found = 0.0, False
    for i, s in enumerate(spans):
        if s["name"] not in names:
            continue
        found = True
        hi = bisect.bisect_right(starts, _end(s))
        inner = [(c["ts"], _end(c)) for c in spans[i + 1:hi] if _end(c) <= _end(s)]
        total += s["dur"] - union_length(inner)
    return total if found else None


def idle_us_under(trace, names: Iterable[str]) -> Optional[float]:
    """The window's device idle time whose gap has, at its midpoint, one of
    the spans called `names` as the innermost program span open on the
    units' thread (the host's operator and runtime events are not spans);
    None without such spans or without any device operation."""
    spans = program_spans(trace)
    names = set(names)
    if not any(s["name"] in names for s in spans) or not trace.device:
        return None
    lo, hi = trace.window
    busy = merge(clip([(e["ts"], _end(e)) for e in trace.device], lo, hi))
    gaps, cursor = [], lo
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if hi > cursor:
        gaps.append((cursor, hi))
    starts = [s["ts"] for s in spans]
    total = 0.0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        # spans nest, so the latest begun by then that is still open is the innermost
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if _end(spans[j]) > mid:
                if spans[j]["name"] in names:
                    total += e - s
                break
    return total


def _trace(record: Dict):
    trace = record.get("trace")
    return trace if trace is not None and trace.n_units else None


def update_stage_ms(record: Dict, stage: str) -> Optional[float]:
    """Device ms a traced iteration of K3's `stage`: the kernels that the
    program's `KERNEL_STAGES` (kernels/ppo_update_kernel.py) gives it,
    launched inside `train_step/update/k3`."""
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel

    stages = getattr(ppo_update_kernel, "KERNEL_STAGES", None)
    trace = _trace(record)
    if trace is None or stages is None:
        return None
    return _per_unit_ms(trace, stage_device_us(trace, "train_step/update/k3", stages[stage]))


def self_ms(record: Dict, names: Iterable[str]) -> Optional[float]:
    """Host self ms of the spans `names` per traced unit."""
    trace = _trace(record)
    return None if trace is None else _per_unit_ms(trace, self_us(trace, names))


def idle_ms(record: Dict, names: Iterable[str]) -> Optional[float]:
    """Device idle ms under the spans `names` per traced unit."""
    trace = _trace(record)
    return None if trace is None else _per_unit_ms(trace, idle_us_under(trace, names))
