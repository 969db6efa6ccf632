"""The traced run: a torch.profiler trace over a steady stretch of the
window, and what the layer metrics read from it.

The driver marks every unit of work (an iteration, a call) with the range
``bench/unit``; the stretch is the units from `first` to `first + count -
1`. The trace is exported to a file under the run's temporary directory,
read back, and the file deleted. Device times are taken as the union of
the intervals of device operations (kernels, copies, fills), so that work
that overlaps is counted once. A device operation belongs to a host range
when the launch that queued it (runtime or driver API call, matched by its
correlation id) lies inside that range on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

UNIT = "bench/unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Total length covered by `intervals` (start, end), overlaps once."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def clip(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Tracer:
    """Starts the profiler before unit `first` and stops it after unit
    `first + count - 1`; inactive when `enabled` is False."""

    def __init__(self, enabled: bool, first: int, count: int):
        self.enabled, self.first, self.count = enabled, first, count
        self.prof = None
        self.trace: Optional["Trace"] = None

    def before(self, i: int) -> None:
        if self.enabled and i == self.first:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=activities)
            self.prof.__enter__()

    def after(self, i: int) -> None:
        if self.prof is not None and i == self.first + self.count - 1:
            self.prof.__exit__(None, None, None)

    def pending(self, i: int) -> bool:
        """Whether the stretch is still to come or open after unit `i`: the
        window runs on until it has closed."""
        return self.enabled and i < self.first + self.count - 1

    def finish(self) -> Optional["Trace"]:
        """Read the trace (after the window): None if the stretch was never
        reached."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.trace = Trace(json.load(f))
        finally:
            os.unlink(path)
        self.prof = None
        return self.trace


class Trace:
    """The events of one exported trace, in microseconds."""

    def __init__(self, doc: Dict):
        events = doc["traceEvents"] if isinstance(doc, dict) else doc
        self.device: List[Dict] = []
        self.launch: Dict[int, Dict] = {}
        self.host: List[Dict] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = e
                self.host.append(e)
            elif cat in ("user_annotation", "cpu_op", "python_function"):
                self.host.append(e)
        units = [e for e in self.host if e.get("name") == UNIT]
        units.sort(key=lambda e: e["ts"])
        self.units = units
        self.window: Interval = ((units[0]["ts"], units[-1]["ts"] + units[-1]["dur"])
                                 if units else (0.0, 0.0))

    # ------------------------------------------------------------ window
    @property
    def n_units(self) -> int:
        return len(self.units)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def device_intervals(self, ops: Optional[Sequence[Dict]] = None) -> List[Interval]:
        ops = self.device if ops is None else ops
        return clip([(e["ts"], e["ts"] + e["dur"]) for e in ops], *self.window)

    def busy_us(self) -> float:
        """Device time inside the window: the union of its operations."""
        return union_length(self.device_intervals())

    def kernels_in_window(self) -> List[Dict]:
        lo, hi = self.window
        return [e for e in self.device if e.get("cat") == "kernel" and lo <= e["ts"] < hi]

    # ------------------------------------------------------------ ranges
    def range_device_us(self, name: str) -> Optional[float]:
        """Device time of the operations launched inside every host range
        called `name` within the window (their union); None if the range or
        its operations are not in the trace."""
        lo, hi = self.window
        ranges = [e for e in self.host if e.get("name") == name and lo <= e["ts"] < hi]
        if not ranges:
            return None
        by_tid = defaultdict(list)
        for r in ranges:
            by_tid[r.get("tid")].append((r["ts"], r["ts"] + r["dur"]))
        corr = set()
        for c, launch in self.launch.items():
            for s, e in by_tid.get(launch.get("tid"), ()):
                if s <= launch["ts"] <= e:
                    corr.add(c)
                    break
        ops = [e for e in self.device if (e.get("args") or {}).get("correlation") in corr]
        return union_length([(e["ts"], e["ts"] + e["dur"]) for e in ops]) if ops else None

    # ------------------------------------------------------------ breakdown
    def top_device_ops(self, n: int = 10) -> List[List]:
        total = defaultdict(float)
        lo, hi = self.window
        for e in self.device:
            if lo <= e["ts"] < hi:
                total[e.get("name", "?")[:120]] += e["dur"] * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The window's device idle time by what the host was doing in the
        middle of each gap: the innermost host event then open on the
        thread that ran the units, or, between events, "after" the last
        one that had ended; the largest totals first."""
        lo, hi = self.window
        busy = merge(self.device_intervals())
        gaps, cursor = [], lo
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if hi > cursor:
            gaps.append((cursor, hi))
        tid = self.units[0].get("tid") if self.units else None
        host = sorted((e for e in self.host if e.get("tid") == tid and e.get("name") != UNIT),
                      key=lambda h: h["ts"])
        starts = [h["ts"] for h in host]
        total = defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            what, ended = None, None
            # the last event begun by then that is still open is the innermost
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                h = host[j]
                end = h["ts"] + h["dur"]
                if end > mid:
                    what = h["name"][:120]
                    break
                if ended is None or end > ended[0]:
                    ended = (end, h["name"][:110])
                if mid - h["ts"] > 1e6:
                    break
            if what is None:
                what = f"after {ended[1]}" if ended else "host: no event"
            total[what] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
