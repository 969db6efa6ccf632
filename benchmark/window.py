"""Arithmetic over the measured window that the metric readers share. A
unit is one iteration or call: (start, end, work, failed), host clock in
seconds."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def closed_loop(traffic: Dict) -> None:
    """Refuse a traffic mix other than the closed loop of one client that
    the drivers run."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"the drivers run a closed loop of one client, not {traffic}")


def rate(units: List[List[float]]) -> Optional[float]:
    """Work completed per second over the whole window: all the units'
    work over the time from the first's start to the last's end."""
    if not units:
        return None
    span = units[-1][1] - units[0][0]
    return sum(u[2] for u in units) / span if span > 0 else None


def percentile_ms(units: List[List[float]], q: int) -> Optional[float]:
    """The q-th percentile of every unit's wall time, in milliseconds
    (statistics.quantiles, inclusive method)."""
    if len(units) < 2:
        return None
    cuts = statistics.quantiles([(u[1] - u[0]) * 1e3 for u in units], n=100,
                                method="inclusive")
    return cuts[q - 1]


def untraced(record: Dict) -> List[List[float]]:
    """The units outside the traced stretch (all of them in an untraced
    run)."""
    first, count = record.get("traced", (0, 0))
    return [u for i, u in enumerate(record["units"]) if not first <= i < first + count]


def per_unit_ms(record: Dict, range_name: str) -> Optional[float]:
    """Device milliseconds per traced unit inside the host range
    `range_name`; None without a trace or without that range."""
    trace = record.get("trace")
    if trace is None or not trace.n_units:
        return None
    us = trace.range_device_us(range_name)
    return None if not us else us / 1e3 / trace.n_units


def idle_pct(record: Dict) -> Optional[float]:
    """The device's idle share of the traced stretch, in percent."""
    trace = record.get("trace")
    if trace is None or trace.window_us <= 0:
        return None
    idle = 100.0 * (1.0 - trace.busy_us() / trace.window_us)
    return idle if idle > 0 else None
