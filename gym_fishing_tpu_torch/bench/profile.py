"""Where a PPO iteration's time goes, read from a `torch.profiler` trace.

`ppo_breakdown` times whole train steps on fishing-v1, first without and
then under the profiler, and reports per iteration: the host-clock time of
each window, the device's busy time (the sum of kernel durations in the
trace) and its idle share of the unprofiled window (the profiler slows the
host's launches, not the kernels), the two ranges `train_step` names
(``train_step/rollout``: rollout + GAE + packing, one K4 launch in the
``full`` forms; ``train_step/update``: the epochs of minibatch updates) on
the host and as spans on the device, the kernel launches, and the kernels
that take the most device time. On a CPU device the trace holds no kernels
and the device fields are None.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.bench.throughput import _device_name, _finish, ppo_setup
from gym_fishing_tpu_torch.device import resolve

RANGES = ("train_step/rollout", "train_step/update")


def ppo_breakdown(num_envs: int = 16384, num_steps: int = 128, fused: str = "off",
                  fused_adam: bool = False, iters: int = 2, warmup: int = 1,
                  device=None, seed: int = 0, top: int = 6,
                  compute_dtype: str = "float32") -> dict:
    """Profile `iters` chained PPO iterations after `warmup` (see module doc)."""
    if fused not in ("off", "update", "full"):
        raise ValueError(f"unknown fused form {fused!r}")
    device = resolve(device)
    env, params, cfg, ts, gen, bstate = ppo_setup(num_envs, num_steps, 0.05, fused, fused_adam,
                                                  compute_dtype, device, seed)
    for _ in range(warmup):
        ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
        _finish(metrics["loss"])

    t0 = time.perf_counter()
    for _ in range(iters):
        ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
    _finish(metrics["loss"])
    wall_ms = (time.perf_counter() - t0) / iters * 1e3

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
        _finish(metrics["loss"])
        profiled_ms = (time.perf_counter() - t0) / iters * 1e3

    host, span, kernels = {}, {}, []
    for e in prof.key_averages():
        if e.key in RANGES:   # the CPU range, and its span on the device
            if e.device_type == DeviceType.CPU:
                host[e.key] = e.cpu_time_total / 1e3 / iters
            else:
                span[e.key] = e.device_time_total / 1e3 / iters
        elif e.device_type == DeviceType.CUDA:
            kernels.append(e)
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters or None
    return {
        "mode": f"ppo-{fused}" + ("+adam" if fused_adam else ""),
        "compute_dtype": compute_dtype,
        "device": _device_name(device),
        "num_envs": num_envs,
        "num_steps": num_steps,
        "iters": iters,
        "wall_ms_per_iter": wall_ms,
        "profiled_wall_ms_per_iter": profiled_ms,
        "device_busy_ms_per_iter": busy_ms,
        "idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_iter": sum(e.count for e in kernels) / iters,
        "ranges": {name: {"host_ms": host.get(name), "device_span_ms": span.get(name)}
                   for name in RANGES},
        "top_kernels": [
            {"name": e.key[:80], "ms_per_iter": e.self_device_time_total / 1e3 / iters,
             "launches_per_iter": e.count / iters}
            for e in kernels[:top]
        ],
    }
