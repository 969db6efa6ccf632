"""Weak scaling: env-steps/s at a fixed number of envs per rank, 1 -> N ranks.

Counterpart of ``gym_fishing_tpu/bench/scaling.py``. The engine
(`batched_step` with auto-reset under the escapement policy on
fishing-v1, sigma 0.05) runs on every rank's own envs; env shards never
communicate, so scaling is limited only by what the ranks share (the host,
the card's power, a node's links). Each count of ranks is one spawn of
that many processes (`shard.launch.spawn_ranks`): on the card one rank per
GPU (NCCL), on the CPU gloo ranks. The ranks start their timing together
after an all-reduce, each times chained iterations with a
``torch.cuda.synchronize()`` before every clock read
(`bench.throughput.measure`'s engine timing), and the count's throughput
is all ranks' env-steps over the slowest rank's seconds.

efficiency(N) = throughput(N) / (N * throughput(1)).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gym_fishing_tpu_torch.device import resolve


def _rank_seconds(mesh, job: dict) -> float:
    from gym_fishing_tpu_torch.bench.throughput import _time_engine
    from gym_fishing_tpu_torch.shard.mesh import fold_rank

    mesh.all_reduce(torch.zeros(1, device=mesh.device))   # start together
    seconds, _ = _time_engine("fishing-v1", job["envs"], job["num_steps"], job["iters"], 2, 0.05,
                              mesh.device, fold_rank(job["seed"], mesh.rank))
    return seconds


def weak_scaling(envs_per_device: int = 1 << 14, num_steps: int = 64, iters: int = 5,
                 device_counts: Optional[List[int]] = None, device=None) -> dict:
    """Throughput at `envs_per_device` envs per rank as the rank count
    grows. On the card (`device` None or CUDA) rank r runs on ``cuda:r`` and
    the counts default to every power of two up to the visible GPUs; on the
    CPU (``device="cpu"``) the counts default to [1]."""
    from gym_fishing_tpu_torch.bench.throughput import _device_name
    from gym_fishing_tpu_torch.shard.launch import spawn_ranks

    device = resolve(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if device_counts is None:
        device_counts = ([c for c in (1, 2, 4, 8, 16, 32) if c <= n_cards]
                         if device.type == "cuda" else [1])
    if device.type == "cuda" and max(device_counts) > n_cards:
        raise ValueError(f"{max(device_counts)} ranks need as many GPUs; {n_cards} visible")
    job = {"envs": envs_per_device, "num_steps": num_steps, "iters": iters, "seed": 0}
    results = {}
    for n in device_counts:
        # one card per rank: the spawned rank r takes cuda:r through LOCAL_RANK
        dev = "cpu" if device.type == "cpu" else None
        seconds = spawn_ranks("gym_fishing_tpu_torch.bench.scaling:_rank_seconds", n, job,
                              device=dev, timeout_s=600)
        results[n] = n * envs_per_device * num_steps * iters / max(seconds)
    base = results[device_counts[0]] / device_counts[0]
    return {
        "throughput": results,
        "efficiency": {n: results[n] / (n * base) for n in device_counts},
        "envs_per_device": envs_per_device,
        "device": _device_name(device),
    }
