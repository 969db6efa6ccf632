"""What the benchmark makes from `--seed` and hands to the program and to
the reference alike: the actor-critic's initial weights and the envs'
initial state. Made on the device, in a few large calls, from a
torch.Generator seeded from the run's seed."""

from __future__ import annotations

import math
from typing import Dict

import torch

MASK64 = (1 << 64) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one of the run's input streams."""
    return torch.Generator(device=device).manual_seed((seed * 0x9E3779B1 + stream) & MASK64)


def _orthogonal(out_f: int, in_f: int, gain: float, gen: torch.Generator, device):
    """An [out_f, in_f] matrix with orthonormal rows or columns, times
    `gain` (the sign of R's diagonal folded into Q, as torch's orthogonal
    initialiser does)."""
    rows, cols = max(out_f, in_f), min(out_f, in_f)
    a = torch.randn((rows, cols), generator=gen, device=device, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if out_f < in_f:
        q = q.T
    return (gain * q).contiguous()


def actor_critic_weights(seed: int, hidden: int, device) -> Dict[str, torch.Tensor]:
    """sb3's MlpPolicy initialisation for one observation field and a
    Gaussian head: orthogonal matrices (gain sqrt 2 in the hidden layers,
    0.01 in the action head, 1 in the value head), zero biases, log_std 0."""
    gen = generator(seed, 1, device)
    root2 = math.sqrt(2.0)
    z = lambda n: torch.zeros(n, device=device)  # noqa: E731
    w = {}
    for tower in ("pi", "v"):
        w[f"{tower}_d1.weight"] = _orthogonal(hidden, 1, root2, gen, device)
        w[f"{tower}_d1.bias"] = z(hidden)
        w[f"{tower}_d2.weight"] = _orthogonal(hidden, hidden, root2, gen, device)
        w[f"{tower}_d2.bias"] = z(hidden)
    w["pi_mean.weight"] = _orthogonal(1, hidden, 0.01, gen, device)
    w["pi_mean.bias"] = z(1)
    w["log_std"] = z(1)
    w["v_out.weight"] = _orthogonal(1, hidden, 1.0, gen, device)
    w["v_out.bias"] = z(1)
    return w


def env_state(seed: int, num_envs: int, env: Dict, device,
              years: str = "uniform") -> Dict[str, torch.Tensor]:
    """Every env at the reset stock and harvest, each at its own year of the
    episode: uniform over 0 .. Tmax - 1 (`years="uniform"`), so that resets
    are spread over the steps, or 0 (`"reset"`); the running return is 0
    and the running length is the year."""
    if years == "uniform":
        gen = generator(seed, 2, device)
        t = torch.randint(0, int(env["Tmax"]), (num_envs,), generator=gen, device=device,
                          dtype=torch.int32)
    elif years == "reset":
        t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
    else:
        raise ValueError(f"no such initial year: {years!r}")
    return {
        "stock": torch.full((num_envs,), float(env["init_state"]), device=device),
        "t": t,
        "harvest": torch.full((num_envs,), float(env["init_harvest"]), device=device),
        "ep_ret": torch.zeros((num_envs,), device=device),
        "ep_len": t.clone(),
    }
