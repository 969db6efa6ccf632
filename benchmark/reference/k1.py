"""Plain reference of stepping fishing-v1 under the escapement rule: the
semantics of gym_fishing's `fishing-v1` (logistic growth, continuous quota,
additive process noise, auto-reset at Tmax) stepped for B envs at once, in
float32 or in a lower precision for the control.

Draws: Philox4x32-10 under the 64-bit key `seed`, counter (env, `offset` +
k // 4); one block gives four N(0, 1) by Box-Muller, one a step. A call of
T steps uses T / 4 blocks, so the next call starts at `offset` + T / 4.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import philox


def draws_per_call(num_steps: int) -> int:
    """Philox blocks one env uses in a call of `num_steps` steps."""
    return (num_steps + 3) // 4


def escapement_target(env: Dict) -> float:
    """x*, the stock that maximises the logistic surplus r x (1 - x / K):
    K / 2."""
    return 0.5 * env["K"]


def step_call(env: Dict, state: Dict[str, torch.Tensor], num_steps: int, seed: int,
              offset: int, dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One call of `num_steps` steps from `state` (stock, t, ep_ret, harvest,
    each (B,)); returns the end state with the call's per-env reward, the
    sum of completed episodes' returns and their count. `dtype` is the
    arithmetic's precision: float32 is the reference, a lower one the
    control (every intermediate rounded to it)."""
    dev = state["stock"].device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev).to(dtype)  # noqa: E731
    r, K, sigma = f(env["r"]), f(env["K"]), f(env["sigma"])
    price, cost, pen = f(env["price"]), f(env["cost"]), f(env["collapse_penalty"])
    init_state, x_star, zero = f(env["init_state"]), f(escapement_target(env)), f(0.0)
    tmax = int(env["Tmax"])
    x = state["stock"].to(dtype)
    t = state["t"].clone()
    cur = state["ep_ret"].to(dtype)
    rew = torch.zeros_like(x)
    eps = torch.zeros_like(x)
    epc = torch.zeros_like(t)
    env_idx = torch.arange(x.shape[0], dtype=torch.int64, device=dev)
    draws = ()
    for k in range(num_steps):
        if k % 4 == 0:
            u = philox.uniforms(seed, offset + k // 4, env_idx)
            draws = philox.box_muller(u[0], u[1]) + philox.box_muller(u[2], u[3])
        z = draws[k % 4].to(dtype)
        quota = torch.clamp(x - x_star, min=0.0)
        hv = torch.minimum(x, quota)
        x1 = x - hv
        mu = x1 + r * x1 * (1.0 - x1 / K)
        x2 = mu + sigma * x1 * z
        x_next = torch.where(x2 < 0.0, zero, x2)
        collapsed = x_next <= 0.0
        step_rew = price * hv - cost * quota * quota - torch.where(collapsed, pen, zero)
        rew = rew + step_rew
        cur = cur + step_rew
        t_next = t + 1
        done = (t_next >= tmax) | collapsed
        eps = eps + torch.where(done, cur, zero)
        epc = epc + done.to(torch.int32)
        cur = torch.where(done, zero, cur)
        x = torch.where(done, init_state, x_next)
        t = torch.where(done, torch.zeros_like(t_next), t_next)
    f32 = torch.float32
    return {"stock": x.to(f32), "t": t, "ep_ret": cur.to(f32), "harvest": state["harvest"],
            "reward": rew.to(f32), "ep_ret_sum": eps.to(f32), "ep_count": epc}
