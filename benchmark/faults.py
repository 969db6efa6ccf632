"""Faults planted under the timed path, for the tests and the calibration
that show the check catches them. Each is a context manager that patches
the program's module in place and restores it on exit; none is used by a
run.

- `unchanged`: a step that returns its state unchanged (the work is done
  and thrown away).
- `half_batch`: half of the batch left out and the mean taken over the
  rest (PPO: half of each minibatch's tiles; stepping: half of the envs,
  the reward sum doubled).
- `altered`: an answer altered where it is produced (PPO: the minibatch
  metric sums K3 returns, 5% high; stepping: one env's reward).
"""

from __future__ import annotations

import contextlib
import copy

import torch

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(module, name, replacement):
    original = getattr(module, name)
    setattr(module, name, replacement(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def plant(driver_name: str, fault: str):
    """The context manager that plants `fault` under driver `driver_name`."""
    if fault not in FAULTS:
        raise ValueError(f"no such fault: {fault!r}")
    return {"ppo_train": _ppo, "k1_stepping": _k1}[driver_name](fault)


def _ppo(fault: str):
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused

    if fault == "unchanged":
        def wrap(step):
            def train_step(env, env_params, cfg, ts, bstate, *a, **kw):
                _, _, metrics = step(env, env_params, cfg, copy.deepcopy(ts), bstate, *a, **kw)
                return ts, bstate, metrics
            return train_step
        return _patched(ppo, "train_step", wrap)

    def wrap_kernel(kernel):
        def fused_minibatch_grad_adam(data, tile_order, *a, **kw):
            if fault == "half_batch":
                w, m, v, met = kernel(data, tile_order[: max(1, tile_order.shape[0] // 2)],
                                      *a, **kw)
                return w, m, v, met * (tile_order.shape[0] / max(1, tile_order.shape[0] // 2))
            w, m, v, met = kernel(data, tile_order, *a, **kw)
            return w, m, v, met * 1.05
        return fused_minibatch_grad_adam
    return _patched(ppo_fused, "fused_minibatch_grad_adam", wrap_kernel)


def _k1(fault: str):
    from gym_fishing_tpu_torch.kernels import rollout_kernel

    def wrap(rollout):
        def faulty(stock, t, params, *a, ep_ret=None, harvest=None, **kw):
            if fault == "half_batch":
                half = stock.shape[0] // 2
                out = rollout(stock[:half].contiguous(), t[:half].contiguous(), params, *a,
                              ep_ret=None if ep_ret is None else ep_ret[:half].contiguous(),
                              harvest=None if harvest is None else harvest[:half].contiguous(),
                              **kw)
                rest = lambda x, y: torch.cat([x, y[half:]])  # noqa: E731
                zeros = torch.zeros_like(stock[half:])
                reward = torch.cat([out.reward * 2.0, zeros])
                return out._replace(
                    stock=rest(out.stock, stock), t=rest(out.t, t),
                    ep_ret=rest(out.ep_ret, ep_ret if ep_ret is not None else zeros * 0),
                    harvest=rest(out.harvest, harvest if harvest is not None else zeros),
                    reward=reward, ep_ret_sum=torch.cat([out.ep_ret_sum, zeros]),
                    ep_count=torch.cat([out.ep_count, torch.zeros_like(t[half:])]))
            out = rollout(stock, t, params, *a, ep_ret=ep_ret, harvest=harvest, **kw)
            if fault == "unchanged":
                return out._replace(stock=stock, t=t,
                                    ep_ret=ep_ret if ep_ret is not None else out.ep_ret)
            reward = out.reward.clone()
            reward[0] += 1.0
            return out._replace(reward=reward)
        return faulty
    return _patched(rollout_kernel, "rollout", wrap)
