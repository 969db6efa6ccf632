"""Evaluation helpers: rollouts -> tidy DataFrames, policy-function estimation.

Counterpart of ``gym_fishing_tpu/analysis/simulate.py`` (reference parity:
gym_fishing's ``simulate_mdp(env, model, reps)`` and ``estimate_policyfn(env,
model, reps, n)``). Output schema, the reference's tidy format: columns
``[time, state, action, reward, rep]``, state the *unscaled* stock and
action the raw env action.

All `reps` run as one batch. A model with a pure ``act`` function (the
baseline policies, `PPOPolicy`) takes the device path: a loop of
`batched_step(autoreset=False)` on the params' device whose stacked
trajectory crosses to the host once, at the end. A model with only
``.predict`` (sb3-style) takes the host loop, which still steps the batch
on the device. pandas is imported where the DataFrame is built, so the
device path (`_simulate_steps`) runs where pandas is not installed.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from gym_fishing_tpu_torch.batch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.spaces.scaling import decode_action, stock_from_obs


def _traj_to_df(env, params, obs, actions, rewards, Tmax: int, reps: int):
    """Stacked [T, reps, ...] tensors -> tidy long DataFrame."""
    import pandas as pd

    obs = torch.as_tensor(obs)
    if obs.shape[-1] > 1:
        # windowed observations (ObsStackEnv): the latest entry is current
        obs = obs[..., -1:]
    stock = stock_from_obs(params, obs.to(params.device))                 # [T, reps]
    actions = torch.as_tensor(actions)
    if actions.dim() == 3:  # continuous (T, reps, 1)
        actions = actions[..., 0]
    rewards = torch.as_tensor(rewards)
    # one transfer to the host: float64 holds every float32 value and every
    # action index exactly
    host = torch.stack([stock.double(), actions.to(stock.device).double(),
                        rewards.to(stock.device).double()]).cpu().numpy()
    np_dtype = lambda t: np.dtype(str(t.dtype).replace("torch.", ""))  # noqa: E731
    T = host.shape[1]
    time = np.tile(np.arange(T)[:, None], (1, reps))
    rep = np.tile(np.arange(reps)[None, :], (T, 1))
    return pd.DataFrame(
        {
            "time": time.ravel(order="F"),
            "state": host[0].astype(np_dtype(stock)).ravel(order="F"),
            "action": host[1].astype(np_dtype(actions)).ravel(order="F"),
            "reward": host[2].astype(np_dtype(rewards)).ravel(order="F"),
            "rep": rep.ravel(order="F"),
        }
    )


def simulate_mdp(
    env: Env,
    model: Any,
    reps: int = 1,
    params: Optional[EnvParams] = None,
    seed: int = 0,
    device=None,
):
    """Roll `reps` episodes of `model` in `env`; return a tidy DataFrame.

    `model` is anything with `.predict(obs, state=...) -> (action, state)`
    (sb3 or the port's policies). Pure-`act` models take the device path.
    Without `params` the env's defaults on `device` (default: the card)
    are used; the noise comes from a generator on the params' device seeded
    with `seed`.
    """
    if params is None:
        params = env.params(device=device)
    Tmax = int(torch.as_tensor(params.Tmax))
    generator = torch.Generator(device=params.device).manual_seed(seed)

    if hasattr(model, "act"):
        return _simulate_fused(env, model, reps, params, Tmax, generator)
    obs, actions, rewards = _simulate_host_steps(env, model, reps, params, Tmax, generator)
    return _traj_to_df(env, params, obs, actions, rewards, Tmax, reps)


def _step_noise(noise, t: int):
    return noise[t] if isinstance(noise, torch.Tensor) else noise


def _simulate_host_steps(env, model, reps: int, params: EnvParams, Tmax: int,
                         noise: Union[torch.Tensor, torch.Generator, None] = None):
    """The host loop (sb3-style models): the batch steps on the params'
    device, the policy's `.predict` on numpy. Returns stacked (obs, actions,
    rewards) as CPU tensors [Tmax, reps, ...]; `noise` as in
    `_simulate_steps`."""
    continuous = env.config.scheme == "continuous"
    state = batched_reset(env, params, reps)
    obs = env.get_obs(params, state.env).cpu().numpy()
    pstate = None
    obs_l, act_l, rew_l = [], [], []
    for t in range(Tmax):
        action, pstate = model.predict(obs, state=pstate)
        a_dev = torch.as_tensor(np.asarray(action), device=params.device)
        if not continuous:
            a_dev = a_dev.to(torch.int32)
        state, ts = batched_step(env, params, state, a_dev, _step_noise(noise, t),
                                 autoreset=False)
        obs_l.append(obs)
        act_l.append(np.asarray(action))
        rew_l.append(ts.reward.cpu().numpy())
        obs = ts.obs.cpu().numpy()
    return tuple(torch.from_numpy(np.stack(x)) for x in (obs_l, act_l, rew_l))


def _simulate_steps(env, model, reps: int, params: EnvParams, Tmax: int,
                    noise: Union[torch.Tensor, torch.Generator, None] = None):
    """The device path's tensor part: `Tmax` steps of `model.act` and
    `batched_step(autoreset=False)` -> stacked (obs, actions, rewards), each
    [Tmax, reps, ...] on the params' device. `noise` is a generator or a
    [Tmax, 2, reps] tensor of the per-step (xi, eta) draws. Under the
    relative scheme the carried harvest follows the decode, as the env's."""
    state = batched_reset(env, params, reps)
    carried = None
    if env.config.scheme == "relative":
        h0 = torch.as_tensor(params.init_harvest, dtype=params.dtype, device=params.device)
        carried = h0.expand(reps)
    obs = env.get_obs(params, state.env)
    obs_l, act_l, rew_l = [], [], []
    with torch.no_grad():
        for t in range(Tmax):
            action = model.act(obs, carried)
            if carried is not None:
                _, carried = decode_action(env.config, params, carried, action)
            state, ts = batched_step(env, params, state, action, _step_noise(noise, t),
                                     autoreset=False)
            obs_l.append(obs)
            act_l.append(action)
            rew_l.append(ts.reward)
            obs = ts.obs
    return torch.stack(obs_l), torch.stack(act_l), torch.stack(rew_l)


def _simulate_fused(env, model, reps, params, Tmax, generator):
    """The device path: the whole simulation on the params' device, one
    transfer of the stacked trajectory to the host."""
    obs, actions, rewards = _simulate_steps(env, model, reps, params, Tmax, generator)
    return _traj_to_df(env, params, obs, actions, rewards, Tmax, reps)


def estimate_policyfn(
    env: Env,
    model: Any,
    reps: int = 1,
    n: int = 50,
    params: Optional[EnvParams] = None,
    harvest: Optional[float] = None,
    device=None,
):
    """Evaluate the policy over a grid of states (reference parity).

    Returns tidy columns ``[state, action, rep]``: the policy's action at
    each of `n` stock levels in [0, 2K], repeated `reps` times (stochastic
    policies vary per rep; closed-form ones don't).

    For the 3-action *relative* decode scheme the policy is a function of
    (stock, carried harvest), not of stock alone; `harvest` fixes the carried
    harvest level the grid is conditioned on (default: params.init_harvest).
    It is passed to `.predict` as the sb3 recurrent `state`, which is how the
    baseline policies carry it. Ignored for the other schemes.
    """
    import pandas as pd

    if params is None:
        params = env.params(device=device)
    stocks, actions = _policy_grid(env, model, reps, n, params, harvest)
    return pd.concat([pd.DataFrame({"state": stocks, "action": a, "rep": rep})
                      for rep, a in enumerate(actions)], ignore_index=True)


def _policy_grid(env, model, reps: int, n: int, params: EnvParams,
                 harvest: Optional[float] = None):
    """`estimate_policyfn`'s numbers: (the n stocks, the actions [reps, n]).
    A windowed env (ObsStackEnv) sees each stock in every slot of its
    window, as after k steps at that stock."""
    K = float(torch.as_tensor(params.K))
    stocks = np.linspace(0.0, 2.0 * K, n)
    obs_grid = np.repeat(np.clip(stocks / K - 1.0, -1.0, 1.0)[:, None],
                         env.observation_space.shape[0], axis=1)
    pstate0 = None
    if env.config.scheme == "relative":
        init_h = torch.as_tensor(params.init_harvest).cpu()
        h = float(init_h) if harvest is None else float(harvest)
        pstate0 = np.full((n,), h, dtype=init_h.numpy().dtype)
    actions = []
    for _ in range(reps):
        action, _ = model.predict(obs_grid, state=pstate0)
        a = np.asarray(action)
        actions.append(a[:, 0] if a.ndim == 2 else a)
    return stocks, actions
