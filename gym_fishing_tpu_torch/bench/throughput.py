"""Throughput of the port: stepping (the engine and the fused rollout
kernel) and the PPO train step.

Counterpart of ``gym_fishing_tpu/bench/throughput.py``: `measure` (its
`measure` with ``store_trajectory=False`` and `_measure_pallas`) times
batched fishing-v1 under the escapement policy with auto-reset;
`measure_ppo_train` times whole PPO iterations.

Timing: every timed window chains each iteration on the previous one's
outputs, and ends inside the window with ``torch.cuda.synchronize()`` and a
host fetch (``.item()``) of one value those iterations produced, so the
window bounds the real execution and not just the enqueue.

A result names the device it ran on. The default device is the card, and a
missing card raises rather than falling back to the CPU.
"""

from __future__ import annotations

import time

import torch

from gym_fishing_tpu_torch.agents import ppo
from gym_fishing_tpu_torch.agents.policies import escapement
from gym_fishing_tpu_torch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.kernels import rollout_kernel
from gym_fishing_tpu_torch.registry import make

# BASELINE.json's north-star target, env-steps/s per chip: the bar the
# reference set itself, not a measurement of this port
BASELINE_STEPS_PER_S = 50_000_000.0


def _finish(x: torch.Tensor) -> float:
    """Wait for the device and fetch one value of `x` to the host."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[0].item())


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def measure(
    env_id: str = "fishing-v1",
    num_envs: int = 1 << 21,
    num_steps: int = 512,
    iters: int = 10,
    warmup: int = 3,
    sigma: float = 0.05,
    mode: str = "engine",
    device=None,
    seed: int = 0,
) -> dict:
    """Time `iters` chained rollouts of `num_steps` steps of `num_envs` envs.

    ``mode="engine"``: the batched engine (`batched_step` with auto-reset and
    a `torch.Generator` on the device), the escapement policy on the obs,
    with the reward summed on the device. ``mode="kernel"``: the fused CUDA
    rollout kernel (`kernels.rollout_kernel.rollout`) under the same policy,
    chaining stock, t, the in-flight return and the Philox offset.
    """
    device = resolve(device)
    if mode == "engine":
        seconds, reward = _time_engine(env_id, num_envs, num_steps, iters, warmup, sigma,
                                       device, seed)
    elif mode == "kernel":
        seconds, reward = _time_kernel(env_id, num_envs, num_steps, iters, warmup, sigma,
                                       device, seed)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    total = num_envs * num_steps * iters
    return {
        "env_id": env_id,
        "mode": mode,
        "device": _device_name(device),
        "num_envs": num_envs,
        "num_steps": num_steps,
        "iters": iters,
        "seconds": seconds,
        "ms_per_call": seconds / iters * 1e3,
        "steps_per_s": total / seconds,
        "reward_sum": reward,  # summed over all envs and steps of the last call
    }


def _time_engine(env_id, num_envs, num_steps, iters, warmup, sigma, device, seed):
    env, params = make(env_id, sigma=sigma, device=device)
    pol = escapement(env, params)
    gen = torch.Generator(device=device).manual_seed(seed)

    def run(state):
        obs = env.get_obs(params, state.env)
        total = torch.zeros((), dtype=params.dtype, device=device)
        for _ in range(num_steps):
            state, ts = batched_step(env, params, state, pol.act(obs), gen)
            obs = ts.obs
            total = total + ts.reward.sum()
        return state, total

    state = batched_reset(env, params, num_envs, device)
    for _ in range(warmup):
        state, total = run(state)
    if warmup:
        _finish(total)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, total = run(state)
    reward = _finish(total)
    return time.perf_counter() - t0, reward


def _time_kernel(env_id, num_envs, num_steps, iters, warmup, sigma, device, seed):
    env, params = make(env_id, sigma=sigma, device="cpu")  # host params: read once per launch
    x_star = float(escapement(env, params).x_star)
    cfg = env.config
    stock = torch.full((num_envs,), float(params.init_state), dtype=torch.float32, device=device)
    t = torch.zeros((num_envs,), dtype=torch.int32, device=device)
    ep = torch.zeros((num_envs,), dtype=torch.float32, device=device)
    harvest = torch.full_like(stock, float(params.init_harvest))
    offset = 0

    def run(stock, t, ep, harvest, offset):
        out = rollout_kernel.rollout(
            stock, t, params, "escapement", x_star, num_steps, growth=cfg.growth,
            noise_form=cfg.noise_form, scheme=cfg.scheme, n_actions=cfg.n_actions,
            obs_noise=float(params.sigma_m) > 0, ep_ret=ep, harvest=harvest,
            seed=seed, offset=offset,
        )
        return out.stock, out.t, out.ep_ret, out.harvest, out.next_offset, out.reward

    for _ in range(warmup):
        stock, t, ep, harvest, offset, reward = run(stock, t, ep, harvest, offset)
    if warmup:
        _finish(ep)
    t0 = time.perf_counter()
    for _ in range(iters):
        stock, t, ep, harvest, offset, reward = run(stock, t, ep, harvest, offset)
    total = _finish(reward.sum())
    return time.perf_counter() - t0, total


def ppo_setup(num_envs, num_steps, sigma, fused, fused_adam, compute_dtype, device, seed,
              hidden=64, env_id="fishing-v1", env_kwargs=None):
    """The env (`env_id` made with `env_kwargs`, by default fishing-v1 at
    `sigma`), its params, the PPOConfig of a `fused` form at `hidden` units
    a layer, a fresh train state, the device generator and the reset batch
    state. The fused rollout gets host params, which its kernel reads
    without a sync; the other forms step with params on the device."""
    env_kwargs = {"sigma": sigma} if env_kwargs is None else env_kwargs
    env, params = make(env_id, device="cpu" if fused == "full" else device, **env_kwargs)
    cfg = ppo.PPOConfig(num_envs=num_envs, num_steps=num_steps, hidden=hidden,
                        fused_update=fused != "off", fused_rollout=fused == "full",
                        fused_adam=fused_adam, compute_dtype=compute_dtype)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return env, params, cfg, ts, gen, batched_reset(env, params, num_envs, device)


def measure_ppo_train(
    num_envs: int = 16384,
    num_steps: int = 128,
    iters: int = 10,
    warmup: int = 3,
    sigma: float = 0.05,
    fused: str = "off",
    fused_adam: bool = False,
    compute_dtype: str = "float32",
    device=None,
    seed: int = 0,
    hidden: int = 64,
    env_id: str = "fishing-v1",
    env_kwargs: dict | None = None,
    read_metrics: bool = False,
) -> dict:
    """Time whole PPO iterations (rollout + GAE + 4 x 8 minibatch updates)
    on fishing-v1 (or `env_id` made with `env_kwargs`) at `hidden` units a
    layer, chained through the train state and the batch state.

    ``fused="off"``: the plain form (autograd + hand-written clip and Adam).
    ``fused="update"``: every minibatch gradient through K2, or with
    `fused_adam` gradient + clip + Adam through K3. ``fused="full"``: as
    ``update``, with rollout + GAE + packing in one launch of the
    policy-rollout kernel (K4). `read_metrics` reads every metric to the
    host after each iteration, as a training loop that logs them does.
    """
    if fused not in ("off", "update", "full"):
        raise ValueError(f"unknown fused form {fused!r}")
    device = resolve(device)
    env, params, cfg, ts, gen, bstate = ppo_setup(num_envs, num_steps, sigma, fused, fused_adam,
                                                  compute_dtype, device, seed, hidden, env_id,
                                                  env_kwargs)

    def step(ts, bstate):
        ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
        if read_metrics:
            for x in metrics.values():
                float(x)
        return ts, bstate, metrics

    for _ in range(warmup):
        ts, bstate, metrics = step(ts, bstate)
    if warmup:
        _finish(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        ts, bstate, metrics = step(ts, bstate)
    loss = _finish(metrics["loss"])
    dt = time.perf_counter() - t0

    steps_per_s = num_envs * num_steps * iters / dt
    return {
        "mode": f"ppo-{fused}" + ("+adam" if fused_adam else ""),
        # the options of the fused rollout that ran: its noise is drawn
        # inside the kernel, never pre-generated
        "rollout_flags": {"pregen_noise": False, "fold_obs": cfg.fused_rollout and
                          cfg.rollout_fold_obs, "vector_gae": False},
        "compute_dtype": cfg.compute_dtype,
        "hidden": hidden,
        "env": env_id,
        "device": _device_name(device),
        "num_envs": num_envs,
        "num_steps": num_steps,
        "epochs": cfg.epochs,
        "num_minibatches": cfg.num_minibatches,
        "iters": iters,
        "seconds": dt,
        "ms_per_iter": dt / iters * 1e3,
        "loss": loss,
        "steps_per_s": steps_per_s,
        "vs_baseline": steps_per_s / BASELINE_STEPS_PER_S,
    }
