"""Plain reference of one PPO iteration on fishing-v1: the rollout of B envs
for T steps under a Gaussian actor-critic (two tanh layers of H units a
tower, sb3's MlpPolicy shape), GAE, then epochs x minibatches of the
clipped PPO loss under autograd, clip by global norm and Adam (optax's
semantics). Float32 with TF32 off; `rnd` rounds the inputs of every product
of the hidden and head layers, forward and backward, for the control.

The random stream is the configuration's: the iteration's rollout key and
Philox offset, then one permutation of the sample tiles per epoch, drawn in
that order from one torch.Generator (`rollout_key`). Each step's draws are
Philox block (env, offset + t): action z and process z by Box-Muller of its
first two words.

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from reference import philox

LOG_2PI = math.log(2.0 * math.pi)
ROLLOUT_KEY = 0x9E3779B97F4A7C15
LEAVES = ("pi_d1.weight", "pi_d1.bias", "pi_d2.weight", "pi_d2.bias", "pi_mean.weight",
          "pi_mean.bias", "log_std", "v_d1.weight", "v_d1.bias", "v_d2.weight", "v_d2.bias",
          "v_out.weight", "v_out.bias")

Rounder = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _Product(torch.autograd.Function):
    """a @ b.T with `rnd` applied to both inputs, and in the backward pass
    to the incoming gradient and both inputs again."""

    @staticmethod
    def forward(ctx, a, b, rnd):
        ar, br = rnd(a), rnd(b)
        ctx.save_for_backward(ar, br)
        ctx.rnd = rnd
        return ar @ br.T

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = ctx.rnd(g)
        return gr @ br, gr.T @ ar, None


def product(a: torch.Tensor, b: torch.Tensor, rnd: Rounder) -> torch.Tensor:
    if rnd is identity:
        return a @ b.T
    return _Product.apply(a, b, rnd)


def forward(w: Dict[str, torch.Tensor], obs: torch.Tensor, rnd: Rounder = identity):
    """(action mean [n], value [n]) of the actor-critic at observations
    `obs` [n] (one field)."""
    def tower(d1, d2):
        h1 = torch.tanh(obs[:, None] * w[f"{d1}.weight"][:, 0] + w[f"{d1}.bias"])
        return torch.tanh(product(h1, w[f"{d2}.weight"], rnd) + w[f"{d2}.bias"])

    hp = tower("pi_d1", "pi_d2")
    hv = tower("v_d1", "v_d2")
    mean = product(hp, w["pi_mean.weight"], rnd)[:, 0] + w["pi_mean.bias"][0]
    value = product(hv, w["v_out.weight"], rnd)[:, 0] + w["v_out.bias"][0]
    return mean, value


def rollout_key(gen: torch.Generator, num_steps: int):
    """(Philox key, offset) of the next rollout from `gen`, which moves on
    past the offsets the rollout uses: a CUDA generator gives its seed
    (keyed apart from torch's own draws) and offset; a CPU generator draws
    a fresh 63-bit key at offset 0."""
    if gen.device.type == "cuda":
        offset = gen.get_offset()
        gen.set_offset(offset + -(-num_steps // 4) * 4)
        return gen.initial_seed() ^ ROLLOUT_KEY, offset
    return int(torch.randint(0, (1 << 63) - 1, (), generator=gen)), 0


def observe(stock: torch.Tensor, K: float) -> torch.Tensor:
    return torch.clamp(stock / K - 1.0, -1.0, 1.0)


@torch.no_grad()
def rollout(w, state: Dict[str, torch.Tensor], env: Dict, ppo: Dict, seed: int, offset: int,
            rnd: Rounder = identity):
    """T steps of every env from `state` (stock, t, harvest, ep_ret,
    ep_len), then GAE. Returns (samples {obs, action, logp, value,
    advantage, return}, each [T * B] with sample t * B + env; the end
    state)."""
    T, gamma, lam = ppo["num_steps"], ppo["gamma"], ppo["gae_lambda"]
    K, r, sigma = env["K"], env["r"], env["sigma"]
    x, t = state["stock"].clone(), state["t"].clone()
    h = state["harvest"].clone()
    cur_ret, cur_len = state["ep_ret"].clone(), state["ep_len"].clone()
    B = x.shape[0]
    env_idx = torch.arange(B, dtype=torch.int64, device=x.device)
    log_std = w["log_std"][0]
    std = torch.exp(log_std)
    rows = {k: torch.empty((T, B), device=x.device) for k in
            ("obs", "action", "logp", "value", "reward")}
    dones = torch.empty((T, B), dtype=torch.bool, device=x.device)
    obs = observe(x, K)
    for k in range(T):
        mean, value = forward(w, obs, rnd)
        u = philox.uniforms(seed, offset + k, env_idx)
        za, zp = philox.box_muller(u[0], u[1])
        act = mean + std * za
        logp = -0.5 * ((act - mean) / std) ** 2 - log_std - 0.5 * LOG_2PI
        quota = (torch.clamp(act, -1.0, 1.0) + 1.0) * K * env["action_scale"]
        hv = torch.minimum(x, quota)
        x1 = x - hv
        mu = x1 + r * x1 * (1.0 - x1 / K)
        x2 = mu + sigma * x1 * zp
        xn = torch.clamp(x2, min=0.0)
        collapsed = xn <= 0.0
        rew = env["price"] * hv - env["cost"] * quota * quota
        rew = rew - collapsed.float() * env["collapse_penalty"]
        tn = t + 1
        done = (tn >= env["Tmax"]) | collapsed
        ret_now, len_now = cur_ret + rew, cur_len + 1
        rows["obs"][k], rows["action"][k], rows["logp"][k] = obs, act, logp
        rows["value"][k], rows["reward"][k] = value, rew
        dones[k] = done
        x = torch.where(done, torch.full_like(xn, env["init_state"]), xn)
        t = torch.where(done, torch.zeros_like(tn), tn)
        h = torch.where(done, torch.full_like(hv, env["init_harvest"]), hv)
        cur_ret = torch.where(done, torch.zeros_like(ret_now), ret_now)
        cur_len = torch.where(done, torch.zeros_like(len_now), len_now)
        obs = observe(x, K)
    _, next_value = forward(w, obs, rnd)
    adv = torch.empty((T, B), device=x.device)
    gae = torch.zeros_like(next_value)
    for k in reversed(range(T)):
        nonterm = 1.0 - dones[k].float()
        delta = rows["reward"][k] + gamma * next_value * nonterm - rows["value"][k]
        gae = delta + gamma * lam * nonterm * gae
        adv[k] = gae
        next_value = rows["value"][k]
    samples = {k: rows[k].reshape(-1) for k in ("obs", "action", "logp", "value")}
    samples["advantage"] = adv.reshape(-1)
    samples["return"] = (adv + rows["value"]).reshape(-1)
    end = {"stock": x, "t": t, "harvest": h, "ep_ret": cur_ret, "ep_len": cur_len}
    return samples, end


def ppo_loss(w, mb: Dict[str, torch.Tensor], ppo: Dict, rnd: Rounder = identity):
    """The clipped PPO loss of one minibatch, advantages normalised by the
    minibatch's mean and population std."""
    mean, value = forward(w, mb["obs"], rnd)
    log_std = w["log_std"][0]
    logp = -0.5 * ((mb["action"] - mean) / torch.exp(log_std)) ** 2 - log_std - 0.5 * LOG_2PI
    ratio = torch.exp(logp - mb["logp"])
    adv = mb["advantage"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = ppo["clip_eps"]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    v_clip = mb["value"] + torch.clamp(value - mb["value"], -eps, eps)
    v_loss = 0.5 * torch.maximum((value - mb["return"]) ** 2,
                                 (v_clip - mb["return"]) ** 2).mean()
    entropy = log_std + 0.5 * (LOG_2PI + 1.0)
    return pg + ppo["vf_coef"] * v_loss - ppo["ent_coef"] * entropy


def minibatch_tile(n_mb: int) -> int:
    """Samples a tile: the minibatches are whole tiles of consecutive
    samples, the largest of 2048 ... 128 that divides a minibatch."""
    return next(t for t in (2048, 1024, 512, 256, 128) if n_mb % t == 0)


def update(w, m, v, count: int, samples, ppo: Dict, gen: torch.Generator,
           rnd: Rounder = identity):
    """epochs x minibatches of PPO updates in place on `w`, `m`, `v` (Adam's
    moments); returns (count, the minibatches' losses)."""
    n = samples["obs"].shape[0]
    n_mb = n // ppo["num_minibatches"]
    tile = minibatch_tile(n_mb)
    per_mb, num_tiles = n_mb // tile, n // tile
    within = torch.arange(tile, device=samples["obs"].device)
    b1, b2, adam_eps, lr = ppo["adam_b1"], ppo["adam_b2"], ppo["adam_eps"], ppo["lr"]
    losses: List[torch.Tensor] = []
    for _ in range(ppo["epochs"]):
        perm = torch.randperm(num_tiles, generator=gen, device=gen.device)
        perm = perm.to(samples["obs"].device)
        for i in range(ppo["num_minibatches"]):
            idx = (perm[i * per_mb:(i + 1) * per_mb, None] * tile + within).reshape(-1)
            mb = {k: x[idx] for k, x in samples.items()}
            params = {k: x.detach().requires_grad_(True) for k, x in w.items()}
            loss = ppo_loss(params, mb, ppo, rnd)
            grads = torch.autograd.grad(loss, [params[k] for k in LEAVES])
            losses.append(loss.detach())
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < ppo["max_grad_norm"], torch.ones_like(norm),
                                ppo["max_grad_norm"] / norm)
            count += 1
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            with torch.no_grad():
                for k, g in zip(LEAVES, grads):
                    g = g * scale
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v[k] = b2 * v[k] + (1.0 - b2) * g * g
                    w[k] = w[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + adam_eps)
    return count, losses


def iterate(w, m, v, count: int, state, env: Dict, ppo: Dict, gen: torch.Generator,
            rnd: Rounder = identity):
    """One PPO iteration; returns (count, end state, metrics {loss: the
    minibatches' mean})."""
    seed, offset = rollout_key(gen, ppo["num_steps"])
    samples, end = rollout(w, state, env, ppo, seed, offset, rnd)
    count, losses = update(w, m, v, count, samples, ppo, gen, rnd)
    return count, end, {"loss": float(torch.stack(losses).mean())}


def run(w0: Dict[str, torch.Tensor], state0, env: Dict, ppo: Dict, gen: torch.Generator,
        iterations: int, rnd: Rounder = identity, keep: Optional[Callable] = None):
    """`iterations` PPO iterations from weights `w0` (zero moments) and
    batch state `state0`; returns per iteration (metrics, and what
    `keep(w, m, v, state)` returns after it)."""
    w = {k: x.detach().float().clone() for k, x in w0.items()}
    m = {k: torch.zeros_like(x) for k, x in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    state = {k: x.clone() for k, x in state0.items()}
    count, out = 0, []
    for _ in range(iterations):
        count, state, metrics = iterate(w, m, v, count, state, env, ppo, gen, rnd)
        out.append((metrics, None if keep is None else keep(w, m, v, state)))
    return out


def scaled_rounder(dtype: torch.dtype) -> Rounder:
    """Round to `dtype` under a per-tensor scale that maps the tensor's
    largest magnitude to the type's largest finite value (the scaling an
    8-bit product needs), then back to float32."""
    top = torch.finfo(dtype).max

    def rnd(x: torch.Tensor) -> torch.Tensor:
        amax = x.detach().abs().max().clamp(min=1e-30)
        s = top / amax
        return (x * s).to(dtype).to(torch.float32) / s

    return rnd
