"""Plain reference of one PPO iteration on fishing-v0's proportional quota
grid: the rollout of B envs for T steps under a categorical actor-critic
(two tanh layers of H units a tower, sb3's MlpPolicy shape, a head of A
logits beside the value: A + 1 outputs), GAE, then epochs x minibatches of
the clipped PPO loss under autograd, clip by global norm and Adam (optax's
semantics). Float32 with TF32 off; `rnd` rounds the inputs of every product
of the hidden and head layers, forward and backward, for the control.

It follows `reference/ppo.py` in everything but the head: the same random
stream (the iteration's rollout key and Philox offset, then one permutation
of the sample tiles per epoch, from one torch.Generator), the same
dynamics, auto-reset and GAE, the same clipped loss with advantages
normalised by the minibatch's mean and population std, the same clip by
global norm and Adam. The head is the categorical one:

- the draw is the policy-rollout kernel's inverse CDF: step t of env b
  takes Philox block (b, offset + t); its first uniform u0 picks class
  a = min(#{k : cdf_k < u0}, A - 1), the CDF the running sum of
  softmax(logits) = exp(l_k - max l) / sum; (u1, u2) give the Box-Muller
  pair whose sine is the process noise;
- the proportional decode: quota = a / A * K;
- the log-probability is log_softmax(logits)[a], the entropy
  -sum_k p_k log p_k, and the loss pg + vf_coef v - ent_coef entropy.

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from reference import philox
from reference.ppo import (  # noqa: F401  (scaled_rounder is the control's)
    Rounder,
    identity,
    minibatch_tile,
    observe,
    product,
    rollout_key,
    scaled_rounder,
)

LEAVES = ("pi_d1.weight", "pi_d1.bias", "pi_d2.weight", "pi_d2.bias", "pi_logits.weight",
          "pi_logits.bias", "v_d1.weight", "v_d1.bias", "v_d2.weight", "v_d2.bias",
          "v_out.weight", "v_out.bias")


def forward(w: Dict[str, torch.Tensor], obs: torch.Tensor, rnd: Rounder = identity):
    """(logits [n, A], value [n]) of the actor-critic at observations `obs`
    [n] (one field)."""
    def tower(d1, d2):
        h1 = torch.tanh(obs[:, None] * w[f"{d1}.weight"][:, 0] + w[f"{d1}.bias"])
        return torch.tanh(product(h1, w[f"{d2}.weight"], rnd) + w[f"{d2}.bias"])

    hp = tower("pi_d1", "pi_d2")
    hv = tower("v_d1", "v_d2")
    logits = product(hp, w["pi_logits.weight"], rnd) + w["pi_logits.bias"]
    value = product(hv, w["v_out.weight"], rnd)[:, 0] + w["v_out.bias"][0]
    return logits, value


def draw(logits: torch.Tensor, u: torch.Tensor):
    """(class, log-probability) of the inverse-CDF draw at uniforms `u` [n]."""
    z = logits - logits.max(1, keepdim=True).values
    e = torch.exp(z)
    se = e.sum(1, keepdim=True)
    cdf = torch.cumsum(e / se, 1)
    cls = torch.clamp((cdf < u[:, None]).sum(1), max=logits.shape[1] - 1)
    logp = (z - torch.log(se)).gather(1, cls[:, None])[:, 0]
    return cls, logp


@torch.no_grad()
def rollout(w, state: Dict[str, torch.Tensor], env: Dict, ppo: Dict, seed: int, offset: int,
            rnd: Rounder = identity):
    """T steps of every env from `state` (stock, t, harvest, ep_ret,
    ep_len), then GAE. Returns (samples {obs, action (the class as a
    float), logp, value, advantage, return}, each [T * B] with sample
    t * B + env; the end state)."""
    T, gamma, lam = ppo["num_steps"], ppo["gamma"], ppo["gae_lambda"]
    K, r, sigma, A = env["K"], env["r"], env["sigma"], env["n_actions"]
    x, t = state["stock"].clone(), state["t"].clone()
    h = state["harvest"].clone()
    cur_ret, cur_len = state["ep_ret"].clone(), state["ep_len"].clone()
    B = x.shape[0]
    env_idx = torch.arange(B, dtype=torch.int64, device=x.device)
    rows = {k: torch.empty((T, B), device=x.device) for k in
            ("obs", "action", "logp", "value", "reward")}
    dones = torch.empty((T, B), dtype=torch.bool, device=x.device)
    obs = observe(x, K)
    for k in range(T):
        logits, value = forward(w, obs, rnd)
        u = philox.uniforms(seed, offset + k, env_idx)
        cls, logp = draw(logits, u[0])
        zp = philox.box_muller(u[1], u[2])[1]
        act = cls.float()
        quota = act / float(A) * K
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
    logits, value = forward(w, mb["obs"], rnd)
    logps = torch.log_softmax(logits, 1)
    logp = logps.gather(1, mb["action"].long()[:, None])[:, 0]
    ratio = torch.exp(logp - mb["logp"])
    adv = mb["advantage"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = ppo["clip_eps"]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    v_clip = mb["value"] + torch.clamp(value - mb["value"], -eps, eps)
    v_loss = 0.5 * torch.maximum((value - mb["return"]) ** 2,
                                 (v_clip - mb["return"]) ** 2).mean()
    entropy = -(torch.exp(logps) * logps).sum(1).mean()
    return pg + ppo["vf_coef"] * v_loss - ppo["ent_coef"] * entropy


def update(w, m, v, count: int, samples, ppo: Dict, gen: torch.Generator,
           rnd: Rounder = identity):
    """epochs x minibatches of PPO updates in place on `w`, `m`, `v` (Adam's
    moments); returns (count, the minibatches' losses, the first
    minibatch's gradients as Adam takes them, after the clip)."""
    n = samples["obs"].shape[0]
    n_mb = n // ppo["num_minibatches"]
    tile = minibatch_tile(n_mb)
    per_mb, num_tiles = n_mb // tile, n // tile
    within = torch.arange(tile, device=samples["obs"].device)
    b1, b2, adam_eps, lr = ppo["adam_b1"], ppo["adam_b2"], ppo["adam_eps"], ppo["lr"]
    losses: List[torch.Tensor] = []
    first: Dict[str, torch.Tensor] = {}
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
                    first.setdefault(k, g)
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v[k] = b2 * v[k] + (1.0 - b2) * g * g
                    w[k] = w[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + adam_eps)
    return count, losses, first


def iterate(w, m, v, count: int, state, env: Dict, ppo: Dict, gen: torch.Generator,
            rnd: Rounder = identity):
    """One PPO iteration; returns (count, end state, metrics {loss: the
    minibatches' mean, loss_step1: the first minibatch's, grads_step1: its
    clipped gradients by leaf}, the rollout's classes [T * B])."""
    seed, offset = rollout_key(gen, ppo["num_steps"])
    samples, end = rollout(w, state, env, ppo, seed, offset, rnd)
    count, losses, first = update(w, m, v, count, samples, ppo, gen, rnd)
    metrics = {"loss": float(torch.stack(losses).mean()), "loss_step1": float(losses[0]),
               "grads_step1": first}
    return count, end, metrics, samples["action"]


def run(w0: Dict[str, torch.Tensor], state0, env: Dict, ppo: Dict, gen: torch.Generator,
        iterations: int, rnd: Rounder = identity, keep: Optional[Callable] = None):
    """`iterations` PPO iterations from weights `w0` (zero moments) and
    batch state `state0`; returns per iteration (metrics, what `keep(w, m,
    v, state)` returns after it, the rollout's classes)."""
    w = {k: x.detach().float().clone() for k, x in w0.items()}
    m = {k: torch.zeros_like(x) for k, x in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    state = {k: x.clone() for k, x in state0.items()}
    count, out = 0, []
    for _ in range(iterations):
        count, state, metrics, actions = iterate(w, m, v, count, state, env, ppo, gen, rnd)
        out.append((metrics, None if keep is None else keep(w, m, v, state), actions))
    return out
