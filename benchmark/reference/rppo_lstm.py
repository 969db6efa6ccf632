"""Plain reference of recurrent PPO iterations on fishing-v2 under
sb3-contrib's LSTM actor-critic (`RecurrentPPO` with `MlpLstmPolicy`'s
defaults): the rollout of B envs for T steps carrying each env's LSTM
states, GAE, then epochs x minibatches of the clipped PPO loss over the
replayed segments under autograd, clip by global norm and Adam. Float32
with TF32 off; `rnd` rounds the inputs of every product, forward and
backward, for the control.

The network, per env and step, for the actor's LSTM and the critic's
alike (x the observation, one field; gates in `torch.nn.LSTM`'s order):

    [i, f, g, o] = W_ih x + b_ih + W_hh h + b_hh
    c' = sigmoid(f) c + sigmoid(i) tanh(g),   h' = sigmoid(o) tanh(c')

then ``mean = W_a tanh(W_p2 tanh(W_p1 h'_actor))`` and ``value = W_v
tanh(W_v2 tanh(W_v1 h'_critic))``, with their biases, and a free
``log_std``. The states of an env are zeroed on the step after a done one
(sb3-contrib's ``(1 - episode_start)`` mask).

fishing-v2 is fishing-v1 (logistic growth, additive process noise
``sigma x1 xi``, the continuous decode ``quota = (clip(a, -1, 1) + 1) K
action_scale``) observed through ``measured = x' exp(sigma_m eta)``,
``obs = clip(measured / K - 1, -1, 1)``; at Tmax (or a collapse) the env
resets to ``init_state``, observed without noise.

The draws are the run's, handed in: the action normals ``act [T, B]``,
the env's ``(xi, eta)`` as ``env [T, 2, B]``, one permutation of the envs
per epoch.

Where it departs from sb3-contrib, it follows the learner under test:

- minibatches are whole T-step segments of ``B / num_minibatches`` envs
  (sb3-contrib pads sequences split at episode starts); the forward is the
  same, since the states are zeroed at every start;
- advantages are normalised by the minibatch's population std (sb3: the
  sample std);
- the value loss is ``0.5 max((v - R)^2, (v_clip - R)^2)`` with ``v_clip``
  the old value plus the change clipped to ``clip_eps`` (sb3's default
  ``clip_range_vf=None``: ``(v - R)^2``);
- the gradients are scaled by ``max_grad_norm / norm`` where ``norm >=
  max_grad_norm`` (optax's clip by global norm; torch's ``clip_grad_norm_``
  divides by ``norm + 1e-6``);
- Adam's bias corrections are taken at the incremented count, as optax's
  (the same numbers as torch's Adam up to rounding).

Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from reference.ppo import Rounder, identity, product

LOG_2PI = math.log(2.0 * math.pi)
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def tf32_rounder() -> Rounder:
    """Round float32 to TF32's 10 fraction bits, to nearest with ties away
    from zero (the tensor cores' conversion), and back to float32."""

    def rnd(x: torch.Tensor) -> torch.Tensor:
        bits = x.detach().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    return rnd


def _layers(w: Dict[str, torch.Tensor], tower: str) -> int:
    return sum(1 for k in w if k.startswith(f"{tower}.") and k.endswith(".weight"))


def lstm_step(w: Dict[str, torch.Tensor], name: str, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor, rnd: Rounder = identity):
    """(h', c') of LSTM `name` at inputs x [n, 1] and states h, c [n, H]."""
    gates = (product(x, w[f"{name}.weight_ih"], rnd) + w[f"{name}.bias_ih"]
             + product(h, w[f"{name}.weight_hh"], rnd) + w[f"{name}.bias_hh"])
    H = h.shape[1]
    i, f, g, o = (gates[:, k * H:(k + 1) * H] for k in range(4))
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def forward(w: Dict[str, torch.Tensor], obs: torch.Tensor, state: State,
            rnd: Rounder = identity):
    """(action mean [n], value [n], the states after the step) at
    observations `obs` [n] from `state` (actor h, c, critic h, c)."""
    x = obs[:, None]
    h_pi, c_pi = lstm_step(w, "lstm_actor", x, state[0], state[1], rnd)
    h_vf, c_vf = lstm_step(w, "lstm_critic", x, state[2], state[3], rnd)
    pi, vf = h_pi, h_vf
    for k in range(_layers(w, "pi_mlp")):
        pi = torch.tanh(product(pi, w[f"pi_mlp.{k}.weight"], rnd) + w[f"pi_mlp.{k}.bias"])
    for k in range(_layers(w, "vf_mlp")):
        vf = torch.tanh(product(vf, w[f"vf_mlp.{k}.weight"], rnd) + w[f"vf_mlp.{k}.bias"])
    mean = product(pi, w["action_net.weight"], rnd)[:, 0] + w["action_net.bias"][0]
    value = product(vf, w["value_net.weight"], rnd)[:, 0] + w["value_net.bias"][0]
    return mean, value, (h_pi, c_pi, h_vf, c_vf)


def _zero(state: State, done: torch.Tensor) -> State:
    keep = (~done).float()[:, None]
    return tuple(s * keep for s in state)


def observe(measured: torch.Tensor, K: float) -> torch.Tensor:
    return torch.clamp(measured / K - 1.0, -1.0, 1.0)


@torch.no_grad()
def rollout(w, env_state: Dict[str, torch.Tensor], state: State, env: Dict, rppo: Dict,
            act: torch.Tensor, noise: torch.Tensor, rnd: Rounder = identity):
    """T steps of every env from `env_state` (stock, t, ep_ret, ep_len) and
    the LSTM states `state`, then GAE. Returns (the segment {obs, action,
    mean, logp, value, reward, done, advantage, return}, each [T, B], the
    states the segment started from and ended with, the end env state)."""
    T, gamma, lam = rppo["num_steps"], rppo["gamma"], rppo["gae_lambda"]
    K, r, sigma, sigma_m = env["K"], env["r"], env["sigma"], env["sigma_m"]
    x, t = env_state["stock"].clone(), env_state["t"].clone()
    cur_ret, cur_len = env_state["ep_ret"].clone(), env_state["ep_len"].clone()
    B = x.shape[0]
    log_std = w["log_std"][0]
    std = torch.exp(log_std)
    seg = {k: torch.empty((T, B), device=x.device) for k in
           ("obs", "action", "mean", "logp", "value", "reward")}
    seg["done"] = torch.empty((T, B), dtype=torch.bool, device=x.device)
    start = state
    obs = observe(x, K)
    reset_obs = observe(torch.full_like(x, env["init_state"]), K)
    for k in range(T):
        mean, value, state = forward(w, obs, state, rnd)
        a = mean + std * act[k]
        logp = -0.5 * ((a - mean) / std) ** 2 - log_std - 0.5 * LOG_2PI
        quota = (torch.clamp(a, -1.0, 1.0) + 1.0) * K * env["action_scale"]
        hv = torch.minimum(x, quota)
        x1 = x - hv
        mu = x1 + r * x1 * (1.0 - x1 / K)
        xn = torch.clamp(mu + sigma * x1 * noise[k, 0], min=0.0)
        collapsed = xn <= 0.0
        rew = (env["price"] * hv - env["cost"] * quota * quota
               - collapsed.float() * env["collapse_penalty"])
        tn = t + 1
        done = (tn >= env["Tmax"]) | collapsed
        for name, val in (("obs", obs), ("action", a), ("mean", mean), ("logp", logp),
                          ("value", value), ("reward", rew), ("done", done)):
            seg[name][k] = val
        ret_now, len_now = cur_ret + rew, cur_len + 1
        obs = torch.where(done, reset_obs, observe(xn * torch.exp(sigma_m * noise[k, 1]), K))
        x = torch.where(done, torch.full_like(xn, env["init_state"]), xn)
        t = torch.where(done, torch.zeros_like(tn), tn)
        cur_ret = torch.where(done, torch.zeros_like(ret_now), ret_now)
        cur_len = torch.where(done, torch.zeros_like(len_now), len_now)
        state = _zero(state, done)
    _, next_value, _ = forward(w, obs, state, rnd)
    adv = torch.empty((T, B), device=x.device)
    gae = torch.zeros_like(next_value)
    for k in reversed(range(T)):
        nonterm = 1.0 - seg["done"][k].float()
        delta = seg["reward"][k] + gamma * next_value * nonterm - seg["value"][k]
        gae = delta + gamma * lam * nonterm * gae
        adv[k] = gae
        next_value = seg["value"][k]
    seg["advantage"] = adv
    seg["return"] = adv + seg["value"]
    end = {"stock": x, "t": t, "ep_ret": cur_ret, "ep_len": cur_len}
    return seg, start, state, end


def segment_loss(w, seg: Dict[str, torch.Tensor], start: State, rppo: Dict,
                 rnd: Rounder = identity) -> torch.Tensor:
    """The clipped PPO loss of one minibatch of whole segments ([T, n]
    fields), replayed from the states they started from."""
    state, means, values = start, [], []
    for k in range(seg["obs"].shape[0]):
        mean, value, state = forward(w, seg["obs"][k], state, rnd)
        state = _zero(state, seg["done"][k])
        means.append(mean)
        values.append(value)
    mean, value = torch.stack(means), torch.stack(values)
    log_std = w["log_std"][0]
    logp = -0.5 * ((seg["action"] - mean) / torch.exp(log_std)) ** 2 - log_std - 0.5 * LOG_2PI
    ratio = torch.exp(logp - seg["logp"])
    adv = seg["advantage"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    eps = rppo["clip_eps"]
    pg = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    v_clip = seg["value"] + torch.clamp(value - seg["value"], -eps, eps)
    v_loss = 0.5 * torch.maximum((value - seg["return"]) ** 2,
                                 (v_clip - seg["return"]) ** 2).mean()
    entropy = log_std + 0.5 * (LOG_2PI + 1.0)
    return pg + rppo["vf_coef"] * v_loss - rppo["ent_coef"] * entropy


def update(w, m, v, count: int, seg, start: State, rppo: Dict, perms: Sequence[torch.Tensor],
           rnd: Rounder = identity):
    """epochs x minibatches of updates in place on `w`, `m`, `v` (Adam's
    moments); returns (count, the minibatches' losses, the first
    minibatch's clipped gradients)."""
    B = seg["obs"].shape[1]
    mb = B // rppo["num_minibatches"]
    b1, b2, adam_eps, lr = rppo["adam_b1"], rppo["adam_b2"], rppo["adam_eps"], rppo["lr"]
    names = list(w)
    losses: List[torch.Tensor] = []
    first = None
    for e in range(rppo["epochs"]):
        perm = perms[e].to(seg["obs"].device).long()
        for i in range(rppo["num_minibatches"]):
            envs = perm[i * mb:(i + 1) * mb]
            part = {k: x[:, envs] for k, x in seg.items()}
            params = {k: x.detach().requires_grad_(True) for k, x in w.items()}
            loss = segment_loss(params, part, tuple(s[envs] for s in start), rppo, rnd)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            losses.append(loss.detach())
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < rppo["max_grad_norm"], torch.ones_like(norm),
                                rppo["max_grad_norm"] / norm)
            grads = [g * scale for g in grads]
            if first is None:
                first = {k: g.clone() for k, g in zip(names, grads)}
            count += 1
            bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
            with torch.no_grad():
                for k, g in zip(names, grads):
                    m[k] = b1 * m[k] + (1.0 - b1) * g
                    v[k] = b2 * v[k] + (1.0 - b2) * g * g
                    w[k] = w[k] - lr * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + adam_eps)
    return count, losses, first


def run(w0: Dict[str, torch.Tensor], env_state0: Dict[str, torch.Tensor], env: Dict,
        rppo: Dict, draws: Sequence[Dict], rnd: Rounder = identity,
        keep: Optional[Callable] = None):
    """One iteration per entry of `draws` ({act [T, B], env [T, 2, B],
    perms}) from weights `w0` (zero moments), env state `env_state0` and
    zero LSTM states. Returns per iteration (metrics: the minibatches' mean
    loss and the rollout's episode ends; what `keep(w, m, v)` returns after
    it); the first iteration's metrics also hold its rollout
    (`segment`), the states after it (`state_after`), the first minibatch's
    loss (`loss_step1`) and clipped gradients (`grads_step1`)."""
    w = {k: x.detach().float().clone() for k, x in w0.items()}
    m = {k: torch.zeros_like(x) for k, x in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    env_state = {k: x.clone() for k, x in env_state0.items()}
    B, H = env_state["stock"].shape[0], w["lstm_actor.weight_hh"].shape[1]
    state = tuple(torch.zeros((B, H), device=env_state["stock"].device) for _ in range(4))
    count, out = 0, []
    for i, d in enumerate(draws):
        seg, start, state, env_state = rollout(w, env_state, state, env, rppo, d["act"],
                                               d["env"], rnd)
        count, losses, first = update(w, m, v, count, seg, start, rppo, d["perms"], rnd)
        metrics = {"loss": float(torch.stack(losses).mean()), "dones": int(seg["done"].sum())}
        if i == 0:
            metrics.update(segment=seg, state_after=state, loss_step1=float(losses[0]),
                           grads_step1=first)
        out.append((metrics, None if keep is None else keep(w, m, v)))
    return out
