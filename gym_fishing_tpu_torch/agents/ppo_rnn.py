"""Recurrent PPO for the partially observed variants: a GRU actor-critic
(the JAX learner's) or sb3-contrib's LSTM actor-critic.

Counterpart of ``gym_fishing_tpu/agents/ppo_rnn.py``. Frame stacking
(`envs/wrappers.ObsStackEnv`) is the cheap POMDP remedy; this one carries a
learned belief state across the episode in a recurrent cell, so a policy
can filter observation noise (``sigma_m > 0``), infer the latent growth
model or track a drifting productivity.

- Collection is `agents/ppo.py`'s rollout with the recurrent state carried
  beside the batch state and zeroed after a done step (sb3-contrib's
  ``(1 - episode_start)`` mask on the next step).
- The update replays whole ``[T, B_mb]`` segments through the cell
  (truncated BPTT over the rollout): minibatches cut the env axis only, so
  the recurrence stays intact, and the same permutation takes the states
  the segments started from.
- GAE, the distributions, the clipped loss's arithmetic and Adam come from
  `agents/ppo.py`; the optimizer is optax's ``chain(clip_by_global_norm(
  max_grad_norm), adam(lr, eps=1e-5))`` written by hand.

Two cells (`RPPOConfig.cell`):

- ``"gru"`` (the default): flax's ``GRUCell`` after a tanh embedding:
  ``r = sigmoid(ir(x) + hr(h))``, ``z = sigmoid(iz(x) + hz(h))``, ``n =
  tanh(in(x) + r * hn(h))``, ``h' = (1 - z) n + z h``, where ``ir``, ``iz``,
  ``in`` and ``hn`` have a bias and ``hr`` and ``hz`` none. `GRUCell` holds
  it in `torch.nn.GRUCell`'s layout (gates in the order r, z, n) with the
  one recurrent bias it has, ``bias_hn``, so that Adam steps no parameter
  the flax cell lacks. The state is one ``[B, hidden]`` tensor.
- ``"lstm"``: sb3-contrib's ``RecurrentActorCriticPolicy`` under
  ``MlpLstmPolicy``'s defaults (``shared_lstm=False``,
  ``enable_critic_lstm=True``): an `LSTMCell` of `hidden` units each for
  the actor and the critic on the observation, then `net_arch` tanh layers
  each, a Gaussian ``action_net`` with a free ``log_std`` (or logits) and a
  ``value_net``. The state is four ``[B, hidden]`` tensors, ``(h, c)`` of
  the actor then of the critic.

Both cells run the same phases over fixed buffers: the rollout per step a
`net` and an `env` phase, then the last value and GAE (`_Rollout`), and
per minibatch `replay`, `backward` (with the clip) and `adam` (`_Update`).
The LSTM's phases take fixed inputs (its rollout's draws made before the
first step, Adam's count on the device), so on the card each is a CUDA
graph, captured at the train state's first iteration and replayed from
then on (`_graphs`); the GRU calls them, drawing step by step as the JAX
learner does.

Randomness: the rollout's draws (action normals or Gumbel noise, the env's
(2, B) plane per step) and one permutation of the envs per epoch come from
one `torch.Generator`; ``act_noise [T, B, A]``, ``env_noise [T, 2, B]`` and
``perms`` replace them.

Spans (`utils/trace.py`): ``train_step`` > ``train_step/rollout`` (>
``net``: the cells, heads and draws; ``env``: `batched_step`),
``train_step/update`` > ``minibatch`` > ``replay``, ``backward`` (with the
clip), ``adam``; ``train_step/metrics``. Counters: `replayed_steps` (steps
of every replayed segment) and `state_resets()` (envs whose state a rollout
zeroed at an episode start).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gym_fishing_tpu_torch.agents.es import _lecun_linear
from gym_fishing_tpu_torch.agents.ppo import (
    TrainState,
    Transition,
    _continuous,
    _episode_metrics,
    _orthogonal_linear,
    action_logp_entropy,
    action_noise,
    adam_step,
    clip_by_global_norm,
    compute_gae,
    sample_action,
)
from gym_fishing_tpu_torch.batch import BatchState, batched_reset, batched_step
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.tree import tree_leaves, tree_map
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.utils.trace import span

CELLS = ("gru", "lstm")
# a minibatch's loss metrics, in the order of the vectors `on_minibatch` gets
METRICS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl")

# counters, one add each: the steps of every segment the update replayed
# (`num_steps` a minibatch), and, per device, the envs whose recurrent state
# a rollout zeroed at an episode start (a device integer, read by
# `state_resets`)
replayed_steps = 0
_zeroed: Dict[torch.device, torch.Tensor] = {}


def state_resets() -> int:
    """Envs whose state the rollouts so far zeroed at an episode start, on
    every device (reads them to the host)."""
    return sum(int(x) for x in _zeroed.values())


@dataclasses.dataclass(frozen=True)
class RPPOConfig:
    num_envs: int = 256
    num_steps: int = 64          # BPTT segment length
    epochs: int = 4
    num_minibatches: int = 4     # cuts across envs; num_envs % this == 0
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: int = 64             # GRU width (also the obs embedding width), or each LSTM's
    cell: str = "gru"            # "gru" or "lstm" (see the module's docstring)
    # the LSTM policy's tanh layers after each LSTM, actor and critic alike
    # (sb3-contrib's MlpLstmPolicy: [64, 64]); the GRU policy has none
    net_arch: Tuple[int, ...] = (64, 64)


class GRUCell(nn.Module):
    """flax's GRUCell in `torch.nn.GRUCell`'s layout: ``weight_ih [3H, in]``
    and ``bias_ih [3H]`` (gates r, z, n), ``weight_hh [3H, H]`` and the
    candidate gate's recurrent bias ``bias_hn [H]``. Initialised as flax's:
    truncated-normal input kernels of variance 1 / fan_in, an orthogonal
    recurrent kernel per gate, zero biases."""

    def __init__(self, input_size: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.cat(
            [_lecun_linear(input_size, hidden, generator).weight.detach() for _ in range(3)]))
        w_hh = torch.empty(3 * hidden, hidden)
        for g in range(3):
            nn.init.orthogonal_(w_hh[g * hidden:(g + 1) * hidden], generator=generator)
        self.weight_hh = nn.Parameter(w_hh)
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        i_r, i_z, i_n = F.linear(x, self.weight_ih, self.bias_ih).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(h, self.weight_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * h


class RecurrentActorCritic(nn.Module):
    """``embed`` (tanh) -> ``gru`` -> a ``v_out`` head and a ``pi_mean``
    head with a free ``log_std`` (continuous) or a ``pi_logits`` head.
    ``forward(obs, h) -> (dist, value, h_next)``."""

    def __init__(self, obs_dim: int, action_dim: int, continuous: bool, hidden: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.continuous = continuous
        self.embed = _orthogonal_linear(obs_dim, hidden, math.sqrt(2.0), generator)
        self.gru = GRUCell(hidden, hidden, generator)
        self.v_out = _orthogonal_linear(hidden, 1, 1.0, generator)
        if continuous:
            self.pi_mean = _orthogonal_linear(hidden, action_dim, 0.01, generator)
            self.log_std = nn.Parameter(torch.zeros(action_dim))
        else:
            self.pi_logits = _orthogonal_linear(hidden, action_dim, 0.01, generator)

    def forward(self, obs: torch.Tensor, h: torch.Tensor):
        h = self.gru(torch.tanh(self.embed(obs)), h)
        value = self.v_out(h)[..., 0]
        if self.continuous:
            return (self.pi_mean(h), self.log_std), value, h
        return (self.pi_logits(h),), value, h


class LSTMCell(nn.Module):
    """One step of a one-layer `torch.nn.LSTM`, in its layout: ``weight_ih
    [4H, in]``, ``weight_hh [4H, H]``, ``bias_ih`` and ``bias_hh [4H]``, gates
    in the order i, f, g, o; initialised as nn.LSTM, every entry uniform in
    ``[-1/sqrt(H), 1/sqrt(H)]`` (sb3's orthogonal initialisation leaves the
    LSTMs alone). ``forward(x, (h, c)) -> (h', c')`` with ``c' = sigmoid(f) c
    + sigmoid(i) tanh(g)`` and ``h' = sigmoid(o) tanh(c')``."""

    def __init__(self, input_size: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        k = 1.0 / math.sqrt(hidden)

        def uniform(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(-k, k, generator=generator))

        self.weight_ih = uniform(4 * hidden, input_size)
        self.weight_hh = uniform(4 * hidden, hidden)
        self.bias_ih = uniform(4 * hidden)
        self.bias_hh = uniform(4 * hidden)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The input's term of the gates, ``W_ih x + b_ih``, over any leading
        dimensions."""
        return F.linear(x, self.weight_ih, self.bias_ih)

    def step(self, xw: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        """(h', c') from the input's term `xw` and the state (h, c)."""
        h, c = state
        gates = xw + F.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c

    def forward(self, x: torch.Tensor, state: Tuple[torch.Tensor, torch.Tensor]):
        return self.step(self.project(x), state)


class LSTMActorCritic(nn.Module):
    """sb3-contrib's recurrent actor-critic (MlpLstmPolicy's defaults):
    ``lstm_actor`` and ``lstm_critic`` on the observation, ``pi_mlp`` and
    ``vf_mlp`` tanh layers of `net_arch` after them, an ``action_net`` (the
    Gaussian's mean, with a free ``log_std``, or the logits) and a
    ``value_net``. The linear layers are initialised as sb3's: orthogonal,
    gain sqrt 2 in the MLPs, 0.01 in ``action_net``, 1 in ``value_net``, zero
    biases. ``forward(obs, (h_pi, c_pi, h_vf, c_vf)) -> (dist, value,
    state_next)``; `replay` runs a whole segment."""

    def __init__(self, obs_dim: int, action_dim: int, continuous: bool, hidden: int = 256,
                 net_arch: Sequence[int] = (64, 64),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.continuous = continuous
        self.lstm_actor = LSTMCell(obs_dim, hidden, generator)
        self.lstm_critic = LSTMCell(obs_dim, hidden, generator)
        widths = (hidden,) + tuple(net_arch)
        root2 = math.sqrt(2.0)
        self.pi_mlp = nn.ModuleList(_orthogonal_linear(a, b, root2, generator)
                                    for a, b in zip(widths, widths[1:]))
        self.vf_mlp = nn.ModuleList(_orthogonal_linear(a, b, root2, generator)
                                    for a, b in zip(widths, widths[1:]))
        self.action_net = _orthogonal_linear(widths[-1], action_dim, 0.01, generator)
        if continuous:
            self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.value_net = _orthogonal_linear(widths[-1], 1, 1.0, generator)

    def heads(self, h_pi: torch.Tensor, h_vf: torch.Tensor):
        """(dist, value) from the LSTMs' outputs, over any leading
        dimensions."""
        pi, vf = h_pi, h_vf
        for layer in self.pi_mlp:
            pi = torch.tanh(layer(pi))
        for layer in self.vf_mlp:
            vf = torch.tanh(layer(vf))
        value = self.value_net(vf)[..., 0]
        dist = (self.action_net(pi), self.log_std) if self.continuous else (self.action_net(pi),)
        return dist, value

    def forward(self, obs: torch.Tensor, state: Tuple[torch.Tensor, ...]):
        h_pi, c_pi = self.lstm_actor(obs, state[:2])
        h_vf, c_vf = self.lstm_critic(obs, state[2:])
        dist, value = self.heads(h_pi, h_vf)
        return dist, value, (h_pi, c_pi, h_vf, c_vf)

    def replay(self, obs_seq: torch.Tensor, done_seq: torch.Tensor, state):
        """`forward` over a ``[T, B, ...]`` segment from `state`, the states
        zeroed after a done step -> (dist leaves [T, B, A], values [T, B]).
        Only the recurrence runs step by step: the inputs' terms and the heads
        take the whole segment at once."""
        # unbind, not indexing: its backward stacks the steps' gradients once
        xw_pi = self.lstm_actor.project(obs_seq).unbind(0)
        xw_vf = self.lstm_critic.project(obs_seq).unbind(0)
        out_pi, out_vf = [], []
        for t in range(obs_seq.shape[0]):
            if t:
                state = _zero_done(state, done_seq[t - 1])
            h_pi, c_pi = self.lstm_actor.step(xw_pi[t], state[:2])
            h_vf, c_vf = self.lstm_critic.step(xw_vf[t], state[2:])
            out_pi.append(h_pi)
            out_vf.append(h_vf)
            state = (h_pi, c_pi, h_vf, c_vf)
        dist, value = self.heads(torch.stack(out_pi), torch.stack(out_vf))
        if self.continuous:
            dist = (dist[0], dist[1].expand_as(dist[0]))
        return dist, value


def _map_state(fn: Callable[[torch.Tensor], torch.Tensor], state):
    """`fn` over a recurrent state: the GRU's tensor or the LSTM's tuple."""
    return tuple(fn(x) for x in state) if isinstance(state, tuple) else fn(state)


def init_hidden(cfg: RPPOConfig, batch: int, device=None):
    """The zero state of `batch` envs: a ``[batch, hidden]`` tensor (GRU) or
    four of them (LSTM: actor h, c, critic h, c). `cfg` may be any config
    with a ``hidden`` (the JAX learner's has no ``cell``: a GRU's)."""
    device = resolve(device)
    zeros = lambda: torch.zeros((batch, cfg.hidden), dtype=torch.float32,  # noqa: E731
                                device=device)
    return tuple(zeros() for _ in range(4)) if getattr(cfg, "cell", "gru") == "lstm" else zeros()


def make_rppo_state(env: Env, cfg: RPPOConfig, generator: Optional[torch.Generator] = None,
                    device=None) -> TrainState:
    """A fresh network of `cfg.cell` (initialised from the CPU `generator`)
    on `device` (default: the card) with zero Adam moments."""
    continuous = _continuous(env)
    obs_dim = env.observation_space.shape[0]
    action_dim = 1 if continuous else env.config.n_actions
    if cfg.cell == "lstm":
        model = LSTMActorCritic(obs_dim, action_dim, continuous, cfg.hidden, cfg.net_arch,
                                generator)
    elif cfg.cell == "gru":
        model = RecurrentActorCritic(obs_dim=obs_dim, action_dim=action_dim,
                                     continuous=continuous, hidden=cfg.hidden,
                                     generator=generator)
    else:
        raise ValueError(f"no such cell: {cfg.cell!r}; one of {CELLS}")
    model = model.to(resolve(device))
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, m=zeros, v={n: z.clone() for n, z in zeros.items()})


# the same time-major record as the feed-forward learner's
RTransition = Transition


def _zero_done(state, done: torch.Tensor, tally: Optional[torch.Tensor] = None):
    """The episode boundary: the step after a done one starts from a zero
    state. `tally`, where given, counts the envs zeroed."""
    if tally is not None:
        tally.add_(done.sum())
    d = done[:, None]
    return _map_state(lambda h: torch.where(d, 0.0, h), state)


def _env_step(env: Env, env_params: EnvParams, bstate: BatchState, action: torch.Tensor,
              continuous: bool, noise):
    """A rollout step's env: `batched_step` on the action as the env takes it."""
    env_action = action if continuous else action.to(torch.int32)
    return batched_step(env, env_params, bstate, env_action, noise)


def _tally(device: torch.device) -> torch.Tensor:
    if device not in _zeroed:
        _zeroed[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _zeroed[device]


def _graphs(device: torch.device) -> bool:
    """Whether a learner whose phases take fixed inputs (the LSTM's) runs
    them as CUDA graphs: on the card."""
    return device.type == "cuda"


def _copy_leaves(dst, src) -> None:
    for d, x in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(x)


def _capture(phases: Sequence[Callable[[], None]]) -> List[torch.cuda.CUDAGraph]:
    """One CUDA graph per phase, in one memory pool, captured on a side
    stream; the phases have run once outside any capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for phase in phases:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=side):
            phase()
        graphs.append(graph)
    return graphs


def _fixed(cfg: RPPOConfig) -> bool:
    """Whether the learner's phases take fixed inputs, and so may be CUDA
    graphs: the LSTM's, whose rollout draws its noise before the first step
    and whose Adam count lives on the device. The GRU draws step by step and
    counts on the host, as the JAX learner it follows."""
    return cfg.cell == "lstm"


class _Rollout:
    """A rollout and its GAE over fixed buffers, in phases: per step `net`
    (the zeroing after a done step, the cell and heads, the action and the
    step's network record) and `env` (`batched_step`, its record and the
    next observation), then `last` (the final zeroing and the last value)
    and `gae`. The states and env states live in two buffers each that the
    steps alternate between.

    A run calls the phases in order; with `graphs` the first run calls them
    once, captures each as a CUDA graph (2T + 2 of them), and it and every
    later run replay the graphs. The records are the buffers' until the
    next run. `matches` tells whether the model's weights, the env and the
    config are those it was made for. It holds the model only during a run,
    so that the per-model cache it lives in drops it with the model."""

    def __init__(self, model: nn.Module, env: Env, env_params: EnvParams, cfg: RPPOConfig,
                 graphs: bool):
        self.env, self.env_params, self.cfg = env, env_params, cfg
        self.continuous = _continuous(env)
        self.key = self._key(model, env, env_params, cfg)
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = [] if graphs else None
        self.b: Dict = {}
        self.model = self.generator = self.act = self.noise = None

    @staticmethod
    def _key(model, env, env_params, cfg) -> Tuple:
        return tuple(p.data_ptr() for p in model.parameters()), id(env), id(env_params), cfg

    def matches(self, model, env, env_params, cfg) -> bool:
        return self.key == self._key(model, env, env_params, cfg)

    def _put(self, name: str, t: Optional[int], x: torch.Tensor) -> None:
        """Copy `x` into buffer `name` (at step `t`), made at its first put."""
        if name not in self.b:
            lead = () if t is None else (self.cfg.num_steps,)
            self.b[name] = x.new_empty(lead + tuple(x.shape))
        (self.b[name] if t is None else self.b[name][t]).copy_(x)

    def _load(self, bstate: BatchState, h, act, noise) -> None:
        """The run's inputs into the buffers: the first observation, the env
        and recurrent states, and (fixed inputs) the draws."""
        b, T = self.b, self.cfg.num_steps
        obs = self.env.get_obs(self.env_params, bstate.env).float()
        if not b:
            b["obs"] = obs.new_empty((T + 1,) + tuple(obs.shape))
            b["E"] = [tree_map(torch.empty_like, bstate) for _ in range(2)]
            b["S"] = [_map_state(torch.empty_like, h) for _ in range(3)]
            b["start"] = _map_state(torch.empty_like, h)
        b["obs"][0].copy_(obs)
        _copy_leaves(b["E"][0], bstate)
        _copy_leaves(b["S"][0], h)
        _copy_leaves(b["start"], h)
        if act is not None:
            self._put("act", None, act)
            act = b["act"]
        if noise is not None:
            self._put("noise", None, noise)
            noise = b["noise"]
        self.act, self.noise = act, noise

    def _net(self, t: int) -> None:
        b = self.b
        h = b["S"][0] if t == 0 else _zero_done(b["S"][t % 2], b["done"][t - 1], self.tally)
        dist, value, h_next = self.model(b["obs"][t], h)
        action, logp = sample_action(dist, self.continuous,
                                     None if self.act is None else self.act[t], self.generator)
        _copy_leaves(b["S"][(t + 1) % 2], h_next)
        for name, x in (("action", action), ("logp", logp), ("value", value),
                        ("means", dist[0])):
            self._put(name, t, x)

    def _env(self, t: int) -> None:
        b = self.b
        bs, rs = _env_step(self.env, self.env_params, b["E"][t % 2], b["action"][t],
                           self.continuous, self.generator if self.noise is None
                           else self.noise[t])
        _copy_leaves(b["E"][(t + 1) % 2], bs)
        b["obs"][t + 1].copy_(rs.obs.float())
        for name, x in (("reward", rs.reward.float()), ("done", rs.done),
                        ("episode_return", rs.episode_return.float()),
                        ("episode_length", rs.episode_length)):
            self._put(name, t, x)

    def _last(self) -> None:
        b, T = self.b, self.cfg.num_steps
        _copy_leaves(b["S"][2], _zero_done(b["S"][T % 2], b["done"][T - 1], self.tally))
        self._put("last_value", None, self.model(b["obs"][T], b["S"][2])[1])

    def _traj(self) -> RTransition:
        b = self.b
        return RTransition(obs=b["obs"][:self.cfg.num_steps], **{
            f.name: b[f.name] for f in dataclasses.fields(RTransition) if f.name != "obs"})

    def _gae(self) -> None:
        adv, ret = compute_gae(self.cfg, self._traj(), self.b["last_value"])
        self._put("adv", None, adv)
        self._put("ret", None, ret)

    def _phases(self) -> List[Tuple[Optional[str], Callable[[], None]]]:
        """(span, phase) in the order a run takes them."""
        steps = [(f"train_step/rollout/{name}", functools.partial(fn, t))
                 for t in range(self.cfg.num_steps)
                 for name, fn in (("net", self._net), ("env", self._env))]
        return steps + [("train_step/rollout/net", self._last), (None, self._gae)]

    def run(self, model: nn.Module, bstate: BatchState, h,
            generator: Optional[torch.Generator], act_noise: Optional[torch.Tensor],
            env_noise: Optional[torch.Tensor]):
        """(bstate, h_last, h_start, traj, advantages, returns, means)."""
        try:
            self.model = model
            return self._run(generator, bstate, h, act_noise, env_noise)
        finally:
            self.model = self.generator = None

    def _run(self, generator, bstate, h, act_noise, env_noise):
        device = next(self.model.parameters()).device
        self.tally, self.generator = _tally(device), generator
        if _fixed(self.cfg):
            T, B = self.cfg.num_steps, self.cfg.num_envs
            if act_noise is None:
                act_noise = action_noise((T, B, self.model.action_net.out_features),
                                         self.continuous, generator, torch.float32, device)
            if env_noise is None:
                env_noise = torch.randn((T, 2, B), generator=generator,
                                        dtype=self.env_params.dtype, device=device)
        self._load(bstate, h, act_noise, env_noise)
        phases = self._phases()
        with torch.no_grad():
            if self.graphs == []:
                # a pass outside any capture, its count of zeroed envs undone
                before = self.tally.clone()
                for _, phase in phases:
                    phase()
                self.tally.copy_(before)
                self.graphs = _capture([phase for _, phase in phases])
                self._load(bstate, h, act_noise, env_noise)
            for j, (name, phase) in enumerate(phases):
                with span(name) if name else contextlib.nullcontext():
                    if self.graphs is None:
                        phase()
                    else:
                        self.graphs[j].replay()
        b, T = self.b, self.cfg.num_steps
        return (tree_map(torch.clone, b["E"][T % 2]), _map_state(torch.clone, b["S"][2]),
                b["start"], self._traj(), b["adv"], b["ret"], b["means"])


def collect_rollout(env: Env, env_params: EnvParams, cfg: RPPOConfig, model: nn.Module,
                    bstate: BatchState, h0, generator: Optional[torch.Generator] = None,
                    act_noise: Optional[torch.Tensor] = None,
                    env_noise: Optional[torch.Tensor] = None):
    """`cfg.num_steps` steps carrying the recurrent state, zeroed after a
    done step: the train step's rollout, called phase by phase.

    Returns (bstate, obs_last, h_last, h_start, traj, last_value), `h_start`
    the state the segment started with (the update replays from it) and
    `traj` a time-major RTransition."""
    roll = _Rollout(model, env, env_params, cfg, graphs=False)
    bstate, h_last, _, traj, _, _, _ = roll.run(model, bstate, h0, generator, act_noise,
                                                env_noise)
    return bstate, roll.b["obs"][cfg.num_steps], h_last, h0, traj, roll.b["last_value"]


# the rollout and the update of each model, dropped with it
_rollouts: "weakref.WeakKeyDictionary[nn.Module, _Rollout]" = weakref.WeakKeyDictionary()


def _rollout(ts: TrainState, env: Env, env_params: EnvParams, cfg: RPPOConfig) -> _Rollout:
    """The model's `_Rollout`, made anew when its weights, the env or the
    config have changed since it was made. Graphs take fixed inputs and env
    params that live on the card."""
    roll = _rollouts.get(ts.model)
    if roll is None or not roll.matches(ts.model, env, env_params, cfg):
        device = next(ts.model.parameters()).device
        graphs = _fixed(cfg) and _graphs(device) and all(
            torch.as_tensor(x).device == device for x in tree_leaves(env_params))
        roll = _Rollout(ts.model, env, env_params, cfg, graphs)
        _rollouts[ts.model] = roll
    return roll


def replay_sequence(model: nn.Module, obs_seq: torch.Tensor, done_seq: torch.Tensor, h0):
    """Re-run the recurrent policy over a ``[T, B, ...]`` segment with the
    collection's reset convention -> (dist leaves stacked over time, values
    [T, B]). The Gaussian head's shared ``log_std`` is broadcast to the
    mean's shape, so every leaf is ``[T, B, A]``. A model with a `replay` of
    its own (the LSTM's) runs it."""
    if hasattr(model, "replay"):
        return model.replay(obs_seq, done_seq, h0)
    h = h0
    leaves: List[tuple] = []
    values = []
    for t in range(obs_seq.shape[0]):
        dist, value, h_next = model(obs_seq[t], h)
        if len(dist) == 2:
            dist = (dist[0], dist[1].expand_as(dist[0]))
        leaves.append(dist)
        values.append(value)
        h = _zero_done(h_next, done_seq[t])
    dists = tuple(torch.stack(leaf) for leaf in zip(*leaves))
    return dists, torch.stack(values)


def rppo_loss(model: nn.Module, cfg: RPPOConfig, batch, continuous: bool):
    """Clipped PPO loss over a replayed ``[T, B_mb]`` sequence -> (total,
    metrics); the advantage normalisation uses the population std."""
    obs, action, done, old_logp, old_value, adv, ret, h0 = batch
    dists, value = replay_sequence(model, obs, done, h0)
    logp, entropy = action_logp_entropy(dists, action, continuous)
    ratio = torch.exp(logp - old_logp)
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2).mean()
    ent = entropy.mean()
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                   "approx_kl": ((ratio - 1) - torch.log(ratio)).mean()}


def _minibatch_envs(perm: torch.Tensor, i: int, mb_envs: int) -> torch.Tensor:
    """The envs of minibatch `i` of an epoch: the i-th cut of its
    permutation."""
    return perm[i * mb_envs:(i + 1) * mb_envs]


class _Update:
    """A minibatch's update over fixed buffers, in three phases: `replay`
    (the forward over the segments and the loss), `backward` (the
    gradients, clipped by their global norm) and `adam` (Adam's step on the
    weights and moments in place). Under fixed inputs Adam's count is a
    device number (``count``, set from the train state's before each
    iteration), so that no phase takes a host value that changes; otherwise
    the host's.

    With `graphs` each phase is captured once as a CUDA graph, in one
    memory pool, and `run` replays the three; otherwise `run` calls them.
    `matches` tells whether the train state still holds the tensors, and the
    config and shapes are those, that the buffers were made for."""

    def __init__(self, model: nn.Module, ts: TrainState, cfg: RPPOConfig, continuous: bool,
                 seqs: Sequence[torch.Tensor], state, mb_envs: int, graphs: bool):
        self.cfg, self.continuous = cfg, continuous
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.m = [ts.m[n] for n in self.names]
        self.v = [ts.v[n] for n in self.names]
        self.key = self._key(model, ts)
        # the loss's sums take their order from the minibatch's strides: the
        # LSTM's segments are contiguous, as its plain reference gathers them;
        # the GRU's are the first columns of buffers of the rollout's shape,
        # the strides of the cut of a shuffled rollout it has always taken
        self.seqs = tuple(x.new_empty((x.shape[0], mb_envs) + tuple(x.shape[2:])) if _fixed(cfg)
                          else x.new_empty(x.shape)[:, :mb_envs] for x in seqs)
        self.state = _map_state(lambda x: x.new_empty((mb_envs,) + tuple(x.shape[1:])), state)
        self.count = torch.zeros((), dtype=torch.float64, device=self.params[0].device) \
            if _fixed(cfg) else 0
        self.graphs: Optional[List[torch.cuda.CUDAGraph]] = [] if graphs else None

    @staticmethod
    def _key(model: nn.Module, ts: TrainState) -> Tuple[int, ...]:
        names = [n for n, _ in model.named_parameters()]
        return tuple(x.data_ptr() for x in [*model.parameters(), *(ts.m[n] for n in names),
                                            *(ts.v[n] for n in names)])

    def matches(self, model: nn.Module, ts: TrainState, cfg: RPPOConfig, seqs,
                mb_envs: int) -> bool:
        return self.key == self._key(model, ts) and self.cfg == cfg and all(
            a.shape == (b.shape[0], mb_envs) + tuple(b.shape[2:]) and a.dtype == b.dtype
            for a, b in zip(self.seqs, seqs))

    def set_count(self, count: int) -> None:
        if isinstance(self.count, torch.Tensor):
            self.count.fill_(count)
        else:
            self.count = count

    def load(self, seqs: Sequence[torch.Tensor], state, envs: torch.Tensor) -> None:
        """Gather the minibatch's envs into the buffers."""
        for dst, src in zip(self.seqs, seqs):
            dst.copy_(torch.index_select(src, 1, envs))
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            torch.index_select(src, 0, envs, out=dst)

    def replay(self, model: nn.Module) -> None:
        self.loss, mets = rppo_loss(model, self.cfg, self.seqs + (self.state,), self.continuous)
        self.metrics = torch.stack([mets[k].detach() for k in METRICS])

    def backward(self) -> None:
        grads = torch.autograd.grad(self.loss, self.params)
        self.grads = clip_by_global_norm(dict(zip(self.names, grads)), self.cfg.max_grad_norm)

    def adam(self) -> None:
        self.count += 1      # in place on the device's count
        for name, p, m, v in zip(self.names, self.params, self.m, self.v):
            m_new, v_new = adam_step(p, self.grads[name], m, v, self.cfg.lr, self.count)
            m.copy_(m_new)
            v.copy_(v_new)

    def run(self, model: nn.Module) -> None:
        phases = (lambda: self.replay(model), self.backward, self.adam)
        if self.graphs == []:
            # the first calls (cuBLAS's handles and workspaces, autograd's
            # state) outside any capture, on the stream that captures; the
            # weights, moments and count are left as they were
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(2):
                    self.replay(model)
                    self.backward()
            torch.cuda.current_stream().wait_stream(side)
            self.graphs = _capture(phases)
        for j, (name, phase) in enumerate(zip(("replay", "backward", "adam"), phases)):
            with span(f"train_step/update/{name}"):
                if self.graphs is None:
                    phase()
                else:
                    self.graphs[j].replay()


_updates: "weakref.WeakKeyDictionary[nn.Module, _Update]" = weakref.WeakKeyDictionary()


def _update_of(ts: TrainState, cfg: RPPOConfig, continuous: bool, seqs, state,
               mb_envs: int) -> _Update:
    """The model's `_Update`, made anew when the train state's tensors, the
    config or the shapes have changed since it was made."""
    upd = _updates.get(ts.model)
    if upd is None or not upd.matches(ts.model, ts, cfg, seqs, mb_envs):
        graphs = _fixed(cfg) and _graphs(seqs[0].device)
        upd = _Update(ts.model, ts, cfg, continuous, seqs, state, mb_envs, graphs)
        _updates[ts.model] = upd
    return upd


def _update(cfg: RPPOConfig, ts: TrainState, seqs, h_start, continuous: bool,
            generator: Optional[torch.Generator], perms, on_minibatch) -> List[torch.Tensor]:
    """``epochs x num_minibatches`` replayed updates; returns each
    minibatch's metric vector (`METRICS`)."""
    global replayed_steps
    device = seqs[0].device
    mb_envs = cfg.num_envs // cfg.num_minibatches
    upd = _update_of(ts, cfg, continuous, seqs, h_start, mb_envs)
    upd.set_count(ts.count)
    history = []
    for e in range(cfg.epochs):
        perm = perms[e] if perms is not None else torch.randperm(
            cfg.num_envs, generator=generator, device=device)
        perm = perm.to(device).long()
        for i in range(cfg.num_minibatches):
            with span("train_step/update/minibatch"):
                upd.load(seqs, h_start, _minibatch_envs(perm, i, mb_envs))
                upd.run(ts.model)
                ts.count += 1
                ts.step += 1
                replayed_steps += cfg.num_steps
                history.append(upd.metrics.clone())
                if on_minibatch is not None:
                    on_minibatch(len(history) - 1, history[-1], upd.grads)
    return history


def train_step(env: Env, env_params: EnvParams, cfg: RPPOConfig, ts: TrainState,
               bstate: BatchState, h, generator: Optional[torch.Generator] = None,
               perms: Optional[Sequence[torch.Tensor]] = None,
               act_noise: Optional[torch.Tensor] = None,
               env_noise: Optional[torch.Tensor] = None,
               on_rollout: Optional[Callable] = None,
               on_minibatch: Optional[Callable] = None):
    """One recurrent-PPO iteration: rollout, GAE, and ``epochs x
    num_minibatches`` replayed updates, each minibatch ``num_envs /
    num_minibatches`` whole env segments.

    Updates `ts` in place and returns (ts, bstate, h_last, metrics), the
    metrics as 0-d tensors on the device. `perms` holds one permutation of
    the envs per epoch. The GRU draws step by step from `generator`; the
    LSTM draws all the rollout's action noise, then all its env noise, before
    its first step. Where given, `on_rollout(traj, means)` is called after
    the rollout with its record and each step's first distribution leaf
    ``[T, B, A]`` (the Gaussian's means, or the logits), and
    `on_minibatch(j, metrics, grads)` after the j-th minibatch's step with
    its loss metrics (a vector in `METRICS` order) and the gradients Adam
    took, clipped, by parameter name; what they get is valid until the next
    call of its kind."""
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError(f"num_envs {cfg.num_envs} is not a multiple of num_minibatches "
                         f"{cfg.num_minibatches}")
    if perms is not None and len(perms) != cfg.epochs:
        raise ValueError(f"perms needs one permutation per epoch ({cfg.epochs})")
    continuous = _continuous(env)
    # the spans' names are what the benchmark's trace readers match
    with span("train_step"):
        with span("train_step/rollout"):
            bstate, h_last, h_start, traj, advantages, returns, means = _rollout(
                ts, env, env_params, cfg).run(ts.model, bstate, h, generator, act_noise,
                                              env_noise)
            if on_rollout is not None:
                on_rollout(traj, means)
        seqs = (traj.obs, traj.action, traj.done, traj.logp, traj.value, advantages, returns)
        with span("train_step/update"):
            history = _update(cfg, ts, seqs, h_start, continuous, generator, perms,
                              on_minibatch)
        with span("train_step/metrics"):
            per_metric = torch.stack(history, dim=1)
            metrics = {k: per_metric[j].mean() for j, k in enumerate(METRICS)}
            metrics["episode_return"] = _episode_metrics(traj)["episode_return"]
    return ts, bstate, h_last, metrics


def train(env: Env, cfg: RPPOConfig, iterations: int = 32, seed: int = 0,
          env_params: Optional[EnvParams] = None, verbose: bool = False, device=None):
    """Host loop over `train_step` on `device` (default: the card): the
    network from a CPU generator seeded with `seed`, the rollout's draws
    and the permutations from a generator on `device` seeded with `seed` +
    1. Returns (ts, history of float metrics per iteration)."""
    device = resolve(device)
    if env_params is None:
        env_params = env.params(device=device)
    ts = make_rppo_state(env, cfg, torch.Generator().manual_seed(seed), device)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    bstate = batched_reset(env, env_params, cfg.num_envs, device)
    h = init_hidden(cfg, cfg.num_envs, device)
    history = []
    for it in range(iterations):
        ts, bstate, h, metrics = train_step(env, env_params, cfg, ts, bstate, h, generator)
        history.append({k: float(v) for k, v in metrics.items()})
        if verbose:
            print(f"iter {it}: {history[-1]}")
    return ts, history


class RecurrentPPOPolicy:
    """sb3-style `.predict`; the state slot carries the recurrent state (the
    GRU's hidden, or the LSTMs' ``(h, c)`` of the actor then the critic). It
    has no `.act`, so `analysis.simulate_mdp` takes its host `.predict`
    loop, which threads the state from step to step."""

    def __init__(self, env: Env, ts: TrainState, cfg: RPPOConfig):
        self.env = env
        self.ts = ts
        self.cfg = cfg
        self.continuous = _continuous(env)

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        """(action, state) as numpy: the mean action or the argmax class,
        from `state` (zeros when None; the LSTM's a sequence of four arrays)
        with the rows of `episode_start` reset to zero first."""
        del deterministic
        device = next(self.ts.model.parameters()).device
        obs = torch.as_tensor(np.asarray(obs, np.float32), device=device)
        if state is None:
            h = init_hidden(self.cfg, obs.shape[0], device)
        else:
            state = tuple(state) if self.cfg.cell == "lstm" else state
            h = _map_state(lambda s: torch.as_tensor(np.asarray(s, np.float32), device=device),
                           state)
        if episode_start is not None:
            start = torch.as_tensor(np.asarray(episode_start, bool), device=device)
            h = _zero_done(h, start)
        with torch.no_grad():
            dist, _, h = self.ts.model(obs, h)
        action = dist[0] if self.continuous else torch.argmax(dist[0], dim=-1).to(torch.int32)
        return action.cpu().numpy(), _map_state(lambda x: x.cpu().numpy(), h)
