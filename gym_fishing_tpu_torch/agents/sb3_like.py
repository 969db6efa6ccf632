"""stable-baselines3-style facades over the port's learners.

Counterpart of ``gym_fishing_tpu/agents/sb3_like.py``. The reference's
workflow is ``PPO("MlpPolicy", env).learn(...)``, then ``.predict`` and
``.save``; these facades keep it, so a script moves over by changing its
import:

    from gym_fishing_tpu_torch.agents.sb3_like import PPO
    model = PPO("MlpPolicy", "fishing-v1", num_envs=4096)
    model.learn(total_timesteps=2_000_000)
    action, _ = model.predict(obs)
    model.save("ppo_fishing")

`PPO` and `A2C` run one on-policy iteration per ``num_envs x num_steps``
timesteps; `SAC`, `TD3` (continuous) and `DQN` (discrete) one batched env
step per ``num_envs``. Every facade takes ``device`` (default: the card)
and ``seed``: the networks are initialised from a CPU generator seeded with
`seed`, and every draw of training comes from one generator on the device
seeded with `seed` + 1. With ``fused_rollout=True`` the PPO facade keeps the
env params on the host, where the policy-rollout kernel reads them without a
sync.

`save` writes the whole training tuple through ``utils/checkpoint.py``: the
learner state (networks, optimizer moments and counts, targets, the replay
buffer), the batch state, the generator (and through it the Philox seed and
offset of the fused rollout) and the timestep count. `load` rebuilds a
facade from the same arguments and restores it, so a loaded model learns on
bit for bit as the one that never stopped. `learn` reads each metric as a
float once per iteration or step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from gym_fishing_tpu_torch.agents.a2c import A2CConfig, a2c_train_step, make_a2c_state
from gym_fishing_tpu_torch.agents.dqn import DQNConfig, DQNPolicy, dqn_train_step, make_dqn_state
from gym_fishing_tpu_torch.agents.ppo import PPOConfig, PPOPolicy, make_train_state, train_step
from gym_fishing_tpu_torch.agents.sac import SACConfig, SACPolicy, make_sac_state, sac_train_step
from gym_fishing_tpu_torch.agents.td3 import TD3Config, TD3Policy, make_td3_state, td3_train_step
from gym_fishing_tpu_torch.batch import batched_reset
from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvParams
from gym_fishing_tpu_torch.device import resolve
from gym_fishing_tpu_torch.registry.registry import make as registry_make
from gym_fishing_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint


def _resolve_env(env, device=None) -> Tuple[Env, EnvParams]:
    """(env, params) from an env id, an `Env` (its default params on
    `device`), an ``(env, params)`` tuple, or a gym adapter carrying ``.env``
    and ``.params``."""
    if isinstance(env, str):
        return registry_make(env, device=device)
    if isinstance(env, Env):
        return env, env.params(device=device)
    if isinstance(env, tuple) and len(env) == 2:
        return env
    if hasattr(env, "env") and hasattr(env, "params"):
        return env.env, env.params
    raise TypeError(f"cannot resolve environment from {type(env)!r}")


def _floats(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


class _Facade:
    """What every facade shares: construction from (policy, env, seed,
    verbose, device, config kwargs), `predict`, and save / load of
    `_checkpoint_tree`."""

    _cfg_cls: Any = None
    _default_env = "fishing-v1"
    _log_interval = 100

    def __init__(self, policy: str = "MlpPolicy", env: Any = None, seed: int = 0,
                 verbose: int = 0, device=None, **cfg_kwargs):
        if policy != "MlpPolicy":
            raise ValueError("only MlpPolicy is supported (reference parity)")
        self.device = resolve(device)
        self.cfg = self._cfg_cls(**cfg_kwargs)
        self.env, params = _resolve_env(env if env is not None else self._default_env,
                                        self.device)
        self.env_params = params.astype(params.dtype, self._params_device())
        self.verbose = verbose
        self.generator = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._build(torch.Generator().manual_seed(seed))
        self.num_timesteps = 0
        self.history: list = []

    def _params_device(self) -> torch.device:
        return self.device

    def _build(self, init_generator: torch.Generator) -> None:
        raise NotImplementedError

    def _step(self, draws) -> Dict[str, Any]:
        """One iteration of the learner on the facade's state -> metrics."""
        raise NotImplementedError

    def _timesteps_per_iteration(self) -> int:
        return self.cfg.num_envs

    def train_iteration(self, **draws) -> Dict[str, float]:
        """One iteration of the learner, its metrics read as floats; `draws`
        (the train step's injectable noise, indices and permutations)
        replace the generator's."""
        m = _floats(self._step(draws))
        self.num_timesteps += self._timesteps_per_iteration()
        self.history.append(m)
        return m

    def learn(self, total_timesteps: int, callback=None, log_interval: Optional[int] = None):
        per_iter = self._timesteps_per_iteration()
        iterations = max(1, math.ceil(total_timesteps / per_iter))
        log_interval = log_interval or self._log_interval
        for it in range(iterations):
            m = self.train_iteration()
            if callback is not None:
                callback(self, m)
            if self.verbose and it % log_interval == 0:
                print(f"iter {it}/{iterations} steps={self.num_timesteps} "
                      f"ep_ret={m.get('episode_return', float('nan')):.3f}")
        return self

    def predict(self, obs, state=None, episode_start=None, deterministic=True):
        return self.policy.predict(obs, state=state, episode_start=episode_start,
                                   deterministic=deterministic)

    def _checkpoint_tree(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _set_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        raise NotImplementedError

    def save(self, path: str) -> None:
        save_checkpoint(path, dict(self._checkpoint_tree(), generator=self.generator,
                                   num_timesteps=self.num_timesteps), step=0)

    @classmethod
    def load(cls, path: str, env: Any = None, **kwargs):
        """A facade built from `env` and `kwargs` (the saved model's own),
        with the saved training tuple restored."""
        model = cls(env=env, **kwargs)
        template = dict(model._checkpoint_tree(), generator=model.generator,
                        num_timesteps=model.num_timesteps)
        restored, _ = restore_checkpoint(path, template, step=0)
        model._set_checkpoint_tree(restored)
        model.generator = restored["generator"]
        model.num_timesteps = restored["num_timesteps"]
        return model


class PPO(_Facade):
    """sb3-compatible surface over `agents/ppo.py`: __init__(policy, env),
    learn, predict, save / load. The fused flags (`fused_update`,
    `fused_rollout`, `fused_adam`) route each iteration through the
    kernels: K4 once and K3 ``epochs x num_minibatches`` times."""

    _cfg_cls = PPOConfig
    _log_interval = 10
    _make_state = staticmethod(make_train_state)
    _train_step = staticmethod(train_step)

    def _params_device(self) -> torch.device:
        fused_rollout = getattr(self.cfg, "fused_rollout", False)
        return torch.device("cpu") if fused_rollout else self.device

    def _build(self, init_generator):
        self.train_state = self._make_state(self.env, self.cfg, init_generator, self.device)
        self._bstate = batched_reset(self.env, self.env_params, self.cfg.num_envs, self.device)

    def _step(self, draws):
        self.train_state, self._bstate, metrics = self._train_step(
            self.env, self.env_params, self.cfg, self.train_state, self._bstate,
            self.generator, **draws)
        return metrics

    def _timesteps_per_iteration(self) -> int:
        return self.cfg.num_envs * self.cfg.num_steps

    @property
    def policy(self) -> PPOPolicy:
        return PPOPolicy(self.env, self.train_state)

    def _checkpoint_tree(self):
        return {"train_state": self.train_state, "env_state": self._bstate}

    def _set_checkpoint_tree(self, tree):
        self.train_state, self._bstate = tree["train_state"], tree["env_state"]


class A2C(PPO):
    """sb3-style A2C: the on-policy surface, one unclipped RMSProp update per
    iteration."""

    _cfg_cls = A2CConfig
    _make_state = staticmethod(make_a2c_state)
    _train_step = staticmethod(a2c_train_step)


class _OffPolicyAlgo(_Facade):
    """The sb3-style surface of the off-policy learners (SAC, TD3, DQN). One
    `.learn` timestep is one env step of one instance, so a batched step of
    ``num_envs`` instances counts ``num_envs``."""

    _policy_cls: Any = None
    _make_state: Any = None
    _train_step: Any = None

    def _build(self, init_generator):
        self.state = self._make_state(self.env, self.cfg, init_generator, self.env_params,
                                      self.device)

    def _step(self, draws):
        self.state, metrics = self._train_step(self.env, self.env_params, self.cfg, self.state,
                                               self.generator, **draws)
        return metrics

    @property
    def policy(self):
        return self._policy_cls(self.env, self.state)

    def _checkpoint_tree(self):
        return {"state": self.state}

    def _set_checkpoint_tree(self, tree):
        self.state = tree["state"]


class SAC(_OffPolicyAlgo):
    """sb3-style SAC (continuous envs)."""

    _cfg_cls = SACConfig
    _policy_cls = SACPolicy
    _make_state = staticmethod(make_sac_state)
    _train_step = staticmethod(sac_train_step)


class TD3(_OffPolicyAlgo):
    """sb3-style TD3 (continuous envs)."""

    _cfg_cls = TD3Config
    _policy_cls = TD3Policy
    _make_state = staticmethod(make_td3_state)
    _train_step = staticmethod(td3_train_step)


class DQN(_OffPolicyAlgo):
    """sb3-style DQN (discrete envs)."""

    _cfg_cls = DQNConfig
    _default_env = "fishing-v0"
    _make_state = staticmethod(make_dqn_state)
    _train_step = staticmethod(dqn_train_step)

    @property
    def policy(self) -> DQNPolicy:
        return DQNPolicy(self.env, self.state, self.env_params)
