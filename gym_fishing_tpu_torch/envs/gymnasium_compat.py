"""Gymnasium-native env + registration (reference `gym.make` parity).

Counterpart of ``gym_fishing_tpu/envs/gymnasium_compat.py``: a
`gymnasium.Env` over the port's env with the terminated/truncated split
(terminated = stock collapse, truncated = Tmax horizon), registered for every
id of the registry as ``"gym_fishing_tpu_torch/<id>"``:

    import gymnasium, gym_fishing_tpu_torch.envs.gymnasium_compat  # noqa
    env = gymnasium.make("gym_fishing_tpu_torch/fishing-v1")

The bare ids (``"fishing-v1"``) are the reference package's registration
and are left to it. One instance steps on the CPU from its own generator.
Importing this module needs gymnasium; the rest of the port does not.
"""

from __future__ import annotations

from typing import Optional

import gymnasium
import numpy as np
import torch
from gymnasium import spaces as gspaces

from gym_fishing_tpu_torch.registry.registry import make as registry_make
from gym_fishing_tpu_torch.registry.registry import registered_ids

NAMESPACE = "gym_fishing_tpu_torch"


class GymnasiumFishingEnv(gymnasium.Env):
    metadata = {"render_modes": ["ansi"]}

    def __init__(self, env_id: str = "fishing-v1", render_mode: Optional[str] = None,
                 **overrides):
        super().__init__()
        self.env, self.params = registry_make(env_id, device="cpu", **overrides)
        self.render_mode = render_mode
        if self.env.config.scheme == "continuous":
            self.action_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
        else:
            self.action_space = gspaces.Discrete(self.env.config.n_actions)
        self.observation_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
        self.Tmax = int(self.params.Tmax)
        self._generator = torch.Generator().manual_seed(0)
        self._state = self.env.reset(self.params)

    def reset(self, *, seed: Optional[int] = None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator = torch.Generator().manual_seed(seed)
        self._state = self.env.reset(self.params)
        obs = self.env.get_obs(self.params, self._state).numpy().astype(np.float32)
        return obs, {}

    def step(self, action):
        if self.env.config.scheme == "continuous":
            a = torch.from_numpy(np.asarray(action, np.float32).reshape(1))
        else:
            a = torch.tensor(int(np.asarray(action)), dtype=torch.int32)
        self._state, ts = self.env.step(self.params, self._state, a, self._generator)
        obs = ts.obs.numpy().astype(np.float32)
        reward = float(ts.reward)
        stock = float(self._state.stock)
        terminated = stock <= 0.0
        truncated = int(self._state.t) >= self.Tmax and not terminated
        info = {"quota": float(ts.quota), "harvest": float(ts.harvest), "stock": stock}
        return obs, reward, terminated, truncated, info

    def render(self):
        return (
            f"t={int(self._state.t)} stock={float(self._state.stock):.6f} "
            f"harvest={float(self._state.harvest):.6f}"
        )


def register_all() -> None:
    """Register every env id as ``gym_fishing_tpu_torch/<id>`` (idempotent)."""
    existing = set(gymnasium.registry.keys())
    for env_id in registered_ids():
        name = f"{NAMESPACE}/{env_id}"
        if name in existing:
            continue
        gymnasium.register(
            id=name,
            entry_point="gym_fishing_tpu_torch.envs.gymnasium_compat:GymnasiumFishingEnv",
            kwargs={"env_id": env_id},
        )


register_all()
