"""gymnasium.vector.VectorEnv adapter over the batched engine.

Counterpart of ``gym_fishing_tpu/envs/vector_env.py``. It exposes the
batched engine through the `gymnasium.vector.VectorEnv` protocol (batched
reset/step with auto-reset), numpy at the boundary, while every step runs as
`batched_step(autoreset=True)` on the device (default: the card):

    from gym_fishing_tpu_torch.envs.vector_env import FishingVectorEnv
    envs = FishingVectorEnv("fishing-v1", num_envs=4096, sigma=0.05)
    obs, infos = envs.reset(seed=0)
    obs, rew, term, trunc, infos = envs.step(actions)

Where gymnasium is installed the spaces are gymnasium's and the class is a
`gymnasium.vector.VectorEnv`; without it the base class is `object` and
there are no spaces.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

try:
    import gymnasium
    from gymnasium import spaces as gspaces

    _VectorBase = gymnasium.vector.VectorEnv
except Exception:  # gymnasium optional
    gymnasium = None
    _VectorBase = object

from gym_fishing_tpu_torch.batch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.registry.registry import make as registry_make


class FishingVectorEnv(_VectorBase):
    """Vectorized env: numpy at the boundary, one batched step inside."""

    def __init__(self, env_id: str = "fishing-v1", num_envs: int = 1024, seed: int = 0,
                 device=None, **overrides):
        self.env, self.params = registry_make(env_id, device=device, **overrides)
        self.device = self.params.device
        self.num_envs = num_envs
        if gymnasium is not None:
            if self.env.config.scheme == "continuous":
                self.single_action_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
            else:
                self.single_action_space = gspaces.Discrete(self.env.config.n_actions)
            self.single_observation_space = gspaces.Box(-1.0, 1.0, (1,), np.float32)
            self.action_space = gymnasium.vector.utils.batch_space(
                self.single_action_space, num_envs
            )
            self.observation_space = gymnasium.vector.utils.batch_space(
                self.single_observation_space, num_envs
            )
        self.Tmax = int(self.params.Tmax)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = batched_reset(self.env, self.params, num_envs)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._state = batched_reset(self.env, self.params, self.num_envs)
        obs = self.env.get_obs(self.params, self._state.env).float().cpu().numpy()
        return obs, {}

    def step(self, actions):
        if self.env.config.scheme == "continuous":
            a = torch.from_numpy(np.asarray(actions, np.float32).reshape(self.num_envs, 1))
        else:
            a = torch.from_numpy(np.asarray(actions, np.int64).reshape(self.num_envs)).to(
                torch.int32)
        self._state, ts = batched_step(self.env, self.params, self._state, a.to(self.device),
                                       self._generator, autoreset=True)
        # terminated = collapse, truncated = horizon only: the step carries
        # the collapse flag out, so a collapse exactly on the Tmax-th step is
        # terminated (as in gymnasium_compat)
        out = torch.stack([ts.obs[:, 0].float(), ts.reward.float(), ts.done.float(),
                           ts.collapsed.float(), ts.episode_return.float(),
                           ts.episode_length.float(), ts.harvest.float(),
                           ts.quota.float()]).cpu().numpy()   # one transfer
        done, terminated = out[2] > 0, out[3] > 0
        truncated = done & ~terminated
        infos = {
            "episode_return": out[4],
            "episode_length": out[5].astype(np.int32),
            "harvest": out[6],
            "quota": out[7],
        }
        return out[0][:, None], out[1], terminated, truncated, infos

    def render(self):
        return None

    def close(self, **kwargs):
        pass
