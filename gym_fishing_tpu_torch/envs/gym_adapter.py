"""Stateful gym-style adapter over the functional engine (drop-in surface).

Counterpart of ``gym_fishing_tpu/envs/gym_adapter.py``. A user of the
reference interacts with a mutable `gym.Env` (reset/step/render/simulate/
plot plus the attributes fish_population / harvest / years_passed); this
adapter reproduces that surface on the port's pure env: it owns one
`EnvState` and a CPU `torch.Generator`, steps on the CPU (one instance is
no work for a card) and speaks numpy in and out. The batched engine in
``gym_fishing_tpu_torch.batch`` is the performance path; this is the
compatibility path. The evaluation and plot helpers are imported where they
are called, so the adapter itself needs neither pandas nor matplotlib.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gym_fishing_tpu_torch.registry.registry import make as registry_make


class GymFishingEnv:
    """gym.Env-compatible wrapper: `GymFishingEnv("fishing-v1", sigma=0.1)`."""

    metadata = {"render.modes": ["ansi"]}

    def __init__(
        self,
        env_id: str = "fishing-v1",
        seed: int = 0,
        file: Optional[str] = None,
        **overrides,
    ):
        self.env, self.params = registry_make(env_id, device="cpu", **overrides)
        self.action_space = self.env.action_space
        self.observation_space = self.env.observation_space
        self.Tmax = int(self.params.Tmax)
        self._generator = torch.Generator().manual_seed(seed)
        self._state = None
        # reference-parity per-step episode log (the reference envs take a
        # file= CSV row-writing path): every step appends one tidy row
        # [time, state, action, reward, rep]; rep counts resets.
        self._file = open(file, "w") if file else None
        self._rep = -1
        if self._file:
            self._file.write("time,state,action,reward,rep\n")
        self.reset(seed=seed)

    # ------------------------------------------------------------- gym API
    def seed(self, seed: Optional[int] = None):
        if seed is not None:
            self._generator = torch.Generator().manual_seed(seed)
        return [seed]

    def reset(self, *, seed: Optional[int] = None, options=None, return_info: bool = False):
        del options
        if seed is not None:
            self.seed(seed)
        self._state = self.env.reset(self.params)
        self._rep += 1
        obs = self.env.get_obs(self.params, self._state).numpy()
        return (obs, {}) if return_info else obs

    def _action(self, action) -> torch.Tensor:
        if self.env.config.scheme == "continuous":
            return torch.from_numpy(np.asarray(action, np.float32).reshape(1))
        return torch.tensor(int(np.asarray(action)), dtype=torch.int32)

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        t_pre, x_pre = int(self._state.t), float(self._state.stock)
        self._state, ts = self.env.step(self.params, self._state, self._action(action),
                                        self._generator)
        info = {
            "quota": float(ts.quota),
            "harvest": float(ts.harvest),
            "stock": float(self._state.stock),
        }
        if self._file:
            a_log = (
                float(np.asarray(action).reshape(-1)[0])
                if self.env.config.scheme == "continuous"
                else int(np.asarray(action))
            )
            self._file.write(
                f"{t_pre},{x_pre},{a_log},{float(ts.reward)},{self._rep}\n"
            )
        return ts.obs.numpy(), float(ts.reward), bool(ts.done), info

    def render(self, mode: str = "ansi"):
        return (
            f"t={self.years_passed} stock={self.fish_population:.6f} "
            f"harvest={self.harvest:.6f}"
        )

    def close(self):
        if self._file:
            self._file.close()
            self._file = None

    # -------------------------------------------- reference-parity attrs
    @property
    def fish_population(self) -> float:
        return float(self._state.stock)

    @property
    def harvest(self) -> float:
        return float(self._state.harvest)

    @property
    def years_passed(self) -> int:
        return int(self._state.t)

    # ---------------------------------------- reference-parity utilities
    def get_obs(self):
        return self.env.get_obs(self.params, self._state).numpy()

    def get_fish_population(self, obs) -> float:
        return float(self.env.get_fish_population(self.params, torch.as_tensor(np.asarray(obs))))

    def get_quota(self, action) -> float:
        return float(self.env.get_quota(self.params, self._state, self._action(action)))

    def get_action(self, quota: float):
        return self.env.get_action(self.params, self._state, quota).numpy()

    def simulate(self, model, reps: int = 1, file: Optional[str] = None):
        from gym_fishing_tpu_torch.analysis.plotting import write_csv
        from gym_fishing_tpu_torch.analysis.simulate import simulate_mdp

        df = simulate_mdp(self.env, model, reps=reps, params=self.params)
        if file:
            write_csv(df, file)
        return df

    def policyfn(self, model, reps: int = 1, n: int = 50):
        from gym_fishing_tpu_torch.analysis.simulate import estimate_policyfn

        return estimate_policyfn(self.env, model, reps=reps, n=n, params=self.params)

    def plot(self, df, output: Optional[str] = None):
        from gym_fishing_tpu_torch.analysis.plotting import plot_mdp

        return plot_mdp(df, output)

    def plot_policy(self, df, output: Optional[str] = None):
        from gym_fishing_tpu_torch.analysis.plotting import plot_policyfn

        return plot_policyfn(df, output)
