"""Legacy OpenAI `gym` registration shim (reference `gym.make` parity).

Counterpart of ``gym_fishing_tpu/envs/gym_registration.py``. The
reference's user surface is classic-gym registration, ``gym.make("fishing-v0")``;
this module registers the port's `GymFishingEnv` (the old 4-tuple step API)
with classic `gym` for codebases still on it:

    import gym, gym_fishing_tpu_torch.envs.gym_registration  # noqa
    env = gym.make("gym_fishing_tpu_torch/fishing-v0")

Import degrades gracefully: when classic `gym` is not installed, importing
this module is a no-op and `register_with_gym()` reports False. The ids are
namespaced, as in ``envs.gymnasium_compat``, so that they never shadow the
reference package's.
"""

from __future__ import annotations

from gym_fishing_tpu_torch.envs.gym_adapter import GymFishingEnv
from gym_fishing_tpu_torch.registry.registry import registered_ids

try:
    import gym as _gym
except Exception:  # ImportError or any gym-internal breakage
    _gym = None

NAMESPACE = "gym_fishing_tpu_torch"


class LegacyGymFishingEnv(GymFishingEnv):
    """GymFishingEnv with the classic-gym Env base when available.

    GymFishingEnv already speaks the old protocol (4-tuple step, seed(),
    reset() -> obs); subclassing gym.Env only adds the isinstance checks
    classic gym's `make` performs.
    """


if _gym is not None:
    # re-parent so gym.make's isinstance(env, gym.Env) checks pass
    LegacyGymFishingEnv = type("LegacyGymFishingEnv", (GymFishingEnv, _gym.Env), {})


def register_with_gym() -> bool:
    """Register every env id with classic `gym` (idempotent).

    Returns True iff classic gym is importable and registration ran.
    """
    if _gym is None:
        return False
    existing = set(getattr(_gym.envs.registry, "env_specs", _gym.envs.registry))
    for env_id in registered_ids():
        name = f"{NAMESPACE}/{env_id}"
        if name in existing:
            continue
        _gym.register(
            id=name,
            entry_point="gym_fishing_tpu_torch.envs.gym_registration:LegacyGymFishingEnv",
            kwargs={"env_id": env_id},
        )
    return True


REGISTERED = register_with_gym()
