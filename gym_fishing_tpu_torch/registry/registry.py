"""Environment registry: id string -> assembled Env (+ default params).

Counterpart of ``gym_fishing_tpu/registry/registry.py``, with the same 26
ids: ``fishing-v0`` (discrete, relative decode) and ``fishing-v1``
(continuous), descriptive growth-variant ids in both forms, the mixture,
May-with-observation-noise and non-stationary variants, and the numbered
aliases ``fishing-v2`` and ``fishing-v4`` … ``fishing-v10``.

`make(id, **overrides)` mirrors `gym.make(id, sigma=0.1, ...)`: overrides are
split between static config keys (growth/noise_form/scheme/n_actions) and
EnvParams fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from gym_fishing_tpu_torch.core.env import Env
from gym_fishing_tpu_torch.core.types import EnvConfig, EnvParams
from gym_fishing_tpu_torch.device import resolve

_STATIC_KEYS = ("growth", "noise_form", "scheme", "n_actions")
_PARAM_KEYS = tuple(f.name for f in dataclasses.fields(EnvParams))

_REGISTRY: Dict[str, Tuple[EnvConfig, EnvParams]] = {}


def register(env_id: str, config: EnvConfig, params: EnvParams = EnvParams()) -> None:
    if env_id in _REGISTRY:
        raise ValueError(f"env id {env_id!r} already registered")
    _REGISTRY[env_id] = (config, params)


def registered_ids():
    return sorted(_REGISTRY)


def make(
    env_id: str, dtype=torch.float32, device=None, **overrides
) -> Tuple[Env, EnvParams]:
    """Build (env, params) for a registered id, gym.make-style.

    Static overrides (growth, noise_form, scheme, n_actions) rebuild the
    EnvConfig; everything else overrides EnvParams fields. Params are returned
    as tensors of `dtype` on `device` (default: the card; without one this
    raises, and ``device="cpu"`` asks for the CPU).
    """
    device = resolve(device)
    if env_id not in _REGISTRY:
        raise ValueError(f"unknown env id {env_id!r}; known: {registered_ids()}")
    config, params = _REGISTRY[env_id]

    static = {k: v for k, v in overrides.items() if k in _STATIC_KEYS}
    dyn = {k: v for k, v in overrides.items() if k not in _STATIC_KEYS}
    unknown = [k for k in dyn if k not in _PARAM_KEYS]
    if unknown:
        raise TypeError(f"unknown override(s) {unknown} for {env_id!r}")

    # The discrete env's decode is n_actions-driven: n_actions=3 is the
    # relative (maintain/±20%) scheme, a larger n the proportional quota grid.
    # Passing n_actions != 3 without an explicit scheme switches accordingly.
    if (
        "n_actions" in static
        and "scheme" not in static
        and config.scheme == "relative"
        and static["n_actions"] != 3
    ):
        static["scheme"] = "proportional"

    if static:
        config = dataclasses.replace(config, **static)
    if dyn:
        params = params.replace(**dyn)

    env = Env(id=env_id, config=config, default_params=params)
    return env, params.astype(dtype, device)


def _register_all() -> None:
    growth_defaults = {
        "logistic": {},
        "ricker": {},
        "beverton_holt": {},
        "allen": {},
        "myers": {"r": 3.0},
        "may": {"r": 0.75, "sigma": 0.05},
    }
    # Reference-named flagship ids (logistic).
    register("fishing-v0", EnvConfig(scheme="relative", growth="logistic"))
    register("fishing-v1", EnvConfig(scheme="continuous", growth="logistic"))
    # Descriptive growth-variant ids, discrete (-v0) and continuous (-v1).
    for g, overrides in growth_defaults.items():
        if g == "logistic":
            continue
        p = EnvParams().replace(**overrides)
        register(f"fishing-{g.replace('_', '-')}-v0", EnvConfig(scheme="relative", growth=g), p)
        register(f"fishing-{g.replace('_', '-')}-v1", EnvConfig(scheme="continuous", growth=g), p)
    # Growth-model-uncertainty (mixture) variant: model_idx selects the
    # effective model per instance.
    register("fishing-mixture-v0", EnvConfig(scheme="relative", growth="mixture"))
    register("fishing-mixture-v1", EnvConfig(scheme="continuous", growth="mixture"))
    # May tipping point + observation noise.
    p_obs = EnvParams().replace(r=0.75, sigma=0.05, sigma_m=0.05)
    register("fishing-may-obs-v0", EnvConfig(scheme="relative", growth="may"), p_obs)
    register("fishing-may-obs-v1", EnvConfig(scheme="continuous", growth="may"), p_obs)
    # Non-stationary variant: productivity declines linearly, r 0.3 -> 0.1
    # over the default 100-step horizon (r_eff = r + r_drift * t).
    p_ns = EnvParams().replace(r_drift=-0.002)
    register("fishing-nonstationary-v0", EnvConfig(scheme="relative"), p_ns)
    register("fishing-nonstationary-v1", EnvConfig(scheme="continuous"), p_ns)

    # Numbered alias ids; each is the continuous form of its descriptive id.
    # fishing-v3 is deliberately absent (no known reference env behind it).
    for alias, target in {
        "fishing-v2": "fishing-v1",             # + observation error, below
        "fishing-v4": "fishing-allen-v1",
        "fishing-v5": "fishing-beverton-holt-v1",
        "fishing-v6": "fishing-may-v1",
        "fishing-v7": "fishing-myers-v1",
        "fishing-v8": "fishing-ricker-v1",
        "fishing-v9": "fishing-nonstationary-v1",
        "fishing-v10": "fishing-mixture-v1",
    }.items():
        config, params = _REGISTRY[target]
        if alias == "fishing-v2":
            # observation-error variant of the flagship logistic env
            params = params.replace(sigma_m=0.05)
        register(alias, config, params)


_register_all()
