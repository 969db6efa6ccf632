"""Carry the JAX package's parameters and batch state across to the port.

The JAX side hands over plain numpy arrays, one per field, so this module
never touches JAX:

    fields = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)}
    params = params_from_numpy(fields, torch.float64, "cpu")

`batch_state_from_numpy` takes the flattened fields of a JAX ``BatchState``:
``stock``, ``harvest`` and ``t`` of its ``env`` record, plus
``episode_return`` and ``episode_length``.

`actor_critic_from_numpy` takes the flax ``ActorCritic`` parameter tree as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``): each
flax ``kernel [in, out]`` becomes a ``Linear.weight [out, in]``; A2C's
network is the same. `deterministic_policy_from_numpy` does the same for
the ES learner's ``DeterministicPolicy`` (``d1``, ``d2``, ``out``).
`adam_state_from_numpy` converts optax's Adam moments, and
`actor_critic_to_numpy` goes back from any module or name -> tensor mapping,
so tests compare in the flax layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from gym_fishing_tpu_torch.agents.es import DeterministicPolicy
from gym_fishing_tpu_torch.agents.ppo import ActorCritic
from gym_fishing_tpu_torch.batch.batch import BatchState
from gym_fishing_tpu_torch.core.types import EnvParams, EnvState
from gym_fishing_tpu_torch.device import resolve

_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(EnvParams))
_BATCH_FIELDS = ("stock", "harvest", "t", "episode_return", "episode_length")


def _check_keys(fields: Mapping, expected) -> None:
    missing = [k for k in expected if k not in fields]
    extra = [k for k in fields if k not in expected]
    if missing or extra:
        raise KeyError(f"missing fields {missing}, unexpected fields {extra}")


def params_from_numpy(fields: Mapping[str, np.ndarray], dtype=torch.float32,
                      device=None) -> EnvParams:
    """EnvParams from one numpy array per field (Tmax and model_idx int32),
    on `device` (default: the card)."""
    _check_keys(fields, _PARAM_FIELDS)
    return EnvParams(**{k: torch.as_tensor(np.array(v)) for k, v in fields.items()}).astype(
        dtype, resolve(device)
    )


def batch_state_from_numpy(fields: Mapping[str, np.ndarray], dtype=torch.float32,
                           device=None) -> BatchState:
    """BatchState from numpy arrays shaped (num_envs,) (t, episode_length
    int32), on `device` (default: the card)."""
    _check_keys(fields, _BATCH_FIELDS)
    device = resolve(device)

    def cast(name, ty):
        return torch.as_tensor(np.array(fields[name]), device=device).to(ty).contiguous()

    return BatchState(
        env=EnvState(
            stock=cast("stock", dtype),
            harvest=cast("harvest", dtype),
            t=cast("t", torch.int32),
        ),
        episode_return=cast("episode_return", dtype),
        episode_length=cast("episode_length", torch.int32),
    )


def _named_from_flax(tree: Mapping) -> Dict[str, np.ndarray]:
    """flax {"params": {layer: {"kernel", "bias"}, "log_std"}} -> parameter
    names and arrays in `torch.nn.Linear` layout."""
    tree = tree.get("params", tree)
    out = {}
    for layer, val in tree.items():
        if isinstance(val, Mapping):
            out[f"{layer}.weight"] = np.asarray(val["kernel"]).T
            out[f"{layer}.bias"] = np.asarray(val["bias"])
        else:
            out[layer] = np.asarray(val)
    return out


def actor_critic_from_numpy(tree: Mapping, compute_dtype=torch.float32,
                            device=None) -> ActorCritic:
    """A port ActorCritic loaded with the flax parameter tree's values, on
    `device` (default: the card)."""
    device = resolve(device)
    named = _named_from_flax(tree)
    continuous = "pi_mean.weight" in named
    head = named["pi_mean.weight" if continuous else "pi_logits.weight"]
    hidden, obs_dim = named["pi_d1.weight"].shape
    model = ActorCritic(obs_dim=obs_dim, action_dim=head.shape[0], continuous=continuous,
                        hidden=hidden, compute_dtype=compute_dtype)
    return _load(model, named, device)


def _load(model: torch.nn.Module, named: Mapping[str, np.ndarray], device) -> torch.nn.Module:
    params = dict(model.named_parameters())
    _check_keys(named, tuple(params))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.array(named[name], dtype=np.float32)))
    return model.to(device)


def deterministic_policy_from_numpy(tree: Mapping, continuous: bool,
                                    device=None) -> DeterministicPolicy:
    """A port DeterministicPolicy loaded with the flax tree's values, on
    `device` (default: the card); `continuous` as the env's scheme says."""
    named = _named_from_flax(tree)
    hidden, obs_dim = named["d1.weight"].shape
    model = DeterministicPolicy(obs_dim, named["out.weight"].shape[0], continuous, hidden)
    return _load(model, named, resolve(device))


def adam_state_from_numpy(mu: Mapping, nu: Mapping, count
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """optax ScaleByAdamState fields (mu and nu as flax-shaped trees, count)
    -> (m, v, count) keyed by the port's parameter names."""
    def conv(tree):
        return {k: torch.as_tensor(np.array(v, dtype=np.float32))
                for k, v in _named_from_flax(tree).items()}

    return conv(mu), conv(nu), int(np.asarray(count))


def actor_critic_to_numpy(params) -> Dict[str, Dict]:
    """Inverse of `actor_critic_from_numpy`: a model (or a name -> tensor
    mapping such as Adam's moments) -> the flax tree of numpy arrays."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    tree: Dict[str, Dict] = {}
    for name, t in params.items():
        arr = t.detach().cpu().numpy()
        if "." in name:
            layer, kind = name.split(".")
            tree.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
                arr.T if kind == "weight" else arr)
        else:
            tree[name] = arr
    return {"params": tree}
