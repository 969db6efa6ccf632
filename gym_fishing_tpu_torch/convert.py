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

The recurrent actor-critic's flax ``GRUCell`` (``gru``: Dense layers ``ir``,
``iz``, ``in`` and ``hn`` with a bias, ``hr`` and ``hz`` without) becomes the
port's `GRUCell` in `torch.nn.GRUCell`'s layout: ``weight_ih = [Wir; Wiz;
Win]ᵀ``, ``bias_ih = [bir, biz, bin]``, ``weight_hh = [Whr; Whz; Whn]ᵀ`` and
``bias_hn = bhn`` (torch's ``bias_hh`` would be ``[0, 0, bhn]``). The
off-policy networks flax names by call order (``Dense_0``, ...) take the
port's names through `SAC_ACTOR_NAMES`, `TD3_ACTOR_NAMES` and
`Q_NETWORK_NAMES`; the double critic's names are the same in both.
`off_policy_from_numpy` and `adam_from_numpy` (a plain ``optax.adam`` state,
no clip chain, as an `AdamState`) take such a mapping, and
`actor_critic_to_numpy(..., names=...)` inverts every conversion.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from gym_fishing_tpu_torch.agents.es import DeterministicPolicy
from gym_fishing_tpu_torch.agents.dqn import QNetwork
from gym_fishing_tpu_torch.agents.ppo import ActorCritic
from gym_fishing_tpu_torch.agents.ppo_rnn import RecurrentActorCritic
from gym_fishing_tpu_torch.agents.sac import AdamState, DoubleCritic, SquashedGaussianActor
from gym_fishing_tpu_torch.agents.td3 import DeterministicActor
from gym_fishing_tpu_torch.batch.batch import BatchState
from gym_fishing_tpu_torch.core.types import EnvParams, EnvState
from gym_fishing_tpu_torch.device import resolve

SAC_ACTOR_NAMES = {"Dense_0": "d1", "Dense_1": "d2", "Dense_2": "mean", "Dense_3": "log_std"}
TD3_ACTOR_NAMES = {"Dense_0": "d1", "Dense_1": "d2", "Dense_2": "out"}
Q_NETWORK_NAMES = TD3_ACTOR_NAMES
_GATES = ("r", "z", "n")

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


def _gru_from_flax(gru: Mapping) -> Dict[str, np.ndarray]:
    """flax GRUCell params -> the port's GRUCell names (torch layout)."""
    k = lambda name: np.asarray(gru[name]["kernel"]).T  # noqa: E731
    return {
        "weight_ih": np.concatenate([k(f"i{g}") for g in _GATES]),
        "bias_ih": np.concatenate([np.asarray(gru[f"i{g}"]["bias"]) for g in _GATES]),
        "weight_hh": np.concatenate([k(f"h{g}") for g in _GATES]),
        "bias_hn": np.asarray(gru["hn"]["bias"]),
    }


def _gru_to_flax(named: Mapping[str, np.ndarray]) -> Dict[str, Dict]:
    w_ih, b_ih = np.split(named["weight_ih"], 3), np.split(named["bias_ih"], 3)
    w_hh = np.split(named["weight_hh"], 3)
    tree = {}
    for i, g in enumerate(_GATES):
        tree[f"i{g}"] = {"kernel": w_ih[i].T, "bias": b_ih[i]}
        tree[f"h{g}"] = {"kernel": w_hh[i].T}
    tree["hn"]["bias"] = named["bias_hn"]
    return tree


def _named_from_flax(tree: Mapping, names: Optional[Mapping[str, str]] = None
                     ) -> Dict[str, np.ndarray]:
    """flax {"params": {layer: {"kernel", "bias"}, "log_std"}} -> parameter
    names and arrays in `torch.nn.Linear` layout; `names` renames layers."""
    tree = tree.get("params", tree)
    names = names or {}
    out = {}
    for layer, val in tree.items():
        layer = names.get(layer, layer)
        if isinstance(val, Mapping) and "ir" in val:
            out.update({f"{layer}.{k}": v for k, v in _gru_from_flax(val).items()})
        elif isinstance(val, Mapping):
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


def recurrent_actor_critic_from_numpy(tree: Mapping, device=None) -> RecurrentActorCritic:
    """A port RecurrentActorCritic loaded with the flax tree's values (the
    GRU mapped as the module docstring says), on `device` (default: the
    card)."""
    named = _named_from_flax(tree)
    continuous = "pi_mean.weight" in named
    head = named["pi_mean.weight" if continuous else "pi_logits.weight"]
    hidden, obs_dim = named["embed.weight"].shape
    model = RecurrentActorCritic(obs_dim, head.shape[0], continuous, hidden)
    return _load(model, named, resolve(device))


def off_policy_from_numpy(kind: str, tree: Mapping, device=None) -> torch.nn.Module:
    """One of the off-policy networks, ``kind`` "sac_actor", "critic",
    "td3_actor" or "q", loaded with the flax tree's values on `device`
    (default: the card)."""
    names = {"sac_actor": SAC_ACTOR_NAMES, "td3_actor": TD3_ACTOR_NAMES,
             "q": Q_NETWORK_NAMES, "critic": None}[kind]
    named = _named_from_flax(tree, names)
    if kind == "critic":
        hidden, in_dim = named["q1_d1.weight"].shape
        model = DoubleCritic(in_dim - 1, 1, hidden)
    else:
        hidden, obs_dim = named["d1.weight"].shape
        out = named["mean.weight" if kind == "sac_actor" else "out.weight"].shape[0]
        cls = {"sac_actor": SquashedGaussianActor, "td3_actor": DeterministicActor,
               "q": QNetwork}[kind]
        model = cls(obs_dim, out, hidden)
    return _load(model, named, resolve(device))


def adam_state_from_numpy(mu: Mapping, nu: Mapping, count,
                          names: Optional[Mapping[str, str]] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor], int]:
    """optax ScaleByAdamState fields (mu and nu as flax-shaped trees, count)
    -> (m, v, count) keyed by the port's parameter names."""
    def conv(tree):
        return {k: torch.as_tensor(np.array(v, dtype=np.float32))
                for k, v in _named_from_flax(tree, names).items()}

    return conv(mu), conv(nu), int(np.asarray(count))


def adam_from_numpy(mu: Mapping, nu: Mapping, count,
                    names: Optional[Mapping[str, str]] = None, device=None) -> AdamState:
    """A plain optax.adam state (its ScaleByAdamState's mu, nu and count)
    as the off-policy learners' `AdamState` on `device` (default: the
    card)."""
    device = resolve(device)
    m, v, count = adam_state_from_numpy(mu, nu, count, names)
    return AdamState(m={k: x.to(device) for k, x in m.items()},
                     v={k: x.to(device) for k, x in v.items()}, count=count)


def actor_critic_to_numpy(params, names: Optional[Mapping[str, str]] = None) -> Dict[str, Dict]:
    """Inverse of the conversions above: a model (or a name -> tensor
    mapping such as Adam's moments) -> the flax tree of numpy arrays;
    `names` is the flax -> port mapping of the layer names to undo."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    back = {v: k for k, v in (names or {}).items()}
    tree: Dict[str, Dict] = {}
    gru: Dict[str, Dict[str, np.ndarray]] = {}
    for name, t in params.items():
        arr = t.detach().cpu().numpy()
        if "." in name:
            layer, kind = name.split(".")
            if kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hn"):
                gru.setdefault(layer, {})[kind] = arr
                continue
            tree.setdefault(back.get(layer, layer), {})[
                "kernel" if kind == "weight" else "bias"] = arr.T if kind == "weight" else arr
        else:
            tree[name] = arr
    for layer, named in gru.items():
        tree[layer] = _gru_to_flax(named)
    return {"params": tree}
