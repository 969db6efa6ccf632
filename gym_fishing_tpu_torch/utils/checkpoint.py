"""Checkpoint / resume of a training run.

Counterpart of ``gym_fishing_tpu/utils/checkpoint.py``. A checkpoint holds
the whole training tuple, so that a run resumed from it continues bit for
bit as if it had never stopped: the `TrainState` (network weights, Adam's
moments, the Adam count and the step), the `BatchState` (a wrapper's state
such as `StackedState` included) and the state of every `torch.Generator`
the run draws from (``get_state()``: a CUDA generator's Philox seed and
offset, which `agents.ppo_fused.rollout_seed_offset` reads, or a CPU
generator's Mersenne-Twister state).

Format: NumPy ``<path>/ckpt_<step>.npz`` of the path-flattened tree, plus a
JSON sidecar ``ckpt_<step>.meta.json`` with the step, a structure
fingerprint and the paths of the generator states. A tree is a dataclass,
dict, tuple or list of trees, or a leaf: a tensor, a Python number, a
`torch.nn.Module` (its ``state_dict``) or a `torch.Generator`.

`restore_checkpoint(path, target)` rebuilds the tree in the structure of
`target`: tensors on the template's device and dtype, numbers of the
template's type, a module as a copy of the template's with the saved
tensors, and each template generator with its state set to the saved one
(generators are restored in place and returned).

The JAX package's second backend, orbax, is a JAX library; the port has the
npz backend only, and ``backend="orbax"`` raises.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_BACKENDS = ("npz",)


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise ValueError("backend='orbax' is a JAX library and is not ported; use 'npz'")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown checkpoint backend {backend!r}; the port has 'npz'")


def _is_record(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _children(tree) -> List[Tuple[str, Any]]:
    """(name, subtree) of a container node, in a fixed order; [] for a leaf."""
    if _is_record(tree):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict(keep_vars=True).items())
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_container(tree) -> bool:
    return (_is_record(tree) or isinstance(tree, (torch.nn.Module, dict, tuple, list)))


def _structure(tree) -> str:
    """A structure fingerprint: node types and names, no values or shapes."""
    if tree is None:
        return "None"
    if isinstance(tree, torch.Generator):
        return f"Generator({tree.device.type})"
    if _is_container(tree):
        inner = ", ".join(f"{k}={_structure(v)}" for k, v in _children(tree))
        return f"{type(tree).__name__}({inner})"
    return "*"


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf; generators are leaves."""
    if tree is None:
        return []
    if not isinstance(tree, torch.Generator) and _is_container(tree):
        out = []
        for k, v in _children(tree):
            out += _flatten(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, step: int = 0, backend: str = "npz") -> str:
    """Save `tree` to ``<path>/ckpt_<step>.npz`` (+ meta sidecar); returns the
    file name."""
    _check_backend(backend)
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(tree)
    flat = {k: _to_numpy(v) for k, v in leaves}
    fname = os.path.join(path, f"ckpt_{step}.npz")
    np.savez(fname, **flat)
    meta = {
        "step": step,
        "treedef": _structure(tree),
        "generator_paths": [k for k, v in leaves if isinstance(v, torch.Generator)],
    }
    with open(os.path.join(path, f"ckpt_{step}.meta.json"), "w") as f:
        json.dump(meta, f)
    return fname


def latest_step(path: str, backend: str = "npz") -> Optional[int]:
    _check_backend(backend)
    if not os.path.isdir(path):
        return None
    steps = [
        int(f[len("ckpt_"):-len(".npz")])
        for f in os.listdir(path)
        if f.startswith("ckpt_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def _rebuild(template, data: Dict[str, np.ndarray], prefix: str = ""):
    """`template`'s structure with the saved leaves."""
    if template is None:
        return None
    if isinstance(template, torch.Generator):
        template.set_state(torch.from_numpy(np.array(data[prefix[:-1]])))
        return template
    if isinstance(template, torch.nn.Module):
        module = copy.deepcopy(template)
        state = {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in _children(template)}
        module.load_state_dict(state)
        return module
    if _is_record(template):
        return dataclasses.replace(template, **{
            k: _rebuild(v, data, f"{prefix}{k}/") for k, v in _children(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, data, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        out = [_rebuild(v, data, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(*out) if hasattr(template, "_fields") else type(template)(out)
    key = prefix[:-1]
    arr = data[key]
    if isinstance(template, torch.Tensor):
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(
                f"checkpoint shape mismatch at {key!r}: saved {tuple(arr.shape)} != target "
                f"{tuple(template.shape)} (e.g. restoring into a model/buffer built with "
                "different sizes)")
        return torch.from_numpy(np.array(arr)).to(device=template.device, dtype=template.dtype)
    if arr.shape != np.shape(template):
        raise ValueError(f"checkpoint shape mismatch at {key!r}: saved {arr.shape} != target "
                         f"{np.shape(template)}")
    return type(template)(arr.item()) if np.ndim(template) == 0 else arr


def restore_checkpoint(
    path: str, target: Any, step: Optional[int] = None, backend: str = "npz"
) -> Tuple[Any, int]:
    """Restore into the structure of `target` (a template tree); returns
    (tree, step). Raises on a structure or shape that differs from the
    saved one."""
    _check_backend(backend)
    if step is None:
        step = latest_step(path, backend=backend)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path!r}")
    with open(os.path.join(path, f"ckpt_{step}.meta.json")) as f:
        meta = json.load(f)
    if meta["treedef"] != _structure(target):
        raise ValueError(
            "checkpoint structure mismatch: "
            f"saved {meta['treedef']} != target {_structure(target)}"
        )
    with np.load(os.path.join(path, f"ckpt_{step}.npz")) as data:
        return _rebuild(target, dict(data.items())), step
