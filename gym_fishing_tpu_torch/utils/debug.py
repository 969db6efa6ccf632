"""Debug-mode invariants: RNG stream uniqueness and divergence checks.

Counterpart of ``gym_fishing_tpu/utils/debug.py``. The hazards here are (a)
two consumers drawing from one random stream, which correlates env
instances, and (b) two runs or replicas that drift apart. A stream of the
port's counter-based draws is named by its (seed, offset) pair, as
`agents.ppo_fused.rollout_seed_offset` hands them out, so the uniqueness
check takes an ``[n, 2]`` tensor of such pairs. These helpers read to the
host and are meant for tests and debug runs, not the hot path.
"""

from __future__ import annotations

import numpy as np
import torch

from gym_fishing_tpu_torch.core.tree import tree_leaves, tree_leaves_with_path


def assert_unique_keys(keys: torch.Tensor, name: str = "keys") -> None:
    """Raise if a batch of (seed, offset) pairs, ``[n, 2]``, holds a
    duplicate."""
    data = torch.as_tensor(keys).detach().cpu().reshape(-1, 2)
    uniq = torch.unique(data, dim=0)
    if uniq.shape[0] != data.shape[0]:
        raise AssertionError(
            f"{name}: {data.shape[0] - uniq.shape[0]} duplicate (seed, offset) pairs — "
            "stream reuse produces correlated env instances"
        )


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def trajectory_checksum(tree) -> float:
    """Order-independent scalar digest of a tree of tensors (float and
    integer leaves summed in float64), for comparing two runs."""
    total = 0.0
    for leaf in tree_leaves(tree):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) or np.issubdtype(arr.dtype, np.integer):
            total += float(np.sum(arr.astype(np.float64)))
    return total


def assert_finite(tree, name: str = "tree") -> None:
    """Raise if any float leaf contains NaN/Inf (post-update sanity gate)."""
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            bad = not bool(torch.isfinite(leaf.detach()).all())
        else:
            arr = np.asarray(leaf)
            bad = np.issubdtype(arr.dtype, np.floating) and not np.all(np.isfinite(arr))
        if bad:
            raise AssertionError(f"{name}.{'/'.join(path)} contains non-finite values")
