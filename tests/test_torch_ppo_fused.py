"""The port's fused PPO train step (K2 and K3 forms, run through the kernels'
plain twins on the CPU) against the JAX fused train step (its kernels in
interpret mode), from the same weights and JAX's own draws and tile
permutations. See tests/test_torch_ppo.py for the key schedule and the
tolerances.
"""

import pytest
from test_torch_ppo import _assert_steps_agree, _step_pair


@pytest.mark.parametrize("form,head,anneal", [
    ("update", "gaussian", False), ("adam", "gaussian", False),
    ("update", "categorical", False), ("adam", "categorical", False),
    ("adam", "gaussian", True),
])
def test_fused_train_step_matches_jax(form, head, anneal):
    # 48 envs x 16 steps: minibatches of 384 samples, so 3 tiles of 128 each
    pair = _step_pair(head, form, num_envs=48, anneal_lr=anneal, total_iterations=2)
    # the K3 form's Gaussian entropy metric uses log_std frozen at entry on
    # both sides; the other metrics sum the same samples in another order
    _assert_steps_agree(pair)
