"""The yardstick of the recurrent PPO cell: model FLOPs and least times of an
iteration of PPO under sb3-contrib's LSTM actor-critic (an LSTM of H units
each for the actor and the critic on D observation fields, then tanh layers
of `net_arch` each and the two heads), float32 products on the H100 SXM
(`roofline.PEAK`). Counted from the shapes and the algorithm, never from
what implements them; a multiply-add is two FLOPs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from roofline import PEAK, least_ms, pipes_s


def lstm_params(obs_dim: int, hidden: int, net_arch: Sequence[int], act_dim: int) -> int:
    """Parameters of the actor-critic: per LSTM W_ih [4H, D], W_hh [4H, H]
    and two biases of 4H; per MLP its layers; the heads and log_std."""
    lstm = 4 * hidden * (obs_dim + hidden) + 8 * hidden
    widths = (hidden,) + tuple(net_arch)
    mlp = sum(a * b + b for a, b in zip(widths, widths[1:]))
    return 2 * (lstm + mlp) + widths[-1] * (act_dim + 1) + (act_dim + 1) + act_dim


def lstm_forward_flops(obs_dim: int, hidden: int, net_arch: Sequence[int],
                       act_dim: int) -> float:
    """FLOPs of one sample's forward through both networks: each LSTM's
    gate products 4H x (D + H), each MLP's layers, the mean and the value
    heads."""
    widths = (hidden,) + tuple(net_arch)
    lstm = 4 * hidden * (obs_dim + hidden)
    mlp = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2.0 * (2 * lstm + 2 * mlp + widths[-1] * (act_dim + 1))


def rppo_iteration_flops(num_envs: int, num_steps: int, epochs: int, obs_dim: int,
                         hidden: int, net_arch: Sequence[int], act_dim: int) -> float:
    """Model FLOPs of one iteration: the rollout's forward over all B x T
    samples, then epochs x (forward + backward, three forwards) over all of
    them."""
    n = num_envs * num_steps
    return lstm_forward_flops(obs_dim, hidden, net_arch, act_dim) * n * (1 + 3 * epochs)


def _special(hidden: int, net_arch: Sequence[int]) -> int:
    """Transcendental results a sample's forward needs, one each (a floor):
    per LSTM three sigmoids and two tanh of H, per MLP its tanh."""
    return 2 * (5 * hidden + sum(net_arch))


def rollout_bound(num_envs: int, num_steps: int, obs_dim: int, hidden: int,
                  net_arch: Sequence[int], act_dim: int) -> Tuple[float, str]:
    """The rollout: the forward's FLOPs at the float32 rate, or its
    transcendentals on the special-function units, whichever is longer;
    per env and step its record written once (observation, action,
    log-probability, value, reward, done: 24 bytes), the four states read
    and written once."""
    n = num_envs * num_steps
    ops = max(lstm_forward_flops(obs_dim, hidden, net_arch, act_dim) * n / PEAK["float32"],
              pipes_s({"special": _special(hidden, net_arch) * n}))
    return least_ms(ops, 24 * n + 2 * 4 * 4 * hidden * num_envs)


def update_bound(num_envs: int, num_steps: int, epochs: int, num_minibatches: int,
                 obs_dim: int, hidden: int, net_arch: Sequence[int],
                 act_dim: int) -> Tuple[float, str]:
    """The update: epochs x (forward + backward, three forwards) over all
    samples at the float32 rate; each epoch reads the samples once (the
    record and advantage and return, 32 bytes) and the start states, and
    each minibatch's clip + Adam reads the gradients, weights and moments
    and writes the last three (28 bytes a parameter)."""
    n = num_envs * num_steps
    ops = 3 * epochs * lstm_forward_flops(obs_dim, hidden, net_arch, act_dim) * n
    nbytes = epochs * (32 * n + 4 * 4 * hidden * num_envs) + (
        epochs * num_minibatches * 28 * lstm_params(obs_dim, hidden, net_arch, act_dim))
    return least_ms(ops / PEAK["float32"], nbytes)
