"""The yardstick's arithmetic: published peaks of the H100 SXM, least times
of the port's kernels counted from their algorithms, and the PPO step's
model FLOPs.

A frozen copy of the bound arithmetic that ``chip_smoke.py`` used while the
port was brought up (``PEAK``, ``least_ms``, ``pipes_s``, ``K1_OPS``,
``update_bound``, ``clip_adam_bound``, ``rollout_bound``,
``rollout_kernel_bound``). It lives here so that a later change to the
program cannot move the bar it is measured against. Every count depends on
shapes and on the algorithm, never on what implements it.

Every least time is in milliseconds and comes with the limit that sets it
("operations" or "bytes").
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA's data sheet for the H100 SXM, dense: float32 outside the tensor
# cores, bf16 inside them (FLOP/s), device memory (bytes/s). These rates
# assume the card's full power limit of 700 W.
PEAK = {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12}
# Per SM and clock the card gives 128 float32 results, 64 of 32-bit integer
# arithmetic and logic, 16 special-function results (rcp, rsqrt, sin, cos,
# lg2, ex2), and its 4 schedulers start 128 lane-operations of all kinds
# together (NVIDIA's table of arithmetic instruction throughput for compute
# capability 9.0); 132 SMs at the data sheet's 1980 MHz, which is where
# PEAK's 67e12 comes from.
SM_CLOCKS_PER_S = 132 * 1.98e9
PER_SM_CLOCK = {"float32": 128, "int32": 64, "special": 16, "all": 128}
# What K1's function needs per env and step on fishing-v1 under escapement
# (logistic growth, continuous decode, additive noise, no observation noise,
# r_drift = 0), counted from the algorithm, a multiply with the add it
# feeds as one operation:
# - a quarter of a Philox4x32-10 block: per round two 32 x 32 -> 64-bit
#   multiplies and two three-input xors, 40 integer operations a block, 10
#   a step (the key schedule is shared by every env and not counted);
# - one uniform: one shift-and-add and one float32 subtract;
# - half a Box-Muller pair: 2 special results (of lg2, sqrt, sin, cos) and 2
#   float32 multiplies;
# - the step: quota and harvest (4 float32), logistic growth (3), the noise
#   (2), the collapse test (1), the reward with its penalty (5), the two
#   running sums (2), the reset's selects and episode sum (3); t + 1, its
#   compare with the collapse folded in, the episode count and t's select
#   (4 integer).
K1_OPS = {"float32": 1 + 2 + 4 + 3 + 2 + 1 + 5 + 2 + 3, "int32": 10 + 1 + 4, "special": 2}


def least_ms(ops_s: float, nbytes: float) -> Tuple[float, str]:
    """(least milliseconds the card could take, which limit): the larger of
    the operations' time at their peak rates and the bytes' at the memory
    rate."""
    ops_ms, bytes_ms = ops_s * 1e3, nbytes / PEAK["bytes"] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def pipes_s(ops: Dict[str, float]) -> float:
    """Least seconds for `ops`, {pipe of PER_SM_CLOCK: operations}: the pipes
    overlap, so the longest pipe's time, or the schedulers' time for all."""
    times = [n / (PER_SM_CLOCK[pipe] * SM_CLOCKS_PER_S) for pipe, n in ops.items()]
    return max(*times, sum(ops.values()) / (PER_SM_CLOCK["all"] * SM_CLOCKS_PER_S))


def merged_params(obs_dim: int, hidden: int, act_dim: int) -> int:
    """Entries of the merged block-diagonal actor-critic (both towers side by
    side: W1c [D, 2H], W2c [2H, 2H], the head [2H, A + 1], their biases and
    log_std)."""
    h2, a1 = 2 * hidden, act_dim + 1
    return obs_dim * h2 + h2 + h2 * h2 + h2 + h2 * a1 + a1 + act_dim


def update_bound(n: int, obs_dim: int, hidden: int, act_dim: int, compute: str,
                 head: str = "gaussian", extra_bytes: float = 0.0) -> Tuple[float, str]:
    """The PPO minibatch gradient on n samples: the three 2H-contractions per
    tower (W2c's cross-tower blocks are zero and need no work) at the compute
    mode's rate, the input layer and the head with their backward in float32.
    Under bfloat16 the tensor cores and the float32 pipe work side by side,
    so the operations take the longer of the two; under float32 both are on
    one pipe and add. The packed samples read once (rows rounded up to a
    multiple of 8), the weights read and the gradients written once, and
    `extra_bytes` more (the optimizer's, `clip_adam_bytes`)."""
    h2, a1 = 2 * hidden, act_dim + 1
    products = 3 * 2 * h2 * hidden * n
    rest = (2 * 2 * obs_dim * h2 + 3 * 2 * hidden * a1) * n
    n_par = merged_params(obs_dim, hidden, act_dim)
    na = act_dim if head == "gaussian" else 1
    rows = -(-(obs_dim + na + 4) // 8) * 8
    by_pipe = {compute: products / PEAK[compute]}
    by_pipe["float32"] = by_pipe.get("float32", 0.0) + rest / PEAK["float32"]
    return least_ms(max(by_pipe.values()), 4 * (rows * n + 2 * n_par) + extra_bytes)


def clip_adam_bytes(n_par: int) -> float:
    """The optimizer step (clip + Adam): g, w, m and v read once, w, m and v
    written once, 28 bytes a merged parameter."""
    return 28.0 * n_par


def clip_adam_bound(n_par: int) -> Tuple[float, str]:
    """The optimizer step alone; its few operations an entry are far below
    its bytes."""
    return least_ms(0.0, clip_adam_bytes(n_par))


def rollout_bound(num_envs: int, num_steps: int, obs_dim: int, hidden: int, act_dim: int,
                  compute: str, categorical: bool = False) -> Tuple[float, str]:
    """The policy rollout: per env and step the two H-contractions per tower
    (through W2c and the head) at the compute mode's rate, the input layer
    in float32, and 4H tanh on the special-function units, one result each
    (a floor), with a categorical sampler's A exponentials there too. The
    tensor cores, the float32 pipe and the special-function units work side
    by side, so the operations take the longest of the three. 36 bytes per
    env and step written and the state read and written once."""
    h2, a1, n = 2 * hidden, act_dim + 1, num_envs * num_steps
    products = 2 * (h2 * hidden + hidden * a1) * n
    by_pipe = {compute: products / PEAK[compute]}
    by_pipe["float32"] = by_pipe.get("float32", 0.0) + 2 * obs_dim * h2 * n / PEAK["float32"]
    by_pipe["special"] = pipes_s({"special": (2 * h2 + (act_dim if categorical else 0)) * n})
    return least_ms(max(by_pipe.values()), 36 * n + 40 * num_envs)


def rollout_kernel_bound(num_envs: int, num_steps: int) -> Tuple[float, str]:
    """Stepping fishing-v1 under escapement: K1_OPS per env and step on
    their pipes; 44 bytes per env and call."""
    n = num_envs * num_steps
    return least_ms(pipes_s({pipe: k * n for pipe, k in K1_OPS.items()}), 44 * num_envs)


def ppo_forward_flops(obs_dim: int, hidden: int, act_dim: int) -> float:
    """FLOPs of one sample's forward pass through both towers (a multiply-add
    is two): the input layers, the hidden layers and the two heads."""
    return 2.0 * (2 * obs_dim * hidden + 2 * hidden * hidden + hidden * (act_dim + 1))


def ppo_iteration_flops(num_envs: int, num_steps: int, epochs: int, obs_dim: int, hidden: int,
                        act_dim: int) -> float:
    """Model FLOPs of one PPO iteration: the rollout's forward over all
    B x T samples, then epochs x (forward + backward, three forwards) over
    all of them. Independent of what implements the step."""
    n = num_envs * num_steps
    return ppo_forward_flops(obs_dim, hidden, act_dim) * n * (1 + 3 * epochs)


def share_pct(least: float, measured: float):
    """A least time's share of a measured time, in percent; None where
    nothing was measured (never 0)."""
    if not measured or measured <= 0.0:
        return None
    return 100.0 * least / measured
