#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gym_fishing_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/ and drives the port's
paths at the JAX bench's sizes: stepping, make("fishing-v1") -> escapement
-> fused rollout with auto-reset (2^21 envs, 512 steps per call); PPO
training on fishing-v1 (16384 envs x 128 steps, 4 epochs x 8 minibatches,
hidden 64) in its plain, fused-update and fused-full forms, and on an
observation window of 4 (the POMDP remedy); checkpoint and resume; the
evaluation API; model uncertainty and the gym adapters; the kernels' wide
path and PPO at hidden 256, also on fishing-v0's grid of 100 quotas; the
kernels' own random numbers; observation windows of 6 and 12; the A2C, DP
and ES learners and the examples; the recurrent PPO, SAC, DQN and TD3 at
their defaults and the sb3-style facades, the PPO facade on the kernel path
(K4 and K3); the multi-device path (the sharded fused and plain PPO steps,
K1's sharded launcher, the example and the scaling bench) and the training
curve against JAX's. Phases, each of which raises on failure:

1. device: a CUDA device is required; prints the card's name and power limit;
2. build: nvcc builds csrc/ppo_update_kernel.cu, csrc/policy_rollout_kernel.cu
   and csrc/rollout_kernel.cu, the last once per configuration that phases
   3-5 launch (its switches are fixed when it is compiled), one process per
   library, 8 at a time (prints the seconds);
3. kernel ≡ twin: the kernel against its plain PyTorch twin on the same
   numpy-made noise planes, over every growth model, both noise forms, the
   three policies and schemes, observation noise, cost, collapse penalty,
   drift and chained calls, at a ragged batch; then from a seed, where the
   kernel draws for itself: lognormal noise, observation noise, drift and the
   relative scheme (which keeps the IEEE draws), with step counts that leave
   part of a Philox block over. Every value
   of every compile-time switch must have been launched, each library must
   report the configuration it was asked for, and a library given another
   configuration's parameters must refuse them;
4. Philox stream: >= 2^20 normals through the kernel's own draw path,
   against the twin's stream and N(0, 1);
5. main path, kernel tier: chained calls with launch counting, sanity and
   episode-accounting checks, the twin from the same seed, and env-steps/s
   of both; the kernel's least time, which must not exceed the time the
   schedulers need for the instructions the shipped kernel executes;
6. main path, engine tier: `measure(mode="engine")`;
7. the PPO kernels' build (update kernels and policy rollout): seconds,
   ptxas registers, shared memory and spills, and the tensor-core
   instructions (HMMA) in the policy rollout's machine code: some under
   bfloat16, none under float32; in its wide path's some in every bfloat16
   instantiation at hidden 64 and above, none in the others; and in the
   update kernels' wide stage 1, some in each of ppo_grad_tower's twelve
   instantiations (three widths, both BIGD forms, both heads), none in
   ppo_grad_wide's ten;
8. K2 (fused minibatch gradient) ≡ its twin at full width: numpy-made
   packed data [8, 2^21], one minibatch of 128 random tiles of 2048, both
   heads (fishing-v1 Gaussian, fishing-v0 categorical with 3 actions),
   ent_coef 0 and 0.01, compute float32 and bfloat16; under float32 also
   the kernel's error against the twin in float64 beside the float32
   twin's own; its time in both compute modes beside the least time the
   card could take, and the three 2H-contractions alone as torch.matmul;
9. K3 (gradient + clip + Adam) ≡ its twin from non-zero moments at count 5,
   below and above the clip threshold, and its time in both compute modes;
10. main path, training: train_step in the forms off, update (K2) and
    update + fused_adam (K3) from one set of weights, with launch counting;
    fused ≡ plain after one step at 1 epoch x 1 minibatch; the learning
    agreement of off and update + fused_adam over 20 iterations; ms per
    iteration and env-steps/s of each form;
11. K4 (policy rollout) ≡ its twin at B=16384, T=128, hidden 64: continuous
    fishing-v1, relative fishing-v0, proportional with 8 actions,
    fishing-may-obs-v1 (observation noise) and the mixture, each with the
    obs fold on and off, in float32 and bfloat16, from numpy-made noise
    planes and from a seed; its time in both compute modes beside the least
    time the card could take, and at B=8448 beside B=16384;
12. K4 ≡ the port's plain rollout path (collect_rollout + compute_gae +
    _pack) on the same planes, Gaussian head;
13. main path, fused-full training: train_step in the forms full (K4 + K2)
    and full + fused_adam (K4 + K3) with launch counting (one K4 launch per
    iteration); full + fused_adam ≡ update + fused_adam after one step at
    1 x 1 from the same planes; the learning agreement of off and full +
    fused_adam over 20 iterations; ms per iteration and env-steps/s; then
    full + fused_adam under compute_dtype="bfloat16": its launches and ms
    per iteration, the same one-step comparison and the agreement with the
    float32 plain form.
14. K2/K3 at 16 packed rows (obs windows of 4: 9 fields): ≡ their twins at
    N = 2^21 for both heads, ent_coef 0 and 0.01, float32 (also against the
    float64 twin) and bfloat16, under phases 8-9's bars; times in both modes
    beside the bound and the 8-row times of phases 8-9;
15. main path of the POMDP remedy: train_step on stack_observations(
    fishing-may-obs-v1, 4) at 16384 x 128, 4 x 8, hidden 64: update+adam ≡
    off after one step at 1 x 1 from the same draws in float32 and bfloat16,
    the forms off, update (4 iterations) and update+adam with launch
    counting and ms per iteration, and the 20-iteration agreement of off and
    update+adam;
16. resume: full+adam on fishing-v1 and phase 15's stacked update+adam run 2
    iterations, save (utils/checkpoint.py), run 2 more; restored into a fresh
    state and fresh generators, 2 more iterations give bit-identical weights,
    moments, count, batch state, generator state and metrics; bytes and
    seconds of the save and the restore;
17. evaluation: simulate_mdp's device path (its pandas-free tensor part) for
    escapement on fishing-v1 and for phase 15's first-step policy on the
    stacked fishing-v1, 2^16 reps x 100 steps, ≡ the host .predict loop on
    the first 1024 reps within 1e-6; estimate_policyfn's grid at n = 50;
18. model uncertainty and adapters: randomized_rollout on fishing-mixture-v1
    at 2^18 x 128 with the ranges of examples/model_uncertainty.py (every
    growth model drawn, each within 5 sigma of a uniform share, every field
    in range); degenerate ranges ≡ batched_step from the same noise, every
    value; FishingVectorEnv with 16384 envs x 200 steps and GymFishingEnv
    for one episode;
19. the kernels' wide path (hidden 128 and 256, categorical heads of up to
    128 classes): K2/K3 ≡ their twins at N = 2^21 for the Gaussian head and
    100 classes in both modes (float32 also against the float64 twin), K4 ≡
    its twin at B=16384, T=128 on fishing-v1 and fishing-v0's proportional
    grid of 100 quotas, each timed beside its bound; then the slice's main
    path, PPO full+adam at hidden 256 on fishing-v1 and on
    make("fishing-v0", n_actions=100), 16384 x 128, 4 x 8, in both modes:
    full+adam ≡ the plain epochs after one step at 1 x 1 from the same
    rollout, 20 iterations with launch counting (one K4 and 32 K3 launches
    each) and the agreement with the plain form; then
    validation/kernel_rng.py at its defaults;
20. K2/K3 at observation windows beyond 4 fields, obs_dim 6 (16 packed
    rows) and 12 (24 rows), at hidden 64 and 256, Gaussian and 100 classes,
    in both modes: ≡ their twins at N = 2^21 (float32 also against the
    float64 twin), each timed beside its bound;
21. PPO on stack_observations(fishing-v1, 6) at 16384 x 128, 4 x 8, hidden
    64: update+adam ≡ off after one step at 1 x 1 in both modes, then the
    forms update (2 iterations) and update+adam (4) with launch counting;
22. A2C at its defaults (1024 envs x 16 steps): one step on the card ≡ the
    same step on the CPU from the same planes, then 20 iterations;
23. DP at 257 states x 129 quotas in float64: build_mdp and value_iteration
    on the card ≡ the CPU (the same sweep count), and Reed's constant
    escapement on the deterministic logistic env;
24. ES, one generation at its defaults (256 members x 4 envs x Tmax steps):
    fitness and ranks on the card ≡ the CPU from the same perturbations and
    draws;
25. the four ported examples' numeric cores at tests/test_examples.py's
    sizes;
26. SAC at its defaults (256 envs, buffer 2^17, batch 4096, hidden 64): one
    sac_train_step on the card ≡ the same step on the CPU from the same
    injected draws and a partly filled buffer (every weight, moment, target,
    buffer row and count), then 200 steps timed;
27. DQN on fishing-v0 (relative) and on the proportional grid of 100 quotas,
    at its defaults, as phase 26;
28. TD3 at its defaults, as phase 26; the checked step's update steps the
    delayed actor;
29. recurrent PPO: one train_step on the card ≡ the CPU at
    pomdp_policies.py's configuration (fishing-v1, sigma 0.02, sigma_m 0.15,
    256 x 32, 2 x 4, hidden 32, ent 0.003) from the same draws and
    permutations; ms per iteration there and at the defaults (256 x 64,
    4 x 4, hidden 64);
30. the facade on the kernel path: PPO("MlpPolicy", "fishing-v1",
    num_envs=4096, num_steps=128, fused full + adam).learn(2_000_000), 4
    iterations with launch counting (1 K4 and 32 K3 launches each), saved
    after 2; the loaded model's 2 more iterations ≡ the uninterrupted run's,
    bit for bit; then, from the trained facade's weights, moments and env
    state, K4 at B=4096 T=128 and K3 on one of its minibatches (2^16
    samples, 32 tiles) ≡ their twins; the SAC, TD3 and DQN facades at their
    defaults: 10 steps, save, 10 more ≡ the loaded model's 10; ms per
    iteration of each;
31. the two new examples' numeric cores (pomdp_policies, train_ppo plain
    and fused full + adam) at tests/test_examples.py's sizes, and K4 (B=64
    T=16) and K3 (a minibatch of 128 samples, one tile of 128) ≡ their
    twins at train_ppo full + adam's shapes;
32. the multi-device path under NCCL at world size 1, in this process:
    make_sharded_fused_train_step on fishing-v1 at 16384 x 128, 4 x 8,
    hidden 64 ≡ train_step's full form bit for bit over 2 iterations
    (params, Adam's moments, env state, metrics, generator), 1 K4 and 32 K2
    launches an iteration, ms per iteration of both in turns, and
    state_checksum across the group;
33. two gloo ranks on cuda:0 (child processes, one CPU thread each, results
    through files; a rank's failure, a timeout or a missing result fails
    the run): (a) the sharded fused step at 8192 envs a rank, 1 x 1, from
    the global noise planes ≡ the single process on 16384 envs
    (tests/test_shard_fused.py's bars), (b) 2 iterations at 4 x 8 from a
    generator: the replicas bit-identical, (c) K4 and K2 ≡ their twins from
    rank 0's trained state at a rank's shapes, (d) the plain
    train_step(mesh=) at 1024 x 16, 2 x 2 ≡ the single process within
    1e-5, (e) sharded_rollout at 2^20 envs a rank x 512 steps ≡ K1 on the
    rank's slice with the folded seed bit for bit and ≡ K1's twin, the
    ranks' streams differing;
34. examples/multihost_train without a coordinator at its defaults for 3
    iterations, and weak_scaling() on this one card (its throughput; no
    efficiency is claimed from one card);
35. full + fused_adam in float32 against JAX's recorded plain-form curve
    (validation/fused_training.py --against-jax: 4096 x 128, 300
    iterations, every checkpoint within 0.25).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
It never imports JAX.
"""

import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# the least times the kernels are held against: the benchmark's arithmetic
# (benchmark/roofline.py), imported as the benchmark's modules import it
sys.path.append(os.path.join(ROOT, "benchmark"))
from roofline import (  # noqa: E402
    K1_OPS,
    PEAK,
    PER_SM_CLOCK,
    SM_CLOCKS_PER_S,
    clip_adam_bound,
    least_ms,
    pipes_s,
    rollout_bound,
    rollout_kernel_bound,
    update_bound,
)

B_MAIN, T_MAIN = 1 << 21, 512
B_PARITY, T_PARITY = 65536 + 37, 64
# Kernel vs twin, same inputs: float32 with a different libm, FMA contraction
# and operation order, so values agree to rounding, while the integer
# outputs (t, ep_count) must agree exactly.
STOCK_ATOL = 1e-5
REWARD_ATOL = 1e-4  # sums over 64 steps
# Over 512 steps a float32 running sum of magnitude ~40 rounds by up to
# 512 * ulp(40) / 2 ~ 1e-3.
SUM_ATOL_512 = 2e-3
# PPO: the bench's buffer (16384 envs x 128 steps) and one minibatch of it
B_PPO, T_PPO = 16384, 128
B_K4_PART = 8448   # 264 x 32 envs
N_PPO, TILE, MB_TILES = B_PPO * T_PPO, 2048, 128
# K2/K3 vs twin: float32 sums over 2^18 samples in another order (per-chunk
# partials, then per tile, then over 128 tiles, against one torch reduction),
# so each buffer agrees to 2e-4 of its largest entry plus 2e-6, and each
# metric sum to rtol 2e-4.
GRAD_RTOL, GRAD_ATOL, MET_RTOL = 2e-4, 2e-6, 2e-4
# compute="float32" must stay float32-accurate: against the twin evaluated in
# float64, a buffer's error may be at most 4x the float32 twin's own, or 4x
# two float32 ulps of the buffer's largest entry where the twin happens to
# land closer (several buffers are single sums that cancel over the samples)
F64_FACTOR, F64_FLOOR_ULPS = 4.0, 2.0
# dw2c_split vs its plain version from the same scratch: per range a sum of
# 2048 products in another order (blocks of 64 samples, then the blocks),
# within 1e-5 of the range's largest entry; under bfloat16 the tensor cores'
# accumulator truncates inside each block of 64 (64 x 2^-23 = 7.6e-6), 2e-5
SPLIT_RTOL = {"float32": 1e-5, "bfloat16": 2e-5}
# fused vs plain params after one step at 1 epoch x 1 minibatch (the mirror
# of tests/test_update_kernel.py's own bar), and the learning agreement of
# scripts/validate_fused_training.py --agreement
STEP_RTOL, STEP_ATOL, AGREE_TOL = 5e-4, 1e-6, 0.25
# K4 vs twin (or the plain path), same inputs: float32 with a different libm,
# FMA contraction and summation order, carried through 128 dependent steps
# and the GAE pass (which sums ~1/(1 - gamma lambda) ~ 17 terms), so every
# packed row and end state agrees to 1e-4 absolute, the statistics (sums
# over 2^21 samples) to rtol 1e-4; t, ep_len and the done count exactly.
# Under bfloat16 a one-ulp difference of a tanh can move an input of a
# 2H-contraction to the neighbouring bf16 value (a relative step of 2^-8),
# and the env carries that on: the largest error may reach 5e-3 (the sums
# 1e-3 relative), while the mean error stays at 1e-4, which a rounding
# misplaced for every sample would not meet.
K4_ATOL, K4_STATS_RTOL = 1e-4, 1e-4
K4_BF16_ATOL, K4_BF16_MEAN_ATOL, K4_BF16_STATS_RTOL = 5e-3, 1e-4, 1e-3
# full + fused_adam against update + fused_adam after one step at 1 x 1 under
# compute_dtype="bfloat16": the fused rollout rounds the inputs of its
# products to bf16 and the plain rollout of the update form does not, so the
# two minibatches differ by K4's bf16 bars above. Adam's first step moves
# every parameter by nearly lr = 3e-4 times its gradient's sign, so the two
# forms are held by the step each took (p - p0): on an NVIDIA H100 80GB HBM3
# the steps differed by 8.39e-8 at most and 7.47e-9 in the mean, and the bars
# leave a factor of ~20 over those two readings: 2e-6 (lr / 150) for every
# parameter and 1e-7 for the mean. A sign that differs in one parameter
# (2 lr = 6e-4) or a rollout whose bf16 rounding moves the gradients' ratios
# does not meet them. A first Adam step does not see the gradient's scale:
# phases 8 and 9 hold that.
STEP_BF16_ATOL, STEP_BF16_MEAN_ATOL = 2e-6, 1e-7
# update+adam against off after one step at 1 x 1 under compute_dtype=
# "bfloat16" (phase 15): the same rollout, but two arithmetics: the plain
# form rounds its hidden layers (inputs, weights, bias add, tanh) to bf16,
# the kernel only the inputs of its products. Adam's first step divides each
# gradient entry by its own size, so where a gradient is near zero a
# rounding difference becomes a step difference of up to lr (on the card
# 3.08e-5 in pi_mean.weight at N = 2^21), and steps cannot be compared.
# Under bfloat16 the two forms are held by the gradient itself, Adam's first
# moment m = (1 - beta1) g: per parameter tensor, |m - m_plain| (L2) within
# 2^-6 of |m_plain|. The twin against the plain form on the CPU (N = 131 072
# and 524 288, obs windows of 1 and 4) differed by 1.8e-3 to 3.6e-3, a bf16
# rounding or two (2^-9 = 2.0e-3); a wrong term of the gradient is of the
# order of 1.
GRAD_BF16_RTOL = 2.0 ** -6
# An env leaves the twin's trajectory when a rounding difference carries it
# across a discontinuity: a categorical draw whose u lies within rounding of
# a CDF boundary, or a quota within rounding of the whole stock, which
# harvests it all (a collapse) in one and not in the other; ~2^21 samples
# meet such a boundary a few times in float32 and more often in bfloat16.
# Such envs (a differing class, an error above the bound, t or ep_len) are
# counted, shown at the step where they leave, left out of the comparison,
# and may be at most 1e-3 of B.
K4_MAX_LEFT_FRAC = 1e-3
ROWS = ("obs", "action", "logp", "value", "advantage", "return")
# phase 19: the kernels' wide path and the slice's full-width PPO
WIDE_HIDDEN, WIDE_ACTIONS, WIDE_ITERS = (128, 256), 100, 20
# phases 20-21: observation windows beyond 4 fields (16 and 24 packed rows)
LONG_OBS, STACK_K = (6, 12), 6
# phases 22-24: the other learners against their own CPU runs. A2C at its
# defaults: float32 sums over 16384 samples in another order move RMSProp's
# first step by at most lr / sqrt(eps) = 0.22 times the gradient's change,
# far below 1e-5. DP in float64: P and R to 1e-12, V to 1e-9 after
# thousands of sweeps. ES: float32 sums of Tmax rewards to 1e-5, and the
# same ranks wherever two members' fitness differ by more than 1e-4.
A2C_ATOL, DP_PR_ATOL, DP_V_ATOL, ES_ATOL, ES_RANK_GAP = 1e-5, 1e-12, 1e-9, 1e-5, 1e-4
# Reed's theorem on the deterministic logistic env (tests/test_dp.py):
# escapement at K / 2 between stocks 0.6 and 1.5, within 0.03
REED_ATOL = 0.03
T_START = time.perf_counter()


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def card_label():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def sm_clock_mhz():
    """The card's SM clock now, as nvidia-smi reads it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Device milliseconds per call of `fn`: the median over `reps` calls, each
    between its own pair of CUDA events, so that a pause of the host between
    two calls (the host's cores are shared) is in no call's time. The calls
    are queued behind a device-side wait of about 30 ms, so that a host that
    prepares a launch more slowly than the card runs it is in no pair
    either."""
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(60_000_000)   # SM clocks
    for start, end in pairs:
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([start.elapsed_time(end) for start, end in pairs])), out


def split_bound(n, num_tiles, hidden, compute):
    """dw2c_split on n samples: 2 x hidden^2 multiply-adds a sample (both
    towers) at the compute mode's rate; h1 and g_p2 [n, 2H] read once in the
    mode's type and one partial [2, H, H] a range written."""
    ranges = -(-n // 2048)
    ranges = min(ranges, 2 * num_tiles)
    elt = 2 if compute == "bfloat16" else 4
    return least_ms(2 * 2 * hidden * hidden * n / PEAK[compute],
                    2 * n * 2 * hidden * elt + ranges * 2 * hidden * hidden * 4)


def reduce_bound(rows, n_par):
    """reduce_rows: the workspace's rows of P + 4 floats read once, one row
    written (bytes)."""
    return least_ms(0.0, 4 * (rows + 1) * (n_par + 4))[0]


def check_clip_adam(uk, data, order, w, m, v, stats, kw, what):
    """K3's stage 3 alone (`clip_adam`) against its plain version on the same
    buffers on the card, from the twin's merged gradients, under phase 9's
    bars (the weights through their update, the moments as they are), at
    both clip regimes, and from a zero first moment with the threshold at
    half the twin's norm, where m = (1 - beta1) g scale holds the grid-wide
    norm in every entry; then timed at kw's. Returns (max abs error, ms,
    plain ms, (bound ms, by))."""
    hidden, a = w[0].shape[1] // 2, kw["act_dim"]
    g, met = uk._grad_merged_reference(data, order, w, stats, clip_eps=kw["clip_eps"],
                                       vf_coef=kw["vf_coef"], ent_coef=kw["ent_coef"],
                                       obs_dim=kw["obs_dim"], act_dim=a, tile=kw["tile"],
                                       head=kw["head"], compute="float32")
    gout = torch.cat([uk.flatten_merged(g), met])
    flat = [uk.flatten_merged(t) for t in (w, m, v)]
    ckw = dict(obs_dim=kw["obs_dim"], hidden=hidden, act_dim=a, head=kw["head"],
               ent_coef=kw["ent_coef"], lr=kw["lr"], bc1=kw["bc1"], bc2=kw["bc2"])
    m0 = [flat[0], torch.zeros_like(flat[1]), flat[2]]
    half = 0.5 * uk.clip_norm_reference(gout, obs_dim=kw["obs_dim"], hidden=hidden, act_dim=a,
                                        head=kw["head"], ent_coef=kw["ent_coef"])
    err = 0.0
    for bufs, max_grad_norm in ((flat, 1e6), (flat, 1e-3), (m0, half)):
        got = uk.clip_adam(gout, *bufs, max_grad_norm=max_grad_norm, **ckw)
        ref = uk.clip_adam_reference(gout, *bufs, max_grad_norm=max_grad_norm, **ckw)
        torch.cuda.synchronize()
        new = [uk.unflatten_merged(x, kw["obs_dim"], hidden, a) for x in got]
        want = [uk.unflatten_merged(x, kw["obs_dim"], hidden, a) for x in ref]
        name = f"clip_adam {what} max_grad_norm={max_grad_norm:g}"
        err = max(err, check_buffers([x - y for x, y in zip(new[0], w)],
                                     [x - y for x, y in zip(want[0], w)], name + " dw"),
                  check_buffers(new[1], want[1], name + " m"),
                  check_buffers(new[2], want[2], name + " v"))
    ckw["max_grad_norm"] = kw["max_grad_norm"]
    ms, _ = cuda_ms(lambda: uk.clip_adam(gout, *flat, **ckw), 20)
    plain, _ = cuda_ms(lambda: uk.clip_adam_reference(gout, *flat, **ckw), 5)
    return err, ms, plain, clip_adam_bound(flat[0].numel())


def print_clip_adam(phase, hidden, ms, plain_ms, bound, err, label):
    for key in sorted(k for k in ms if k[0] == hidden):
        print(f"phase {phase}: clip_adam (K3's stage 3 alone) hidden={hidden} {key[1]:11s}: "
              f"{ms[key] * 1e3:.1f} us, twin {plain_ms[key] * 1e3:.1f} us (CUDA events, "
              f"median); bound {bound[key][0] * 1e3:.2f} us by {bound[key][1]} (share "
              f"{bound[key][0] / ms[key]:.3f}); ≡ twin at both clip regimes and at half "
              f"the norm, max abs err "
              f"{err:.3g} so far; {label}")


def issue_ms(instructions_per_step, num_envs, num_steps):
    """Milliseconds the schedulers alone need to start a kernel's
    instructions (one per lane, env and step) at the rate the bounds assume."""
    return (instructions_per_step * num_envs * num_steps
            / (PER_SM_CLOCK["all"] * SM_CLOCKS_PER_S) * 1e3)


def hmma_counts(_build, name, kernel=None, opcode="HMMA"):
    """{mangled name: HMMA instructions (or those of `opcode`)} of every
    instantiation of the kernel `kernel` (default: `name`) in the machine
    code of the built library csrc/<name>.cu."""
    kernel = kernel or name
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = fn if kernel in fn else None
            if fn:
                counts[fn] = 0
        elif fn and opcode in line:
            counts[fn] += 1
    return counts


def build_all(jobs):
    """Run every job of {name: function that builds and loads kernel
    libraries} at once; returns {name: seconds}."""
    def timed(job):
        t0 = time.perf_counter()
        job()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(timed, jobs.values())))


def print_ptxas(_build, name):
    """The ptxas report of the library built under `name` (a source's name,
    or a library's file name)."""
    for line in _build.build_log.get(name, "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())


def compare(ker, ref, what, stock_atol=STOCK_ATOL, reward_atol=REWARD_ATOL):
    """Kernel result vs twin result; returns the largest float error."""
    for name in ("t", "ep_count"):
        if not torch.equal(getattr(ker, name), getattr(ref, name)):
            n = int((getattr(ker, name) != getattr(ref, name)).sum())
            fail(f"{what}: {name} differs in {n} envs")
    errs = {}
    for name, tol in (("stock", stock_atol), ("harvest", stock_atol), ("ep_ret", reward_atol),
                      ("reward", reward_atol), ("ep_ret_sum", reward_atol)):
        errs[name] = max_err(getattr(ker, name), getattr(ref, name))
        if not errs[name] <= tol:
            fail(f"{what}: {name} max abs err {errs[name]:.3g} > {tol}")
    if ker.next_offset != ref.next_offset:
        fail(f"{what}: next_offset {ker.next_offset} != {ref.next_offset}")
    return max(errs.values())


def ppo_case(ppo, ppo_fused, rng, head, dev, obs_dim=1, hidden=64, n_actions=3):
    """Jittered random weights and the bench's packed buffer [R, 2^21] drawn
    from them with numpy-made noise: (merged weights, data, act_dim). R is obs_dim + the action columns + 4 rounded up to a multiple
    of 8: 8 at obs_dim 1, 16 at 4 and 6, 24 at 12 (observation windows).
    Old log-probs and values are spread so every clip branch is visited."""
    gauss = head == "gaussian"
    a = 1 if gauss else n_actions
    model = ppo.ActorCritic(obs_dim, a, gauss, hidden,
                            generator=torch.Generator().manual_seed(3)).to(dev)
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    n = N_PPO
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * normal(*p.shape))
        if gauss:
            model.log_std.fill_(-0.4)
        obs = 0.7 * normal(n, obs_dim)
        dist, value = model(obs)
        if gauss:
            noise = normal(n, 1)
        else:
            u = torch.from_numpy(rng.random((n, a)).astype(np.float32)).to(dev)
            noise = -torch.log(-torch.log(u.clamp_min(1e-30)))
        action, logp = ppo.sample_action(dist, gauss, noise)
        packed = torch.cat([obs, action.float().reshape(n, -1), (logp + 0.3 * normal(n))[:, None],
                            (value + 0.3 * normal(n))[:, None], normal(n, 1),
                            (value + normal(n))[:, None]], 1)
    weights = ppo_fused.merged_weights(dict(model.named_parameters()), head)
    return weights, ppo_fused.pack_feature_major(packed), a


def towers(uk, merged):
    """The 13 split-tower arrays of merged weights or gradients: K2 computes
    no cross-tower block, its twin the whole products."""
    return uk.unmerge_weights(merged, merged[2].shape[0] // 2, merged[4].shape[1] - 1)


def check_buffers(got, want, what):
    """Each buffer within GRAD_RTOL of its largest entry + GRAD_ATOL;
    returns the largest absolute error."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, want)):
        err = max_err(g, r)
        tol = GRAD_RTOL * float(r.abs().max()) + GRAD_ATOL
        if not err <= tol:
            fail(f"{what}: buffer {i} max abs err {err:.3g} > {tol:.3g}")
        worst = max(worst, err)
    return worst


def check_split(ws, part, hidden, compute, what, obs_dim=1):
    """dw2c_split's workspace rows against its plain version's partials: each
    range's dW2c within SPLIT_RTOL of the range's largest entry, every other
    entry of the rows zero as they were given. Returns (the largest absolute
    error, the worst error relative to its range's largest entry)."""
    h2 = 2 * hidden
    l_w2 = obs_dim * h2 + h2
    w2 = ws[:, l_w2:l_w2 + h2 * h2].reshape(-1, h2, h2)
    h = hidden
    if (bool(ws[:, :l_w2].any()) or bool(ws[:, l_w2 + h2 * h2:].any())
            or bool(w2[part.shape[0]:].any()) or bool(w2[:, :h, h:].any())
            or bool(w2[:, h:, :h].any())):
        fail(f"{what}: dw2c_split wrote outside its ranges' dW2c blocks")
    worst = worst_rel = 0.0
    for j in range(part.shape[0]):
        err = float((w2[j] - part[j]).abs().max())
        rel = err / max(float(part[j].abs().max()), 1e-30)
        if not rel <= SPLIT_RTOL[compute]:
            fail(f"{what}: range {j}: error {rel:.3g} of its largest entry > "
                 f"{SPLIT_RTOL[compute]}")
        worst, worst_rel = max(worst, err), max(worst_rel, rel)
    return worst, worst_rel


def check_float64_bar(uk, got, twin, data, order, weights, stats, kw, what):
    """compute="float32" keeps float32 accuracy: per parameter, the kernel's
    error against the twin evaluated in float64 within F64_FACTOR of the
    float32 twin's own (or of F64_FLOOR_ULPS ulps of the parameter's largest
    entry). Returns (name, kernel error, twin error) of the parameter with the
    largest kernel error relative to its bar."""
    from gym_fishing_tpu_torch.agents import ppo_fused

    exact, _ = uk._grad_merged_reference(
        data.double(), order, tuple(x.double() for x in weights), stats.double(), **kw)
    worst = ("", 0.0, 0.0, -1.0)
    named = [ppo_fused.params_from_merged(x, kw["head"]) for x in (got, twin, exact)]
    for name, g, t, ex in ((k, *(d[k] for d in named)) for k in named[2]):
        err, err_twin = max_err(g, ex), max_err(t, ex)
        bar = F64_FACTOR * max(err_twin, F64_FLOOR_ULPS * float(ex.abs().max()) * 2.0 ** -23)
        if not err <= bar:
            fail(f"{what}: {name} error against float64 {err:.3g} > {bar:.3g} (float32 twin "
                 f"{err_twin:.3g})")
        if bar > 0 and err / bar > worst[3]:
            worst = (name, err, err_twin, err / bar)
    return worst[:3]


def check_metrics(met, met_ref, what):
    bad = (met.double() - met_ref.double()).abs() > MET_RTOL * met_ref.double().abs() + 1e-6
    if bool(bad.any()):
        fail(f"{what}: metric sums {met.tolist()} vs twin {met_ref.tolist()}")


def resume_leaves(tup):
    """Every tensor of a training tuple {train_state, batch, generator} by
    name: weights, Adam's moments, count and step, the batch state's fields
    (a StackedState's window included) and the generator's state."""
    ts, bs = tup["train_state"], tup["batch"]
    out = {f"model/{k}": p.detach() for k, p in ts.model.named_parameters()}
    out.update({f"m/{k}": x for k, x in ts.m.items()})
    out.update({f"v/{k}": x for k, x in ts.v.items()})
    out.update({"count": torch.tensor(ts.count), "step": torch.tensor(ts.step),
                "generator": tup["generator"].get_state()})
    env_state = bs.env
    if hasattr(env_state, "window"):
        out["window"] = env_state.window
        env_state = env_state.env
    out.update({"stock": env_state.stock, "harvest": env_state.harvest, "t": env_state.t,
                "episode_return": bs.episode_return, "episode_length": bs.episode_length})
    return out


def parity_cases(gtt):
    """(label, env, params, policy, policy_param, obs_noise, stock floor)."""
    cases = []

    def add(label, env_id, policy="escapement", param=0.5, floor=0.3, **overrides):
        overrides.setdefault("sigma", 0.1)
        overrides.setdefault("Tmax", 13)
        env, params = gtt.make(env_id, device="cpu", **overrides)  # K1 reads them on the host
        cases.append((label, env, params, policy, param, float(params.sigma_m) > 0, floor))

    for growth, r in (("logistic", 0.3), ("ricker", 0.3), ("beverton_holt", 0.3),
                      ("allen", 0.3), ("may", 0.75)):
        add(f"{growth}/additive", "fishing-v1", growth=growth, r=r)
    # myers below ~0.4 decays through denormals to a collapse; start above it
    add("myers/additive", "fishing-v1", growth="myers", r=3.0, param=1.0, floor=0.5)
    add("mixture(allen)/additive", "fishing-v1", growth="mixture", model_idx=3)
    add("logistic/lognormal", "fishing-v1", noise_form="lognormal")
    add("ricker/lognormal", "fishing-v1", growth="ricker", noise_form="lognormal")
    add("constant_mortality/proportional", "fishing-v0", "constant_mortality", 0.15,
        n_actions=10)
    add("constant/relative", "fishing-v0", "constant", 0.05)
    add("escapement/relative+cost", "fishing-v0", cost=0.3)
    add("obs_noise (may-obs)", "fishing-may-obs-v1", param=0.4)
    add("collapse_penalty", "fishing-v1", "constant", 2.0, collapse_penalty=2.5)
    add("r_drift", "fishing-nonstationary-v1", Tmax=60)
    return cases


def seeded_cases(gtt):
    """Cases in which K1 draws for itself, as parity_cases' tuples with the
    step count appended: 62 and 63 steps leave half a Philox block over."""
    cases = []

    def add(label, env_id, steps, policy="escapement", param=0.5, **overrides):
        overrides.setdefault("sigma", 0.1)
        overrides.setdefault("Tmax", 13)
        env, params = gtt.make(env_id, device="cpu", **overrides)
        cases.append((label, env, params, policy, param, float(params.sigma_m) > 0, 0.3, steps))

    add("seeded logistic/additive", "fishing-v1", 62)
    add("seeded ricker/lognormal", "fishing-v1", 62, growth="ricker", noise_form="lognormal")
    add("seeded obs_noise (may-obs)", "fishing-may-obs-v1", 63, param=0.4)
    add("seeded r_drift", "fishing-nonstationary-v1", T_PARITY, Tmax=60)
    # the discrete schemes draw through the IEEE functions: their own loops and tails
    add("seeded constant_mortality/relative", "fishing-v0", 62, "constant_mortality", 0.15)
    add("seeded obs_noise/relative", "fishing-v0", 63, sigma_m=0.1)
    return cases


def case_configuration(rk, env, params, policy, obs_noise, planes):
    """The compile-time configuration K1 runs a case under."""
    cfg = env.config
    return rk.configuration(cfg.growth, int(params.model_idx), cfg.noise_form, policy,
                            cfg.scheme, obs_noise, planes, float(params.r_drift))


def k4_setup(gtt, ppo, ppo_fused, rng, env_id, dev, hidden=64, **overrides):
    """An env at the PPO width: jittered random weights (the Gaussian mean
    shifted to -0.5 so that envs outlive their first harvest), desynchronised
    start states and numpy-made noise planes [za or u, zp(, nf)]."""
    env, params = gtt.make(env_id, device="cpu", **overrides)  # K4 reads them on the host
    cfg = env.config
    gauss = cfg.scheme == "continuous"
    a = 1 if gauss else cfg.n_actions
    model = ppo.ActorCritic(1, a, gauss, hidden, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
        if gauss:
            model.pi_mean.bias.sub_(0.5)
            model.log_std.fill_(-1.0)
    head = "gaussian" if gauss else "categorical"
    weights = ppo_fused.merged_weights({k: x.to(dev) for k, x in model.named_parameters()},
                                       head)
    B, T = B_PPO, T_PPO
    tmax = int(params.Tmax)
    f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
    state = (f32(rng.uniform(0.3, 1.2, B)),
             torch.from_numpy(rng.integers(0, tmax, B).astype(np.int32)).to(dev),
             f32(rng.uniform(0.0, 0.05, B)), f32(rng.uniform(0.0, 3.0, B)),
             torch.from_numpy(rng.integers(0, tmax, B).astype(np.int32)).to(dev))
    obs_noise = float(params.sigma_m) > 0
    planes = [rng.standard_normal((T, B)) if gauss else rng.random((T, B)),
              rng.standard_normal((T, B))]
    if obs_noise:
        planes.append(np.exp(float(params.sigma_m) * rng.standard_normal((T, B))))
    kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
              n_actions=cfg.n_actions, obs_noise=obs_noise)
    return env, params, model, weights, state, f32(np.stack(planes)), kw


def compare_k4(ker, ref, what, categorical, bf16=False, B=B_PPO, T=T_PPO):
    """K4 result vs the twin's: returns (largest float error, envs left out
    because they left the twin's trajectory)."""
    P, R = ker.packed_t.view(8, T, B), ref.packed_t.view(8, T, B)
    atol = K4_BF16_ATOL if bf16 else K4_ATOL
    step_err = (P[:6] - R[:6]).abs().amax(0)                     # [T, B]
    same = (step_err.amax(0) <= atol) & (ker.t == ref.t) & (ker.ep_len == ref.ep_len)
    if categorical:
        same &= (P[1] == R[1]).all(0)
    flipped = B - int(same.sum())
    for e in (~same).nonzero()[:2, 0].tolist():
        off = (step_err[:, e] > atol).nonzero()
        k = int(off[0, 0]) if off.numel() else T - 1
        print(f"  {what}: env {e} leaves at step {k}: (obs, action, logp, value) kernel "
              f"{[round(v, 6) for v in P[:4, k, e].tolist()]} twin "
              f"{[round(v, 6) for v in R[:4, k, e].tolist()]}")
    if flipped > K4_MAX_LEFT_FRAC * B:
        fail(f"{what}: {flipped} of {B} envs left the twin's trajectory")
    if bool(P[6:].any()):
        fail(f"{what}: rows 6-7 are not zero")
    pairs = {name: (P[r][:, same], R[r][:, same]) for r, name in enumerate(ROWS)}
    for name in ("stock", "harvest", "ep_ret"):
        pairs[name] = (getattr(ker, name)[same], getattr(ref, name)[same])
    errs = {}
    for name, (got, want) in pairs.items():
        diff = (got.double() - want.double()).abs()
        errs[name] = float(diff.max())
        if not errs[name] <= atol:
            fail(f"{what}: {name} max abs err {errs[name]:.3g}")
        if bf16 and not float(diff.mean()) <= K4_BF16_MEAN_ATOL:
            fail(f"{what}: {name} mean abs err {float(diff.mean()):.3g} > {K4_BF16_MEAN_ATOL}")
    for name in ("t", "ep_len"):
        if not torch.equal(getattr(ker, name)[same], getattr(ref, name)[same]):
            fail(f"{what}: {name} differs")
    nd, nd_ref = float(ker.stats[0]), float(ref.stats[0])
    if abs(nd - nd_ref) > flipped * T:
        fail(f"{what}: done count {nd} vs twin {nd_ref} ({flipped} envs left)")
    # an env that left moves each sum by at most a few times its share, 1/B
    rtol = (K4_BF16_STATS_RTOL if bf16 else K4_STATS_RTOL) + 4 * flipped / B
    bad = ((ker.stats[1:].double() - ref.stats[1:].double()).abs()
           > rtol * ref.stats[1:].double().abs() + 1e-3)
    if bool(bad.any()):
        fail(f"{what}: stats {ker.stats.tolist()} vs twin {ref.stats.tolist()}")
    if ker.next_offset != ref.next_offset:
        fail(f"{what}: next_offset {ker.next_offset} != {ref.next_offset}")
    return max(errs.values()), flipped


# phases 26-31: the recurrent PPO, the off-policy learners and the facades at
# their JAX defaults. Card ≡ CPU after one step from the same injected draws:
# float32 sums in another order move a first Adam step by a fraction of lr
# only where a gradient is near eps, far below 1e-5 (as A2C_ATOL).
SLICE_ATOL = 1e-5


def to_device(tree, device):
    """A copy of a learner state (dataclasses, modules, dicts, tensors) on
    `device`; host numbers stay as they are."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree


def state_diff(a, b):
    """(max abs difference of the float tensors, names of the other leaves
    that differ) between two learner states of one structure."""
    from gym_fishing_tpu_torch.utils.checkpoint import _flatten

    la, lb = dict(_flatten(a)), dict(_flatten(b))
    if la.keys() != lb.keys():
        fail(f"state structures differ: {sorted(set(la) ^ set(lb))[:6]}")
    err, other = 0.0, []
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            err = max(err, max_err(x.detach().cpu(), y.detach().cpu()))
        elif isinstance(x, torch.Tensor):
            other += [] if torch.equal(x.cpu(), y.cpu()) else [k]
        elif x != y:
            other.append(k)
    return err, other


def facade_leaves(model):
    """Every leaf of a facade's training tuple, the generator's state
    included, on the host."""
    from gym_fishing_tpu_torch.utils.checkpoint import _flatten

    tree = dict(model._checkpoint_tree(), generator=model.generator,
                num_timesteps=model.num_timesteps)
    return {k: (v.get_state() if isinstance(v, torch.Generator)
                else v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten(tree)}


def check_resumed(what, straight, resumed):
    """Bit-identity of two facades' training tuples and last metrics."""
    a, b = facade_leaves(straight), facade_leaves(resumed)
    bad = [k for k in a if (not torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                            else a[k] != b[k])]
    n = len(resumed.history)
    same = all(np.array_equal(list(g.values()), list(w.values()), equal_nan=True)
               for g, w in zip(resumed.history, straight.history[-n:]))
    if bad or not same:
        fail(f"{what}: the loaded model's run differs from the uninterrupted one in "
             f"{bad[:6]} (metrics equal: {same})")
    return len(a)


def check_facade_kernels(model, what):
    """K4 and K3 against their twins at a fused PPO facade's own shapes, from
    its current weights, moments and env state: one rollout of its B envs x
    T steps from a seed, then one K3 minibatch of that rollout's samples
    (old log-probs and values jittered), cut into tiles as
    `fused_epoch_scan_adam` cuts them. Returns (K4's
    largest error, envs that left the twin's trajectory, K3's largest error,
    samples per minibatch, tile)."""
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    cfg, env, ts, bs = model.cfg, model.env, model.train_state, model._bstate
    gauss = env.config.scheme == "continuous"
    head = "gaussian" if gauss else "categorical"
    act_dim = 1 if gauss else env.config.n_actions
    scal = ppo_fused.rollout_scalars(model.env_params, 2026, 7)
    args = (bs.env.stock.float().contiguous(), bs.env.t.to(torch.int32).contiguous(),
            bs.env.harvest.float().contiguous(), bs.episode_return.float().contiguous(),
            bs.episode_length.to(torch.int32).contiguous(),
            ppo_fused.merged_weights(ts.params(), head), scal, cfg.num_steps)
    kw = dict(growth=env.config.growth, noise_form=env.config.noise_form, gamma=cfg.gamma,
              gae_lambda=cfg.gae_lambda, scheme=env.config.scheme,
              n_actions=env.config.n_actions, obs_noise=scal.sigma_m > 0.0,
              compute=cfg.compute_dtype, fold_obs=cfg.rollout_fold_obs)
    ker = pk.policy_rollout(*args, **kw)
    ref = pk.policy_rollout_reference(*args, **kw)
    torch.cuda.synchronize()
    k4_err, left = compare_k4(ker, ref, f"{what}: K4", not gauss,
                              cfg.compute_dtype == "bfloat16", B=cfg.num_envs, T=cfg.num_steps)

    # at the weights that collected them the ratio is 1, so the policy-loss
    # and KL sums are rounding noise around 0: old log-probs and values are
    # spread as in phase 8, so every clip branch is visited
    data = ref.packed_t.clone()
    jitter = np.random.default_rng(30).standard_normal((2, data.shape[1])).astype(np.float32)
    data[2:4] += 0.3 * torch.from_numpy(jitter).to(data.device)
    tile, per_mb, t_sum, t_sq = ppo_fused._tiling(cfg, data, 1, act_dim, head)
    order = torch.randperm(t_sum.shape[0], generator=torch.Generator().manual_seed(30))
    order = order[:per_mb].to(data.device, torch.int32)
    stats = ppo_fused._adv_stats(t_sum, t_sq, order, per_mb * tile)
    w, m, v = (ppo_fused.merged_weights(x, head) for x in (ts.params(), ts.m, ts.v))
    count1 = ts.count + 1
    kw3 = dict(clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
               lr=ppo.learning_rate(cfg, ts.count), bc1=1.0 - uk.ADAM_B1 ** count1,
               bc2=1.0 - uk.ADAM_B2 ** count1, obs_dim=1, act_dim=act_dim, tile=tile,
               head=head, compute=cfg.compute_dtype, max_grad_norm=cfg.max_grad_norm)
    *new, met = uk.fused_minibatch_grad_adam(data, order, w, m, v, stats, **kw3)
    *twin, met_ref = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, stats, **kw3)
    torch.cuda.synchronize()
    # the weights through their update (~lr), the moments as they are
    k3_err = max(check_buffers([x - y for x, y in zip(new[0], w)],
                               [x - y for x, y in zip(twin[0], w)], f"{what}: K3 dw"),
                 check_buffers(new[1], twin[1], f"{what}: K3 m"),
                 check_buffers(new[2], twin[2], f"{what}: K3 v"))
    check_metrics(met, met_ref, f"{what}: K3")
    return k4_err, left, k3_err, per_mb * tile, tile


def slice_phases(dev, label, counts, reset_counts):
    """Phases 26-31; returns phase 30's launch counts per kernel (in all
    and in the first iteration) and the largest K4 and K3 errors at the
    facades' shapes."""
    import tempfile

    from gym_fishing_tpu_torch import make
    from gym_fishing_tpu_torch.agents import DQN, PPO, SAC, TD3, dqn, ppo_rnn, sac, td3
    from gym_fishing_tpu_torch.batch import batched_reset

    cpu = torch.device("cpu")
    rng = np.random.default_rng(26)

    def off_policy(phase, name, cfg, env_id, make_state, step, draws, overrides=None, fill=8,
                   n_steps=200):
        t0 = time.perf_counter()
        overrides = overrides or {}
        env, p_dev = make(env_id, device=dev, **overrides)
        p_cpu = make(env_id, device="cpu", **overrides)[1]
        state = make_state(env, cfg, torch.Generator().manual_seed(phase), p_dev, dev)
        gen = torch.Generator(device=dev).manual_seed(phase)
        for _ in range(fill):
            state, _ = step(env, p_dev, cfg, state, gen)
        before = to_device(state, cpu)
        filled = state.buffer.size
        size = min(filled + cfg.num_envs, cfg.buffer_size)
        d = draws(cfg, size)
        (card_st, card_met), (cpu_st, cpu_met) = (
            step(env, p, cfg, st, **{k: torch.from_numpy(v).to(device) for k, v in d.items()})
            for device, st, p in ((dev, state, p_dev), (cpu, before, p_cpu)))
        err, other = state_diff(card_st, cpu_st)
        met_err = max(abs(float(card_met[k]) - float(cpu_met[k]))
                      for k in cpu_met if np.isfinite(float(cpu_met[k])))
        if other or not err <= SLICE_ATOL or not met_err <= SLICE_ATOL:
            fail(f"phase {phase}: {name} one step on the card vs the CPU: max abs err {err:.3g} "
                 f"of the state, {met_err:.3g} of the metrics, other leaves differing {other}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n_steps):
            state, met = step(env, p_dev, cfg, state, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / n_steps * 1e3
        if not all(np.isfinite(float(v)) for k, v in met.items() if k != "episode_return"):
            fail(f"phase {phase}: {name}: a non-finite metric after {n_steps} steps")
        print(f"phase {phase}: {name} {cfg.num_envs} envs, buffer {cfg.buffer_size}, batch "
              f"{cfg.batch_size}, hidden {cfg.hidden}: one step on the card ≡ the CPU from the "
              f"same draws after {fill} steps ({filled} rows in the buffer): max abs err "
              f"{err:.3g} (state), {met_err:.3g} (metrics) <= {SLICE_ATOL}; "
              f"{n_steps} steps at {ms:.3f} ms/step (host clock); phase "
              f"{time.perf_counter() - t0:.1f} s {label}")
        return state, ms

    def normals(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def indices(cfg, size):
        return rng.integers(0, size, (cfg.updates_per_step, cfg.batch_size))

    # --------------------------------------------------------------- 26
    scfg = sac.SACConfig()
    off_policy(26, "SAC fishing-v1", scfg, "fishing-v1", sac.make_sac_state,
               sac.sac_train_step, lambda c, s: dict(
                   act_noise=normals(c.num_envs, 1), env_noise=normals(2, c.num_envs),
                   sample_idx=indices(c, s),
                   target_noise=normals(c.updates_per_step, c.batch_size, 1),
                   actor_noise=normals(c.updates_per_step, c.batch_size, 1)))

    # --------------------------------------------------------------- 27
    dcfg = dqn.DQNConfig()
    for what, overrides in (("relative", {}),
                            ("proportional, 100 quotas", dict(scheme="proportional",
                                                              n_actions=100))):
        n_act = 3 if not overrides else 100
        off_policy(27, f"DQN fishing-v0 {what}", dcfg, "fishing-v0", dqn.make_dqn_state,
                   dqn.dqn_train_step, lambda c, s, n=n_act: dict(
                       explore_u=rng.uniform(size=c.num_envs).astype(np.float32),
                       rand_actions=rng.integers(0, n, c.num_envs).astype(np.int32),
                       env_noise=normals(2, c.num_envs), sample_idx=indices(c, s)),
                   overrides)

    # --------------------------------------------------------------- 28
    tcfg = td3.TD3Config()
    fill = 9   # the checked update is the delayed actor's (count % 2 == 1)
    t_state, _ = off_policy(28, "TD3 fishing-v1 (the checked update steps the actor)", tcfg,
                            "fishing-v1", td3.make_td3_state, td3.td3_train_step,
                            lambda c, s: dict(
                                act_noise=normals(c.num_envs, 1),
                                env_noise=normals(2, c.num_envs), sample_idx=indices(c, s),
                                smooth_noise=normals(c.updates_per_step, c.batch_size, 1)),
                            fill=fill)
    if (fill % tcfg.policy_delay) != tcfg.policy_delay - 1:
        fail("phase 28: the checked TD3 update does not step the actor")

    # --------------------------------------------------------------- 29
    t29 = time.perf_counter()
    rcfg = ppo_rnn.RPPOConfig(num_envs=256, num_steps=32, epochs=2, num_minibatches=4,
                              hidden=32, ent_coef=0.003)
    r_over = dict(sigma=0.02, sigma_m=0.15)
    r_env, r_dev = make("fishing-v1", device=dev, **r_over)
    r_cpu = make("fishing-v1", device="cpu", **r_over)[1]
    r0 = ppo_rnn.make_rppo_state(r_env, rcfg, torch.Generator().manual_seed(29), cpu)
    r_draws = dict(act_noise=normals(rcfg.num_steps, rcfg.num_envs, 1),
                   env_noise=normals(rcfg.num_steps, 2, rcfg.num_envs))
    r_perms = [rng.permutation(rcfg.num_envs) for _ in range(rcfg.epochs)]
    r_card, r_cpu_out = (ppo_rnn.train_step(
        r_env, p, rcfg, to_device(r0, device), batched_reset(r_env, p, rcfg.num_envs, device),
        ppo_rnn.init_hidden(rcfg, rcfg.num_envs, device),
        perms=[torch.from_numpy(x).to(device) for x in r_perms],
        **{k: torch.from_numpy(v).to(device) for k, v in r_draws.items()})
        for device, p in ((dev, r_dev), (cpu, r_cpu)))
    r_err, r_other = state_diff((r_card[0], r_card[2]), (r_cpu_out[0], r_cpu_out[2]))
    if r_other or not r_err <= SLICE_ATOL:
        fail(f"phase 29: recurrent PPO one step on the card vs the CPU: max abs err {r_err:.3g} "
             f"of the weights, moments and hidden; other leaves differing {r_other}")
    print(f"phase 29: recurrent PPO fishing-v1 sigma 0.02 sigma_m 0.15, 256 x 32, 2 x 4, hidden "
          f"32: one train_step on the card ≡ the CPU from the same draws: max abs err "
          f"{r_err:.3g} <= {SLICE_ATOL} (weights, Adam's moments, hidden)")
    for what, cfg_r in (("pomdp_policies' configuration", rcfg),
                        ("the defaults (256 x 64, 4 x 4, hidden 64)", ppo_rnn.RPPOConfig())):
        ts = ppo_rnn.make_rppo_state(r_env, cfg_r, torch.Generator().manual_seed(1), dev)
        bs = batched_reset(r_env, r_dev, cfg_r.num_envs, dev)
        h = ppo_rnn.init_hidden(cfg_r, cfg_r.num_envs, dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        ts, bs, h, met = ppo_rnn.train_step(r_env, r_dev, cfg_r, ts, bs, h, gen)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            ts, bs, h, met = ppo_rnn.train_step(r_env, r_dev, cfg_r, ts, bs, h, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        if not np.isfinite(float(met["loss"])):
            fail(f"phase 29: recurrent PPO at {what}: a non-finite loss")
        print(f"phase 29: recurrent PPO at {what}: {ms:.1f} ms/iter (host clock, "
              f"2 iterations after one warm-up) {label}")
    print(f"phase 29: in {time.perf_counter() - t29:.1f} s")

    # --------------------------------------------------------------- 30
    t30 = time.perf_counter()
    f_kw = dict(num_envs=4096, num_steps=128, fused_update=True, fused_rollout=True,
                fused_adam=True)
    per_iter = 4096 * 128
    iters = math.ceil(2_000_000 / per_iter)
    model = PPO("MlpPolicy", "fishing-v1", seed=30, **f_kw)
    per_call = []

    def timed_learn(m, n_iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.learn(n_iters * per_iter, callback=lambda _, met: per_call.append(dict(counts())))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    reset_counts()
    f_s = timed_learn(model, iters // 2)
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        f_s += timed_learn(model, iters - iters // 2)
        launches = counts()
        f_ms = f_s / iters * 1e3
        loaded = PPO.load(tmp, env="fishing-v1", seed=30, **f_kw)
    if len(model.history) != iters:
        fail(f"phase 30: learn(2000000) made {len(model.history)} iterations, not {iters}")
    mb = model.cfg.epochs * model.cfg.num_minibatches
    steps_seen = [{k: b[k] - a.get(k, 0) for k in b} for a, b in zip([{}] + per_call, per_call)]
    if any((c["policy"], c["adam"], c["grad"], c["rollout"]) != (1, mb, 0, 0)
           for c in steps_seen):
        fail(f"phase 30: launches per iteration {steps_seen}, expected 1 K4 and {mb} K3")
    loaded.learn((iters - iters // 2) * per_iter)
    n_ckpt = check_resumed("phase 30: PPO facade full+adam", model, loaded)
    k4_err, k4_left, k3_err, k3_n, k3_tile = check_facade_kernels(model, "phase 30")
    facade_err = {"K4": k4_err, "K3": k3_err}
    print(f"phase 30: at the facade's shapes from its trained state: K4 at B=4096 T=128 ≡ the "
          f"twin, max abs err {k4_err:.3g} (envs left {k4_left}); K3 on a minibatch of {k3_n} "
          f"samples (tiles of {k3_tile}) ≡ the twin, max abs err {k3_err:.3g}")
    print(f"phase 30: PPO('MlpPolicy', 'fishing-v1', num_envs=4096, num_steps=128, fused full "
          f"+ adam).learn(2000000): {iters} iterations, launches {launches} "
          f"({steps_seen[0]['policy']} K4 and {steps_seen[0]['adam']} K3 per iteration), "
          f"{f_ms:.1f} ms/iter (host clock); saved after {iters // 2}, the loaded "
          f"model's {iters - iters // 2} iterations ≡ the uninterrupted run's ({n_ckpt} leaves "
          f"and the metrics bit-identical); episode return {model.history[0]['episode_return']:.4f}"
          f" -> {model.history[-1]['episode_return']:.4f} {label}")
    n = 10
    for cls, env_id in ((SAC, "fishing-v1"), (TD3, "fishing-v1"), (DQN, "fishing-v0")):
        m = cls("MlpPolicy", env_id, seed=31)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.learn(n * m.cfg.num_envs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        with tempfile.TemporaryDirectory() as tmp:
            m.save(tmp)
            m.learn(n * m.cfg.num_envs)
            back = cls.load(tmp, env=env_id, seed=31)
        back.learn(n * back.cfg.num_envs)
        k = check_resumed(f"phase 30: {cls.__name__} facade", m, back)
        print(f"phase 30: {cls.__name__}('MlpPolicy', '{env_id}') at its defaults: {n} steps at "
              f"{ms:.3f} ms/step (host clock, a float read of every metric per step), saved, "
              f"{n} more ≡ the loaded model's {n} ({k} leaves bit-identical) {label}")
    print(f"phase 30: in {time.perf_counter() - t30:.1f} s")

    # --------------------------------------------------------------- 31
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.examples.pomdp_policies import pomdp_returns
    from gym_fishing_tpu_torch.examples.train_ppo import mean_returns, train_model

    t31 = time.perf_counter()
    rows = pomdp_returns(iterations=2, num_envs=64, reps=2, k=3, device=dev)
    if len(rows) != 4 or not all(np.isfinite(m) for m, _ in rows.values()):
        fail(f"phase 31: pomdp_policies: {rows}")
    rets = {}
    for form, kw in (("off", dict(timesteps=512, num_steps=8)),
                     ("full+adam", dict(timesteps=1024, num_steps=16, fused="full",
                                        fused_adam=True))):
        t_model, t_env, t_params = train_model(num_envs=64, verbose=0, device=dev, **kw)
        rets[form] = mean_returns(t_env, t_params, {"ppo": t_model.policy,
                                                    "escapement": escapement(t_env, t_params)})
        if not all(np.isfinite(v) for v in rets[form].values()):
            fail(f"phase 31: train_ppo {form}: {rets[form]}")
    k4_err, k4_left, k3_err, k3_n, k3_tile = check_facade_kernels(t_model, "phase 31")
    facade_err = {"K4": max(facade_err["K4"], k4_err), "K3": max(facade_err["K3"], k3_err)}
    print(f"phase 31: at train_ppo full+adam's shapes from its trained state: K4 at B=64 T=16 "
          f"≡ the twin, max abs err {k4_err:.3g} (envs left {k4_left}); K3 on a minibatch of "
          f"{k3_n} samples (tiles of {k3_tile}) ≡ the twin, max abs err {k3_err:.3g}")
    print(f"phase 31: examples on the card: pomdp_policies "
          f"{ {k: round(v[0], 3) for k, v in rows.items()} }, train_ppo "
          f"{ {k: {n: round(x, 3) for n, x in v.items()} for k, v in rets.items()} }; phase "
          f"{time.perf_counter() - t31:.1f} s {label}")
    return launches, steps_seen[0], facade_err


# phases 32-35: the multi-device path. Phase 33's sharded fused step at
# 1 x 1 against the single process: tests/test_shard_fused.py's bars (the
# minibatch's sums split over two ranks and added again, in float32); the
# plain step at 2 x 2: tests/test_shard.py's.
SHARD_RTOL, SHARD_ATOL, SHARD_MET_RTOL, SHARD_MET_ATOL = 1e-5, 2e-6, 1e-4, 1e-5
PLAIN_SHARD_ATOL = 1e-5
B_SHARD_K1 = 1 << 20   # envs per rank of phase 33(e), T_MAIN steps


def _bstate_leaves(bs):
    return {"stock": bs.env.stock, "harvest": bs.env.harvest, "t": bs.env.t,
            "episode_return": bs.episode_return, "episode_length": bs.episode_length}


def rank_phase33(mesh, job):
    """What each of phase 33's two gloo ranks on cuda:0 runs: (a) the
    sharded fused step at 1 x 1 from the global planes, (b) two iterations
    at 4 x 8 from a generator, (d) the plain train_step(mesh=) at 1024 x 16,
    2 x 2, and (e) sharded_rollout at B_SHARD_K1 envs per rank x T_MAIN
    steps, held bit for bit against K1 on the rank's slice with the folded
    seed and against K1's twin. Returns each part's result and the
    launches of the sharded calls alone."""
    from gym_fishing_tpu_torch import make
    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk
    from gym_fishing_tpu_torch.shard import fold_rank, shard_batch
    from gym_fishing_tpu_torch.shard.launch import rollout_job, train_job

    if "jax" in sys.modules:
        fail("jax was imported in a rank")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {name: train_job(mesh, job[name]) for name in ("a", "b", "d")}
    out["rank"] = mesh.rank
    # the collectives of one iteration at 4 x 8 alone, as phase 32 times them
    buf, sums = torch.zeros(job["collective_floats"], device=mesh.device), torch.zeros(
        2, device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(32):
        mesh.all_reduce(sums)
        mesh.all_reduce(buf)
    torch.cuda.synchronize()
    out["collectives_ms"] = (time.perf_counter() - t0) * 1e3
    e = job["e"]
    got = rollout_job(mesh, e)
    out["e_launches"] = got["launches"]
    _, params = make(e["env_id"], device="cpu", **e["env_kw"])
    stock, t = shard_batch((e["stock"], e["t"]), mesh)
    args = (stock, t, params, e["policy"], e["policy_param"], e["num_steps"])
    seed = fold_rank(e["seed"], mesh.rank)
    direct = rk.rollout(*args, seed=seed)
    twin = rk.rollout_reference(*args, seed=seed)
    torch.cuda.synchronize()
    sharded = rk.KernelRollout(**{k: v.to(mesh.device) if isinstance(v, torch.Tensor) else v
                                  for k, v in got["out"].items()})
    diff = [k for k in rk.KernelRollout._fields[:-1]
            if not torch.equal(getattr(sharded, k), getattr(direct, k))]
    if diff:
        fail(f"phase 33(e): rank {mesh.rank}: sharded_rollout differs from K1 on the slice with "
             f"the folded seed in {diff}")
    out["e_err"] = compare(sharded, twin, f"phase 33(e) rank {mesh.rank} vs twin",
                           stock_atol=1e-4, reward_atol=SUM_ATOL_512)
    out["e_head"] = sharded.stock[:4096].cpu()
    out["e_reward"] = float(sharded.reward.double().sum())
    return out


def _check_equal(what, got, want):
    bad = [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]
    if bad:
        fail(f"{what}: not bit-identical in {bad}")


def _close(what, got, want, rtol, atol):
    worst = 0.0
    for k in want:
        g, w = got[k].double().cpu(), want[k].double().cpu()
        err = float((g - w).abs().max())
        if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
            fail(f"{what}: {k} max abs err {err:.3g} (rtol {rtol}, atol {atol})")
        worst = max(worst, err)
    return worst


def multi_device_phases(dev, label, counts, reset_counts):
    """Phases 32-35; returns (launches of K1, K2 and K4 on the sharded
    paths, their largest errors against the twins, phase 32's and 33's
    times)."""
    import tempfile

    import torch.distributed as dist

    from gym_fishing_tpu_torch import make
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
    from gym_fishing_tpu_torch.shard import distributed_init, make_mesh, state_checksum
    from gym_fishing_tpu_torch.shard.fused_ppo import make_sharded_fused_train_step
    from gym_fishing_tpu_torch.shard.launch import spawn_ranks

    sharded = {"rollout": 0, "grad": 0, "policy": 0}
    errs = {}
    times = {}

    # ------------------------------------------------------------ 32
    t32 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke-nccl-")
    distributed_init(f"file://{work}/rendezvous", 1, 0, device=dev)
    if dist.get_backend() != "nccl":
        fail(f"phase 32: backend {dist.get_backend()}, not nccl")
    mesh = make_mesh(device=dev)
    env, p_host = make("fishing-v1", sigma=0.05, device="cpu")
    cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=True, fused_rollout=True)
    ts0 = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), dev)
    step = make_sharded_fused_train_step(env, p_host, cfg, mesh)
    runs = {}
    for name in ("sharded", "full"):
        ts, bs = ts0.clone(), batched_reset(env, p_host, cfg.num_envs, dev)
        gen = torch.Generator(device=dev).manual_seed(32)
        mets = []
        reset_counts()
        for _ in range(2):
            if name == "sharded":
                ts, bs, met = step(ts, bs, gen)
            else:
                ts, bs, met = ppo.train_step(env, p_host, cfg, ts, bs, gen)
            mets.append(met)
        torch.cuda.synchronize()
        runs[name] = (ts, bs, mets, counts(), gen)
    (ts_s, bs_s, met_s, n_s, gen_s), (ts_f, bs_f, met_f, n_f, gen_f) = runs["sharded"], runs["full"]
    sharded["grad"] += n_s["grad"]
    sharded["policy"] += n_s["policy"]
    mb = cfg.epochs * cfg.num_minibatches
    if n_s["policy"] != 2 or n_s["grad"] != 2 * mb or n_s["adam"] or n_s != n_f:
        fail(f"phase 32: launches {n_s} (sharded) and {n_f} (full) over 2 iterations, expected "
             f"2 K4 and {2 * mb} K2 each")
    _check_equal("phase 32: params", ts_s.params(), ts_f.params())
    _check_equal("phase 32: Adam m", ts_s.m, ts_f.m)
    _check_equal("phase 32: Adam v", ts_s.v, ts_f.v)
    _check_equal("phase 32: env state", _bstate_leaves(bs_s), _bstate_leaves(bs_f))
    for k, (a, b) in enumerate(zip(met_s, met_f)):
        _check_equal(f"phase 32: metrics of iteration {k}", a, b)
    if ts_s.count != ts_f.count or not torch.equal(gen_s.get_state(), gen_f.get_state()):
        fail("phase 32: Adam count or generator state differs")
    c_mesh, c_one = state_checksum(ts_s.model, mesh), state_checksum(ts_f.model)
    if float(c_mesh) != float(c_one):
        fail(f"phase 32: state_checksum across the group {float(c_mesh)} != {float(c_one)}")
    # ms per iteration, each iteration synchronised, in turns: full, sharded,
    # sharded, full; the host-bound form varies with the host, so medians
    ms = {"sharded": [], "full": []}
    for name in ("full", "sharded", "sharded", "full"):
        ts, bs, _, _, gen = runs[name]
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "sharded":
                ts, bs, met = step(ts, bs, gen)
            else:
                ts, bs, met = ppo.train_step(env, p_host, cfg, ts, bs, gen)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    times["nccl_w1_ms"] = float(np.median(ms["sharded"]))
    times["full_ms"] = float(np.median(ms["full"]))
    # what the step's collectives cost alone: per minibatch one all-reduce of
    # K2's output buffer and one of the two advantage sums
    buf = torch.zeros(ppo_fused.merged_weights(ts0.params()).flat.numel() + 4, device=dev)
    sums = torch.zeros(2, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(mb):
        mesh.all_reduce(sums)
        mesh.all_reduce(buf)
    torch.cuda.synchronize()
    times["nccl_w1_collectives_ms"] = (time.perf_counter() - t0) * 1e3
    dist.destroy_process_group()
    print(f"phase 32: NCCL at world size 1, fishing-v1 {B_PPO} x {T_PPO}, 4 x 8, hidden 64, "
          f"float32: the sharded fused step ≡ train_step full bit for bit over 2 iterations "
          f"(params, Adam m and v, env state, metrics, generator; state_checksum "
          f"{float(c_mesh):.6f} across the group); launches per iteration {n_s['policy'] // 2} "
          f"K4 and {n_s['grad'] // 2} K2; ms per iteration (host clock, median of 10, in turns "
          f"full, sharded, sharded, full) sharded {times['nccl_w1_ms']:.2f} (range "
          f"{min(ms['sharded']):.2f}-{max(ms['sharded']):.2f}), full {times['full_ms']:.2f} "
          f"({min(ms['full']):.2f}-{max(ms['full']):.2f}); the iteration's {2 * mb} "
          f"collectives alone {times['nccl_w1_collectives_ms']:.2f} ms ({buf.numel()} + 2 "
          f"floats a minibatch) {label}; in {time.perf_counter() - t32:.1f} s")

    # ------------------------------------------------------------ 33
    t33 = time.perf_counter()
    rng = np.random.default_rng(33)
    cfg_a = dataclasses.replace(cfg, epochs=1, num_minibatches=1)
    planes = torch.from_numpy(rng.standard_normal((2, T_PPO, B_PPO)).astype(np.float32))
    ts_cpu = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    cfg_d = ppo.PPOConfig(num_envs=1024, num_steps=16, epochs=2, num_minibatches=2)
    ts_d = ppo.make_train_state(env, cfg_d, torch.Generator().manual_seed(1), "cpu")
    env_k1, p_k1 = make("fishing-v1", sigma=0.05, device="cpu")
    x_star = float(escapement(env_k1, p_k1).x_star)
    job = {
        "a": dict(env_id="fishing-v1", env_kw=dict(sigma=0.05), cfg=dataclasses.asdict(cfg_a),
                  form="fused", state=ts_cpu.clone(), iterations=1, rollout_noise=[planes],
                  seed=5),
        "b": dict(env_id="fishing-v1", env_kw=dict(sigma=0.05), cfg=dataclasses.asdict(cfg),
                  form="fused", state=ts_cpu.clone(), iterations=2, seed=3),
        "collective_floats": buf.numel(),
        "d": dict(env_id="fishing-v1", env_kw=dict(sigma=0.05), cfg=dataclasses.asdict(cfg_d),
                  form="plain", state=ts_d.clone(), iterations=1, seed=11),
        "e": dict(env_id="fishing-v1", env_kw=dict(sigma=0.05),
                  stock=torch.full((2 * B_SHARD_K1,), float(p_k1.init_state)),
                  t=torch.zeros(2 * B_SHARD_K1, dtype=torch.int32), policy="escapement",
                  policy_param=x_star, num_steps=T_MAIN, seed=2033),
    }
    ranks = spawn_ranks("chip_smoke:rank_phase33", 2, job, device=dev, backend="gloo",
                        timeout_s=300)
    for part in ("a", "b", "d"):
        for r in ranks:
            for kern in ("grad", "policy"):
                sharded[kern] += r[part]["launches"][kern]
    for r in ranks:
        sharded["rollout"] += r["e_launches"]["rollout"]
    # (a) against the single process on the global batch from the same planes
    ts, bs = to_device(ts_cpu, dev), batched_reset(env, p_host, B_PPO, dev)
    ts, bs, met = ppo.train_step(env, p_host, cfg_a, ts, bs,
                                 torch.Generator(device=dev).manual_seed(5),
                                 rollout_noise=planes.to(dev))
    a_err = max(_close(f"phase 33(a): rank {r['rank']} params", r["a"]["params"],
                       {k: v.detach() for k, v in ts.params().items()}, SHARD_RTOL, SHARD_ATOL)
                for r in ranks)
    names = ("pg_loss", "v_loss", "approx_kl", "episode_return", "mean_reward")
    for r in ranks:
        _close(f"phase 33(a): rank {r['rank']} metrics",
               {k: torch.tensor(r["a"]["metrics"][0][k]) for k in names},
               {k: met[k].detach() for k in names}, SHARD_MET_RTOL, SHARD_MET_ATOL)
    stock_a = torch.cat([r["a"]["bstate"].env.stock for r in ranks])
    _close("phase 33(a): end stock", {"stock": stock_a}, {"stock": bs.env.stock}, 1e-6, 1e-7)
    # (b) the replicas stay equal
    _check_equal("phase 33(b): rank 1's params against rank 0's", ranks[1]["b"]["params"],
                 ranks[0]["b"]["params"])
    if not all(np.isfinite(r["b"]["metrics"][-1]["loss"]) for r in ranks):
        fail("phase 33(b): a non-finite loss")
    if ranks[0]["b"]["checksum"] != ranks[1]["b"]["checksum"]:
        fail("phase 33(b): the ranks' checksums differ")
    times["gloo_w2_ms"] = max(r["b"]["ms"][-1] for r in ranks)
    times["gloo_w2_collectives_ms"] = max(r["collectives_ms"] for r in ranks)
    # (c) K4 and K2 from rank 0's trained state, at a rank's shapes
    local = dataclasses.replace(cfg, num_envs=B_PPO // 2)
    st = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        for k, p in st.model.named_parameters():
            p.copy_(ranks[0]["b"]["params"][k])
    b0 = to_device(ranks[0]["b"]["bstate"], dev)
    scal = ppo_fused.rollout_scalars(p_host, 2026, 7)
    args = (b0.env.stock.float().contiguous(), b0.env.t.to(torch.int32).contiguous(),
            b0.env.harvest.float().contiguous(), b0.episode_return.float().contiguous(),
            b0.episode_length.to(torch.int32).contiguous(),
            ppo_fused.merged_weights(st.params(), "gaussian"), scal, local.num_steps)
    kw = dict(growth=env.config.growth, noise_form=env.config.noise_form, gamma=local.gamma,
              gae_lambda=local.gae_lambda, scheme=env.config.scheme,
              n_actions=env.config.n_actions, obs_noise=False, compute="float32",
              fold_obs=local.rollout_fold_obs)
    ker = pk.policy_rollout(*args, **kw)
    ref = pk.policy_rollout_reference(*args, **kw)
    torch.cuda.synchronize()
    errs["K4"], k4_left = compare_k4(ker, ref, "phase 33(c): K4", False, B=local.num_envs,
                                     T=local.num_steps)
    data = ref.packed_t.clone()
    jitter = np.random.default_rng(34).standard_normal((2, data.shape[1])).astype(np.float32)
    data[2:4] += 0.3 * torch.from_numpy(jitter).to(dev)
    tile, per_mb, t_sum, t_sq = ppo_fused._tiling(local, data, 1, 1, "gaussian")
    order = torch.randperm(t_sum.shape[0], generator=torch.Generator().manual_seed(34))
    order = order[:per_mb].to(dev, torch.int32)
    stats = ppo_fused._adv_stats(t_sum, t_sq, order, per_mb * tile)
    kw2 = dict(clip_eps=local.clip_eps, vf_coef=local.vf_coef, ent_coef=local.ent_coef,
               obs_dim=1, act_dim=1, tile=tile, head="gaussian", compute="float32")
    weights = ppo_fused.merged_weights(st.params(), "gaussian")
    g, m = uk.fused_minibatch_grad(data, order, weights, stats, **kw2)
    g_ref, m_ref = uk.fused_minibatch_grad_reference(data, order, weights, stats, **kw2)
    torch.cuda.synchronize()
    errs["K2"] = check_buffers(towers(uk, g), towers(uk, g_ref), "phase 33(c): K2")
    check_metrics(m, m_ref, "phase 33(c): K2")
    # (d) the plain step against the single process
    ts = to_device(ts_d, dev)
    env_d, p_d = make("fishing-v1", sigma=0.05, device=dev)
    ts, _, met_d = ppo.train_step(env_d, p_d, cfg_d, ts, batched_reset(env_d, p_d, 1024, dev),
                                  torch.Generator(device=dev).manual_seed(11))
    d_err = max(_close(f"phase 33(d): rank {r['rank']} params", r["d"]["params"],
                       {k: v.detach() for k, v in ts.params().items()}, 0.0, PLAIN_SHARD_ATOL)
                for r in ranks)
    for r in ranks:
        _close(f"phase 33(d): rank {r['rank']} metrics",
               {k: torch.tensor(r["d"]["metrics"][0][k]) for k in names},
               {k: met_d[k].detach() for k in names}, SHARD_MET_RTOL, SHARD_MET_ATOL)
    # (e) the ranks drew different streams from one seed
    if torch.equal(ranks[0]["e_head"], ranks[1]["e_head"]):
        fail("phase 33(e): the two ranks drew the same noise")
    errs["K1"] = max(r["e_err"] for r in ranks)
    print(f"phase 33: gloo, two ranks on {dev}: (a) the sharded fused step at {B_PPO // 2} envs "
          f"per rank, 1 x 1, from the global planes ≡ the single process within {a_err:.3g} "
          f"(params; rtol {SHARD_RTOL}, atol {SHARD_ATOL}); (b) 2 iterations at 4 x 8: the "
          f"replicas bit-identical, loss {ranks[0]['b']['metrics'][-1]['loss']:.5f}, second "
          f"iteration {times['gloo_w2_ms']:.2f} ms, its 64 collectives alone "
          f"{times['gloo_w2_collectives_ms']:.2f} ms (host clock; two processes on one card, not "
          f"scaling) {label}; (c) from rank 0's state K4 (B={local.num_envs}, T={local.num_steps}) "
          f"≡ twin within {errs['K4']:.3g} ({k4_left} envs left), K2 ({per_mb} tiles of {tile}) "
          f"within {errs['K2']:.3g}; (d) train_step(mesh=) at 1024 x 16, 2 x 2 ≡ the single "
          f"process within {d_err:.3g}; (e) sharded_rollout at {B_SHARD_K1} envs per rank x "
          f"{T_MAIN} steps ≡ K1 on the slice with the folded seed bit for bit, ≡ twin within "
          f"{errs['K1']:.3g}, the ranks' streams differ; launches in the ranks {sharded}; in "
          f"{time.perf_counter() - t33:.1f} s")

    # ------------------------------------------------------------ 34
    t34 = time.perf_counter()
    from gym_fishing_tpu_torch.bench.scaling import weak_scaling
    from gym_fishing_tpu_torch.examples import multihost_train

    hist = multihost_train.main(["--iterations", "3"])
    if len(hist) != 3 or not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"phase 34: multihost_train: {hist}")
    ex_s = time.perf_counter() - t34
    ws = weak_scaling()
    if list(ws["throughput"]) != [1] or not ws["throughput"][1] > 0:
        fail(f"phase 34: weak_scaling: {ws}")
    times["weak_scaling_1"] = ws["throughput"][1]
    print(f"phase 34: multihost_train without a coordinator at its defaults (4096 envs x 128 "
          f"steps), 3 iterations in {ex_s:.1f} s, episode return "
          f"{hist[-1]['episode_return']:.4f}; weak_scaling() on this one card: "
          f"{ws['throughput'][1]:.4g} env-steps/s at {ws['envs_per_device']} envs per rank "
          f"{label} (scaling beyond one card not measured); in {time.perf_counter() - t34:.1f} s")

    # ------------------------------------------------------------ 35
    t35 = time.perf_counter()
    from gym_fishing_tpu_torch.validation import fused_training

    if fused_training.main(["--against-jax", "--fused-adam", "--device", str(dev)]) != 0:
        fail("phase 35: full+adam does not follow the JAX curve within the tolerance")
    print(f"phase 35: full+adam float32 against JAX's recorded plain-form curve: PASS "
          f"{label}; in {time.perf_counter() - t35:.1f} s")
    return sharded, errs, times


def main():
    # ---------------------------------------------------------------- 1
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA device")
    sys.path.insert(0, ROOT)
    from gym_fishing_tpu_torch import make
    import gym_fishing_tpu_torch as gtt
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.bench import measure
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.batch import BatchState, batched_reset
    from gym_fishing_tpu_torch.core.types import EnvState
    from gym_fishing_tpu_torch.bench import measure_ppo_train, rollout_instructions
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

    def reset_counts():
        rk.launches = uk.grad_launches = uk.adam_launches = pk.launches = 0
        uk.split_launches = uk.clip_adam_launches = 0

    def counts():
        return {"rollout": rk.launches, "grad": uk.grad_launches, "adam": uk.adam_launches,
                "policy": pk.launches}

    if "jax" in sys.modules:
        fail("jax was imported")
    dev = torch.device("cuda", 0)
    smi = card_label()
    print(smi)
    label = f"[{smi}]"
    print(f"phase 1: device {torch.cuda.get_device_name(0)}, count "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---------------------------------------------------------------- 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the twins' matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    plane_cases, seed_cases = parity_cases(gtt), seeded_cases(gtt)
    # K1's libraries: the main path's (fishing-v1 under escapement, from a
    # seed; also phase 4's), each parity case's, and the chained calls'
    v0 = gtt.make("fishing-v0", sigma=0.1, Tmax=13, device="cpu")
    k1_configs = {rk.DEFAULT_CONFIGURATION,
                  case_configuration(rk, *v0, "escapement", False, False)}
    k1_configs |= {case_configuration(rk, c[1], c[2], c[3], c[5], True) for c in plane_cases}
    k1_configs |= {case_configuration(rk, c[1], c[2], c[3], c[5], False) for c in seed_cases}
    build_s = build_all({"rollout_kernel": lambda: rk.build(k1_configs),
                         "ppo_update_kernel": uk.library, "policy_rollout_kernel": pk.library})
    main_so = _build.library_path("rollout_kernel", rk.DEFAULT_CONFIGURATION.defines()).name
    print(f"phase 2: built and loaded {len(k1_configs) + 2} libraries, 8 nvcc at a time, in "
          f"{time.perf_counter() - t0:.2f} s: {len(k1_configs)} configurations of "
          f"rollout_kernel in {build_s['rollout_kernel']:.2f} s, ppo_update_kernel in "
          f"{build_s['ppo_update_kernel']:.2f} s, policy_rollout_kernel in "
          f"{build_s['policy_rollout_kernel']:.2f} s")
    print(f"phase 2: {main_so} is fishing-v1 under escapement, noise from a seed: "
          f"{' '.join(rk.DEFAULT_CONFIGURATION.defines())}")
    print_ptxas(_build, main_so)

    # ---------------------------------------------------------------- 3
    rng = np.random.default_rng(2026)
    worst = 0.0
    n = B_PARITY
    launched_configs = set()
    for label_c, env, params, policy, param, obs_noise, floor in plane_cases:
        cfg = env.config
        launched_configs.add(case_configuration(rk, env, params, policy, obs_noise, True))
        stock = torch.from_numpy(rng.uniform(floor, 1.2, n).astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.integers(0, int(params.Tmax), n).astype(np.int32)).to(dev)
        noise = torch.from_numpy(
            rng.standard_normal((2 if obs_noise else 1, T_PARITY, n)).astype(np.float32)
        ).to(dev)
        kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
                  n_actions=cfg.n_actions, obs_noise=obs_noise, noise=noise)
        ker = rk.rollout(stock, t, params, policy, param, T_PARITY, **kw)
        ref = rk.rollout_reference(stock, t, params, policy, param, T_PARITY, **kw)
        torch.cuda.synchronize()
        err = compare(ker, ref, label_c)
        if label_c == "collapse_penalty" and not bool((ker.ep_count == T_PARITY).all()):
            fail("collapse_penalty: every step should collapse")
        worst = max(worst, err)
        print(f"phase 3: {label_c:34s} max abs err {err:.3g}")
    for label_c, env, params, policy, param, obs_noise, floor, steps in seed_cases:
        cfg = env.config
        launched_configs.add(case_configuration(rk, env, params, policy, obs_noise, False))
        stock = torch.from_numpy(rng.uniform(floor, 1.2, n).astype(np.float32)).to(dev)
        t = torch.from_numpy(rng.integers(0, int(params.Tmax), n).astype(np.int32)).to(dev)
        kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
                  n_actions=cfg.n_actions, obs_noise=obs_noise, seed=11, offset=2**32 - 3)
        ker = rk.rollout(stock, t, params, policy, param, steps, **kw)
        ref = rk.rollout_reference(stock, t, params, policy, param, steps, **kw)
        torch.cuda.synchronize()
        err = compare(ker, ref, label_c)
        worst = max(worst, err)
        print(f"phase 3: {label_c:34s} max abs err {err:.3g} ({steps} steps)")
    # two chained calls carrying ep_ret and harvest (relative scheme)
    env, params = v0
    launched_configs.add(case_configuration(rk, env, params, "escapement", False, False))
    stock = torch.from_numpy(rng.uniform(0.3, 1.2, n).astype(np.float32)).to(dev)
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    kw = dict(scheme="relative")
    k1 = rk.rollout(stock, t, params, "escapement", 0.5, T_PARITY, seed=7, **kw)
    r1 = rk.rollout_reference(stock, t, params, "escapement", 0.5, T_PARITY, seed=7, **kw)
    worst = max(worst, compare(k1, r1, "chained call 1"))
    k2 = rk.rollout(k1.stock, k1.t, params, "escapement", 0.5, T_PARITY, seed=7,
                    offset=k1.next_offset, ep_ret=k1.ep_ret, harvest=k1.harvest, **kw)
    r2 = rk.rollout_reference(r1.stock, r1.t, params, "escapement", 0.5, T_PARITY, seed=7,
                              offset=r1.next_offset, ep_ret=r1.ep_ret, harvest=r1.harvest, **kw)
    err = compare(k2, r2, "chained call 2")
    worst = max(worst, err)
    print(f"phase 3: {'chained relative, seeded':34s} max abs err {err:.3g}")
    # every value of every compile-time switch was launched, from its own library
    for field, size in zip(rk.Configuration._fields, rk.CONFIG_SIZES):
        missing = set(range(size)) - {getattr(c, field) for c in launched_configs}
        if missing:
            fail(f"phase 3 launched no configuration with {field} in {sorted(missing)}")
    n_launches = len(plane_cases) + len(seed_cases) + 2
    if not launched_configs <= k1_configs or rk.launches != n_launches:
        fail(f"phase 3: {rk.launches} launches of {len(launched_configs)} configurations, "
             f"{len(launched_configs - k1_configs)} of them not built in phase 2")
    # there is no generic kernel: a library refuses another configuration's parameters
    label_c, env, params, policy, param, obs_noise, floor = plane_cases[1]
    real_library = rk.library
    rk.library = lambda config=None: real_library()
    try:
        rk.rollout(stock, t, params, policy, param, T_PARITY, growth=env.config.growth)
    except RuntimeError as exc:
        refusal = str(exc)
    else:
        fail(f"the library of fishing-v1 under escapement took the parameters of {label_c}")
    finally:
        rk.library = real_library
    print(f"phase 3: {len(launched_configs)} configurations launched, each from its own "
          f"library; another configuration's parameters are refused ({refusal[:60]})")

    # ---------------------------------------------------------------- 4
    m = 1 << 20
    z = rk.philox_normals(seed=12345, offset=99, num_envs=m, device=dev)
    z_ref = rk.philox_normals(seed=12345, offset=99, num_envs=m, device="cpu")
    err = max_err(z.cpu(), z_ref)
    if not err <= 1e-5:
        fail(f"philox normals differ from the twin's stream by {err:.3g}")
    x = z.double().reshape(-1)
    N = x.numel()
    mean, std = float(x.mean()), float(x.std())
    skew = float(((x - mean) ** 3).mean()) / std**3
    xs = torch.sort(x).values
    cdf = torch.special.ndtr(xs)
    i = torch.arange(1, N + 1, dtype=torch.float64, device=dev)
    ks = float(torch.maximum(i / N - cdf, cdf - (i - 1) / N).max())
    corr_env = float(torch.corrcoef(torch.stack([z[0, :-1], z[0, 1:]]).double())[0, 1])
    corr_draw = float(torch.corrcoef(torch.stack([z[0], z[2]]).double())[0, 1])
    z_next = rk.philox_normals(seed=12345, offset=100, num_envs=m, device=dev)
    same = float((z_next == z).double().mean())
    print(f"phase 4: {N} normals: mean {mean:.2e} std {std:.6f} skew {skew:.2e} KS {ks:.2e} "
          f"corr(env,env+1) {corr_env:.2e} corr(draw0,draw2) {corr_draw:.2e} "
          f"twin err {err:.2e} equal-at-next-offset {same:.2e}")
    checks = {
        "mean": abs(mean) < 5 / math.sqrt(N),
        "std": abs(std - 1) < 5 * math.sqrt(0.5 / N),
        "skew": abs(skew) < 5 * math.sqrt(6 / N),
        "ks": ks < 1.95 / math.sqrt(N),  # alpha = 0.001
        "corr_env": abs(corr_env) < 5 / math.sqrt(m),
        "corr_draw": abs(corr_draw) < 5 / math.sqrt(m),
        "fresh_offset": same < 1e-3,
    }
    if not all(checks.values()):
        fail(f"Philox stream checks: {checks}")
    # chained rollout calls draw fresh numbers
    env, params = make("fishing-v1", sigma=0.1, device="cpu")
    stock = torch.full((n,), 0.75, device=dev)
    t = torch.zeros(n, dtype=torch.int32, device=dev)
    a = rk.rollout(stock, t, params, "escapement", 0.5, 8, seed=3)
    b = rk.rollout(stock, t, params, "escapement", 0.5, 8, seed=3, offset=a.next_offset)
    if a.next_offset != 2 or float((a.stock == b.stock).float().mean()) > 1e-3:
        fail("a chained call replayed the previous call's noise")

    # ---------------------------------------------------------------- 5
    env, params = make("fishing-v1", sigma=0.05, device="cpu")
    x_star = float(escapement(env, params).x_star)
    seed = 2026
    stock0 = torch.full((B_MAIN,), float(params.init_state), dtype=torch.float32, device=dev)
    t0_ = torch.zeros(B_MAIN, dtype=torch.int32, device=dev)
    ep0 = torch.zeros(B_MAIN, dtype=torch.float32, device=dev)
    n_calls = 6
    reset_counts()
    state = (stock0, t0_, ep0, 0)
    calls = []

    def call():
        nonlocal state
        stock, t, ep, offset = state
        out = rk.rollout(stock, t, params, "escapement", x_star, T_MAIN, ep_ret=ep,
                         seed=seed, offset=offset)
        calls.append((ep, offset, out))
        state = (out.stock, out.t, out.ep_ret, out.next_offset)
        return out

    # measure() first: its 6 calls also bring the card to its working clocks
    # after phase 4's host-side work, which the window below would see
    timed = measure(mode="kernel", num_envs=B_MAIN, num_steps=T_MAIN, iters=5, warmup=1,
                    seed=seed + 1)
    call()  # warm-up, also held against the twin below
    torch.cuda.synchronize()
    host0 = time.perf_counter()
    ker_ms, last = cuda_ms(call, n_calls - 1)
    last.ep_ret.reshape(-1)[0].item()
    host_s = time.perf_counter() - host0
    sm_clock = sm_clock_mhz()
    launched = counts()["rollout"]
    if launched != n_calls + 6:
        fail(f"launch counter {launched} != {n_calls + 6} calls")
    for k, (ep_in, offset, out) in enumerate(calls):
        if not bool(torch.isfinite(out.stock).all()) or float(out.stock.min()) < 0:
            fail(f"call {k}: non-finite or negative stock")
        if int(out.ep_count.min()) < 1:
            fail(f"call {k}: an env completed no episode in {T_MAIN} steps")
        if int(out.t.min()) < 0 or int(out.t.max()) >= int(params.Tmax):
            fail(f"call {k}: t out of range")
        gap = max_err(out.ep_ret_sum + out.ep_ret - ep_in, out.reward)
        if not gap <= SUM_ATOL_512:
            fail(f"call {k}: ep_ret_sum + ep_ret_out - ep_ret_in - reward = {gap:.3g}")
        if out.next_offset != offset + rk.draws_per_call(T_MAIN, False):
            fail(f"call {k}: offset did not advance")
    mean_ret = float(calls[-1][2].ep_ret_sum.sum() / calls[-1][2].ep_count.sum())
    print(f"phase 5: {launched} launches on the main path; mean episode return "
          f"{mean_ret:.4f}; per-call identities hold")
    ref_fn = lambda: rk.rollout_reference(stock0, t0_, params, "escapement", x_star,  # noqa: E731
                                          T_MAIN, ep_ret=ep0, seed=seed, offset=0)
    ref_fn()
    plain_ms, ref = cuda_ms(ref_fn, 1)
    main_err = compare(calls[0][2], ref, "main path vs twin", stock_atol=1e-4,
                       reward_atol=SUM_ATOL_512)
    steps = B_MAIN * T_MAIN
    print(f"phase 5: kernel {ker_ms:.3f} ms/call (CUDA events; SM clock {sm_clock} just "
          f"after), {steps * (n_calls - 1) / host_s:.4g} env-steps/s (host clock, "
          f"{n_calls - 1} chained calls); measure(mode='kernel'): "
          f"{timed['ms_per_call']:.3f} ms/call, {timed['steps_per_s']:.4g} env-steps/s; "
          f"B={B_MAIN} T={T_MAIN} {label}")
    k1_bound = rollout_kernel_bound(B_MAIN, T_MAIN)
    print(f"phase 5: K1 bound {k1_bound[0]:.4f} ms by {k1_bound[1]}: {K1_OPS} per env and "
          f"step, counted from the algorithm, on their pipes (share "
          f"{k1_bound[0] / ker_ms:.3f}); by bytes {least_ms(0.0, 44 * B_MAIN)[0]:.4f} ms")
    # a least time that the kernel's own instructions undercut is no least time
    k1_count = rollout_instructions.instruction_count(rk, _build, None)
    k1_issue = issue_ms(k1_count["instructions_per_step"], B_MAIN, T_MAIN)
    print(f"phase 5: the shipped fishing-v1 library executes "
          f"{k1_count['instructions_per_step']} instructions per env and step "
          f"({k1_count['mix']} per Philox block of four steps; "
          f"{k1_count['registers']} registers): the schedulers need {k1_issue:.4f} ms for them")
    if not k1_issue >= k1_bound[0]:
        fail(f"K1's bound {k1_bound[0]:.4f} ms is above the {k1_issue:.4f} ms its own "
             "instructions need: K1_OPS counts more than the function needs")
    print(f"phase 5: twin {plain_ms:.1f} ms/call (CUDA events), "
          f"{steps / plain_ms * 1e3:.4g} env-steps/s; kernel vs twin max abs err "
          f"{main_err:.3g}; B={B_MAIN} T={T_MAIN} {label}")

    # ---------------------------------------------------------------- 6
    eng = measure(mode="engine", num_envs=B_MAIN, num_steps=64, iters=3, warmup=1)
    if not math.isfinite(eng["reward_sum"]) or eng["reward_sum"] <= 0:
        fail(f"engine reward sum {eng['reward_sum']}")
    print(f"phase 6: engine {eng['ms_per_call']:.2f} ms/call, {eng['steps_per_s']:.4g} "
          f"env-steps/s, reward sum {eng['reward_sum']:.6g}; B={B_MAIN} T=64 {label}")

    # ---------------------------------------------------------------- 7
    for name in ("ppo_update_kernel", "policy_rollout_kernel"):
        print(f"phase 7: {_build.library_path(name).name} in {build_s[name]:.2f} s (built "
              "beside rollout_kernel in phase 2)")
        print_ptxas(_build, name)
    # the bf16 dw2c_split: its two instantiations (64 and 128 wide tiles) take
    # their operands by TMA and multiply on wgmma
    dw_ops = [hmma_counts(_build, "ppo_update_kernel", "dw2c_split_bf16", op)
              for op in ("HGMMA", "UTMALDG")]
    if len(dw_ops[0]) != 2 or not all(dw_ops[0][k] > 0 and dw_ops[1][k] > 0 for k in dw_ops[0]):
        fail(f"phase 7: dw2c_split_bf16's instantiations (HGMMA, UTMALDG): {dw_ops}")
    print(f"phase 7: dw2c_split_bf16, 2 instantiations: HGMMA (wgmma) and UTMALDG (TMA loads) "
          f"{sorted((dw_ops[0][k], dw_ops[1][k]) for k in dw_ops[0])}")
    for fn, n_hmma in hmma_counts(_build, "policy_rollout_kernel").items():
        bf16 = "Lb1E" in fn   # the mangled template argument BF = true
        print(f"phase 7: {fn[:40]} ({'bfloat16' if bf16 else 'float32'}): {n_hmma} HMMA")
        if (n_hmma > 0) != bf16:
            fail(f"{fn}: {n_hmma} HMMA instructions under "
                 f"{'bfloat16' if bf16 else 'float32'}")
    # the wide path: its products on the tensor cores under bfloat16 at hidden
    # 64 and above, FMA under float32 and at hidden 32
    wide_hmma = hmma_counts(_build, "policy_rollout_kernel", "policy_rollout_wide")
    if len(wide_hmma) != 2 * len(pk.KERNEL_HIDDEN):
        fail(f"phase 7: {len(wide_hmma)} instantiations of policy_rollout_wide, expected "
             f"{2 * len(pk.KERNEL_HIDDEN)}")
    for fn, n_hmma in wide_hmma.items():
        hidden, bf16 = int(re.search(r"ILi(\d+)E", fn).group(1)), "Lb1E" in fn
        mma = bf16 and hidden >= 64
        print(f"phase 7: policy_rollout_wide hidden={hidden} "
              f"({'bfloat16' if bf16 else 'float32'}): {n_hmma} HMMA")
        if (n_hmma > 0) != mma:
            fail(f"{fn}: {n_hmma} HMMA instructions under {'bfloat16' if bf16 else 'float32'} "
                 f"at hidden {hidden}")

    # K2/K3's wide stage 1: ppo_grad_tower (bfloat16 at hidden 64 and above,
    # both BIGD forms, both heads) on the tensor cores, ppo_grad_wide
    # (float32 at every hidden size, bfloat16 at 32) FMA
    for kernel, n_inst, mma in (("ppo_grad_tower", 12, True), ("ppo_grad_wide", 10, False)):
        stage1_hmma = hmma_counts(_build, "ppo_update_kernel", kernel)
        print(f"phase 7: {kernel}, {len(stage1_hmma)} instantiations: HMMA "
              f"{sorted(stage1_hmma.values())}")
        if len(stage1_hmma) != n_inst or any((n > 0) != mma for n in stage1_hmma.values()):
            fail(f"phase 7: {kernel}'s instantiations: {stage1_hmma}")

    # ---------------------------------------------------------------- 8
    rng = np.random.default_rng(7)
    cases = {head: ppo_case(ppo, ppo_fused, rng, head, dev) for head in ("gaussian",
                                                                         "categorical")}
    order = torch.from_numpy(rng.permutation(N_PPO // TILE)[:MB_TILES].astype(np.int32)).to(dev)
    grad_err = 0.0
    grad_ms, grad_plain_ms = {}, {}
    n_mb = MB_TILES * TILE
    for head, (weights, data, a) in cases.items():
        adv = data[4, order.long()[:, None] * TILE + torch.arange(TILE, device=dev)]
        stats = torch.stack([adv.mean(), 1.0 / (adv.std(correction=0) + 1e-8)])
        for ent_coef in (0.0, 0.01):
            for compute in ("float32", "bfloat16"):
                kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=ent_coef, obs_dim=1, act_dim=a,
                          tile=TILE, head=head, compute=compute)
                g, met = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
                g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights,
                                                                    stats, **kw)
                torch.cuda.synchronize()
                what = f"K2 {head} ent_coef={ent_coef} {compute}"
                err = check_buffers(towers(uk, g), towers(uk, g_ref), what)
                check_metrics(met, met_ref, what)
                grad_err = max(grad_err, err)
                line = f"phase 8: {what:40s} max abs err {err:.3g}"
                if compute == "float32":
                    worst64 = check_float64_bar(uk, g, g_ref, data, order, weights, stats, kw,
                                                what)
                    line += (f"; against float64, worst buffer {worst64[0]}: kernel "
                             f"{worst64[1]:.3g}, float32 twin {worst64[2]:.3g}")
                print(line)
                if head == "gaussian" and ent_coef == 0.0:
                    grad_ms[compute], _ = cuda_ms(lambda: uk.fused_minibatch_grad(
                        data, order, weights, stats, **kw), 20)
                    grad_plain_ms[compute], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_reference(data, order, weights, stats,
                                                                  **kw), 5)
    # one PyTorch call computes none of K2; its three 2H-contractions alone, as
    # the merged [n, 2H] x [2H, 2H] products a library would be given
    lib_ms = {}
    xa = torch.from_numpy(rng.standard_normal((n_mb, 128)).astype(np.float32)).to(dev)
    xb = torch.from_numpy(rng.standard_normal((n_mb, 128)).astype(np.float32)).to(dev)
    wm = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32)).to(dev)
    for compute, ty in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        a_, b_, w_ = xa.to(ty), xb.to(ty), wm.to(ty)
        three = lambda: (a_ @ w_, a_.T @ b_, b_ @ w_.T)  # noqa: E731
        three()
        lib_ms[compute], _ = cuda_ms(three, 10)
    del xa, xb, wm
    grad_bound = {c: update_bound(n_mb, 1, 64, 1, c) for c in grad_ms}
    for c in grad_ms:
        print(f"phase 8: K2 {c}: {grad_ms[c]:.3f} ms, twin {grad_plain_ms[c]:.3f} ms per "
              f"minibatch of {MB_TILES} x {TILE} samples (CUDA events); bound "
              f"{grad_bound[c][0]:.4f} ms by {grad_bound[c][1]} (share "
              f"{grad_bound[c][0] / grad_ms[c]:.3f}); the three products alone as torch.matmul "
              f"{lib_ms[c]:.3f} ms; N={N_PPO} hidden=64 {label}")

    # ---------------------------------------------------------------- 9
    adam_err = clip_adam_err = 0.0
    adam_ms, adam_plain_ms = {}, {}
    clip_ms, clip_plain_ms, clip_bound = {}, {}, {}
    for head, (weights, data, a) in cases.items():
        w = weights
        m = tuple(torch.from_numpy(0.01 * rng.standard_normal(x.shape).astype(np.float32))
                  .to(dev) for x in w)
        v = tuple(torch.from_numpy(1e-4 * rng.random(x.shape).astype(np.float32)).to(dev)
                  for x in w)
        stats = torch.tensor([0.01, 1.2], device=dev)
        for max_grad_norm in (1e6, 1e-3):   # below the threshold, then clipped
            kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, lr=3e-4, bc1=1 - 0.9 ** 5,
                      bc2=1 - 0.999 ** 5, obs_dim=1, act_dim=a, tile=TILE, head=head,
                      max_grad_norm=max_grad_norm)
            *new, met = uk.fused_minibatch_grad_adam(data, order, w, m, v, stats, **kw)
            *ref, met_ref = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, stats,
                                                                   **kw)
            torch.cuda.synchronize()
            what = f"K3 {head} max_grad_norm={max_grad_norm:g}"
            # the weights through their update (~lr), the moments as they are
            err = max(check_buffers([x - y for x, y in zip(new[0], w)],
                                    [x - y for x, y in zip(ref[0], w)], what + " dw"),
                      check_buffers(new[1], ref[1], what + " m"),
                      check_buffers(new[2], ref[2], what + " v"))
            check_metrics(met, met_ref, what)
            adam_err = max(adam_err, err)
            print(f"phase 9: {what:40s} max abs err {err:.3g}")
            if max_grad_norm == 1e-3:   # K3's stage 3 alone, from the twin's gradients
                clip_err, clip_ms[64, head], clip_plain_ms[64, head], clip_bound[64, head] = \
                    check_clip_adam(uk, data, order, w, m, v, stats, kw, what)
                clip_adam_err = max(clip_adam_err, clip_err)
            if head == "gaussian" and max_grad_norm == 1e-3:
                for compute in ("float32", "bfloat16"):
                    kw_c = dict(kw, compute=compute)
                    adam_ms[compute], _ = cuda_ms(lambda: uk.fused_minibatch_grad_adam(
                        data, order, w, m, v, stats, **kw_c), 20)
                    adam_plain_ms[compute], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_adam_reference(
                            data, order, w, m, v, stats, **kw_c), 5)
    for c in adam_ms:
        print(f"phase 9: K3 {c}: {adam_ms[c]:.3f} ms, twin {adam_plain_ms[c]:.3f} ms per "
              f"minibatch of {MB_TILES} x {TILE} samples (CUDA events); bound "
              f"{grad_bound[c][0]:.4f} ms by {grad_bound[c][1]} (share "
              f"{grad_bound[c][0] / adam_ms[c]:.3f}); {label}")
    print_clip_adam(9, 64, clip_ms, clip_plain_ms, clip_bound, clip_adam_err, label)
    del cases

    # --------------------------------------------------------------- 10
    forms = {"off": dict(fused="off"), "update": dict(fused="update"),
             "update+adam": dict(fused="update", fused_adam=True)}
    expect = {"off": {"grad": 0, "adam": 0}, "update": {"grad": 4 * 32, "adam": 0},
              "update+adam": {"grad": 0, "adam": 4 * 32}}
    train_launches = {}
    for name, kw in forms.items():
        reset_counts()
        res = measure_ppo_train(num_envs=B_PPO, num_steps=T_PPO, iters=3, warmup=1, **kw)
        got = counts()
        if ({k: got[k] for k in ("grad", "adam")} != expect[name] or got["rollout"]
                or got["policy"]):
            fail(f"train_step {name}: launches {got}, expected {expect[name]} "
                 "(32 per iteration over 1 warm-up + 3 timed iterations)")
        train_launches[name] = got
        print(f"phase 10: train_step {name:12s} {res['seconds'] / res['iters'] * 1e3:.1f} "
              f"ms/iter, {res['steps_per_s']:.4g} env-steps/s (host clock, 3 chained "
              f"iterations after 1 warm-up); launches {got}; B={B_PPO} T={T_PPO} 4x8 "
              f"hidden=64 {label}")
    env, params = make("fishing-v1", sigma=0.05)   # no device given: the card
    ts0 = ppo.make_train_state(env, ppo.PPOConfig(), torch.Generator().manual_seed(11))
    if params.device != dev or next(ts0.model.parameters()).device != dev:
        fail("make and make_train_state without a device did not land on the card")

    host_params = make("fishing-v1", sigma=0.05, device="cpu")[1]   # K4 reads them without a sync

    def run(cfg, iterations, seed=5):
        ts = ts0.clone()
        gen = torch.Generator(device=dev).manual_seed(seed)
        p = host_params if cfg.fused_rollout else params
        bstate = batched_reset(env, p, cfg.num_envs, dev)
        hist = []
        for _ in range(iterations):
            ts, bstate, met = ppo.train_step(env, p, cfg, ts, bstate, gen)
            hist.append({k: float(x) for k, x in met.items()})
        for name_, p in ts.model.named_parameters():
            if not bool(torch.isfinite(p).all()):
                fail(f"non-finite parameter {name_}")
        return ts, hist

    base = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, epochs=1, num_minibatches=1)
    one = {name: run(dataclasses.replace(base, fused_update=name != "off",
                                         fused_adam=name == "update+adam"), 1)[0]
           for name in forms}
    step_err = 0.0
    for name in ("update", "update+adam"):
        for (pname, p), q in zip(one[name].model.named_parameters(), one["off"].model.parameters()):
            p, q = p.detach(), q.detach()
            err = float((p - q).abs().max())
            bound = STEP_ATOL + STEP_RTOL * q.abs()
            if not bool(((p - q).abs() <= bound).all()):
                fail(f"one step at 1x1, {name} vs off: {pname} max abs err {err:.3g}")
            step_err = max(step_err, err)
    print(f"phase 10: fused ≡ plain after one step at 1 epoch x 1 minibatch, N={N_PPO}: "
          f"max abs param err {step_err:.3g} (rtol {STEP_RTOL}, atol {STEP_ATOL})")

    curves = {}
    for name in ("off", "update+adam"):
        cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=name != "off",
                            fused_adam=name != "off")
        t0 = time.perf_counter()
        _, hist = run(cfg, 20)
        rets = np.array([h["episode_return"] for h in hist])
        first, last = float(np.nanmean(rets[:5])), float(np.nanmean(rets[-5:]))
        if not last > first:
            fail(f"{name}: mean episode return did not rise ({first:.4f} -> {last:.4f})")
        curves[name] = (first, last)
        print(f"phase 10: agreement {name:12s} episode return first5 {first:.4f} -> last5 "
              f"{last:.4f} over 20 iterations ({time.perf_counter() - t0:.1f} s)")
    gap = abs(curves["off"][1] - curves["update+adam"][1])
    if not gap <= AGREE_TOL:
        fail(f"last-5 mean episode returns differ by {gap:.4f} > {AGREE_TOL}")
    print(f"phase 10: agreement gap {gap:.4f} <= {AGREE_TOL}")

    # --------------------------------------------------------------- 11
    rng = np.random.default_rng(11)
    k4_err, k4_flips = 0.0, 0
    k4_ms, k4_plain_ms, k4_clock, k4_part_ms = {}, {}, {}, {}
    t11 = time.perf_counter()
    for label_c, env_id, overrides in (
        ("continuous fishing-v1", "fishing-v1", dict(sigma=0.1)),
        ("relative fishing-v0", "fishing-v0", dict(sigma=0.1)),
        ("proportional n_actions=8", "fishing-v0", dict(sigma=0.1, n_actions=8)),
        ("obs noise fishing-may-obs-v1", "fishing-may-obs-v1", {}),
        ("mixture(allen)", "fishing-mixture-v1", dict(sigma=0.1, model_idx=3)),
    ):
        _, k_params, _, weights, state, planes, kw = k4_setup(gtt, ppo, ppo_fused, rng,
                                                              env_id, dev, **overrides)
        for fold in (False, True):
            for compute in ("float32", "bfloat16"):
                for source in ("planes", "seed"):
                    seed_off = (2026, 7) if source == "seed" else (0, 0)
                    scal = ppo_fused.rollout_scalars(k_params, *seed_off)
                    args = (*state, weights, scal, T_PPO)
                    kw_c = dict(kw, fold_obs=fold, compute=compute,
                                noise=planes if source == "planes" else None)
                    ker = pk.policy_rollout(*args, **kw_c)
                    ref = pk.policy_rollout_reference(*args, **kw_c)
                    torch.cuda.synchronize()
                    what = f"K4 {label_c} fold={fold} {compute} {source}"
                    err, flips = compare_k4(ker, ref, what, kw["scheme"] != "continuous",
                                            compute == "bfloat16")
                    k4_err, k4_flips = max(k4_err, err), k4_flips + flips
                    print(f"phase 11: {what:66s} max abs err {err:.3g}, envs left {flips}")
                    if env_id == "fishing-v1" and fold and source == "seed":
                        k4_ms[compute], _ = cuda_ms(lambda: pk.policy_rollout(*args, **kw_c),
                                                    20)
                        k4_clock[compute] = sm_clock_mhz()
                        k4_plain_ms[compute], _ = cuda_ms(
                            lambda: pk.policy_rollout_reference(*args, **kw_c), 2)
                        # the kernel that took 32 envs a CTA at two CTAs an SM ran
                        # 8448 envs as one full wave and 16384 as 1.94
                        part = tuple(x[:B_K4_PART] for x in state)
                        k4_part_ms[compute], _ = cuda_ms(lambda: pk.policy_rollout(
                            *part, weights, scal, T_PPO, **kw_c), 20)
    k4_bound = {c: rollout_bound(B_PPO, T_PPO, 1, 64, 1, c) for c in k4_ms}
    for c in k4_ms:
        print(f"phase 11: K4 {c}: {k4_ms[c]:.3f} ms (SM clock {k4_clock[c]} just after), twin "
              f"{k4_plain_ms[c]:.1f} ms per rollout of B={B_PPO} T={T_PPO} hidden=64 (CUDA "
              f"events, continuous, fold, from a seed); bound {k4_bound[c][0]:.4f} ms by "
              f"{k4_bound[c][1]} (share {k4_bound[c][0] / k4_ms[c]:.3f}); at B={B_K4_PART}: "
              f"{k4_part_ms[c]:.3f} ms {label}")
    print(f"phase 11: 40 cases in {time.perf_counter() - t11:.1f} s; {k4_flips} envs left "
          f"the twin's trajectory in all")

    # --------------------------------------------------------------- 12
    for env_id, fold in (("fishing-v1", True), ("fishing-may-obs-v1", False)):
        k_env, k_params, model, _, state, _, kw = k4_setup(gtt, ppo, ppo_fused, rng, env_id, dev)
        model = model.to(dev)
        cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, rollout_fold_obs=fold)
        bstate = BatchState(env=EnvState(stock=state[0], harvest=state[2], t=state[1]),
                            episode_return=state[3], episode_length=state[4])
        act = torch.from_numpy(rng.standard_normal((T_PPO, B_PPO, 1)).astype(np.float32)).to(dev)
        env_n = torch.from_numpy(rng.standard_normal((T_PPO, 2, B_PPO)).astype(np.float32)).to(dev)
        roll, _ = ppo_fused.fused_rollout_collect(
            k_env, k_params, cfg, ppo.TrainState(model=model, m={}, v={}), bstate,
            noise=ppo_fused.rollout_noise_from_draws(act, env_n, float(k_params.sigma_m),
                                                     kw["obs_noise"]))
        b2, _, traj, last = ppo.collect_rollout(k_env, k_params.astype(torch.float32, dev), cfg,
                                                model, bstate, act_noise=act, env_noise=env_n)
        adv, ret = ppo.compute_gae(cfg, traj, last)
        packed = ppo._pack(traj, adv, ret).T
        done = traj.done.float()
        plain = pk.PolicyRollout(
            torch.cat([packed, torch.zeros_like(packed[:2])]), b2.env.stock, b2.env.t,
            b2.env.harvest, b2.episode_return, b2.episode_length,
            torch.stack([done.sum(), (traj.episode_return * done).sum(),
                         (traj.episode_length.float() * done).sum(), traj.reward.sum()]),
            roll.next_offset)
        torch.cuda.synchronize()
        err, _ = compare_k4(roll, plain, f"K4 vs plain path {env_id} fold={fold}", False)
        k4_err = max(k4_err, err)
        print(f"phase 12: K4 ≡ collect_rollout + compute_gae + _pack, {env_id} fold={fold}: "
              f"max abs err {err:.3g}; B={B_PPO} T={T_PPO}")

    # --------------------------------------------------------------- 13
    forms13 = {"full": dict(fused="full"), "full+adam": dict(fused="full", fused_adam=True),
               "full+adam bfloat16": dict(fused="full", fused_adam=True,
                                          compute_dtype="bfloat16")}
    expect13 = {"full": {"grad": 4 * 32, "adam": 0, "policy": 4},
                "full+adam": {"grad": 0, "adam": 4 * 32, "policy": 4}}
    expect13["full+adam bfloat16"] = expect13["full+adam"]
    for name, kw in forms13.items():
        reset_counts()
        res = measure_ppo_train(num_envs=B_PPO, num_steps=T_PPO, iters=3, warmup=1, **kw)
        got = counts()
        if {k: got[k] for k in ("grad", "adam", "policy")} != expect13[name] or got["rollout"]:
            fail(f"train_step {name}: launches {got}, expected {expect13[name]} (one K4 and "
                 "32 update launches per iteration over 1 warm-up + 3 timed iterations)")
        train_launches[name] = got
        print(f"phase 13: train_step {name:18s} {res['seconds'] / res['iters'] * 1e3:.1f} "
              f"ms/iter, {res['steps_per_s']:.4g} env-steps/s (host clock, 3 chained "
              f"iterations after 1 warm-up); launches {got}; rollout flags "
              f"{res['rollout_flags']}; compute {res['compute_dtype']}; B={B_PPO} T={T_PPO} "
              f"4x8 hidden=64 {label}")
    # full + fused_adam ≡ update + fused_adam after one step, the same planes
    act = torch.from_numpy(rng.standard_normal((T_PPO, B_PPO, 1)).astype(np.float32)).to(dev)
    env_n = torch.from_numpy(rng.standard_normal((T_PPO, 2, B_PPO)).astype(np.float32)).to(dev)
    perms = [torch.from_numpy(rng.permutation(N_PPO // TILE).astype(np.int32)).to(dev)]
    for compute in ("float32", "bfloat16"):
        one_cfg = dataclasses.replace(base, fused_update=True, fused_adam=True,
                                      compute_dtype=compute)
        upd, _, _ = ppo.train_step(env, params, one_cfg, ts0.clone(),
                                   batched_reset(env, params, B_PPO), perms=perms,
                                   act_noise=act, env_noise=env_n)
        full, _, _ = ppo.train_step(
            env, host_params, dataclasses.replace(one_cfg, fused_rollout=True), ts0.clone(),
            batched_reset(env, host_params, B_PPO, dev), perms=perms,
            rollout_noise=ppo_fused.rollout_noise_from_draws(act, env_n, 0.0, False))
        full_err, dist, count = 0.0, 0.0, 0
        for (pname, p), q, p0 in zip(full.model.named_parameters(), upd.model.parameters(),
                                     ts0.model.parameters()):
            # the steps the two forms took from the same weights
            diff = ((p.detach() - p0.detach()) - (q.detach() - p0.detach())).abs()
            err = float(diff.max())
            bound = (STEP_BF16_ATOL if compute == "bfloat16"
                     else STEP_ATOL + STEP_RTOL * q.detach().abs())
            if not bool((diff <= bound).all()):
                fail(f"one step at 1x1 under {compute}, full+adam vs update+adam: {pname} max "
                     f"abs err {err:.3g}")
            full_err, dist, count = max(full_err, err), dist + float(diff.sum()), count + p.numel()
        if compute == "bfloat16" and not dist / count <= STEP_BF16_MEAN_ATOL:
            fail(f"one step at 1x1 under bfloat16, full+adam vs update+adam: mean abs err of "
                 f"the step {dist / count:.3g} > {STEP_BF16_MEAN_ATOL}")
        bar = (f"atol {STEP_BF16_ATOL}, mean {dist / count:.3g} <= {STEP_BF16_MEAN_ATOL}"
               if compute == "bfloat16" else f"rtol {STEP_RTOL}, atol {STEP_ATOL}")
        print(f"phase 13: full+adam ≡ update+adam after one step at 1 epoch x 1 minibatch from "
              f"the same planes under {compute}, N={N_PPO}: max abs err of the step "
              f"{full_err:.3g} ({bar})")
    for compute in ("float32", "bfloat16"):
        name = f"full+adam {compute}"
        cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=True, fused_adam=True,
                            fused_rollout=True, compute_dtype=compute)
        t0 = time.perf_counter()
        _, hist = run(cfg, 20)
        rets = np.array([h["episode_return"] for h in hist])
        first, last = float(np.nanmean(rets[:5])), float(np.nanmean(rets[-5:]))
        if not last > first:
            fail(f"{name}: mean episode return did not rise ({first:.4f} -> {last:.4f})")
        print(f"phase 13: agreement {name:18s} episode return first5 {first:.4f} -> last5 "
              f"{last:.4f} over 20 iterations ({time.perf_counter() - t0:.1f} s)")
        gap = abs(curves["off"][1] - last)
        if not gap <= AGREE_TOL:
            fail(f"last-5 mean episode returns of off (float32) and {name} differ by "
                 f"{gap:.4f} > {AGREE_TOL}")
        print(f"phase 13: agreement gap off (float32) vs {name} {gap:.4f} <= {AGREE_TOL}")

    # --------------------------------------------------------------- 14
    # K2/K3 at 16 packed rows: obs windows of 4, so 4 + 1 + 4 = 9 fields
    rng = np.random.default_rng(14)
    cases16 = {head: ppo_case(ppo, ppo_fused, rng, head, dev, obs_dim=4)
               for head in ("gaussian", "categorical")}
    grad16_err = adam16_err = 0.0
    grad16_ms, grad16_plain_ms, adam16_ms, adam16_plain_ms = {}, {}, {}, {}
    for head, (weights, data, a) in cases16.items():
        if data.shape[0] != 16:
            fail(f"phase 14: {head} data has {data.shape[0]} rows, not 16")
        adv = data[4 + 1 + 2, order.long()[:, None] * TILE + torch.arange(TILE, device=dev)]
        stats = torch.stack([adv.mean(), 1.0 / (adv.std(correction=0) + 1e-8)])
        w = weights
        m = tuple(torch.from_numpy(0.01 * rng.standard_normal(x.shape).astype(np.float32))
                  .to(dev) for x in w)
        v = tuple(torch.from_numpy(1e-4 * rng.random(x.shape).astype(np.float32)).to(dev)
                  for x in w)
        for ent_coef in (0.0, 0.01):
            for compute in ("float32", "bfloat16"):
                kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=ent_coef, obs_dim=4, act_dim=a,
                          tile=TILE, head=head, compute=compute)
                g, met = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
                g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights,
                                                                    stats, **kw)
                torch.cuda.synchronize()
                what = f"K2 16 rows {head} ent_coef={ent_coef} {compute}"
                err = check_buffers(towers(uk, g), towers(uk, g_ref), what)
                check_metrics(met, met_ref, what)
                grad16_err = max(grad16_err, err)
                line = f"phase 14: {what:48s} max abs err {err:.3g}"
                if compute == "float32":
                    worst64 = check_float64_bar(uk, g, g_ref, data, order, weights, stats, kw,
                                                what)
                    line += (f"; against float64, worst buffer {worst64[0]}: kernel "
                             f"{worst64[1]:.3g}, float32 twin {worst64[2]:.3g}")
                print(line)
                kw3 = dict(kw, lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5,
                           max_grad_norm=1e-3)
                *new, met3 = uk.fused_minibatch_grad_adam(data, order, w, m, v, stats, **kw3)
                *ref, met3_ref = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v,
                                                                       stats, **kw3)
                torch.cuda.synchronize()
                what = f"K3 16 rows {head} ent_coef={ent_coef} {compute}"
                err = max(check_buffers([x - y for x, y in zip(new[0], w)],
                                        [x - y for x, y in zip(ref[0], w)], what + " dw"),
                          check_buffers(new[1], ref[1], what + " m"),
                          check_buffers(new[2], ref[2], what + " v"))
                check_metrics(met3, met3_ref, what)
                adam16_err = max(adam16_err, err)
                print(f"phase 14: {what:48s} max abs err {err:.3g}")
                if head == "gaussian" and ent_coef == 0.0:   # phase 8's K2 settings
                    grad16_ms[compute], _ = cuda_ms(lambda: uk.fused_minibatch_grad(
                        data, order, weights, stats, **kw), 20)
                    grad16_plain_ms[compute], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_reference(data, order, weights, stats,
                                                                  **kw), 5)
                if head == "gaussian" and ent_coef == 0.01:  # phase 9's K3 settings
                    adam16_ms[compute], _ = cuda_ms(lambda: uk.fused_minibatch_grad_adam(
                        data, order, w, m, v, stats, **kw3), 20)
                    adam16_plain_ms[compute], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_adam_reference(
                            data, order, w, m, v, stats, **kw3), 5)
    del cases16
    grad16_bound = {c: update_bound(n_mb, 4, 64, 1, c) for c in grad16_ms}
    for c in grad16_ms:
        for name, ms16, ms8, plain in (("K2", grad16_ms[c], grad_ms[c], grad16_plain_ms[c]),
                                       ("K3", adam16_ms[c], adam_ms[c], adam16_plain_ms[c])):
            print(f"phase 14: {name} {c} at 16 rows: {ms16:.3f} ms, twin {plain:.3f} ms per "
                  f"minibatch of {MB_TILES} x {TILE} samples (CUDA events); at 8 rows "
                  f"(phases 8-9) {ms8:.3f} ms, ratio {ms16 / ms8:.3f}; bound "
                  f"{grad16_bound[c][0]:.4f} ms by {grad16_bound[c][1]} (share "
                  f"{grad16_bound[c][0] / ms16:.3f}); obs_dim=4 hidden=64 {label}")

    # --------------------------------------------------------------- 15
    # the POMDP remedy on the main path: update+adam on a window of 4
    from gym_fishing_tpu_torch.envs.wrappers import stack_observations

    s_env0, s_params = make("fishing-may-obs-v1")
    s_env = stack_observations(s_env0, 4)

    def s_init(compute="float32", seed=12):
        return ppo.make_train_state(s_env, ppo.PPOConfig(compute_dtype=compute),
                                    torch.Generator().manual_seed(seed))

    def s_run(cfg, iterations, ts, seed=5):
        gen = torch.Generator(device=dev).manual_seed(seed)
        bstate = batched_reset(s_env, s_params, cfg.num_envs)
        hist = []
        t0 = time.perf_counter()
        for _ in range(iterations):
            ts, bstate, met = ppo.train_step(s_env, s_params, cfg, ts, bstate, gen)
            hist.append({k: float(x) for k, x in met.items()})
        secs = time.perf_counter() - t0
        for name_, p in ts.model.named_parameters():
            if not bool(torch.isfinite(p).all()):
                fail(f"phase 15: non-finite parameter {name_}")
        return ts, hist, secs

    s_one = {}
    for compute in ("float32", "bfloat16"):
        one_cfg = dataclasses.replace(base, compute_dtype=compute)
        plain, _, _ = s_run(one_cfg, 1, s_init(compute))
        fused, _, _ = s_run(dataclasses.replace(one_cfg, fused_update=True, fused_adam=True), 1,
                            s_init(compute))
        s_one[compute] = fused
        if compute == "float32":   # phase 10's bars on the parameters
            s_err = 0.0
            for (pname, p), q in zip(fused.model.named_parameters(), plain.model.parameters()):
                p, q = p.detach(), q.detach()
                s_err = max(s_err, float((p - q).abs().max()))
                if not bool(((p - q).abs() <= STEP_ATOL + STEP_RTOL * q.abs()).all()):
                    fail(f"phase 15: one step at 1x1 under float32, update+adam vs off: {pname} "
                         f"max abs err {float((p - q).abs().max()):.3g}")
            what = f"max abs param err {s_err:.3g} (rtol {STEP_RTOL}, atol {STEP_ATOL})"
        else:   # the gradients, through Adam's first moment
            rel = {k: float((fused.m[k] - plain.m[k]).norm() / plain.m[k].norm())
                   for k in plain.m}
            name_ = max(rel, key=rel.get)
            if not rel[name_] <= GRAD_BF16_RTOL:
                fail(f"phase 15: one step at 1x1 under bfloat16, update+adam vs off: the first "
                     f"moment of {name_} differs by {rel[name_]:.3g} of its norm")
            what = (f"first moment (the gradient) within {rel[name_]:.3g} of its norm in the "
                    f"worst tensor, {name_} (bar {GRAD_BF16_RTOL:.4g})")
        print(f"phase 15: stacked fishing-may-obs-v1 (k=4): update+adam ≡ off after one step at "
              f"1 x 1 from the same draws under {compute}, N={N_PPO}: {what}")
    s_curves, launches15, s_ms = {}, {}, {}
    for name, iters in (("off", 20), ("update", 4), ("update+adam", 20)):
        cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=name != "off",
                            fused_adam=name == "update+adam")
        reset_counts()
        _, hist, secs = s_run(cfg, iters, s_init())
        launches15[name] = counts()
        want = {"off": (0, 0), "update": (32 * iters, 0), "update+adam": (0, 32 * iters)}[name]
        got = launches15[name]
        if (got["grad"], got["adam"]) != want or got["rollout"] or got["policy"]:
            fail(f"phase 15: {name} on the stacked env launched {got}, expected (grad, adam) "
                 f"{want}")
        rets = np.array([h["episode_return"] for h in hist])
        s_curves[name] = (float(np.nanmean(rets[:5])), float(np.nanmean(rets[-5:])))
        s_ms[name] = secs / iters * 1e3
        print(f"phase 15: stacked {name:12s} {s_ms[name]:.1f} ms/iter (host clock, {iters} "
              f"iterations, a metric read after each); launches {got}; episode return first5 "
              f"{s_curves[name][0]:.4f} -> last5 {s_curves[name][1]:.4f}; B={B_PPO} "
              f"T={T_PPO} 4x8 hidden=64 {label}")
    gap = abs(s_curves["off"][1] - s_curves["update+adam"][1])
    if not gap <= AGREE_TOL:
        fail(f"phase 15: stacked last-5 mean episode returns differ by {gap:.4f} > {AGREE_TOL}")
    print(f"phase 15: agreement gap off vs update+adam on the stacked env {gap:.4f} <= "
          f"{AGREE_TOL}")

    # --------------------------------------------------------------- 16
    # resume: saved after 2 iterations and restored into fresh state and
    # generators, a run continues bit for bit as the run that never stopped
    import tempfile

    from gym_fishing_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    full_cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=True,
                             fused_rollout=True, fused_adam=True)
    stacked_cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=True,
                                fused_adam=True)
    for what, r_env, r_params, r_cfg in (
            ("full+adam fishing-v1", env, host_params, full_cfg),
            ("update+adam stacked fishing-may-obs-v1", s_env, s_params, stacked_cfg)):
        def fresh(seed):
            return {"train_state": ppo.make_train_state(r_env, r_cfg,
                                                        torch.Generator().manual_seed(seed)),
                    "batch": batched_reset(r_env, r_params, r_cfg.num_envs, dev),
                    "generator": torch.Generator(device=dev).manual_seed(seed + 1)}

        def iterate(tup, n):
            ts, bs, gen = tup["train_state"], tup["batch"], tup["generator"]
            mets = []
            for _ in range(n):
                ts, bs, met = ppo.train_step(r_env, r_params, r_cfg, ts, bs, gen)
                mets.append([float(x) for x in met.values()])
            return dict(tup, train_state=ts, batch=bs), np.array(mets)

        tup, _ = iterate(fresh(0), 2)
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fname = save_checkpoint(tmp, tup, step=2)
            save_s, nbytes = time.perf_counter() - t0, os.path.getsize(fname)
            straight, mets = iterate(tup, 2)
            blank = fresh(9)
            t0 = time.perf_counter()
            restored, _ = restore_checkpoint(tmp, blank)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        resumed, mets_r = iterate(restored, 2)
        a, b = resume_leaves(straight), resume_leaves(resumed)
        bad = [k for k in a if a[k].dtype != b[k].dtype or not torch.equal(a[k], b[k])]
        if bad or not np.array_equal(mets, mets_r, equal_nan=True):
            fail(f"phase 16: {what}: resumed run differs from the straight run in {bad[:6]} "
                 f"(metrics equal: {np.array_equal(mets, mets_r, equal_nan=True)})")
        print(f"phase 16: resume {what}: {len(a)} tensors (weights, m, v, count, step, "
              f"batch state, generator) and {mets.size} metrics bit-identical after 2 + 2 "
              f"iterations; save {nbytes} bytes in {save_s * 1e3:.1f} ms, restore "
              f"{restore_s * 1e3:.1f} ms (host clock); B={B_PPO} T={T_PPO}")

    # --------------------------------------------------------------- 17
    # evaluation: simulate_mdp's device path against its host .predict loop
    from gym_fishing_tpu_torch.analysis import simulate as sim

    e_env, e_params = make("fishing-v1")
    e_reps, e_T, e_host = 1 << 16, 100, 1024
    e_noise = torch.randn((e_T, 2, e_reps), generator=torch.Generator(device=dev).manual_seed(17),
                          device=dev)

    class HostOnly:
        """`.predict` only: simulate_mdp's host loop."""

        def __init__(self, model):
            self.model = model

        def predict(self, obs, state=None, **kw):
            return self.model.predict(obs, state)

    pols = {"escapement": (e_env, escapement(e_env, e_params)),
            "PPO after phase 15's first step": (stack_observations(e_env, 4),
                                                ppo.PPOPolicy(s_env, s_one["float32"]))}
    for what, (p_env, pol) in pols.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs_d, act_d, rew_d = sim._simulate_steps(p_env, pol, e_reps, e_params, e_T, e_noise)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        obs_h, act_h, rew_h = sim._simulate_host_steps(
            p_env, HostOnly(pol), e_host, e_params, e_T, e_noise[:, :, :e_host].contiguous())
        host_s = time.perf_counter() - t0
        errs = [max_err(x[:, :e_host].cpu(), y) for x, y in
                ((obs_d, obs_h), (act_d, act_h), (rew_d, rew_h))]
        if not (max(errs) <= 1e-6 and bool(torch.isfinite(rew_d).all())):
            fail(f"phase 17: {what}: device path vs host loop on the first {e_host} reps: "
                 f"(obs, action, reward) max abs err {errs}")
        ret = float(rew_d.sum(0).mean())
        print(f"phase 17: simulate {what}: device path {dev_s * 1e3:.1f} ms for {e_reps} reps x "
              f"{e_T} steps (host clock), host .predict loop {host_s * 1e3:.1f} ms for "
              f"{e_host} reps; max abs err on those reps {max(errs):.3g}; mean return "
              f"{ret:.4f} {label}")
    stocks, grid = sim._policy_grid(e_env, pols["escapement"][1], 1, 50, e_params)
    x_star = float(pols["escapement"][1].x_star)
    K = float(e_params.K)
    want = np.clip(np.maximum(stocks - x_star, 0.0) / K - 1.0, -1.0, 1.0)
    if len(stocks) != 50 or not np.allclose(grid[0], want, atol=1e-6):
        fail(f"phase 17: the escapement policy function differs from its rule by "
             f"{np.abs(grid[0] - want).max():.3g}")
    _, ppo_grid = sim._policy_grid(stack_observations(e_env, 4), ppo.PPOPolicy(
        s_env, s_one["float32"]), 1, 50, e_params)
    print(f"phase 17: estimate_policyfn's grid, n=50: escapement equals its rule (x*={x_star:.4f}); "
          f"PPO actions in [{ppo_grid[0].min():.3f}, {ppo_grid[0].max():.3f}]")

    # --------------------------------------------------------------- 18
    # model uncertainty at the example's ranges, then the gym adapters
    from gym_fishing_tpu_torch.batch import batched_step
    from gym_fishing_tpu_torch.batch import randomized as rnd
    from gym_fishing_tpu_torch.core.types import GROWTH_MODELS
    from gym_fishing_tpu_torch.envs import FishingVectorEnv, GymFishingEnv

    m_env, m_params = make("fishing-mixture-v1")
    ranges = {"model_idx": (0, len(GROWTH_MODELS) - 1), "r": (0.2, 1.0), "K": (0.7, 1.3),
              "sigma": (0.0, 0.1)}
    m_pol = escapement(m_env, m_params)
    m_policy = lambda obs, g: m_pol.act(obs)  # noqa: E731
    B18, T18 = 1 << 18, 128
    gen18 = torch.Generator(device=dev).manual_seed(18)
    sampler = rnd.make_param_sampler(m_params, ranges)
    m_state, bp = rnd.randomized_reset(m_env, sampler, B18, gen18)

    def check_draws(bp, what):
        """Every field within its range; the growth-model shares of the
        params in use (after a rollout they favour the models whose
        episodes last longest, so only fresh draws are held to uniform)."""
        share = torch.bincount(bp.model_idx.long(), minlength=len(GROWTH_MODELS)).double() / B18
        sd = math.sqrt((1 / 6) * (5 / 6) / B18)
        if what == "reset" and not bool(((share - 1 / 6).abs() <= 5 * sd).all()):
            fail(f"phase 18: {what}: growth-model shares {share.tolist()}")
        for name, (lo, hi) in ranges.items():
            x = getattr(bp, name).double()
            if not bool(((x >= lo) & (x <= hi)).all()):
                fail(f"phase 18: {what}: {name} outside [{lo}, {hi}]")
        return share

    share0 = check_draws(bp, "reset")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_state, bp, traj = rnd.randomized_rollout(m_env, sampler, m_policy, m_state, bp, gen18,
                                               T18)
    torch.cuda.synchronize()
    m_s = time.perf_counter() - t0
    share_end = check_draws(bp, "after the rollout")
    traj_bytes = sum(x.numel() * x.element_size() for x in vars(traj).values())
    n_eps = int(traj.done.sum())
    if not bool(torch.isfinite(traj.reward).all()) or n_eps < B18:
        fail(f"phase 18: randomized rollout: {n_eps} episodes ended, finite rewards "
             f"{bool(torch.isfinite(traj.reward).all())}")
    print(f"phase 18: randomized_rollout fishing-mixture-v1 B={B18} T={T18}: {m_s * 1e3:.1f} ms "
          f"(host clock), {traj_bytes / 1e9:.3f} GB of trajectory, {n_eps} episodes resampled; "
          f"model shares drawn at reset {[round(x, 4) for x in share0.tolist()]}, in use at "
          f"the end {[round(x, 4) for x in share_end.tolist()]} {label}")
    del traj
    degenerate = rnd.make_param_sampler(
        m_params, {k: (float(getattr(m_params, k)),) * 2 for k in ranges})
    r_state, dbp = rnd.randomized_reset(m_env, degenerate, B18, gen18)
    b_state = batched_reset(m_env, m_params, B18)
    noise_gen = torch.Generator(device=dev).manual_seed(19)
    obs = m_env.get_obs(m_params, b_state.env)
    n_diff = torch.zeros((), dtype=torch.int64, device=dev)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(T18):
        acts = m_pol.act(obs)
        noise = torch.randn((2, B18), generator=noise_gen, device=dev)
        r_state, dbp, r_out = rnd.randomized_step(m_env, degenerate, dbp, r_state, acts, noise,
                                                  gen18)
        b_state, b_out = batched_step(m_env, m_params, b_state, acts, noise)
        for f in ("obs", "reward", "done", "collapsed", "quota", "harvest", "episode_return",
                  "episode_length"):
            n_diff += (getattr(r_out, f) != getattr(b_out, f)).sum()
        n_done += b_out.done.sum()
        obs = b_out.obs
    if int(n_diff) or int(n_done) < B18:
        fail(f"phase 18: degenerate ranges vs batched_step: {int(n_diff)} values differ, "
             f"{int(n_done)} episodes ended")
    print(f"phase 18: degenerate ranges ≡ batched_step from the same noise over {T18} steps of "
          f"{B18} envs: every value equal, {int(n_done)} episodes ended")
    venv = FishingVectorEnv("fishing-v1", num_envs=B_PPO)
    v_obs, _ = venv.reset(seed=3)
    v_pol = escapement(venv.env, venv.params)
    n_term = n_trunc = 0
    t0 = time.perf_counter()
    for _ in range(200):
        action, _ = v_pol.predict(v_obs)
        v_obs, v_rew, term, trunc, infos = venv.step(action)
        n_term, n_trunc = n_term + int(term.sum()), n_trunc + int(trunc.sum())
        if trunc.any() and not (infos["episode_length"][trunc] == venv.Tmax).all():
            fail("phase 18: FishingVectorEnv truncated an episode before Tmax")
    v_s = time.perf_counter() - t0
    if n_term + n_trunc < 2 * B_PPO * 0.99 or not np.isfinite(v_rew).all():
        fail(f"phase 18: FishingVectorEnv: {n_term} terminated, {n_trunc} truncated in 200 "
             f"steps of {B_PPO} envs")
    g_env = GymFishingEnv("fishing-v1")
    g_pol = escapement(g_env.env, g_env.params)
    g_obs, done, g_ret, t0 = g_env.reset(), False, 0.0, time.perf_counter()
    while not done:
        g_obs, g_r, done, _ = g_env.step(g_pol.predict(g_obs[None])[0][0])
        g_ret += g_r
    g_s = time.perf_counter() - t0
    if g_env.years_passed != g_env.Tmax and g_env.fish_population > 0:
        fail(f"phase 18: GymFishingEnv's episode ended at t={g_env.years_passed}")
    print(f"phase 18: FishingVectorEnv {B_PPO} envs x 200 steps in {v_s * 1e3:.1f} ms "
          f"({n_term} terminated, {n_trunc} truncated; spaces: "
          f"{hasattr(venv, 'single_action_space')}); GymFishingEnv one episode of "
          f"{g_env.years_passed} steps in {g_s * 1e3:.1f} ms, return {g_ret:.4f} (host clock)")

    # --------------------------------------------------------------- 19
    # the wide path: K2/K3 and K4 at hidden 128 and 256 and at 100 classes,
    # the two full-width full+adam paths, then the RNG validation
    t19 = time.perf_counter()
    rng = np.random.default_rng(19)
    wide_err = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    wide_flips, wide_ms, wide_plain_ms, wide_bound = 0, {}, {}, {}
    wide_part_ms, split_err, split_rel = {}, 0.0, 0.0
    for hidden in WIDE_HIDDEN:
        for head in ("gaussian", "categorical"):
            weights, data, a = ppo_case(ppo, ppo_fused, rng, head, dev, hidden=hidden,
                                        n_actions=WIDE_ACTIONS)
            adv = data[4, order.long()[:, None] * TILE + torch.arange(TILE, device=dev)]
            stats = torch.stack([adv.mean(), 1.0 / (adv.std(correction=0) + 1e-8)])
            w = weights
            m = tuple(torch.from_numpy(0.01 * rng.standard_normal(x.shape).astype(np.float32))
                      .to(dev) for x in w)
            v = tuple(torch.from_numpy(1e-4 * rng.random(x.shape).astype(np.float32)).to(dev)
                      for x in w)
            for compute in ("float32", "bfloat16"):
                kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a,
                          tile=TILE, head=head, compute=compute)
                kw3 = dict(kw, lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5, max_grad_norm=1e-3)
                g, met = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
                g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights, stats,
                                                                    **kw)
                *new, met3 = uk.fused_minibatch_grad_adam(data, order, w, m, v, stats, **kw3)
                *ref, met3_ref = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v,
                                                                       stats, **kw3)
                torch.cuda.synchronize()
                what = f"hidden={hidden} {head} A={a} {compute}"
                err = check_buffers(towers(uk, g), towers(uk, g_ref), "K2 " + what)
                check_metrics(met, met_ref, "K2 " + what)
                err3 = max(check_buffers([x - y for x, y in zip(new[0], w)],
                                         [x - y for x, y in zip(ref[0], w)], "K3 " + what + " dw"),
                           check_buffers(new[1], ref[1], "K3 " + what + " m"),
                           check_buffers(new[2], ref[2], "K3 " + what + " v"))
                check_metrics(met3, met3_ref, "K3 " + what)
                wide_err["K2"], wide_err["K3"] = max(wide_err["K2"], err), max(wide_err["K3"], err3)
                if compute == "float32":   # K3's stage 3 alone: it has no compute mode
                    clip_err, clip_ms[hidden, head], clip_plain_ms[hidden, head], \
                        clip_bound[hidden, head] = check_clip_adam(uk, data, order, w, m, v,
                                                                   stats, kw3, "K3 " + what)
                    clip_adam_err = max(clip_adam_err, clip_err)
                line = f"phase 19: K2/K3 {what:38s} max abs err {err:.3g} / {err3:.3g}"
                if compute == "float32":
                    worst64 = check_float64_bar(uk, g, g_ref, data, order, weights, stats, kw,
                                                "K2 " + what)
                    line += (f"; against float64, worst buffer {worst64[0]}: kernel "
                             f"{worst64[1]:.3g}, float32 twin {worst64[2]:.3g}")
                print(line)
                key = (hidden, head, compute)
                wide_ms["K2", key], _ = cuda_ms(lambda: uk.fused_minibatch_grad(
                    data, order, weights, stats, **kw), 10)
                wide_plain_ms["K2", key], _ = cuda_ms(lambda: uk.fused_minibatch_grad_reference(
                    data, order, weights, stats, **kw), 3)
                wide_ms["K3", key], _ = cuda_ms(lambda: uk.fused_minibatch_grad_adam(
                    data, order, w, m, v, stats, **kw3), 10)
                wide_plain_ms["K3", key], _ = cuda_ms(
                    lambda: uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, stats,
                                                                   **kw3), 3)
                wide_bound["K2", key] = wide_bound["K3", key] = update_bound(
                    n_mb, 1, hidden, a, compute, head)
                # the wide path's two launches apart: stage 1 (wide_prep and
                # ppo_grad_wide or ppo_grad_tower), then dw2c_split from its
                # scratch, held against its plain version range by range
                act, ws1 = uk.wide_stage1(data, order, w, stats, **kw)
                split = dict(hidden=hidden, obs_dim=1, act_dim=a, num_tiles=MB_TILES, tile=TILE,
                             head=head, compute=compute)
                ws2 = uk.dw2c_split(act, torch.zeros_like(ws1), **split)
                part = uk.dw2c_split_reference(*act.float().view(2, n_mb, 2 * hidden), hidden,
                                               MB_TILES, TILE)
                torch.cuda.synchronize()
                err_s, rel_s = check_split(ws2, part, hidden, compute, "dw2c_split " + what)
                split_err, split_rel = max(split_err, err_s), max(split_rel, rel_s)
                wide_part_ms["stage1", key], _ = cuda_ms(
                    lambda: uk.wide_stage1(data, order, w, stats, **kw), 10)
                wide_part_ms["split", key], _ = cuda_ms(lambda: uk.dw2c_split(act, ws1, **split),
                                                        10)
                wide_plain_ms["split", key], _ = cuda_ms(
                    lambda: uk.dw2c_split_reference(*act.float().view(2, n_mb, 2 * hidden),
                                                    hidden, MB_TILES, TILE), 3)
                wide_bound["split", key] = split_bound(n_mb, MB_TILES, hidden, compute)
                del act, ws1, ws2, part
            del weights, data, w, m, v, g, g_ref, new, ref
    # one PyTorch call per product computes none of K2; its three
    # H-contractions per tower alone, on the same [N, H] x [H, H] operands per
    # tower that the kernel and its bound take (W2c's cross-tower blocks are
    # zero), two towers; and for dw2c_split one batched product over the
    # towers, the whole minibatch in one sum
    wide_lib_ms = {}
    for hidden in WIDE_HIDDEN:
        xa = torch.from_numpy(rng.standard_normal((2, n_mb, hidden)).astype(np.float32)).to(dev)
        xb = torch.from_numpy(rng.standard_normal((2, n_mb, hidden)).astype(np.float32)).to(dev)
        wm = torch.from_numpy(rng.standard_normal((2, hidden, hidden)).astype(np.float32)).to(dev)
        for compute, ty in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            a_, b_, w_ = xa.to(ty), xb.to(ty), wm.to(ty)
            three = lambda: [(a_[t] @ w_[t], a_[t].T @ b_[t], b_[t] @ w_[t].T)  # noqa: E731
                             for t in range(2)]
            one = lambda: torch.bmm(a_.transpose(1, 2), b_)  # noqa: E731
            three()
            one()
            wide_lib_ms["three", hidden, compute], _ = cuda_ms(three, 10)
            wide_lib_ms["split", hidden, compute], _ = cuda_ms(one, 10)
        del xa, xb, wm, a_, b_, w_
    for name in ("K2", "K3"):
        for (kname, (hidden, head, compute)), ms in wide_ms.items():
            if kname != name:
                continue
            key = (hidden, head, compute)
            bound = wide_bound[name, key]
            print(f"phase 19: {name} hidden={hidden} {head:11s} {compute:8s}: {ms:.3f} ms, twin "
                  f"{wide_plain_ms[name, key]:.3f} ms per minibatch of {MB_TILES} x {TILE} (CUDA "
                  f"events); bound {bound[0]:.4f} ms by {bound[1]} (share {bound[0] / ms:.3f}); "
                  f"library (the three products per tower, torch.matmul) "
                  f"{wide_lib_ms['three', hidden, compute]:.3f} ms {label}")
    for (hidden, head, compute), ms in ((k[1], v) for k, v in wide_part_ms.items()
                                        if k[0] == "stage1"):
        key = (hidden, head, compute)
        sp, bound = wide_part_ms["split", key], wide_bound["split", key]
        n_par = sum(r * c for r, c in uk.merged_shapes(
            1, hidden, WIDE_ACTIONS if head == "categorical" else 1))
        print(f"phase 19: wide K2 hidden={hidden} {head:11s} {compute:8s} in parts: stage 1 "
              f"{ms:.3f} ms + dw2c_split {sp:.3f} ms = {ms + sp:.3f} ms (whole K2 "
              f"{wide_ms['K2', key]:.3f}, so reduce_rows {wide_ms['K2', key] - ms - sp:.3f} ms "
              f"against its bound by bytes {reduce_bound(2 * MB_TILES, n_par):.4f} ms); "
              f"dw2c_split's plain version "
              f"{wide_plain_ms['split', key]:.3f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
              f"(share {bound[0] / sp:.3f}), library (torch.bmm over the towers) "
              f"{wide_lib_ms['split', hidden, compute]:.3f} ms {label}")
    for hidden in WIDE_HIDDEN:
        print_clip_adam(19, hidden, clip_ms, clip_plain_ms, clip_bound, clip_adam_err, label)
    print(f"phase 19: dw2c_split ≡ its plain version at hidden {WIDE_HIDDEN}, Gaussian and "
          f"{WIDE_ACTIONS} classes, float32 and bfloat16: max abs err {split_err:.3g}, worst "
          f"error {split_rel:.3g} of its range's largest entry (bars {SPLIT_RTOL})")

    wide_k4_envs = (("continuous fishing-v1", "fishing-v1", dict(sigma=0.1)),
                    (f"proportional n_actions={WIDE_ACTIONS}", "fishing-v0",
                     dict(sigma=0.1, n_actions=WIDE_ACTIONS)))
    for hidden in WIDE_HIDDEN:
        for label_c, env_id, overrides in wide_k4_envs:
            _, k_params, _, weights, state, planes, kw = k4_setup(
                gtt, ppo, ppo_fused, rng, env_id, dev, hidden=hidden, **overrides)
            categorical = kw["scheme"] != "continuous"
            for compute in ("float32", "bfloat16"):
                for fold, source in ((False, "planes"), (True, "planes"), (True, "seed")):
                    seed_off = (2026, 7) if source == "seed" else (0, 0)
                    scal = ppo_fused.rollout_scalars(k_params, *seed_off)
                    args = (*state, weights, scal, T_PPO)
                    kw_c = dict(kw, fold_obs=fold, compute=compute,
                                noise=planes if source == "planes" else None)
                    ker = pk.policy_rollout(*args, **kw_c)
                    ref = pk.policy_rollout_reference(*args, **kw_c)
                    torch.cuda.synchronize()
                    what = f"K4 hidden={hidden} {label_c} fold={fold} {compute} {source}"
                    err, flips = compare_k4(ker, ref, what, categorical, compute == "bfloat16")
                    wide_err["K4"], wide_flips = max(wide_err["K4"], err), wide_flips + flips
                    print(f"phase 19: {what:70s} max abs err {err:.3g}, envs left {flips}")
                    if source == "seed":
                        key = (hidden, env_id, compute)
                        wide_ms["K4", key], _ = cuda_ms(lambda: pk.policy_rollout(*args, **kw_c), 5)
                        wide_plain_ms["K4", key], _ = cuda_ms(
                            lambda: pk.policy_rollout_reference(*args, **kw_c), 1)
                        wide_bound["K4", key] = rollout_bound(
                            B_PPO, T_PPO, 1, hidden, WIDE_ACTIONS if categorical else 1, compute,
                            categorical)
                        bound = wide_bound["K4", key]
                        print(f"phase 19: K4 hidden={hidden} {label_c} {compute}: "
                              f"{wide_ms['K4', key]:.3f} ms, twin {wide_plain_ms['K4', key]:.1f} "
                              f"ms per rollout of B={B_PPO} T={T_PPO} (CUDA events, fold, from a "
                              f"seed); bound {bound[0]:.4f} ms by {bound[1]} (share "
                              f"{bound[0] / wide_ms['K4', key]:.3f}) {label}")
    print(f"phase 19: {wide_flips} envs left the twin's trajectory in all")

    # the slice's main path: PPO full+adam at hidden 256 on fishing-v1 and on
    # fishing-v0's proportional grid of 100 quotas, 16384 x 128, 4 x 8
    wide_launches, wide_iter_ms = {}, {}
    for env_label, env_id, overrides in (("fishing-v1", "fishing-v1", dict(sigma=0.05)),
                                         (f"fishing-v0 n_actions={WIDE_ACTIONS}", "fishing-v0",
                                          dict(n_actions=WIDE_ACTIONS))):
        w_env, w_params = make(env_id, **overrides)
        w_host = make(env_id, device="cpu", **overrides)[1]   # K4 reads them on the host
        continuous = env_id == "fishing-v1"
        wcfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, hidden=WIDE_HIDDEN[-1],
                             fused_update=True, fused_rollout=True, fused_adam=True)
        w_ts0 = ppo.make_train_state(w_env, wcfg, torch.Generator().manual_seed(19))

        def w_run(cfg, iterations, seed=5):
            ts = w_ts0.clone()
            gen = torch.Generator(device=dev).manual_seed(seed)
            p = w_host if cfg.fused_rollout else w_params
            bstate = batched_reset(w_env, p, cfg.num_envs, dev)
            hist = []
            t0 = time.perf_counter()
            for _ in range(iterations):
                ts, bstate, met = ppo.train_step(w_env, p, cfg, ts, bstate, gen)
                hist.append({k: float(x) for k, x in met.items()})
            secs = time.perf_counter() - t0
            for name_, p in ts.model.named_parameters():
                if not bool(torch.isfinite(p).all()):
                    fail(f"phase 19: {env_label}: non-finite parameter {name_}")
            rets = np.array([h["episode_return"] for h in hist])
            return ts, (float(np.nanmean(rets[:5])), float(np.nanmean(rets[-5:]))), secs

        # fused ≡ plain after one step at 1 x 1 from the same rollout: K4's
        # packed samples through K3, and through the plain epochs (autograd)
        if continuous:
            planes = ppo_fused.rollout_noise_from_draws(
                torch.from_numpy(rng.standard_normal((T_PPO, B_PPO, 1)).astype(np.float32)).to(dev),
                torch.from_numpy(rng.standard_normal((T_PPO, 2, B_PPO)).astype(np.float32)).to(dev),
                0.0, False)
        else:
            planes = torch.from_numpy(np.stack([rng.random((T_PPO, B_PPO)),
                                                rng.standard_normal((T_PPO, B_PPO))])
                                      .astype(np.float32)).to(dev)
        for compute in ("float32", "bfloat16"):
            one_cfg = dataclasses.replace(wcfg, epochs=1, num_minibatches=1, compute_dtype=compute)
            fused, _, _ = ppo.train_step(
                w_env, w_host, one_cfg, w_ts0.clone(), batched_reset(w_env, w_host, B_PPO, dev),
                perms=[torch.arange(N_PPO // TILE, dtype=torch.int32, device=dev)],
                rollout_noise=planes)
            roll, _ = ppo_fused.fused_rollout_collect(
                w_env, w_host, one_cfg, w_ts0, batched_reset(w_env, w_host, B_PPO, dev),
                noise=planes)
            plain = w_ts0.clone()
            ppo._plain_epochs(one_cfg, plain, roll.packed_t[:6].T.contiguous(), 1, 1, continuous,
                              None, [torch.arange(N_PPO, device=dev)])
            if compute == "float32":   # phase 10's bars on the parameters
                s_err = 0.0
                for (pname, p), q in zip(fused.model.named_parameters(), plain.model.parameters()):
                    p, q = p.detach(), q.detach()
                    s_err = max(s_err, float((p - q).abs().max()))
                    if not bool(((p - q).abs() <= STEP_ATOL + STEP_RTOL * q.abs()).all()):
                        fail(f"phase 19: {env_label}: one step at 1x1, full+adam vs plain: "
                             f"{pname} max abs err {float((p - q).abs().max()):.3g}")
                what = f"max abs param err {s_err:.3g} (rtol {STEP_RTOL}, atol {STEP_ATOL})"
            else:   # phase 15's bar on the gradients, through Adam's first moment
                rel = {k: float((fused.m[k] - plain.m[k]).norm() / plain.m[k].norm())
                       for k in plain.m}
                name_ = max(rel, key=rel.get)
                if not rel[name_] <= GRAD_BF16_RTOL:
                    fail(f"phase 19: {env_label}: one step at 1x1 under bfloat16, full+adam vs "
                         f"plain: the first moment of {name_} differs by {rel[name_]:.3g}")
                what = (f"first moment within {rel[name_]:.3g} of its norm in the worst tensor, "
                        f"{name_} (bar {GRAD_BF16_RTOL:.4g})")
            print(f"phase 19: {env_label} hidden={WIDE_HIDDEN[-1]}: full+adam ≡ plain after one "
                  f"step at 1 x 1 from the same rollout under {compute}, N={N_PPO}: {what}")

        curves = {}
        for compute in ("float32", "bfloat16"):
            reset_counts()
            _, curves[compute], secs = w_run(dataclasses.replace(wcfg, compute_dtype=compute),
                                             WIDE_ITERS)
            got = counts()
            want = {"rollout": 0, "grad": 0, "adam": 32 * WIDE_ITERS, "policy": WIDE_ITERS}
            if got != want:
                fail(f"phase 19: {env_label} full+adam {compute}: launches {got}, expected {want}")
            # each K3 launch on the wide path runs dw2c_split and clip_adam once
            if uk.split_launches != 32 * WIDE_ITERS or uk.clip_adam_launches != 32 * WIDE_ITERS:
                fail(f"phase 19: {env_label} full+adam {compute}: dw2c_split launched "
                     f"{uk.split_launches} times, clip_adam {uk.clip_adam_launches}, expected "
                     f"{32 * WIDE_ITERS} each")
            got = dict(got, split=uk.split_launches, clip_adam=uk.clip_adam_launches)
            wide_launches[env_label, compute] = got
            wide_iter_ms[env_label, compute] = secs / WIDE_ITERS * 1e3
            print(f"phase 19: {env_label} full+adam {compute} hidden={WIDE_HIDDEN[-1]}: "
                  f"{secs / WIDE_ITERS * 1e3:.1f} ms/iter over {WIDE_ITERS} iterations (host "
                  f"clock, a metric read after each); launches {got}; episode return first5 "
                  f"{curves[compute][0]:.4f} -> last5 {curves[compute][1]:.4f}; B={B_PPO} "
                  f"T={T_PPO} 4x8 {label}")
        _, curves["off"], secs = w_run(dataclasses.replace(wcfg, fused_update=False,
                                                           fused_rollout=False, fused_adam=False),
                                       WIDE_ITERS)
        print(f"phase 19: {env_label} off hidden={WIDE_HIDDEN[-1]}: {secs / WIDE_ITERS * 1e3:.1f} "
              f"ms/iter; episode return first5 {curves['off'][0]:.4f} -> last5 "
              f"{curves['off'][1]:.4f}")
        for name, (first, last) in curves.items():
            if not last > first:
                fail(f"phase 19: {env_label} {name}: mean episode return did not rise "
                     f"({first:.4f} -> {last:.4f})")
        for compute in ("float32", "bfloat16"):
            gap = abs(curves["off"][1] - curves[compute][1])
            if not gap <= AGREE_TOL:
                fail(f"phase 19: {env_label}: last-5 mean episode returns of off and full+adam "
                     f"{compute} differ by {gap:.4f} > {AGREE_TOL}")
            print(f"phase 19: agreement gap off vs full+adam {compute} on {env_label} "
                  f"{gap:.4f} <= {AGREE_TOL}")
        if continuous:   # K2's wide path on a main path: the full form
            reset_counts()
            w_run(dataclasses.replace(wcfg, fused_adam=False), 2)
            wide_launches["full", "float32"] = dict(counts(), split=uk.split_launches,
                                                    clip_adam=uk.clip_adam_launches)
            if wide_launches["full", "float32"] != {"rollout": 0, "grad": 64, "adam": 0,
                                                    "policy": 2, "split": 64, "clip_adam": 0}:
                fail(f"phase 19: full at hidden {WIDE_HIDDEN[-1]}: launches "
                     f"{wide_launches['full', 'float32']}")

    from gym_fishing_tpu_torch.validation import kernel_rng

    t0 = time.perf_counter()
    if kernel_rng.main(["--require-cuda"]) != 0:
        fail("phase 19: validation/kernel_rng.py printed FAIL (its JSON line is above)")
    print(f"phase 19: validation/kernel_rng.py PASS at its defaults in "
          f"{time.perf_counter() - t0:.1f} s; phase 19 in {time.perf_counter() - t19:.1f} s")

    # --------------------------------------------------------------- 20
    # K2/K3 at observation windows beyond 4 fields: obs_dim 6 (11 fields, 16
    # rows) and 12 (17 fields, 24 rows), on the narrow path (hidden 64) and
    # the wide one (hidden 256, and 100 classes at any width)
    t20 = time.perf_counter()
    rng = np.random.default_rng(20)
    long_err = {"K2": 0.0, "K3": 0.0}
    long_ms, long_plain_ms, long_bound = {}, {}, {}
    for obs_dim in LONG_OBS:
        for hidden in (64, WIDE_HIDDEN[-1]):
            for head in ("gaussian", "categorical"):
                weights, data, a = ppo_case(ppo, ppo_fused, rng, head, dev, obs_dim=obs_dim,
                                            hidden=hidden, n_actions=WIDE_ACTIONS)
                if data.shape[0] != uk.packed_rows(obs_dim + 5):
                    fail(f"phase 20: obs_dim {obs_dim} data has {data.shape[0]} rows")
                adv = data[obs_dim + 3, order.long()[:, None] * TILE
                           + torch.arange(TILE, device=dev)]
                stats = torch.stack([adv.mean(), 1.0 / (adv.std(correction=0) + 1e-8)])
                w = weights
                m = tuple(torch.from_numpy(0.01 * rng.standard_normal(x.shape).astype(np.float32))
                          .to(dev) for x in w)
                v = tuple(torch.from_numpy(1e-4 * rng.random(x.shape).astype(np.float32))
                          .to(dev) for x in w)
                for compute in ("float32", "bfloat16"):
                    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=obs_dim,
                              act_dim=a, tile=TILE, head=head, compute=compute)
                    kw3 = dict(kw, lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5,
                               max_grad_norm=1e-3)
                    g, met = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
                    g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights,
                                                                        stats, **kw)
                    *new, met3 = uk.fused_minibatch_grad_adam(data, order, w, m, v, stats, **kw3)
                    *ref, met3_ref = uk.fused_minibatch_grad_adam_reference(
                        data, order, w, m, v, stats, **kw3)
                    torch.cuda.synchronize()
                    what = f"obs_dim={obs_dim} hidden={hidden} {head} A={a} {compute}"
                    err = check_buffers(towers(uk, g), towers(uk, g_ref), "K2 " + what)
                    check_metrics(met, met_ref, "K2 " + what)
                    err3 = max(check_buffers([x - y for x, y in zip(new[0], w)],
                                             [x - y for x, y in zip(ref[0], w)],
                                             "K3 " + what + " dw"),
                               check_buffers(new[1], ref[1], "K3 " + what + " m"),
                               check_buffers(new[2], ref[2], "K3 " + what + " v"))
                    check_metrics(met3, met3_ref, "K3 " + what)
                    long_err["K2"] = max(long_err["K2"], err)
                    long_err["K3"] = max(long_err["K3"], err3)
                    line = f"phase 20: K2/K3 {what:48s} max abs err {err:.3g} / {err3:.3g}"
                    if compute == "float32":
                        worst64 = check_float64_bar(uk, g, g_ref, data, order, weights, stats,
                                                    kw, "K2 " + what)
                        line += (f"; against float64, worst buffer {worst64[0]}: kernel "
                                 f"{worst64[1]:.3g}, float32 twin {worst64[2]:.3g}")
                    print(line)
                    key = (obs_dim, hidden, head, compute)
                    long_ms["K2", key], _ = cuda_ms(lambda: uk.fused_minibatch_grad(
                        data, order, weights, stats, **kw), 10)
                    long_plain_ms["K2", key], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_reference(data, order, weights, stats,
                                                                  **kw), 3)
                    long_ms["K3", key], _ = cuda_ms(lambda: uk.fused_minibatch_grad_adam(
                        data, order, w, m, v, stats, **kw3), 10)
                    long_plain_ms["K3", key], _ = cuda_ms(
                        lambda: uk.fused_minibatch_grad_adam_reference(data, order, w, m, v,
                                                                       stats, **kw3), 3)
                    long_bound[key] = update_bound(n_mb, obs_dim, hidden, a, compute, head)
                del weights, data, w, m, v, g, g_ref, new, ref
    for (name, key), ms in long_ms.items():
        obs_dim, hidden, head, compute = key
        bound = long_bound[key]
        print(f"phase 20: {name} obs_dim={obs_dim:2d} ({uk.packed_rows(obs_dim + 5)} rows) "
              f"hidden={hidden} {head:11s} {compute:8s}: {ms:.3f} ms, twin "
              f"{long_plain_ms[name, key]:.3f} ms per minibatch of {MB_TILES} x {TILE} (CUDA "
              f"events); bound {bound[0]:.4f} ms by {bound[1]} (share {bound[0] / ms:.3f}) "
              f"{label}")
    print(f"phase 20: in {time.perf_counter() - t20:.1f} s")

    # --------------------------------------------------------------- 21
    # the main path at a window of 6 observations: PPO update(+adam) on
    # stack_observations(fishing-v1, 6) at 16384 x 128, 4 x 8, hidden 64
    t21 = time.perf_counter()
    k_env, k_params = make("fishing-v1")
    k_env = stack_observations(k_env, STACK_K)

    def k_run(cfg, iterations, ts, seed=5):
        gen = torch.Generator(device=dev).manual_seed(seed)
        bstate = batched_reset(k_env, k_params, cfg.num_envs)
        hist = []
        t0 = time.perf_counter()
        for _ in range(iterations):
            ts, bstate, met = ppo.train_step(k_env, k_params, cfg, ts, bstate, gen)
            hist.append({k: float(x) for k, x in met.items()})
        secs = time.perf_counter() - t0
        for name_, p in ts.model.named_parameters():
            if not bool(torch.isfinite(p).all()):
                fail(f"phase 21: non-finite parameter {name_}")
        return ts, hist, secs

    def k_init(compute="float32", seed=21):
        return ppo.make_train_state(k_env, ppo.PPOConfig(compute_dtype=compute),
                                    torch.Generator().manual_seed(seed))

    for compute in ("float32", "bfloat16"):
        one_cfg = dataclasses.replace(base, compute_dtype=compute)
        plain, _, _ = k_run(one_cfg, 1, k_init(compute))
        fused, _, _ = k_run(dataclasses.replace(one_cfg, fused_update=True, fused_adam=True), 1,
                            k_init(compute))
        if compute == "float32":   # phase 10's bars on the parameters
            s_err = 0.0
            for (pname, p), q in zip(fused.model.named_parameters(), plain.model.parameters()):
                p, q = p.detach(), q.detach()
                s_err = max(s_err, float((p - q).abs().max()))
                if not bool(((p - q).abs() <= STEP_ATOL + STEP_RTOL * q.abs()).all()):
                    fail(f"phase 21: one step at 1x1 under float32, update+adam vs off: {pname} "
                         f"max abs err {float((p - q).abs().max()):.3g}")
            what = f"max abs param err {s_err:.3g} (rtol {STEP_RTOL}, atol {STEP_ATOL})"
        else:   # phase 15's bar on the gradients, through Adam's first moment
            rel = {k: float((fused.m[k] - plain.m[k]).norm() / plain.m[k].norm())
                   for k in plain.m}
            name_ = max(rel, key=rel.get)
            if not rel[name_] <= GRAD_BF16_RTOL:
                fail(f"phase 21: one step at 1x1 under bfloat16, update+adam vs off: the first "
                     f"moment of {name_} differs by {rel[name_]:.3g} of its norm")
            what = (f"first moment within {rel[name_]:.3g} of its norm in the worst tensor, "
                    f"{name_} (bar {GRAD_BF16_RTOL:.4g})")
        print(f"phase 21: stacked fishing-v1 (k={STACK_K}): update+adam ≡ off after one step "
              f"at 1 x 1 from the same draws under {compute}, N={N_PPO}: {what}")
    launches21 = {}
    for name, iters in (("update", 2), ("update+adam", 4)):
        cfg = ppo.PPOConfig(num_envs=B_PPO, num_steps=T_PPO, fused_update=True,
                            fused_adam=name == "update+adam")
        reset_counts()
        _, hist, secs = k_run(cfg, iters, k_init())
        launches21[name] = got = counts()
        want = {"update": (32 * iters, 0), "update+adam": (0, 32 * iters)}[name]
        if (got["grad"], got["adam"]) != want or got["rollout"] or got["policy"]:
            fail(f"phase 21: {name} on the stacked env launched {got}, expected (grad, adam) "
                 f"{want}")
        print(f"phase 21: stacked k={STACK_K} {name:12s} {secs / iters * 1e3:.1f} ms/iter (host "
              f"clock, {iters} iterations); launches {got}; episode return last "
              f"{hist[-1]['episode_return']:.4f}; B={B_PPO} T={T_PPO} 4x8 hidden=64 {label}")
    print(f"phase 21: in {time.perf_counter() - t21:.1f} s")

    # --------------------------------------------------------------- 22
    # A2C at its defaults (1024 envs x 16 steps, hidden 64): one step on the
    # card ≡ the same step on the CPU from the same planes, then 20 iterations
    import importlib

    from gym_fishing_tpu_torch.agents import a2c, es

    t22 = time.perf_counter()
    rng = np.random.default_rng(22)
    acfg = a2c.A2CConfig()
    a_env, _ = make("fishing-v1")
    a0 = a2c.make_a2c_state(a_env, acfg, torch.Generator().manual_seed(22), device="cpu")
    a_act = rng.standard_normal((acfg.num_steps, acfg.num_envs, 1)).astype(np.float32)
    a_envn = rng.standard_normal((acfg.num_steps, 2, acfg.num_envs)).astype(np.float32)
    a_out = {}
    for d in (dev, torch.device("cpu")):
        a_params = make("fishing-v1", device=d)[1]
        st = a2c.A2CState(model=copy.deepcopy(a0.model).to(d),
                          nu={k: x.to(d) for k, x in a0.nu.items()})
        a_out[d.type], _, _ = a2c.a2c_train_step(
            a_env, a_params, acfg, st, batched_reset(a_env, a_params, acfg.num_envs),
            act_noise=torch.from_numpy(a_act).to(d), env_noise=torch.from_numpy(a_envn).to(d))
    a_err = 0.0
    for (pname, p), q in zip(a_out["cuda"].model.named_parameters(),
                             a_out["cpu"].model.parameters()):
        a_err = max(a_err, max_err(p.detach().cpu(), q.detach()),
                    max_err(a_out["cuda"].nu[pname].cpu(), a_out["cpu"].nu[pname]))
    if not a_err <= A2C_ATOL:
        fail(f"phase 22: A2C one step on the card vs the CPU: max abs err {a_err:.3g} of the "
             f"parameters and RMSProp's moments > {A2C_ATOL}")
    t0 = time.perf_counter()
    _, a_hist = a2c.a2c_train(a_env, acfg, seed=0, iterations=20)
    a_secs = time.perf_counter() - t0
    if not all(np.isfinite(h["loss"]) for h in a_hist):
        fail("phase 22: A2C: a non-finite loss in 20 iterations")
    print(f"phase 22: A2C one step at {acfg.num_envs} x {acfg.num_steps} on the card ≡ the CPU "
          f"from the same planes: max abs err {a_err:.3g} <= {A2C_ATOL}; 20 iterations in "
          f"{a_secs:.2f} s ({a_secs / 20 * 1e3:.1f} ms/iter, host clock), loss "
          f"{a_hist[0]['loss']:.4f} -> {a_hist[-1]['loss']:.4f} {label}")

    # --------------------------------------------------------------- 23
    # DP at 257 states x 129 quotas in float64: the MDP and value iteration on
    # the card ≡ the CPU, then Reed's constant escapement
    dpm = importlib.import_module("gym_fishing_tpu_torch.agents.dp")
    t23 = time.perf_counter()
    d_env, d_gpu = make("fishing-v1", sigma=0.05, dtype=torch.float64)
    d_cpu = make("fishing-v1", sigma=0.05, dtype=torch.float64, device="cpu")[1]
    dkw = dict(n_states=257, n_quotas=129)
    mdps = {"cuda": dpm.build_mdp(d_env, d_gpu, **dkw), "cpu": dpm.build_mdp(d_env, d_cpu, **dkw)}
    pr_err = max(max_err(getattr(mdps["cuda"], f).cpu(), getattr(mdps["cpu"], f))
                 for f in ("grid", "quotas", "P", "R"))
    if not pr_err <= DP_PR_ATOL:
        fail(f"phase 23: build_mdp on the card vs the CPU: max abs err {pr_err:.3g}")
    sols, vi_s = {}, {}
    for d, mdp in mdps.items():
        t0 = time.perf_counter()
        sols[d] = dpm.value_iteration(d_env, gamma=0.99, mdp=mdp)
        float(sols[d].V[1])
        vi_s[d] = time.perf_counter() - t0
    v_err = max_err(sols["cuda"].V.cpu(), sols["cpu"].V)
    if not v_err <= DP_V_ATOL:
        fail(f"phase 23: value_iteration V on the card vs the CPU: max abs err {v_err:.3g}")
    sweeps = {d: s.iterations for d, s in sols.items()}
    if sweeps["cuda"] != sweeps["cpu"]:
        stop = 1e-6 * (1.0 - 0.99) / 0.99
        near = abs(float(sols["cpu"].residual) - stop) <= 1e-12 * stop
        if not (near and abs(sweeps["cuda"] - sweeps["cpu"]) == 1):
            fail(f"phase 23: value_iteration stopped after {sweeps} sweeps")
        print(f"phase 23: the residual lies within 1e-12 of the threshold: sweeps {sweeps}")
    reed_env, reed_p = make("fishing-v1", sigma=0.0, dtype=torch.float64)
    t0 = time.perf_counter()
    reed = dpm.value_iteration(reed_env, reed_p, gamma=0.999, tol=1e-3, **dkw)
    grid, pol = reed.grid.cpu().numpy(), reed.policy_quota.cpu().numpy()
    reed_s = time.perf_counter() - t0
    mask = (grid > 0.6) & (grid < 1.5)
    reed_err = float(np.abs(pol[mask] - np.maximum(grid[mask] - 0.5, 0.0)).max())
    if not reed_err <= REED_ATOL:
        fail(f"phase 23: the DP policy is {reed_err:.3g} from constant escapement at K/2")
    print(f"phase 23: DP 257 x 129 float64: P, R on the card ≡ the CPU within {pr_err:.3g}; "
          f"value_iteration (gamma 0.99) V within {v_err:.3g}, {sweeps['cuda']} sweeps on both "
          f"({vi_s['cuda']:.2f} s on the card, {vi_s['cpu']:.2f} s on the CPU); Reed (sigma 0, "
          f"gamma 0.999, tol 1e-3): {reed.iterations} sweeps in {reed_s:.2f} s, constant "
          f"escapement within {reed_err:.3g} <= {REED_ATOL} {label}")

    # --------------------------------------------------------------- 24
    # ES, one generation at its defaults (256 members x 4 envs, Tmax steps):
    # the card ≡ the CPU from the same perturbations and draws
    t24 = time.perf_counter()
    rng = np.random.default_rng(24)
    ecfg = es.ESConfig()
    e_env, _ = make("fishing-v1")
    e0 = es.make_es_state(e_env, ecfg, torch.Generator().manual_seed(24), device="cpu")
    # the fresh policy's quota takes the whole stock at once, so every member
    # earns the initial stock and all ranks tie; an output bias of -0.8 makes
    # the members' harvests, and so their fitness, differ
    with torch.no_grad():
        e0.model.out.bias.fill_(-0.8)
    steps = int(e_env.default_params.Tmax)
    half, n_e = ecfg.pop_size // 2, ecfg.pop_size * ecfg.envs_per_member
    e_eps = {n: rng.standard_normal((half,) + tuple(p.shape)).astype(np.float32)
             for n, p in e0.model.named_parameters()}
    e_noise = rng.standard_normal((steps, 2, n_e)).astype(np.float32)
    fit, e_ms = {}, {}
    for d in (dev, torch.device("cpu")):
        e_params = make("fishing-v1", device=d)[1]
        eps_d = {n: torch.from_numpy(x).to(d) for n, x in e_eps.items()}
        pop = {n: p.detach().to(d)[None] + ecfg.sigma * torch.cat([eps_d[n], -eps_d[n]])
               for n, p in e0.model.named_parameters()}
        t0 = time.perf_counter()
        fit[d.type] = es._episode_returns(e_env, e_params, pop, True, steps,
                                          ecfg.envs_per_member,
                                          torch.from_numpy(e_noise).to(d)).cpu()
        e_ms[d.type] = (time.perf_counter() - t0) * 1e3
    f_err = max_err(fit["cuda"], fit["cpu"])
    if not f_err <= ES_ATOL:
        fail(f"phase 24: ES fitness on the card vs the CPU: max abs err {f_err:.3g}")
    f = fit["cpu"].double()
    gap = (f[:, None] - f[None, :]).abs() + torch.eye(len(f), dtype=torch.float64)
    clear = gap.min(dim=1).values > ES_RANK_GAP
    ranks = {d: es._centered_ranks(x) for d, x in fit.items()}
    if not torch.equal(ranks["cuda"][clear], ranks["cpu"][clear]):
        fail("phase 24: ES ranks differ on the card and the CPU where the fitness is clear")
    st = es.ESState(model=copy.deepcopy(e0.model).to(dev),
                    m={k: x.to(dev) for k, x in e0.m.items()},
                    v={k: x.to(dev) for k, x in e0.v.items()})
    t0 = time.perf_counter()
    st, e_met = es.es_train_step(e_env, make("fishing-v1")[1], ecfg, steps, st,
                                 eps={n: torch.from_numpy(x).to(dev) for n, x in e_eps.items()},
                                 env_noise=torch.from_numpy(e_noise).to(dev))
    gen_ms = (time.perf_counter() - t0) * 1e3
    if not all(bool(torch.isfinite(p).all()) for p in st.model.parameters()):
        fail("phase 24: ES: a non-finite parameter after one generation")
    print(f"phase 24: ES {ecfg.pop_size} members x {ecfg.envs_per_member} envs x {steps} steps: "
          f"fitness on the card ≡ the CPU within {f_err:.3g} (mean "
          f"{float(fit['cuda'].mean()):.4f}), ranks equal for the {int(clear.sum())} members "
          f"more than {ES_RANK_GAP} from any other; population rollout {e_ms['cuda']:.1f} ms "
          f"on the card, {e_ms['cpu']:.1f} ms on the CPU; one generation "
          f"{gen_ms:.1f} ms (host clock) {label}")

    # --------------------------------------------------------------- 25
    # the examples' numeric cores at tests/test_examples.py's sizes
    from gym_fishing_tpu_torch.examples.dp_optimal import dp_report
    from gym_fishing_tpu_torch.examples.model_uncertainty import uncertainty_rollout
    from gym_fishing_tpu_torch.examples.simulate_baselines import baseline_trajectories
    from gym_fishing_tpu_torch.examples.tipping_point import UNSTABLE, basin_stocks

    t25 = time.perf_counter()
    n_base = 0
    for env_id, name, _, _, traj in baseline_trajectories(2, dev):
        if not all(bool(torch.isfinite(x.float()).all()) for x in traj):
            fail(f"phase 25: simulate_baselines: {env_id} {name} is not finite")
        n_base += 1
    if n_base != 2 * len(gtt.registered_ids()):
        fail(f"phase 25: simulate_baselines ran {n_base} env and policy pairs")
    stocks = basin_stocks(torch.linspace(0.01, 1.0, 64), 20, dev)
    if not (bool(torch.isfinite(stocks).all()) and bool((stocks[-1] > UNSTABLE).any())
            and bool((stocks[-1] < UNSTABLE).any())):
        fail("phase 25: tipping_point does not reach both basins")
    n_u, r_u, models_u = uncertainty_rollout(64, 8, 3, dev)
    if n_u != 64 * 8 * 3 or not np.isfinite(r_u):
        fail(f"phase 25: model_uncertainty: {n_u} steps, mean reward {r_u}")
    _, _, rows_dp = dp_report(reps=2, n_states=65, n_quotas=33, device=dev)
    if not all(rows_dp["dp"][2] >= v - 1e-4 for _, _, v in rows_dp.values()):
        fail(f"phase 25: dp_optimal: the DP value is below a baseline's: {rows_dp}")
    print(f"phase 25: examples on the card: simulate_baselines {n_base} pairs, tipping_point "
          f"{int((stocks[-1] > UNSTABLE).sum())} of 64 recover, model_uncertainty mean reward "
          f"{r_u:.4f} {models_u}, dp_optimal V^pi(x0) "
          f"{ {k: round(v[2], 3) for k, v in rows_dp.items()} }; phases 22-25 in "
          f"{time.perf_counter() - t22:.1f} s")

    t26 = time.perf_counter()
    facade_launches, facade_per_iter, facade_err = slice_phases(dev, label, counts, reset_counts)
    print(f"phases 26-31 in {time.perf_counter() - t26:.1f} s")

    t32 = time.perf_counter()
    shard_launches, shard_err, shard_ms = multi_device_phases(dev, label, counts, reset_counts)
    print(f"phases 32-35 in {time.perf_counter() - t32:.1f} s")

    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s of command time")
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [
        {
            "name": "rollout_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/rollout_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/rollout_kernel.py:177",
            "launches": launched,
            "max_abs_err": max(worst, main_err),
            "ms": ker_ms,
            "plain_ms": plain_ms,
            # the larger of 44 bytes per env and call and of the operations
            # its function needs on their pipes (see K1_OPS)
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
            "configurations_launched": len(launched_configs),
            "sharded_launches": shard_launches["rollout"],
            "sharded_max_abs_err": shard_err["K1"],
            "instructions_per_step": k1_count["instructions_per_step"],
            "issue_ms": k1_issue,
        },
        {
            "name": "ppo_grad_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "launches": train_launches["update"]["grad"],
            "sharded_launches": shard_launches["grad"],
            "sharded_max_abs_err": shard_err["K2"],
            "sharded_nccl_w1_ms_per_iteration": shard_ms["nccl_w1_ms"],
            "full_ms_per_iteration": shard_ms["full_ms"],
            "sharded_nccl_w1_collectives_ms": shard_ms["nccl_w1_collectives_ms"],
            "sharded_gloo_w2_ms_per_iteration": shard_ms["gloo_w2_ms"],
            "sharded_gloo_w2_collectives_ms": shard_ms["gloo_w2_collectives_ms"],
            "max_abs_err": grad_err,
            "ms": grad_ms["float32"],
            "plain_ms": grad_plain_ms["float32"],
            "bound_ms": grad_bound["float32"][0],
            "bound_by": grad_bound["float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": grad_ms["bfloat16"],
            "bfloat16_bound_ms": grad_bound["bfloat16"][0],
        },
        {
            "name": "ppo_grad_adam_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:455",
            "launches": train_launches["update+adam"]["adam"],
            "facade_launches": facade_launches["adam"],
            "facade_launches_per_iteration": facade_per_iter["adam"],
            "facade_max_abs_err": facade_err["K3"],
            "max_abs_err": adam_err,
            "ms": adam_ms["float32"],
            "plain_ms": adam_plain_ms["float32"],
            "bound_ms": grad_bound["float32"][0],
            "bound_by": grad_bound["float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": adam_ms["bfloat16"],
            "bfloat16_bound_ms": grad_bound["bfloat16"][0],
        },
        {
            "name": "ppo_grad_kernel (16 rows)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "launches": launches15["update"]["grad"],
            "max_abs_err": grad16_err,
            "ms": grad16_ms["float32"],
            "plain_ms": grad16_plain_ms["float32"],
            "bound_ms": grad16_bound["float32"][0],
            "bound_by": grad16_bound["float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": grad16_ms["bfloat16"],
            "bfloat16_bound_ms": grad16_bound["bfloat16"][0],
            "rows_8_ms": grad_ms["float32"],
        },
        {
            "name": "ppo_grad_adam_kernel (16 rows)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:455",
            "launches": launches15["update+adam"]["adam"],
            "max_abs_err": adam16_err,
            "ms": adam16_ms["float32"],
            "plain_ms": adam16_plain_ms["float32"],
            "bound_ms": grad16_bound["float32"][0],
            "bound_by": grad16_bound["float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": adam16_ms["bfloat16"],
            "bfloat16_bound_ms": grad16_bound["bfloat16"][0],
            "rows_8_ms": adam_ms["float32"],
        },
        {
            "name": "ppo_grad_kernel (wide path, hidden 256)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "launches": wide_launches["full", "float32"]["grad"],
            "max_abs_err": wide_err["K2"],
            "ms": wide_ms["K2", (256, "gaussian", "float32")],
            "plain_ms": wide_plain_ms["K2", (256, "gaussian", "float32")],
            "bound_ms": wide_bound["K2", (256, "gaussian", "float32")][0],
            "bound_by": wide_bound["K2", (256, "gaussian", "float32")][1],
            "library_ms": wide_lib_ms["three", 256, "float32"],
            "library_note": "the three H-contractions per tower only, two towers",
            "bfloat16_ms": wide_ms["K2", (256, "gaussian", "bfloat16")],
            "bfloat16_library_ms": wide_lib_ms["three", 256, "bfloat16"],
            "categorical_100_ms": wide_ms["K2", (256, "categorical", "float32")],
            "hidden_128_ms": wide_ms["K2", (128, "gaussian", "float32")],
        },
        {
            "name": "ppo_grad_adam_kernel (wide path, hidden 256)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:455",
            "launches": wide_launches["fishing-v1", "float32"]["adam"],
            "max_abs_err": wide_err["K3"],
            "ms": wide_ms["K3", (256, "gaussian", "float32")],
            "plain_ms": wide_plain_ms["K3", (256, "gaussian", "float32")],
            "bound_ms": wide_bound["K3", (256, "gaussian", "float32")][0],
            "bound_by": wide_bound["K3", (256, "gaussian", "float32")][1],
            "library_ms": wide_lib_ms["three", 256, "float32"],
            "library_note": "the three H-contractions per tower only, two towers",
            "bfloat16_ms": wide_ms["K3", (256, "gaussian", "bfloat16")],
            "bfloat16_library_ms": wide_lib_ms["three", 256, "bfloat16"],
            "categorical_100_ms": wide_ms["K3", (256, "categorical", "float32")],
            "hidden_128_ms": wide_ms["K3", (128, "gaussian", "float32")],
        },
        {
            "name": "dw2c_split (wide path of K2/K3, hidden 256)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "replaces_part": "dW2c of _grad_tile, gym_fishing_tpu/kernels/ppo_update_kernel.py:296",
            "launches": wide_launches["fishing-v1", "float32"]["split"],
            "max_abs_err": split_err,
            "max_err_of_range_max": split_rel,
            "ms": wide_part_ms["split", (256, "gaussian", "float32")],
            "plain_ms": wide_plain_ms["split", (256, "gaussian", "float32")],
            "bound_ms": wide_bound["split", (256, "gaussian", "float32")][0],
            "bound_by": wide_bound["split", (256, "gaussian", "float32")][1],
            "library_ms": wide_lib_ms["split", 256, "float32"],
            "library_note": "torch.bmm over the towers, the whole minibatch in one sum",
            "bfloat16_ms": wide_part_ms["split", (256, "gaussian", "bfloat16")],
            "bfloat16_bound_ms": wide_bound["split", (256, "gaussian", "bfloat16")][0],
            "bfloat16_bound_by": wide_bound["split", (256, "gaussian", "bfloat16")][1],
            "bfloat16_library_ms": wide_lib_ms["split", 256, "bfloat16"],
            "stage1_ms": wide_part_ms["stage1", (256, "gaussian", "float32")],
            "stage1_bfloat16_ms": wide_part_ms["stage1", (256, "gaussian", "bfloat16")],
        },
        {
            "name": "clip_adam (K3's stage 3: masked global-norm clip and Adam, hidden 256)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:455",
            "replaces_part": "_optimizer_step of _ppo_grad_adam_kernel, "
                             "gym_fishing_tpu/kernels/ppo_update_kernel.py:501",
            "launches": wide_launches["fishing-v1", "float32"]["clip_adam"],
            "max_abs_err": clip_adam_err,
            "ms": clip_ms[256, "gaussian"],
            "plain_ms": clip_plain_ms[256, "gaussian"],
            "bound_ms": clip_bound[256, "gaussian"][0],
            "bound_by": clip_bound[256, "gaussian"][1],
            "library_ms": None,
            "categorical_100_ms": clip_ms[256, "categorical"],
            "categorical_100_bound_ms": clip_bound[256, "categorical"][0],
            "hidden_128_ms": clip_ms[128, "gaussian"],
            "hidden_64_ms": clip_ms[64, "gaussian"],
            "hidden_64_bound_ms": clip_bound[64, "gaussian"][0],
        },
        {
            "name": "policy_rollout_kernel (wide path, hidden 256)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/policy_rollout_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/policy_rollout_kernel.py:86",
            "launches": wide_launches["fishing-v1", "float32"]["policy"],
            "max_abs_err": wide_err["K4"],
            "ms": wide_ms["K4", (256, "fishing-v1", "float32")],
            "plain_ms": wide_plain_ms["K4", (256, "fishing-v1", "float32")],
            "bound_ms": wide_bound["K4", (256, "fishing-v1", "float32")][0],
            "bound_by": wide_bound["K4", (256, "fishing-v1", "float32")][1],
            "library_ms": None,
            "bfloat16_ms": wide_ms["K4", (256, "fishing-v1", "bfloat16")],
            "bfloat16_bound_ms": wide_bound["K4", (256, "fishing-v1", "bfloat16")][0],
            "categorical_100_ms": wide_ms["K4", (256, "fishing-v0", "float32")],
            "categorical_100_bfloat16_ms": wide_ms["K4", (256, "fishing-v0", "bfloat16")],
            "hidden_128_ms": wide_ms["K4", (128, "fishing-v1", "float32")],
            "hidden_128_bfloat16_ms": wide_ms["K4", (128, "fishing-v1", "bfloat16")],
        },
        {
            "name": "ppo_grad_kernel (observation windows, obs_dim 6 and 12)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "launches": launches21["update"]["grad"],
            "max_abs_err": long_err["K2"],
            "ms": long_ms["K2", (6, 64, "gaussian", "float32")],
            "plain_ms": long_plain_ms["K2", (6, 64, "gaussian", "float32")],
            "bound_ms": long_bound[6, 64, "gaussian", "float32"][0],
            "bound_by": long_bound[6, 64, "gaussian", "float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": long_ms["K2", (6, 64, "gaussian", "bfloat16")],
            "obs_dim_12_ms": long_ms["K2", (12, 64, "gaussian", "float32")],
            "obs_dim_12_bound_ms": long_bound[12, 64, "gaussian", "float32"][0],
            "hidden_256_ms": long_ms["K2", (6, 256, "gaussian", "float32")],
            "hidden_256_bound_ms": long_bound[6, 256, "gaussian", "float32"][0],
        },
        {
            "name": "ppo_grad_adam_kernel (observation windows, obs_dim 6 and 12)",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:455",
            "launches": launches21["update+adam"]["adam"],
            "max_abs_err": long_err["K3"],
            "ms": long_ms["K3", (6, 64, "gaussian", "float32")],
            "plain_ms": long_plain_ms["K3", (6, 64, "gaussian", "float32")],
            "bound_ms": long_bound[6, 64, "gaussian", "float32"][0],
            "bound_by": long_bound[6, 64, "gaussian", "float32"][1],
            "library_ms": lib_ms["float32"],
            "library_note": "the three 2H-contractions only",
            "bfloat16_ms": long_ms["K3", (6, 64, "gaussian", "bfloat16")],
            "obs_dim_12_ms": long_ms["K3", (12, 64, "gaussian", "float32")],
            "obs_dim_12_bound_ms": long_bound[12, 64, "gaussian", "float32"][0],
            "hidden_256_ms": long_ms["K3", (6, 256, "gaussian", "float32")],
            "hidden_256_bound_ms": long_bound[6, 256, "gaussian", "float32"][0],
        },
        {
            "name": "policy_rollout_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/policy_rollout_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/policy_rollout_kernel.py:86",
            "launches": train_launches["full+adam"]["policy"],
            "sharded_launches": shard_launches["policy"],
            "sharded_max_abs_err": shard_err["K4"],
            "facade_launches": facade_launches["policy"],
            "facade_launches_per_iteration": facade_per_iter["policy"],
            "facade_max_abs_err": facade_err["K4"],
            "max_abs_err": k4_err,
            "ms": k4_ms["float32"],
            "plain_ms": k4_plain_ms["float32"],
            "bound_ms": k4_bound["float32"][0],
            "bound_by": k4_bound["float32"][1],
            "library_ms": None,
            "bfloat16_ms": k4_ms["bfloat16"],
            "bfloat16_bound_ms": k4_bound["bfloat16"][0],
        },
    ]}))
    # the run drives one device, cuda:0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,
    }}))


if __name__ == "__main__":
    main()
