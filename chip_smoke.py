#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gym_fishing_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written CUDA kernels from csrc/ and drives the port's two
paths at the JAX bench's sizes: stepping, make("fishing-v1") -> escapement
-> fused rollout with auto-reset (2^21 envs, 512 steps per call), and PPO
training on fishing-v1 (16384 envs x 128 steps, 4 epochs x 8 minibatches,
hidden 64) in its plain, fused-update and fused-full forms. Phases, each of
which raises on failure:

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
   bfloat16, none under float32;
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

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failure exits non-zero before either.
It never imports JAX.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
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
# NVIDIA's data sheet for the H100 SXM, dense: float32 outside the tensor
# cores, bf16 inside them (FLOP/s), device memory (bytes/s)
PEAK = {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12}
# Per SM and clock the card gives 128 float32 results, 64 of 32-bit integer
# arithmetic and logic, 16 special-function results (rcp, rsqrt, sin, cos, lg2,
# ex2), and its 4 schedulers start 128 lane-operations of all kinds together
# (NVIDIA's table of arithmetic instruction throughput for compute capability
# 9.0); 132 SMs at the data sheet's 1980 MHz, which is where PEAK's 67e12
# comes from. The pipes work side by side, so operations of several kinds
# take at least the longest of the pipes' times and of the schedulers' time
# for all of them.
SM_CLOCKS_PER_S = 132 * 1.98e9
PER_SM_CLOCK = {"float32": 128, "int32": 64, "special": 16, "all": 128}
# What K1's function needs per env and step at the main path's parameters
# (fishing-v1: logistic, escapement, continuous, additive noise, no obs noise,
# r_drift = 0, so r is a constant and t is not converted), counted from the
# algorithm, a multiply with the add it feeds as one operation:
# - a quarter of a Philox4x32-10 block: per round two 32 x 32 -> 64-bit
#   multiplies and two three-input xors, 40 integer operations a block (the
#   key schedule is the same for every env and is not counted), 10 a step;
# - one uniform: the mantissa under the exponent of 1 (one shift-and-add) and
#   one float32 subtract;
# - half a Box-Muller pair: of a pair's lg2, sqrt, sin and cos, 2 special
#   results; of its four float32 multiplies (the two scalings, rad x cos,
#   rad x sin), 2;
# - the step: quota and harvest (4 float32), logistic growth as 1 - x/K in
#   one multiply-add, r x, and one multiply-add (3), the noise (2), the
#   collapse test (1; the clamp at 0 changes only an env that resets), the
#   reward with its penalty (5), the two running sums (2), the reset's
#   selects and episode sum (3); t + 1, its compare with the collapse folded
#   in, the episode count and t's select (4 integer).
# A count of this kind is a floor only while no compilation gets by with
# fewer: phase 5 holds it against the instructions the shipped kernel executes.
K1_OPS = {"float32": 1 + 2 + 4 + 3 + 2 + 1 + 5 + 2 + 3, "int32": 10 + 1 + 4, "special": 2}
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


def least_ms(ops_s, nbytes):
    """(least milliseconds the card could take, which limit): the larger of
    the operations' time at their peak rates and the bytes' at the memory
    rate."""
    ops_ms, bytes_ms = ops_s * 1e3, nbytes / PEAK["bytes"] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def pipes_s(ops):
    """Least seconds for `ops`, {pipe of PER_SM_CLOCK: operations}: the pipes
    overlap, so the longest pipe's time, or the schedulers' time for all of them."""
    times = [n / (PER_SM_CLOCK[pipe] * SM_CLOCKS_PER_S) for pipe, n in ops.items()]
    return max(*times, sum(ops.values()) / (PER_SM_CLOCK["all"] * SM_CLOCKS_PER_S))


def update_bound(n, obs_dim, hidden, act_dim, compute):
    """K2/K3 on n samples: the three 2H-contractions per tower (W2c's
    cross-tower blocks are zero and need no work) at the compute mode's rate,
    the input layer and the head with their backward in float32. Under
    bfloat16 the tensor cores and the float32 pipe work side by side, so the
    operations take the longer of the two; under float32 both are on one
    pipe and add. The packed samples read once, the weights read and the
    gradients written once."""
    h2, a1 = 2 * hidden, act_dim + 1
    products = 3 * 2 * h2 * hidden * n
    rest = (2 * 2 * obs_dim * h2 + 3 * 2 * h2 * a1) * n
    n_par = obs_dim * h2 + h2 + h2 * h2 + h2 + h2 * a1 + a1 + act_dim
    by_pipe = {compute: products / PEAK[compute]}
    by_pipe["float32"] = by_pipe.get("float32", 0.0) + rest / PEAK["float32"]
    return least_ms(max(by_pipe.values()), 4 * (8 * n + 2 * n_par))


def rollout_bound(num_envs, num_steps, obs_dim, hidden, act_dim, compute):
    """K4: per env and step the two H-contractions per tower (through W2c and
    Whc) at the compute mode's rate, the input layer in float32, and 4H tanh
    on the special-function units, one result each (a floor: an IEEE tanhf
    takes more). The tensor cores, the float32 pipe and the special-function
    units work side by side, so the operations take the longest of the three
    and not their sum. 36 bytes per env and step written and the state read
    and written once."""
    h2, a1, n = 2 * hidden, act_dim + 1, num_envs * num_steps
    products = 2 * (h2 * hidden + hidden * a1) * n
    by_pipe = {compute: products / PEAK[compute]}
    by_pipe["float32"] = by_pipe.get("float32", 0.0) + 2 * obs_dim * h2 * n / PEAK["float32"]
    by_pipe["special"] = pipes_s({"special": 2 * h2 * n})
    return least_ms(max(by_pipe.values()), 36 * n + 40 * num_envs)


def rollout_kernel_bound(num_envs, num_steps):
    """K1 on the main path's configuration: K1_OPS per env and step on their
    pipes; 44 bytes per env and call."""
    n = num_envs * num_steps
    return least_ms(pipes_s({pipe: k * n for pipe, k in K1_OPS.items()}), 44 * num_envs)


def issue_ms(instructions_per_step, num_envs, num_steps):
    """Milliseconds the schedulers alone need to start a kernel's
    instructions (one per lane, env and step) at the rate the bounds assume."""
    return (instructions_per_step * num_envs * num_steps
            / (PER_SM_CLOCK["all"] * SM_CLOCKS_PER_S) * 1e3)


def hmma_counts(_build, name):
    """{mangled name: HMMA instructions} of every instantiation of the kernel
    `name` in the machine code of the built library csrc/<name>.cu."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split(":", 1)[1].strip()
            fn = fn if name in fn else None
            if fn:
                counts[fn] = 0
        elif fn and "HMMA" in line:
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


def ppo_case(ppo, ppo_fused, rng, head, dev):
    """Jittered random weights and the bench's packed buffer [8, 2^21] drawn
    from them with numpy-made noise: (13 kernel-layout weights, data,
    act_dim). Old log-probs and values are spread so every clip branch is
    visited."""
    gauss = head == "gaussian"
    a = 1 if gauss else 3
    model = ppo.ActorCritic(1, a, gauss, 64, generator=torch.Generator().manual_seed(3)).to(dev)
    normal = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape).astype(np.float32)).to(dev)
    n = N_PPO
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * normal(*p.shape))
        if gauss:
            model.log_std.fill_(-0.4)
        obs = 0.7 * normal(n, 1)
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
    weights = ppo_fused.kernel_weights(dict(model.named_parameters()), head)
    return weights, ppo_fused.pack_feature_major(packed), a


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


def check_float64_bar(uk, got, twin, data, order, weights, stats, kw, what):
    """compute="float32" keeps float32 accuracy: per buffer, the kernel's error
    against the twin evaluated in float64 within F64_FACTOR of the float32
    twin's own (or of F64_FLOOR_ULPS ulps of the buffer's largest entry).
    Returns (name, kernel error, twin error) of the buffer with the largest
    kernel error relative to its bar."""
    merged = uk.merge_weights(weights)
    exact, _ = uk._grad_merged_reference(
        data.double(), order, tuple(x.double() for x in merged), stats.double(), **kw)
    hidden, worst = merged[0].shape[1] // 2, ("", 0.0, 0.0, -1.0)
    for name, g, t, ex in zip(uk.PPOGrads._fields, got, twin,
                              uk.unmerge_weights(exact, hidden, kw["act_dim"])):
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


def k4_setup(gtt, ppo, ppo_fused, rng, env_id, dev, **overrides):
    """An env at the PPO width: jittered random weights (the Gaussian mean
    shifted to -0.5 so that envs outlive their first harvest), desynchronised
    start states and numpy-made noise planes [za or u, zp(, nf)]."""
    env, params = gtt.make(env_id, device="cpu", **overrides)  # K4 reads them on the host
    cfg = env.config
    gauss = cfg.scheme == "continuous"
    a = 1 if gauss else cfg.n_actions
    model = ppo.ActorCritic(1, a, gauss, 64, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
        if gauss:
            model.pi_mean.bias.sub_(0.5)
            model.log_std.fill_(-1.0)
    head = "gaussian" if gauss else "categorical"
    weights = tuple(x.detach().to(dev) for x in ppo_fused.kernel_weights(
        dict(model.named_parameters()), head))
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
    for fn, n_hmma in hmma_counts(_build, "policy_rollout_kernel").items():
        bf16 = "Lb1E" in fn   # the mangled template argument BF = true
        print(f"phase 7: {fn[:40]} ({'bfloat16' if bf16 else 'float32'}): {n_hmma} HMMA")
        if (n_hmma > 0) != bf16:
            fail(f"{fn}: {n_hmma} HMMA instructions under "
                 f"{'bfloat16' if bf16 else 'float32'}")

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
                err = check_buffers(g, g_ref, what)
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
    adam_err = 0.0
    adam_ms, adam_plain_ms = {}, {}
    for head, (weights, data, a) in cases.items():
        w = uk.merge_weights(weights)
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
            "instructions_per_step": k1_count["instructions_per_step"],
            "issue_ms": k1_issue,
        },
        {
            "name": "ppo_grad_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/ppo_update_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/ppo_update_kernel.py:114",
            "launches": train_launches["update"]["grad"],
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
            "name": "policy_rollout_kernel",
            "route": "cuda",
            "source": "gym_fishing_tpu_torch/csrc/policy_rollout_kernel.cu",
            "replaces": "gym_fishing_tpu/kernels/policy_rollout_kernel.py:86",
            "launches": train_launches["full+adam"]["policy"],
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
