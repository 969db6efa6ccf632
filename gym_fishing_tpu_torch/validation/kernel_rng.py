"""Statistical validation of the kernels' own random numbers, on the card.

    python -m gym_fishing_tpu_torch.validation.kernel_rng --require-cuda [-B 131072] [-T 74]

Counterpart of ``scripts/validate_kernel_rng.py``. The stepping kernel (K1)
and the policy-rollout kernel (K4) draw from Philox4x32-10 inside the kernel,
while the port's engine (``batch.batched_step``) and its plain rollout
(``agents/ppo.collect_rollout``) draw from a torch generator: seeded runs of
the two can only agree in distribution. At matched (B, T, sigma) with no
horizon reset (T = 74 < Tmax = 100):

1. K1's final stock under escapement against the engine's: KS distance
   below 0.02, means within 6 combined standard errors, std ratio in
   (0.95, 1.05);
2. the per-env summed reward, the same;
3. independence across envs: the std of the means of blocks of 8 x 128 envs
   within 3 times the population std / sqrt(1024) (one draw replayed over a
   block's lanes inflates it ~32 times, which a marginal test can miss);
4. the lognormal-noise ricker model repeats check 1;
5. K4's categorical sampler at step 0, where every env sees the same
   observation: each class's frequency within 6 binomial standard errors of
   the policy's softmax;
6-9. K4's Gaussian head (fishing-v1): the step-0 actions' mean within 6
   standard errors of the network's mean and their std within 2% of
   exp(log_std), their block independence, and the final stock and the
   in-flight episode return against the plain collect_rollout under
   check 1's bars;
10-12. K4's categorical head (fishing-v0, relative decode): the step-0
   actions' block independence and the same two whole-trajectory
   comparisons, which catch an action draw that reuses the process noise's
   numbers.

Beside the reference's cases, checks 5 and 10-12 also run at 100 actions
(fishing-v0's proportional grid) and check 5 at hidden 256, the widths of
the kernels' wide path.

Needs the card: without one it prints SKIP and exits 0, or 2 under
``--require-cuda``; it never falls back to the CPU. Prints one JSON line with
PASS or FAIL; exits 1 on FAIL.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

KS_TOL = 0.02
BLOCK = 8 * 128


def ks_distance(a, b) -> float:
    """Two-sample Kolmogorov-Smirnov statistic: the largest gap between the
    empirical CDFs."""
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    grid = np.concatenate([a, b])
    ca = np.searchsorted(a, grid, side="right") / a.size
    cb = np.searchsorted(b, grid, side="right") / b.size
    return float(np.abs(ca - cb).max())


def compare(name, kern, eng, checks) -> bool:
    """Checks 1, 2, 4, 8-9, 11-12: KS, mean gap in standard errors, std ratio."""
    kern = np.asarray(kern, np.float64)
    eng = np.asarray(eng, np.float64)
    d = ks_distance(kern, eng)
    se = math.sqrt(kern.var() / kern.size + eng.var() / eng.size)
    mean_gap_se = abs(kern.mean() - eng.mean()) / max(se, 1e-12)
    std_ratio = float(kern.std() / max(eng.std(), 1e-12))
    ok = d < KS_TOL and mean_gap_se < 6.0 and 0.95 < std_ratio < 1.05
    checks[name] = {"ks": round(d, 5), "mean_kernel": round(float(kern.mean()), 6),
                    "mean_engine": round(float(eng.mean()), 6),
                    "mean_gap_se": round(mean_gap_se, 2), "std_ratio": round(std_ratio, 4),
                    "ok": bool(ok)}
    return ok


def block_independence(values, checks, name="block_independence") -> bool:
    """Checks 3, 7, 10: the std of the means of blocks of BLOCK consecutive
    envs against the population std / sqrt(BLOCK)."""
    s = np.asarray(values, np.float64)
    s = s[:s.size // BLOCK * BLOCK].reshape(-1, BLOCK)
    block_means_std = float(s.mean(axis=1).std())
    expected = float(s.std() / math.sqrt(BLOCK))
    ratio = block_means_std / max(expected, 1e-12)
    ok = ratio < 3.0
    checks[name] = {"block_means_std": round(block_means_std, 6),
                    "iid_expectation": round(expected, 6), "ratio": round(ratio, 2),
                    "ok": bool(ok)}
    return ok


def _host(x) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def engine_rollout(env, params, S, B, T, seed, dev):
    """The port's engine under escapement, auto-reset on, its N(0, 1) draws
    from a torch generator: (final stocks, summed rewards)."""
    import torch

    from gym_fishing_tpu_torch.batch import batched_reset, batched_step

    state = batched_reset(env, params, B, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rewards = torch.zeros(B, dtype=torch.float32, device=dev)
    for _ in range(T):
        q = torch.clamp(state.env.stock - S, min=0.0)
        a = torch.clamp(q / (params.K * params.action_scale) - 1.0, -1.0, 1.0)[:, None]
        state, step = batched_step(env, params, state, a, gen)
        rewards = rewards + step.reward
    return _host(state.env.stock), _host(rewards)


def kernel_rollout(env, host_params, S, B, T, seed, dev):
    """K1 under escapement from a seed: (final stocks, summed rewards)."""
    import torch

    from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

    cfg = env.config
    out = rk.rollout(torch.full((B,), float(host_params.init_state), device=dev),
                     torch.zeros(B, dtype=torch.int32, device=dev), host_params, "escapement",
                     S, T, growth=cfg.growth, noise_form=cfg.noise_form, seed=seed)
    return _host(out.stock), _host(out.reward)


def _policy(env_id, hidden, seed, dev, **overrides):
    """(env, host params, device params, train state, config) of a random
    policy."""
    import torch

    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.registry import make

    env, host_params = make(env_id, device="cpu", sigma=0.05, **overrides)
    cfg = ppo.PPOConfig(hidden=hidden)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed), device=dev)
    return env, host_params, env.params(device=dev), ts, cfg


def _fused_step0(env, host_params, ts, cfg, B, T, seed, dev):
    """K4 from a seed over T steps: (step-0 actions, next batch state)."""
    import dataclasses

    import torch

    from gym_fishing_tpu_torch.agents import ppo_fused
    from gym_fishing_tpu_torch.batch import batched_reset

    roll, nxt = ppo_fused.fused_rollout_collect(
        env, host_params, dataclasses.replace(cfg, num_envs=B, num_steps=T), ts,
        batched_reset(env, host_params, B, dev), torch.Generator(device=dev).manual_seed(seed))
    return _host(roll.packed_t[1, :B]), nxt


def _plain(env, params, ts, cfg, B, T, seed, dev):
    """The plain collect_rollout from a torch generator: next batch state."""
    import dataclasses

    import torch

    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset

    cfg = dataclasses.replace(cfg, num_envs=B, num_steps=T)
    with torch.no_grad():
        nxt, _, _, _ = ppo.collect_rollout(env, params, cfg, ts.model,
                                           batched_reset(env, params, B, dev),
                                           torch.Generator(device=dev).manual_seed(seed))
    return nxt


def _obs0(ts, host_params, dev):
    import torch

    obs0 = float(host_params.init_state) / float(host_params.K) - 1.0
    with torch.no_grad():
        return ts.model(torch.full((1, 1), obs0, device=dev))[0]


def categorical_sampling(B, checks, dev, n_actions=3, hidden=64, seed=777,
                         name="categorical_sampling") -> bool:
    """Check 5: class frequencies at step 0 against the policy's softmax."""
    import torch

    overrides = {} if n_actions == 3 else {"n_actions": n_actions}
    env, host_params, _, ts, cfg = _policy("fishing-v0", hidden, 3, dev, **overrides)
    acts, _ = _fused_step0(env, host_params, ts, cfg, B, 4, seed, dev)
    (logits,) = _obs0(ts, host_params, dev)
    probs = _host(torch.softmax(logits[0].double(), -1))
    freqs = np.bincount(acts.astype(np.int64), minlength=n_actions)[:n_actions] / B
    se = np.sqrt(np.maximum(probs * (1 - probs), 1e-12) / B)
    gap = np.abs(freqs - probs) / se
    ok = bool((gap < 6.0).all() and acts.min() >= 0 and acts.max() < n_actions)
    checks[name] = {"n_actions": n_actions, "hidden": hidden,
                    "max_gap_se": round(float(gap.max()), 2), "ok": ok}
    if n_actions <= 8:
        checks[name].update(empirical=[round(float(f), 5) for f in freqs],
                            softmax=[round(float(p), 5) for p in probs])
    return ok


def gaussian_policy_sampling(B, T, checks, dev, seed=999) -> bool:
    """Checks 6-9: the Gaussian head's step-0 marginals and block
    independence, and the whole trajectory against collect_rollout."""
    import torch

    env, host_params, params, ts, cfg = _policy("fishing-v1", 64, 5, dev)
    with torch.no_grad():   # episodes survive long enough to be informative
        ts.model.log_std.fill_(math.log(0.25))
    acts0, kb = _fused_step0(env, host_params, ts, cfg, B, T, seed, dev)
    mean0, log_std = _obs0(ts, host_params, dev)
    mean0, std0 = float(mean0.reshape(())), float(torch.exp(log_std.detach()).reshape(()))
    mean_gap_se = abs(acts0.mean() - mean0) / (std0 / math.sqrt(B))
    std_ratio = float(acts0.std() / std0)
    ok = mean_gap_se < 6.0 and 0.98 < std_ratio < 1.02
    checks["gaussian_action_marginals_step0"] = {
        "mean_kernel": round(float(acts0.mean()), 6), "mean_mlp": round(mean0, 6),
        "mean_gap_se": round(float(mean_gap_se), 2), "std_kernel": round(float(acts0.std()), 6),
        "std_policy": round(std0, 6), "std_ratio": round(std_ratio, 4), "ok": bool(ok)}
    ok &= block_independence(acts0, checks, name="gaussian_action_block_independence")
    xb = _plain(env, params, ts, cfg, B, T, seed + 1, dev)
    ok &= compare("gaussian_final_stock", _host(kb.env.stock), _host(xb.env.stock), checks)
    ok &= compare("gaussian_inflight_return", _host(kb.episode_return),
                  _host(xb.episode_return), checks)
    return ok


def categorical_trajectory(B, T, checks, dev, n_actions=3, seed=555, suffix="") -> bool:
    """Checks 10-12: the categorical head's step-0 block independence and
    the whole trajectory against collect_rollout."""
    overrides = {} if n_actions == 3 else {"n_actions": n_actions}
    env, host_params, params, ts, cfg = _policy("fishing-v0", 64, 7, dev, **overrides)
    acts0, kb = _fused_step0(env, host_params, ts, cfg, B, T, seed, dev)
    ok = block_independence(acts0, checks,
                            name=f"categorical_action_block_independence{suffix}")
    xb = _plain(env, params, ts, cfg, B, T, seed + 1, dev)
    ok &= compare(f"categorical_final_stock{suffix}", _host(kb.env.stock),
                  _host(xb.env.stock), checks)
    ok &= compare(f"categorical_inflight_return{suffix}", _host(kb.episode_return),
                  _host(xb.episode_return), checks)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--require-cuda", action="store_true",
                    help="exit 2 instead of 0 when there is no card")
    ap.add_argument("-B", type=int, default=1 << 17)
    ap.add_argument("-T", type=int, default=74, help="< Tmax = 100: no horizon reset")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print(json.dumps({"kernel_rng_validation": "SKIP",
                          "reason": "no CUDA device: the kernels' own draws exist only there"}))
        return 2 if args.require_cuda else 0

    from gym_fishing_tpu_torch.registry import make

    dev = torch.device("cuda", 0)
    B, T, S = args.B, args.T, 0.5
    checks = {}
    ok = True

    # 1-3: logistic, additive noise
    env, host_params = make("fishing-v1", device="cpu", sigma=0.05, Tmax=100)
    ex, er = engine_rollout(env, env.params(device=dev), S, B, T, 0, dev)
    kx, kr = kernel_rollout(env, host_params, S, B, T, 12345, dev)
    ok &= compare("final_stock_additive", kx, ex, checks)
    ok &= compare("summed_reward_additive", kr, er, checks)
    ok &= block_independence(kx, checks)

    # 4: ricker, lognormal noise
    env2, host_params2 = make("fishing-ricker-v1", device="cpu", sigma=0.05, Tmax=100,
                              noise_form="lognormal")
    ex2, _ = engine_rollout(env2, env2.params(device=dev), S, B, T, 1, dev)
    kx2, _ = kernel_rollout(env2, host_params2, S, B, T, 54321, dev)
    ok &= compare("final_stock_lognormal_ricker", kx2, ex2, checks)

    # 5: the categorical sampler, the reference's 3 classes, then the wide path's
    ok &= categorical_sampling(B, checks, dev)
    ok &= categorical_sampling(B, checks, dev, n_actions=100, name="categorical_sampling_n100")
    ok &= categorical_sampling(B, checks, dev, n_actions=100, hidden=256,
                               name="categorical_sampling_n100_hidden256")

    # 6-9: the Gaussian head
    ok &= gaussian_policy_sampling(B, T, checks, dev)

    # 10-12: the categorical head's whole trajectory, 3 classes then 100
    ok &= categorical_trajectory(B, T, checks, dev)
    ok &= categorical_trajectory(B, T, checks, dev, n_actions=100, suffix="_n100")

    print(json.dumps({"kernel_rng_validation": "PASS" if ok else "FAIL", "B": B, "T": T,
                      "sigma": 0.05, "device": torch.cuda.get_device_name(0),
                      "checks": checks}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
