"""End-to-end validation of the fully fused PPO path: does it learn?

    python -m gym_fishing_tpu_torch.validation.fused_training --agreement \
        --fused-adam --compute bfloat16 --chain-shortening

Counterpart of ``scripts/validate_fused_training.py``. The fused kernels
change two things against the plain train step that the one-step parity
checks cannot see: the rollout's random numbers (the policy-rollout kernel's
Philox stream in place of the plain rollout's draws) and the minibatch
composition (tile-granular zero-copy shuffle in place of a full row
permutation). The proof that neither hurts learning is a training run:
fused-full PPO (`fused_update` + `fused_rollout`) on fishing-v1 (sigma 0.05)
at 16 384 envs x 128 steps must reach a final mean episode return (the mean
of the last 10 iterations) of at least `--threshold` (escapement 7.72, the
DP optimum 7.68).

``--agreement`` also trains the plain form (``fused="off"``: autograd and the
hand-written Adam, float32) with the same configuration and seed, and
requires the two episode-return curves to agree at every checkpoint: the
means of 10-iteration windows every 30 iterations may differ by at most
`--agreement-tol`, so a change in the random numbers or the shuffle that
merely slows learning is caught.

Both forms run on `--device` (default: the card; without one this fails as
`device.resolve` does). Prints one JSON line, then PASS or FAIL; exits 1 on
FAIL.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def checkpoints(rets: np.ndarray, every: int = 30, window: int = 10) -> list:
    """Mean episode return over [c - window, c) for c = every, 2 every, ..."""
    return [float(np.nanmean(rets[c - window:c])) for c in range(every, rets.size + 1, every)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-envs", type=int, default=16384)
    ap.add_argument("--num-steps", type=int, default=128)
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--threshold", type=float, default=7.0,
                    help="min final episode return (escapement=7.72)")
    ap.add_argument("--compute", default="float32", choices=["float32", "bfloat16"],
                    help="compute_dtype for the fused path")
    ap.add_argument("--agreement", action="store_true",
                    help="also train the plain form and require per-checkpoint agreement "
                         "of the learning curves")
    ap.add_argument("--agreement-tol", type=float, default=0.25)
    ap.add_argument("--chain-shortening", action="store_true",
                    help="rollout_pregen_noise + rollout_fold_obs on the fused path")
    ap.add_argument("--fused-adam", action="store_true",
                    help="clip + Adam inside the update kernel on the fused path")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)

    import torch

    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.device import resolve
    from gym_fishing_tpu_torch.registry import make

    device = resolve(args.device)
    env, _ = make("fishing-v1", device=device, sigma=0.05)

    def run_path(fused: bool):
        cfg = ppo.PPOConfig(
            num_envs=args.num_envs, num_steps=args.num_steps,
            fused_update=fused, fused_rollout=fused,
            compute_dtype=args.compute if fused else "float32",
            rollout_pregen_noise=args.chain_shortening and fused,
            rollout_fold_obs=args.chain_shortening and fused,
            fused_adam=args.fused_adam and fused,
        )
        t0 = time.perf_counter()
        _, history = ppo.train(env, cfg, seed=0, iterations=args.iterations, device=device)
        wall = time.perf_counter() - t0
        rets = np.asarray([h["episode_return"] for h in history], np.float64)
        return np.where(np.isfinite(rets), rets, np.nan), wall

    rets, wall = run_path(fused=True)
    valid = rets[np.isfinite(rets)]
    final = float(np.mean(valid[-10:])) if valid.size else float("nan")
    first = float(valid[0]) if valid.size else float("nan")
    ok = final >= args.threshold
    line = {
        "metric": "fused-full PPO episode return (fishing-v1, sigma=0.05)",
        "first_iter": round(first, 3),
        "final": round(final, 3),
        "threshold": args.threshold,
        "escapement_baseline": 7.72,
        "dp_optimum": 7.68,
        "iterations": args.iterations,
        "env_steps": args.iterations * args.num_envs * args.num_steps,
        "wall_s_incl_build": round(wall, 1),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        "compute": args.compute,
        "fused_adam": args.fused_adam,
        "chain_shortening": args.chain_shortening,
    }
    if args.agreement:
        plain_rets, plain_wall = run_path(fused=False)
        cp_f, cp_p = checkpoints(rets), checkpoints(plain_rets)
        gaps = [abs(a - b) for a, b in zip(cp_f, cp_p)]
        agree = all(g <= args.agreement_tol for g in gaps)
        ok = ok and agree
        line["agreement"] = {
            "checkpoint_every": 30,
            "fused": [round(v, 3) for v in cp_f],
            "plain": [round(v, 3) for v in cp_p],
            "max_gap": round(max(gaps), 4) if gaps else None,
            "tol": args.agreement_tol,
            "plain_wall_s": round(plain_wall, 1),
            "ok": agree,
        }
    line["pass"] = ok
    print(json.dumps(line))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
