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

``--against-jax [FILE]`` holds the port against JAX's own plain-form curve,
recorded on the CPU (default: `JAX_CURVE`, fishing-v1 at 4096 envs x 128
steps, 300 iterations, seeds 0 and 1; the recorder is
tests/test_torch_validation.py): the run takes the file's sizes, epochs,
minibatches and hidden width, and seed 0,
and every checkpoint of each form it trains (the fused one, and the plain
one with ``--agreement``) must lie within `--agreement-tol` of JAX's seed 0.
The gap between JAX's two seeds is printed beside it, the noise floor of
such a comparison. In this mode the comparison decides PASS, not
`--threshold`.

Both forms run on `--device` (default: the card; without one this fails as
`device.resolve` does). Prints one JSON line, then PASS or FAIL; exits 1 on
FAIL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# JAX's plain-form curve on fishing-v1, recorded on the CPU by
# tests/test_torch_validation.py (the card's machine has no JAX).
JAX_CURVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_curve_fishing_v1.json")


def load_jax_curve(path=JAX_CURVE) -> dict:
    with open(path) as f:
        return json.load(f)


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
    ap.add_argument("--against-jax", nargs="?", const=JAX_CURVE, default=None, metavar="FILE",
                    help="compare each form's checkpoints with JAX's recorded curve")
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    jax_curve = None
    if args.against_jax is not None:
        jax_curve = load_jax_curve(args.against_jax)
        flags = jax_curve["flags"]
        args.num_envs, args.num_steps = flags["num_envs"], flags["num_steps"]
        args.iterations = flags["iterations"]
    shape = ({k: jax_curve["flags"][k] for k in ("epochs", "num_minibatches", "hidden")}
             if jax_curve is not None else {})

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
            **shape,
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
    ok = final >= args.threshold or jax_curve is not None
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
    plain_rets = None
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
    if jax_curve is not None:
        cp_j = [jax_curve["seeds"][s]["checkpoints"] for s in ("0", "1")]
        forms = {"fused": checkpoints(rets)}
        if plain_rets is not None:
            forms["plain"] = checkpoints(plain_rets)
        gaps = {k: [abs(a - b) for a, b in zip(v, cp_j[0])] for k, v in forms.items()}
        agree = all(g <= args.agreement_tol for v in gaps.values() for g in v)
        ok = ok and agree
        line["against_jax"] = {
            "file": os.path.basename(args.against_jax),
            "jax_version": jax_curve["jax_version"],
            "jax_seed0": [round(v, 4) for v in cp_j[0]],
            "jax_seed1": [round(v, 4) for v in cp_j[1]],
            "jax_seed_gap_max": round(max((abs(a - b) for a, b in zip(*cp_j)), default=0.0), 4),
            **{k: [round(x, 4) for x in v] for k, v in forms.items()},
            **{f"{k}_gap_max": round(max(v), 4) if v else None for k, v in gaps.items()},
            "tol": args.agreement_tol,
            "ok": agree,
        }
    line["pass"] = ok
    print(json.dumps(line))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
