"""Time the fused PPO policy rollout kernel (K4) alone, at the bench's shapes.

    python gym_fishing_tpu_torch/bench/policy_rollout.py [--root DIR] [--envs B,B,...] [--reps N]
                                                         [--errors] [--phases]
                                                         [--hidden H] [--n-actions A]

One rollout is T = 128 steps of fishing-v1 (continuous decode, Gaussian head,
hidden `--hidden`, default 64; with `--n-actions A` fishing-v0 under the
proportional decode of A classes, the categorical head), the obs map folded
into the input layer, noise drawn inside the kernel from a seed, timed with CUDA events over `--reps` calls of the
wrapper after a warm-up, for compute float32 and bfloat16 and for every
batch size in `--envs` (default 8448 and 16384: 8448 envs were one full wave
of the kernel that took 32 envs a CTA at two CTAs an SM, 16384 is the PPO
bench's batch). The wrapper makes no host sync, so the time is the kernel's,
its statistics reduction's, and the weights' merging and the output
allocation's on the card.

`--root` names the checkout whose ``gym_fishing_tpu_torch`` is imported
(default: the one this file lies in), so the same inputs can time two
versions of the kernel in turns on one card, one process each (a version
whose wrapper takes the merged weights is given those). Prints one
JSON line with the times, the SM clock after each and a checksum of the
packed rows; needs a CUDA device.

With `--errors` each result also holds the kernel's error against the plain
twin from the same seed: the envs that left the twin's trajectory (an error
above 1e-4 under float32, 5e-3 under bfloat16, or another t), and over the
others the largest and the mean absolute error of each packed row.

With `--phases` it times nothing of the shipped kernel: it builds an
instrumented copy (into the gitignored ``_build/``) in which thread 0 of
every CTA reads ``clock64()`` at the kernel's entry, at the borders of each
step's parts and after the GAE pass, and writes the sums in place of the
CTA's statistics (and, on the wide path, of its first env's carried
harvest and running return), which the copy therefore gets wrong. Prints,
per compute mode at B = 16384, the cycles before the first step (loading
the weights), per step in each part, and after the last step (the
bootstrap forward and the GAE pass), averaged over the CTAs: elapsed cycles
of one warp among those that share an SM, not its own instructions. The
parts of a step are the forward and the tail (sampling, decode, dynamics,
stores) in policy_rollout_kernel (hidden 32 and 64, at most 16 logits);
in policy_rollout_wide the input layer, the W2 product with its tanh, the
head and value, and the tail.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

T = 128


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# the wide kernel follows this line of the source; the clocks go into the
# kernel before it
WIDE_SECTION = "// ------------------------------------------------------------------ wide\n"


def _edit(source: str, edits, what: str) -> str:
    for old, new in edits:
        if source.count(old) != 1:
            raise RuntimeError(f"the {what}'s source has no single {old!r}")
        source = source.replace(old, new)
    return source


# policy_rollout_kernel: thread 0 sums its forward's and its tail's cycles
NARROW_EDITS = [
    ("  extern __shared__ __align__(16) float sm[];\n",
     "  extern __shared__ __align__(16) float sm[];\n"
     "  const long long c_entry = clock64();\n"),
    ("  for (int t = 0; t < T; ++t) {\n    forward(c.inp);\n",
     "  long long cyc_fwd = 0, cyc_tail = 0;\n  const long long c_loop = clock64();\n"
     "  for (int t = 0; t < T; ++t) {\n"
     "    const long long c0 = clock64();\n    forward(c.inp);\n"
     "    const long long c1 = clock64();\n"),
    ("    // the next forward overwrites the head outputs this step's tail read\n"
     "    __syncwarp();\n",
     "    __syncwarp();\n    cyc_fwd += c1 - c0;\n    cyc_tail += clock64() - c1;\n"),
    ("    st[3] = c.srw;\n  }\n",
     "    st[3] = c.srw;\n  }\n  if (tid == 0) {\n"
     "    sm[L_::STAT] = (float)(c_loop - c_entry);\n"
     "    sm[L_::STAT + 1] = (float)cyc_fwd;\n    sm[L_::STAT + 2] = (float)cyc_tail;\n"
     "    sm[L_::STAT + 3] = (float)(clock64() - c_loop - cyc_fwd - cyc_tail);\n  }\n"),
    ("    for (int s = 0; s < kEnvs; ++s) z += sm[L_::STAT + s * kStats + tid];\n",
     "    z = sm[L_::STAT + tid];\n"),
]

# policy_rollout_wide: thread 0 sums the cycles of each part of a step
# (forward's input layer, W2 product, head and value; the tail) over the
# T steps; the bootstrap forward after them counts to the end. The part
# borders are block barriers, so every warp of the CTA has reached them.
_WIDE_ENTRY = ("  const long long c_entry = clock64();\n"
               "  long long cyc_in = 0, cyc_w2 = 0, cyc_head = 0, cyc_tail = 0;\n")
_M1 = "    const long long m1 = clock64();\n    cyc_in += m1 - m0;\n"
_M2 = "    const long long m2 = clock64();\n    cyc_w2 += m2 - m1;\n"
WIDE_EDITS = [
    ("  auto forward = [&]() {\n",
     "  auto forward = [&]() {\n    const long long m0 = clock64();\n"),
    ("  for (int t = 0; t < T; ++t) {\n    forward();\n",
     "  const long long c_loop = clock64();\n"
     "  for (int t = 0; t < T; ++t) {\n    forward();\n    const long long c1 = clock64();\n"),
    ("    // the next forward overwrites the head outputs and values this step read\n"
     "    __syncthreads();\n  }\n",
     "    __syncthreads();\n    cyc_tail += clock64() - c1;\n  }\n"
     "  const long long c_last = clock64();\n"
     "  const long long s_in = cyc_in, s_w2 = cyc_w2, s_head = cyc_head;\n"),
    ("    st[3] = c.srw;\n  }\n",
     "    st[3] = c.srw;\n  }\n  if (tid == 0) {\n"
     "    sm[L_::STAT] = (float)(c_loop - c_entry);\n"
     "    sm[L_::STAT + 1] = (float)s_in;\n    sm[L_::STAT + 2] = (float)s_w2;\n"
     "    sm[L_::STAT + 3] = (float)s_head;\n    hv_out[env] = (float)cyc_tail;\n"
     "    ret_out[env] = (float)(clock64() - c_last);\n  }\n"),
    ("    __syncthreads();\n  };\n",
     "    __syncthreads();\n    cyc_head += clock64() - m2;\n  };\n"),
    ("  extern __shared__ __align__(16) float sm[];\n  constexpr bool MMA = kWideMma<2 * H, BF>;\n",
     "  extern __shared__ __align__(16) float sm[];\n  constexpr bool MMA = kWideMma<2 * H, BF>;\n"
     + _WIDE_ENTRY),
    ("    __syncthreads();\n    // the W2 product", "    __syncthreads();\n" + _M1
     + "    // the W2 product"),
    ("    __syncthreads();\n    // the heads:", "    __syncthreads();\n" + _M2 + "    // the heads:"),
    ("    for (int s = 0; s < E; ++s) z += sm[L_::STAT + s * kStats + tid];\n",
     "    z = sm[L_::STAT + tid];\n"),
]


def instrument(source: str) -> str:
    """`source` with the clocks added to policy_rollout_kernel and to
    policy_rollout_wide; raises if an anchor is not found."""
    if source.count(WIDE_SECTION) != 1:
        raise RuntimeError("the rollout kernel's source has no single wide section")
    narrow, wide = source.split(WIDE_SECTION)
    return (_edit(narrow, NARROW_EDITS, "rollout kernel") + WIDE_SECTION
            + _edit(wide, WIDE_EDITS, "wide rollout kernel"))


def phases(state_of, weights, scal, hidden, roll_kw) -> None:
    from gym_fishing_tpu_torch.kernels import _build
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    csrc = _build.BUILD_DIR / "rollout_phases_csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    _build.BUILD_DIR.mkdir(exist_ok=True)
    shutil.copytree(_build.CSRC, csrc)
    path = Path(csrc) / "policy_rollout_kernel.cu"
    path.write_text(instrument(path.read_text()))
    _build.CSRC = csrc   # this process builds and loads the instrumented copy only
    B = 16384
    A = 1 if roll_kw["scheme"] == "continuous" else roll_kw["n_actions"]
    lib = pk.library()
    wide = lib.policy_rollout_prep_floats(hidden, A) > 0   # the wide path lays out its weights
    state = state_of(B)
    out = {"card": smi("name,power.limit"), "B": B, "T": T, "hidden": hidden, "act_dim": A,
           "kernel": "policy_rollout_wide" if wide else "policy_rollout_kernel"}
    for compute in uk.COMPUTES:
        E = lib.policy_rollout_envs_per_cta(hidden, A, uk.COMPUTES.index(compute))
        ctas = -(-B // E)
        for _ in range(3):
            roll = pk.policy_rollout(*state, weights, scal, T, compute=compute, **roll_kw)
        torch.cuda.synchronize()
        sums = [float(v) / ctas for v in roll.stats]
        if wide:
            tail, after = (float(x[::E].double().mean()) for x in (roll.harvest, roll.ep_ret))
            out[compute] = {"envs_per_cta": E, "cycles_before_first_step": sums[0],
                            "input_layer_cycles_per_step": sums[1] / T,
                            "w2_product_cycles_per_step": sums[2] / T,
                            "head_value_cycles_per_step": sums[3] / T,
                            "tail_cycles_per_step": tail / T,
                            "cycles_after_last_step": after}
        else:
            before, fwd, tail, after = sums
            out[compute] = {"cycles_before_first_step": before,
                            "forward_cycles_per_step": fwd / T,
                            "tail_cycles_per_step": tail / T, "cycles_after_last_step": after}
        out[compute]["sm_clock"] = smi("clocks.sm")
    print(json.dumps(out))


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--envs", default="8448,16384")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n-actions", type=int, default=0,
                    help="fishing-v0, proportional decode of this many classes (default: "
                         "fishing-v1, Gaussian head)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("policy_rollout: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    import gym_fishing_tpu_torch as gtt
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    gauss = args.n_actions == 0
    if gauss:
        env_kw, head, a = dict(env_id="fishing-v1"), "gaussian", 1
    else:
        env_kw, head, a = dict(env_id="fishing-v0", n_actions=args.n_actions), "categorical", \
            args.n_actions
    # the kernel reads the params on the host
    env, params = gtt.make(**env_kw, sigma=0.1, device="cpu")
    cfg = env.config
    roll_kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
                   n_actions=cfg.n_actions, fold_obs=True)
    model = ppo.ActorCritic(1, a, gauss, args.hidden, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.05 * rng.standard_normal(p.shape).astype(np.float32)))
        if gauss:
            model.pi_mean.bias.sub_(0.5)   # envs outlive their first harvest
            model.log_std.fill_(-1.0)
    weights = tuple(x.detach().to(dev) for x in ppo_fused.kernel_weights(
        dict(model.named_parameters()), head))
    if "merged" in inspect.signature(pk.policy_rollout).parameters:
        weights = uk.merge_weights(weights)
    scal = ppo_fused.rollout_scalars(params, 2026, 7)
    tmax = int(params.Tmax)

    def state_of(B):
        f32 = lambda x: torch.from_numpy(x.astype(np.float32)).to(dev)  # noqa: E731
        i32 = lambda x: torch.from_numpy(x.astype(np.int32)).to(dev)  # noqa: E731
        return (f32(rng.uniform(0.3, 1.2, B)), i32(rng.integers(0, tmax, B)),
                f32(rng.uniform(0.0, 0.05, B)), f32(rng.uniform(0.0, 3.0, B)),
                i32(rng.integers(0, tmax, B)))

    if args.phases:
        phases(state_of, weights, scal, args.hidden, roll_kw)
        return
    out = {"root": os.path.abspath(args.root), "reps": args.reps, "T": T, "hidden": args.hidden,
           "head": head, "act_dim": a, "card": smi("name,power.limit")}
    for B in (int(b) for b in args.envs.split(",")):
        state = state_of(B)
        for compute in uk.COMPUTES:
            run = lambda: pk.policy_rollout(  # noqa: E731
                *state, weights, scal, T, compute=compute, **roll_kw)
            for _ in range(3):
                roll = run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                roll = run()
            end.record()
            torch.cuda.synchronize()
            if not bool(torch.isfinite(roll.packed_t).all()):
                raise SystemExit(f"policy_rollout: non-finite output under {compute} at B={B}")
            out[f"B={B} {compute}"] = {
                "ms": start.elapsed_time(end) / args.reps, "sm_clock": smi("clocks.sm"),
                "packed_sum": float(roll.packed_t.double().sum()),
                "stats": [float(v) for v in roll.stats]}
            if args.errors:
                ref = pk.policy_rollout_reference(*state, weights, scal, T, compute=compute,
                                                  **roll_kw)
                err = (roll.packed_t - ref.packed_t).abs().view(8, T, B)[:6]
                same = ((err.amax((0, 1)) <= (5e-3 if compute == "bfloat16" else 1e-4))
                        & (roll.t == ref.t))
                out[f"B={B} {compute}"]["errors"] = {
                    "envs_left": B - int(same.sum()),
                    "max": [float(v) for v in err[:, :, same].amax((1, 2))],
                    "mean": [float(v) for v in err[:, :, same].double().mean((1, 2))]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
