"""Time the fused PPO update kernels per minibatch at the bench's shapes: K2
(stages 1 and 2) and K3 (the same, then its optimizer stage), and with
`--parts` their parts apart.

    python gym_fishing_tpu_torch/bench/update_kernels.py [--root DIR] [--reps N] [--errors]
                                                        [--hidden H] [--n-actions A]
                                                        [--obs-dim D] [--parts] [--ppo]

One minibatch is 128 random tiles of 2048 samples out of the packed buffer
[R, 2^21] of 16384 envs x 128 steps (R = 8 at the default `--obs-dim 1`,
the fields rounded up to a multiple of 8 otherwise), hidden `--hidden`
(default 64), the Gaussian head or, with `--n-actions A`, the categorical
head of A classes,
timed with CUDA events over `--reps` launches after a warm-up, for compute
float32 and bfloat16. The launcher is called below the wrapper (no weight merging), so
the time is the kernels' and the workspace allocation's. K3 starts from small random
moments at Adam count 5 and clips (max_grad_norm 0.5).

With `--parts` it also times K3's stage 3 alone (`clip_adam`, from K2's
output; `rollout_instructions.median_ms`, per-call CUDA-event pairs queued behind a
device-side wait) with its bound, 28 bytes a merged parameter (g, w, m, v read, w,
m, v written) at 3.35 TB/s, and on the wide path its two stage-1 launches apart,
the same way as K2 (``wide_prep`` with ``ppo_grad_wide`` or
``ppo_grad_tower``, `wide_stage1`; ``dw2c_split`` from its scratch), with a
hash of stage 1's activation scratch and workspace rows.

With `--ppo` it times whole PPO iterations instead (`measure_ppo_train`, 16384
envs x 128 steps, 2 warm-up and `--reps` timed iterations, every metric read after
each): the forms ``full+adam`` under float32 and bfloat16 and ``off``, at hidden
256 on fishing-v1 (sigma 0.05) and on ``fishing-v0`` with 100 classes, and at
hidden 64 on fishing-v1.

`--root` names the checkout whose ``gym_fishing_tpu_torch`` is imported
(default: the one this file lies in), so the same inputs can time two
versions of the kernel in turns on one card, one process each. Prints one
JSON line, with a hash of the output's bits per compute mode (two
checkouts whose kernels should agree bit for bit give the same hash);
needs a CUDA device.

With `--errors` it times nothing and prints instead, for compute float32,
each gradient buffer's largest error against the twin evaluated in float64,
kernel / float32 twin, in float32 ulps of the buffer's largest entry: both
heads, hidden 32 and 64, two seeds, 64 tiles of 256 samples. An entry is
marked ``!`` where the kernel's error is above 4 times the larger of the
twin's and 2 ulps.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

N, TILE, MB_TILES = 16384 * 128, 2048, 128
HBM_BYTES_S = 3.35e12   # NVIDIA's data sheet for the H100 SXM
PPO_CASES = [  # (env id, env kwargs, hidden, fused form, fused_adam, compute)
    *[(env_id, env_kwargs, 256, fused, fused != "off", compute)
      for env_id, env_kwargs in (("fishing-v1", {"sigma": 0.05}),
                                 ("fishing-v0", {"n_actions": 100}))
      for fused, compute in (("full", "float32"), ("full", "bfloat16"), ("off", "float32"))],
    *[("fishing-v1", {"sigma": 0.05}, 64, fused, fused != "off", compute)
      for fused, compute in (("full", "float32"), ("full", "bfloat16"), ("off", "float32"))],
]


def ppo_table(measure_ppo_train, iters: int) -> dict:
    out = {}
    for env_id, env_kwargs, hidden, fused, fused_adam, compute in PPO_CASES:
        res = measure_ppo_train(num_envs=16384, num_steps=128, iters=iters, warmup=2,
                                fused=fused, fused_adam=fused_adam, compute_dtype=compute,
                                hidden=hidden, env_id=env_id, env_kwargs=env_kwargs,
                                read_metrics=True)
        if not res["loss"] == res["loss"]:
            raise SystemExit(f"update_kernels: a NaN loss in {env_id} {fused} {compute}")
        form = res["mode"][4:]
        out[f"{env_id} {env_kwargs} hidden={hidden} {form} {compute}"] = res["ms_per_iter"]
    return out


def error_table(uk, ppo, ppo_fused, dev) -> None:
    for head in uk.HEADS:
        gauss, a = head == "gaussian", 1 if head == "gaussian" else 3
        for hidden in (32, 64):
            for seed in (6, 7):
                gen = torch.Generator().manual_seed(seed)
                randn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
                n = 64 * 256
                model = ppo.ActorCritic(1, a, gauss, hidden, generator=gen)
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(0.05 * randn(*p.shape))
                    if gauss:
                        model.log_std.fill_(-0.4)
                    obs = 0.7 * randn(n, 1)
                    dist, value = model(obs)
                    action, logp = ppo.sample_action(dist, gauss, generator=gen)
                packed = torch.cat([
                    obs, action.float().reshape(n, -1), (logp + 0.3 * randn(n))[:, None],
                    (value + 0.3 * randn(n))[:, None], randn(n, 1),
                    (value + randn(n))[:, None]], 1)
                weights = ppo_fused.merged_weights(
                    {k: w.to(dev) for k, w in model.named_parameters()}, head)
                data = ppo_fused.pack_feature_major(packed).to(dev)
                order = torch.arange(0, 64, dtype=torch.int32, device=dev)
                stats = torch.tensor([0.05, 1.1], device=dev)
                kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a,
                          tile=256, head=head, compute="float32")
                got, _ = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
                twin, _ = uk.fused_minibatch_grad_reference(data, order, weights, stats, **kw)
                exact, _ = uk._grad_merged_reference(
                    data.double(), order, tuple(x.double() for x in weights), stats.double(),
                    **kw)
                cells = []
                # by parameter: the kernel computes no cross-tower block
                named = [ppo_fused.params_from_merged(x, head) for x in (got, twin, exact)]
                for name, g, t, ex in ((k, *(d[k] for d in named)) for k in named[2]):
                    ulp = float(ex.abs().max()) * 2.0 ** -23
                    if ulp == 0.0:
                        continue
                    e, et = float((g - ex).abs().max()) / ulp, float((t - ex).abs().max()) / ulp
                    cells.append(f"{name} {e:.0f}/{et:.0f}" + ("!" if e > 4 * max(et, 2) else ""))
                print(f"{head} hidden={hidden} seed={seed}:", " ".join(cells))


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--n-actions", type=int, default=0,
                    help="categorical head of this many classes (default: Gaussian)")
    ap.add_argument("--obs-dim", type=int, default=1,
                    help="observation fields (a window of stacked observations)")
    ap.add_argument("--parts", action="store_true",
                    help="also time clip_adam, and the wide path's stage 1 and dw2c_split, apart")
    ap.add_argument("--ppo", action="store_true",
                    help="time whole PPO iterations instead, --reps of each case")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("update_kernels: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from gym_fishing_tpu_torch.agents import ppo, ppo_fused
    from gym_fishing_tpu_torch.bench.rollout_instructions import median_ms, smi
    from gym_fishing_tpu_torch.bench.throughput import measure_ppo_train
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

    dev = torch.device("cuda", 0)
    if args.errors:
        error_table(uk, ppo, ppo_fused, dev)
        return
    if args.ppo:
        print(json.dumps({"root": os.path.abspath(args.root), "iters": args.reps,
                          "card": smi("name,power.limit"),
                          **ppo_table(measure_ppo_train, args.reps)}))
        return
    rng = np.random.default_rng(7)
    gauss = args.n_actions == 0
    head, a = ("gaussian", 1) if gauss else ("categorical", args.n_actions)
    d = args.obs_dim
    model = ppo.ActorCritic(d, a, gauss, args.hidden, generator=torch.Generator().manual_seed(3))
    weights = ppo_fused.kernel_weights(dict(model.named_parameters()), head)
    w_flat = uk.flatten_merged(uk.merge_weights(tuple(x.detach().to(dev) for x in weights)))
    rows = rng.standard_normal((uk.packed_rows(d + 5), N)).astype(np.float32)
    rows[:d] *= 0.7
    if not gauss:   # the action row holds the class index
        rows[d] = rng.integers(0, a, N)
    rows[d + 1] = -1.0 + 0.3 * rows[d + 1]
    rows[d + 5:] = 0.0
    data = torch.from_numpy(rows).to(dev)
    order = torch.from_numpy(rng.permutation(N // TILE)[:MB_TILES].astype(np.int32)).to(dev)
    stats = torch.tensor([0.0, 1.0], device=dev)
    m_flat = torch.from_numpy(0.01 * rng.standard_normal(w_flat.numel()).astype(np.float32))
    v_flat = torch.from_numpy(1e-4 * rng.random(w_flat.numel()).astype(np.float32))
    m_flat, v_flat = m_flat.to(dev), v_flat.to(dev)
    adam = dict(lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5, beta1=0.9, beta2=0.999,
                adam_eps=1e-5, max_grad_norm=0.5)

    out = {"root": os.path.abspath(args.root), "reps": args.reps, "hidden": args.hidden,
           "head": head, "act_dim": a, "obs_dim": d, "rows": rows.shape[0],
           "card": smi("name,power.limit")}
    for compute in uk.COMPUTES:
        scal = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=d, act_dim=a, tile=TILE,
                    head=head, compute=compute)
        run = lambda: uk._launch(data, order, w_flat, stats, args.hidden, **scal)  # noqa: E731
        for _ in range(5):
            gout = run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            gout = run()
        end.record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(gout).all()):
            raise SystemExit(f"update_kernels: non-finite output under {compute}")
        out[f"{compute}_ms"] = start.elapsed_time(end) / args.reps
        out[f"{compute}_sha256"] = hashlib.sha256(gout.cpu().numpy().tobytes()).hexdigest()[:16]
        q = uk._AdamParams(lr=adam["lr"], bc1=adam["bc1"], bc2=adam["bc2"],
                           max_grad_norm=adam["max_grad_norm"], beta1=0.9, beta2=0.999,
                           one_minus_b1=1.0 - 0.9, one_minus_b2=1.0 - 0.999,
                           adam_eps=adam["adam_eps"], pad0=0.0)
        outs = [torch.empty_like(w_flat) for _ in range(3)]
        run3 = lambda: uk._launch(data, order, w_flat, stats, args.hidden,  # noqa: E731
                                  adam=(q, m_flat, v_flat, *outs), **scal)
        for _ in range(5):
            run3()
        start.record()
        for _ in range(args.reps):
            run3()
        end.record()
        torch.cuda.synchronize()
        out[f"{compute}_k3_ms"] = start.elapsed_time(end) / args.reps
        out[f"{compute}_k3_sha256"] = hashlib.sha256(
            torch.cat(outs).cpu().numpy().tobytes()).hexdigest()[:16]
        if args.parts:
            kw3 = dict(obs_dim=d, hidden=args.hidden, act_dim=a, head=head, ent_coef=0.0,
                       **adam)
            clip = lambda: uk.clip_adam(gout, w_flat, m_flat, v_flat, **kw3)  # noqa: E731
            out[f"{compute}_clip_adam_ms"] = median_ms(clip, max(args.reps, 20))
            out["clip_adam_bound_ms"] = 28 * w_flat.numel() / HBM_BYTES_S * 1e3
            out["clip_adam_ctas"] = uk.library().ppo_clip_adam_ctas(d, args.hidden, a)
        if args.parts and uk.wide_path(args.hidden, a):
            merged = uk.unflatten_merged(w_flat, d, args.hidden, a)
            act, ws = uk.wide_stage1(data, order, merged, stats, **scal)
            bits = torch.cat([act.view(torch.uint8).flatten(), ws.view(torch.uint8).flatten()])
            out[f"{compute}_stage1_sha256"] = hashlib.sha256(
                bits.cpu().numpy().tobytes()).hexdigest()[:16]
            stage1 = lambda: uk.wide_stage1(data, order, merged, stats, **scal)  # noqa: E731
            split = lambda: uk.dw2c_split(  # noqa: E731
                act, ws, hidden=args.hidden, obs_dim=d, act_dim=a, num_tiles=MB_TILES,
                tile=TILE, head=head, compute=compute)
            for name, fn in (("stage1", stage1), ("dw2c_split", split)):
                for _ in range(3):
                    fn()
                start.record()
                for _ in range(args.reps):
                    fn()
                end.record()
                torch.cuda.synchronize()
                out[f"{compute}_{name}_ms"] = start.elapsed_time(end) / args.reps
    print(json.dumps(out))


if __name__ == "__main__":
    main()
