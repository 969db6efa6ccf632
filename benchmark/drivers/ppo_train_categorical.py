"""Driver `ppo_train_categorical`: `ppo_train`'s closed loop over the port's
PPO train step (`agents/ppo.py::train_step`), on a discrete env with a
categorical head: `make(id, n_actions=...)` on the proportional quota
grid, the categorical actor-critic's weights, its plain reference
(`reference/ppo_categorical.py`) and its bounds.

Set-up, window and release are `ppo_train`'s. Set-up also keeps the classes
that the first iteration's rollout drew and the first K3 call's loss and
gradients, and the window counts the launches it makes on the categorical
paths: K4's categorical sampler
(`kernels/policy_rollout_kernel.py::categorical_launches`) and K3's stage 1
on `ppo_grad_tower` (`kernels/ppo_update_kernel.py::tower_launches`).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

import inputs
import roofline
from drivers import ppo_train as base
from reference import ppo_categorical as ref
from window import closed_loop

SETUP_ITERATIONS = base.SETUP_ITERATIONS
TRACE_FIRST, TRACE_COUNT = base.TRACE_FIRST, base.TRACE_COUNT
HEAD = "categorical"


def facts(config: Dict) -> Dict:
    """Work per unit and the least times the layer metrics divide by, for
    the categorical head of `n_actions` classes."""
    p, prec = config["ppo"], config["precision"]["compute_dtype"]
    A = config["env"]["n_actions"]
    n = p["num_envs"] * p["num_steps"]
    n_mb = n // p["num_minibatches"]
    steps = p["epochs"] * p["num_minibatches"]
    n_par = roofline.merged_params(1, p["hidden"], A)
    upd, _ = roofline.update_bound(n_mb, 1, p["hidden"], A, prec, head=HEAD,
                                   extra_bytes=roofline.clip_adam_bytes(n_par))
    roll, _ = roofline.rollout_bound(p["num_envs"], p["num_steps"], 1, p["hidden"], A, prec,
                                     categorical=True)
    return {
        "work_per_unit": n,
        "flops_per_unit": roofline.ppo_iteration_flops(p["num_envs"], p["num_steps"],
                                                       p["epochs"], 1, p["hidden"], A),
        "peak_flops": roofline.PEAK[prec],
        "update_least_ms": steps * upd,
        "rollout_least_ms": roll,
        "ranges": {"rollout": "train_step/rollout", "update": "train_step/update"},
    }


def _env_dict(config: Dict) -> Dict:
    return {k: v for k, v in config["env"].items() if k not in ("id", "scheme")}


def categorical_weights(seed: int, hidden: int, n_actions: int, device
                        ) -> Dict[str, torch.Tensor]:
    """sb3's MlpPolicy initialisation for one observation field and a
    categorical head: orthogonal matrices (gain sqrt 2 in the hidden layers,
    0.01 in the logits, 1 in the value head), zero biases; drawn in
    `inputs.actor_critic_weights`' order from the same stream."""
    gen = inputs.generator(seed, 1, device)
    root2 = math.sqrt(2.0)
    z = lambda n: torch.zeros(n, device=device)  # noqa: E731
    w = {}
    for tower in ("pi", "v"):
        w[f"{tower}_d1.weight"] = inputs._orthogonal(hidden, 1, root2, gen, device)
        w[f"{tower}_d1.bias"] = z(hidden)
        w[f"{tower}_d2.weight"] = inputs._orthogonal(hidden, hidden, root2, gen, device)
        w[f"{tower}_d2.bias"] = z(hidden)
    w["pi_logits.weight"] = inputs._orthogonal(n_actions, hidden, 0.01, gen, device)
    w["pi_logits.bias"] = z(n_actions)
    w["v_out.weight"] = inputs._orthogonal(1, hidden, 1.0, gen, device)
    w["v_out.bias"] = z(1)
    return w


def _first_step(step1, cfg, n_actions: int) -> Dict:
    """The first K3 call's loss and clipped gradients by parameter name,
    from its metric sums and Adam's first moment after it (m = (1 - b1) g
    from m = 0)."""
    from gym_fishing_tpu_torch.agents import ppo_fused
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
    m1, met = step1
    n_mb = cfg.num_envs * cfg.num_steps // cfg.num_minibatches
    loss = (met[0] + cfg.vf_coef * met[1] - cfg.ent_coef * met[3]) / n_mb
    named = ppo_fused.params_from_kernel(uk.unmerge_weights(m1, cfg.hidden, n_actions), HEAD)
    return {"loss_step1": float(loss),
            "grads_step1": {k: x.float() / (1.0 - uk.ADAM_B1) for k, x in named.items()}}


def _launch_counts() -> Dict[str, int]:
    """The program's launch counters of the categorical paths. A program
    older than K4's categorical counter gives K4's count of all launches."""
    from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
    from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
    return {"k4": getattr(pk, "categorical_launches", pk.launches),
            "tower": uk.tower_launches}


def prepare(config: Dict, traffic: Dict, seed: int, device) -> Dict:
    """Set-up: the program's objects, driven through SETUP_ITERATIONS
    iterations, with what the check needs kept aside (the classes of the
    first rollout among it)."""
    ppo, BatchState, EnvState, make = base._program()
    from gym_fishing_tpu_torch.agents import ppo_fused
    p, env_cfg = config["ppo"], config["env"]
    overrides = {k: v for k, v in env_cfg.items() if k not in ("id", "scheme")}
    env, params = make(env_cfg["id"], device="cpu", **overrides)
    if env.config.scheme != env_cfg["scheme"]:
        raise ValueError(f"{env_cfg['id']} with n_actions {env_cfg['n_actions']} decodes as "
                         f"{env.config.scheme!r}, not {env_cfg['scheme']!r}")
    form = config["form"]
    cfg = ppo.PPOConfig(
        num_envs=p["num_envs"], num_steps=p["num_steps"], epochs=p["epochs"],
        num_minibatches=p["num_minibatches"], gamma=p["gamma"], gae_lambda=p["gae_lambda"],
        clip_eps=p["clip_eps"], lr=p["lr"], vf_coef=p["vf_coef"], ent_coef=p["ent_coef"],
        max_grad_norm=p["max_grad_norm"], hidden=p["hidden"],
        compute_dtype=config["precision"]["compute_dtype"], fused_update=form["fused_update"],
        fused_rollout=form["fused_rollout"], fused_adam=form["fused_adam"])
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed % (1 << 63)),
                              device)
    w0 = categorical_weights(seed, p["hidden"], env_cfg["n_actions"], device)
    with torch.no_grad():
        for name, x in ts.model.named_parameters():
            x.copy_(w0[name].reshape(x.shape))
    closed_loop(traffic)
    s0 = inputs.env_state(seed, p["num_envs"], _env_dict(config), device,
                          traffic["initial_year"])
    bstate = BatchState(env=EnvState(stock=s0["stock"].clone(), harvest=s0["harvest"].clone(),
                                     t=s0["t"].clone()),
                        episode_return=s0["ep_ret"].clone(),
                        episode_length=s0["ep_len"].clone())
    gen = torch.Generator(device=device).manual_seed(seed)
    run = {"ppo": ppo, "env": env, "params": params, "cfg": cfg, "ts": ts, "bstate": bstate,
           "gen": gen, "device": torch.device(device)}
    kept = {"w0": w0, "s0": s0, "metrics": []}
    first = {}
    collect, k3 = ppo_fused.fused_rollout_collect, ppo_fused.fused_minibatch_grad_adam

    def keep_classes(*a, **kw):
        roll, bs = collect(*a, **kw)
        first.setdefault("actions", roll.packed_t[1].clone())
        return roll, bs

    def keep_first_step(*a, **kw):
        out = k3(*a, **kw)
        if "step1" not in first:
            first["step1"] = (tuple(x.clone() for x in out[1]), out[3].clone())
        return out

    for i in range(SETUP_ITERATIONS):
        if i == 0:
            ppo_fused.fused_rollout_collect = keep_classes
            ppo_fused.fused_minibatch_grad_adam = keep_first_step
        try:
            metrics = base._iteration(run)
        finally:
            ppo_fused.fused_rollout_collect = collect
            ppo_fused.fused_minibatch_grad_adam = k3
        kept["metrics"].append(metrics)
        named = run["ts"].params()
        if i == 0:
            kept["m1"] = {k: run["ts"].m[k].detach().float().clone() for k in named}
            kept["v1"] = {k: run["ts"].v[k].detach().float().clone() for k in named}
            kept["w1"] = {k: x.detach().float().clone() for k, x in named.items()}
    kept["w_last"] = {k: x.detach().float().clone() for k, x in run["ts"].params().items()}
    kept["actions"] = first["actions"]
    kept.update(_first_step(first["step1"], cfg, env_cfg["n_actions"]))
    run["kept"] = kept
    return run


def measure(run: Dict, seconds: float, tracer) -> List[List[float]]:
    """`ppo_train`'s window, with the launches on the categorical paths
    counted over it: off_path is the launches expected on the card (one K4
    and epochs x minibatches `ppo_grad_tower` an iteration; none on the CPU,
    where the twins run) less those counted, as a distance."""
    before = _launch_counts()
    units = base.measure(run, seconds, tracer)
    after = _launch_counts()
    cfg = run["cfg"]
    on_card = run["device"].type == "cuda"
    want = {"k4": len(units) if on_card else 0,
            "tower": len(units) * cfg.epochs * cfg.num_minibatches if on_card else 0}
    run["kept"]["off_path"] = float(sum(abs(want[k] - (after[k] - before[k])) for k in want))
    return units


release = base.release


def compare(config: Dict, seed: int, device, kept: Dict) -> Dict[str, float]:
    """Run the reference over the set-up's iterations from the same weights,
    state and generator seed, and return each number compared:

    - loss_step1: the first minibatch's loss (taken before any Adam step),
      relative gap;
    - grad_step1_median, grad_step1_worst: its gradients as Adam took them
      (after the clip), the median leaf's and the worst leaf's gap of norms;
    - `ppo_train`'s five: loss_first, moment1_median, moment2_worst,
      change_first_median, change_last_worst;
    - actions_differ: the share of the first rollout's (env, step) draws
      whose class differs from the reference's;
    - actions_far: how many of them differ by more than one class (a
      rounding moves a draw across one CDF boundary at most);
    - off_path: the window's launches expected on the categorical paths
      less those counted (`measure`).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ref.run(kept["w0"], kept["s0"], _env_dict(config), config["ppo"], gen,
                  len(kept["metrics"]), keep=base._snapshot)
    first, last = out[0][1], out[-1][1]
    w0 = kept["w0"]
    median_grad = base._median(sorted(float(x.norm()) for x in first["m"].values()))
    moved = lambda k: float(first["m"][k].norm()) >= 1e-3 * median_grad  # noqa: E731
    change = lambda w: {k: w[k].reshape(w0[k].shape) - w0[k] for k in w0}  # noqa: E731
    loss_p, loss_r = kept["metrics"][0]["loss"], out[0][0]["loss"]
    step1_p, step1_r = kept["loss_step1"], out[0][0]["loss_step1"]
    grads_gap = base._leaf_gaps(kept["grads_step1"], out[0][0]["grads_step1"])
    gap = (kept["actions"].to(out[0][2].device).round().long() - out[0][2].long()).abs()
    return {
        "loss_step1": abs(step1_p - step1_r) / abs(step1_r),
        "grad_step1_median": base._median(grads_gap),
        "grad_step1_worst": grads_gap[-1],
        "loss_first": abs(loss_p - loss_r) / abs(loss_r),
        "moment1_median": base._median(base._leaf_gaps(kept["m1"], first["m"])),
        "moment2_worst": base._leaf_gaps(kept["v1"], first["v"])[-1],
        "change_first_median": base._median(base._leaf_gaps(change(kept["w1"]),
                                                            change(first["w"]), moved)),
        "change_last_worst": base._leaf_gaps(change(kept["w_last"]), change(last["w"]),
                                             moved)[-1],
        "actions_differ": float((gap > 0).float().mean()),
        "actions_far": float((gap > 1).sum()),
        "off_path": float(kept["off_path"]),
    }


def control(config: Dict, traffic: Dict, seed: int, device) -> Dict[str, float]:
    """The control: the reference computed in the precision below the
    configuration's, put in the program's place (its outputs kept as the
    program's would be), compared with the reference."""
    rnd = ref.scaled_rounder(getattr(torch, config["precision"]["control"]))
    p = config["ppo"]
    w0 = categorical_weights(seed, p["hidden"], config["env"]["n_actions"], device)
    s0 = inputs.env_state(seed, p["num_envs"], _env_dict(config), device,
                          traffic["initial_year"])
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ref.run(w0, s0, _env_dict(config), p, gen, SETUP_ITERATIONS, rnd, keep=base._snapshot)
    kept = {"w0": w0, "s0": s0, "metrics": [m for m, _, _ in out], "m1": out[0][1]["m"],
            "v1": out[0][1]["v"], "w1": out[0][1]["w"], "w_last": out[-1][1]["w"],
            "actions": out[0][2], "off_path": 0.0, "loss_step1": out[0][0]["loss_step1"],
            "grads_step1": out[0][0]["grads_step1"]}
    return compare(config, seed, device, kept)
