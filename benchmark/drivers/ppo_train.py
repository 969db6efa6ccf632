"""Driver `ppo_train`: one trainer in a closed loop over the port's PPO
train step (`agents/ppo.py::train_step`) in the form the configuration
states.

Set-up builds one train state from the benchmark's weights and env state,
drives it through its first iterations (the first one loads the kernels),
keeping what the check compares, and hands that same state to the window.
In the window each iteration is chained on the last one's train state and
batch state, and reads its metrics to the host, as a logging loop does.

The check follows the set-up's iterations with the plain reference
(`reference/ppo.py`) from the same weights, state and generator seed;
`compare` says what it compares.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

import inputs
import roofline
from reference import ppo as ref
from window import closed_loop

SETUP_ITERATIONS = 3     # the first one loads the kernels; the reference follows all three
TRACE_FIRST, TRACE_COUNT = 4, 8   # the traced stretch: iterations of the window


def _program():
    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch.batch import BatchState
    from gym_fishing_tpu_torch.core.types import EnvState
    from gym_fishing_tpu_torch.registry import make
    return ppo, BatchState, EnvState, make


def facts(config: Dict) -> Dict:
    """Work per unit and the least times the layer metrics divide by."""
    p, prec = config["ppo"], config["precision"]["compute_dtype"]
    n = p["num_envs"] * p["num_steps"]
    n_mb = n // p["num_minibatches"]
    steps = p["epochs"] * p["num_minibatches"]
    n_par = roofline.merged_params(1, p["hidden"], 1)
    upd, _ = roofline.update_bound(n_mb, 1, p["hidden"], 1, prec,
                                   extra_bytes=roofline.clip_adam_bytes(n_par))
    roll, _ = roofline.rollout_bound(p["num_envs"], p["num_steps"], 1, p["hidden"], 1, prec)
    return {
        "work_per_unit": n,
        "flops_per_unit": roofline.ppo_iteration_flops(p["num_envs"], p["num_steps"],
                                                       p["epochs"], 1, p["hidden"], 1),
        "peak_flops": roofline.PEAK[prec],
        "update_least_ms": steps * upd,
        "rollout_least_ms": roll,
        "ranges": {"rollout": "train_step/rollout", "update": "train_step/update"},
    }


def _env_dict(config: Dict) -> Dict:
    return {k: v for k, v in config["env"].items() if k != "id"}


def prepare(config: Dict, traffic: Dict, seed: int, device) -> Dict:
    """Set-up: the program's objects, driven through SETUP_ITERATIONS
    iterations, with what the check needs kept aside."""
    ppo, BatchState, EnvState, make = _program()
    p, env_cfg = config["ppo"], config["env"]
    env, params = make(env_cfg["id"], device="cpu", sigma=env_cfg["sigma"])
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
    w0 = inputs.actor_critic_weights(seed, p["hidden"], device)
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
           "gen": gen}
    kept = {"w0": w0, "s0": s0, "metrics": []}
    for i in range(SETUP_ITERATIONS):
        metrics = _iteration(run)
        kept["metrics"].append(metrics)
        named = run["ts"].params()
        if i == 0:
            kept["m1"] = {k: run["ts"].m[k].detach().float().clone() for k in named}
            kept["v1"] = {k: run["ts"].v[k].detach().float().clone() for k in named}
            kept["w1"] = {k: x.detach().float().clone() for k, x in named.items()}
    kept["w_last"] = {k: x.detach().float().clone() for k, x in run["ts"].params().items()}
    run["kept"] = kept
    return run


def _iteration(run: Dict) -> Dict[str, float]:
    """One train step chained on the last, with its metrics read to the
    host one by one."""
    ts, bstate, metrics = run["ppo"].train_step(run["env"], run["params"], run["cfg"],
                                                run["ts"], run["bstate"], run["gen"])
    run["ts"], run["bstate"] = ts, bstate
    return {k: float(v) for k, v in metrics.items()}


def measure(run: Dict, seconds: float, tracer) -> List[List[float]]:
    """The window: iterations until `seconds` have passed; per iteration
    (start, end, env-steps, failed)."""
    units: List[List[float]] = []
    n = run["cfg"].num_envs * run["cfg"].num_steps
    t_start = time.perf_counter()
    i = 0
    while True:
        tracer.before(i)
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench/unit"):
            metrics = _iteration(run)
        t1 = time.perf_counter()
        tracer.after(i)
        units.append([t0, t1, n, 0 if math.isfinite(metrics["loss"]) else 1])
        i += 1
        if t1 - t_start >= seconds and not tracer.pending(i - 1):
            return units


def release(run: Dict) -> Dict:
    """Drop the program's state; return what the check compares."""
    kept = run.pop("kept")
    run.clear()
    return kept


def _leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               keep=None) -> List[float]:
    """Per leaf, the gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; sorted."""
    names = [k for k in want if keep is None or keep(k)]
    ref_norm = {k: float(want[k].double().norm()) for k in names}
    median = sorted(ref_norm.values())[len(names) // 2]
    return sorted(abs(float(prog[k].reshape(want[k].shape).double().norm()) - ref_norm[k])
                  / max(ref_norm[k], median) for k in names)


def _median(values: List[float]) -> float:
    return values[len(values) // 2]


def _snapshot(w, m, v, state):
    return {"m": {k: x.clone() for k, x in m.items()}, "v": {k: x.clone() for k, x in v.items()},
            "w": {k: x.clone() for k, x in w.items()}}


def compare(config: Dict, seed: int, device, kept: Dict) -> Dict[str, float]:
    """Run the reference over the set-up's iterations from the same weights,
    state and generator seed, and return each number compared:

    - loss_first: the first iteration's loss, relative gap;
    - moment1_median, moment2_worst: Adam's first and second moments after
      the first iteration (the gradients as the optimizer got them), the
      median leaf's and the worst leaf's gap of norms;
    - change_first_median: the parameters' change over the first iteration,
      the median leaf's gap, leaves whose reference gradient is under a
      thousandth of the median leaf's left out;
    - change_last_worst: the parameters' change over all the set-up's
      iterations, the worst leaf's gap, the same leaves left out.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ref.run(kept["w0"], kept["s0"], _env_dict(config), config["ppo"], gen,
                  len(kept["metrics"]), keep=_snapshot)
    first, last = out[0][1], out[-1][1]
    w0 = kept["w0"]
    median_grad = _median(sorted(float(x.norm()) for x in first["m"].values()))
    moved = lambda k: float(first["m"][k].norm()) >= 1e-3 * median_grad  # noqa: E731
    change = lambda w: {k: w[k].reshape(w0[k].shape) - w0[k] for k in w0}  # noqa: E731
    loss_p, loss_r = kept["metrics"][0]["loss"], out[0][0]["loss"]
    return {
        "loss_first": abs(loss_p - loss_r) / abs(loss_r),
        "moment1_median": _median(_leaf_gaps(kept["m1"], first["m"])),
        "moment2_worst": _leaf_gaps(kept["v1"], first["v"])[-1],
        "change_first_median": _median(_leaf_gaps(change(kept["w1"]), change(first["w"]),
                                                  moved)),
        "change_last_worst": _leaf_gaps(change(kept["w_last"]), change(last["w"]), moved)[-1],
    }


def control(config: Dict, traffic: Dict, seed: int, device) -> Dict[str, float]:
    """The control: the reference computed in the precision below the
    configuration's, put in the program's place (its outputs kept as the
    program's would be), compared with the reference."""
    rnd = ref.scaled_rounder(getattr(torch, config["precision"]["control"]))
    p = config["ppo"]
    w0 = inputs.actor_critic_weights(seed, p["hidden"], device)
    s0 = inputs.env_state(seed, p["num_envs"], _env_dict(config), device,
                          traffic["initial_year"])
    gen = torch.Generator(device=device).manual_seed(seed)
    out = ref.run(w0, s0, _env_dict(config), p, gen, SETUP_ITERATIONS, rnd, keep=_snapshot)
    kept = {"w0": w0, "s0": s0, "metrics": [m for m, _ in out], "m1": out[0][1]["m"],
            "v1": out[0][1]["v"], "w1": out[0][1]["w"], "w_last": out[-1][1]["w"]}
    return compare(config, seed, device, kept)
