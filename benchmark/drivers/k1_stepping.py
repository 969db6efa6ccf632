"""Driver `k1_stepping`: one evaluator in a closed loop over the port's
stepping kernel (`kernels/rollout_kernel.py::rollout`) under a closed-form
policy. Each call steps every env the configuration's steps, chained on
the last call's stock, year, running return, harvest and Philox offset,
and its reward sum is read to the host.

The check runs the plain reference (`reference/k1.py`) over three calls:
the set-up's first, from the benchmark's own state; one of the window's,
drawn from the seed; and the window's last; the latter two from the state
the program handed them, at the offset the reference works out itself.
Per call: the stock, the running return, the call's rewards and completed
returns (the largest gap over all envs), the host's reward sum, and the
envs whose year, episode count or harvest differ at all.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

import inputs
import roofline
from reference import k1 as ref
from window import closed_loop

TRACE_FIRST, TRACE_COUNT = 50, 100   # the traced stretch: calls of the window
SAMPLE_RANGE = 4096   # the window's call checked is drawn from 0 .. SAMPLE_RANGE - 1


def facts(config: Dict) -> Dict:
    s = config["stepping"]
    least, _ = roofline.rollout_kernel_bound(s["num_envs"], s["num_steps"])
    return {"work_per_unit": s["num_envs"] * s["num_steps"], "k1_least_ms": least,
            "ranges": {"k1": "bench/k1"}}


def _env_dict(config: Dict) -> Dict:
    return {k: v for k, v in config["env"].items() if k != "id"}


def prepare(config: Dict, traffic: Dict, seed: int, device) -> Dict:
    from gym_fishing_tpu_torch.agents.policies import escapement
    from gym_fishing_tpu_torch.kernels import rollout_kernel
    from gym_fishing_tpu_torch.registry import make

    env_cfg, s = config["env"], config["stepping"]
    env, params = make(env_cfg["id"], device="cpu", sigma=env_cfg["sigma"])
    closed_loop(traffic)
    if s["policy"] != "escapement":
        raise ValueError(f"no such policy in this driver: {s['policy']!r}")
    s0 = inputs.env_state(seed, s["num_envs"], _env_dict(config), device,
                          traffic["initial_year"])
    run = {
        "kernel": rollout_kernel, "params": params, "config": env.config,
        "x_star": float(escapement(env, params).x_star), "num_steps": s["num_steps"],
        "key": seed % (1 << 64), "state": {k: s0[k] for k in ("stock", "t", "ep_ret", "harvest")},
        "offset": 0, "calls": 0,
        "sample": int(torch.randint(0, SAMPLE_RANGE, (), generator=torch.Generator()
                                    .manual_seed(seed % (1 << 63)))),
    }
    first_in = {k: x.clone() for k, x in run["state"].items()}
    out, total = _call(run)
    run["kept"] = {"checked": [(0, first_in, out, total)]}
    _call(run)   # one more call, warm
    run["calls_before_window"] = run["calls"]
    return run


def _call(run: Dict):
    """One call chained on the last; returns (its outputs, the reward sum
    read to the host)."""
    st, cfg = run["state"], run["config"]
    with torch.profiler.record_function("bench/k1"):
        out = run["kernel"].rollout(
            st["stock"], st["t"], run["params"], "escapement", run["x_star"], run["num_steps"],
            growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
            n_actions=cfg.n_actions, obs_noise=False, ep_ret=st["ep_ret"],
            harvest=st["harvest"], seed=run["key"], offset=run["offset"])
    total = float(out.reward.sum())
    run["state"] = {"stock": out.stock, "t": out.t, "ep_ret": out.ep_ret,
                    "harvest": out.harvest}
    run["offset"] = out.next_offset
    run["calls"] += 1
    return out, total


def measure(run: Dict, seconds: float, tracer) -> List[List[float]]:
    """The window: calls until `seconds` have passed; per call (start, end,
    env-steps, failed)."""
    units: List[List[float]] = []
    work = run["state"]["stock"].shape[0] * run["num_steps"]
    t_start = time.perf_counter()
    i = 0
    while True:
        tracer.before(i)
        t0 = time.perf_counter()
        state_in = run["state"]
        with torch.profiler.record_function("bench/unit"):
            out, total = _call(run)
        t1 = time.perf_counter()
        tracer.after(i)
        if i == run["sample"]:
            run["kept"]["checked"].append((run["calls"] - 1, state_in, out, total))
        run["last"] = (run["calls"] - 1, state_in, out, total)
        units.append([t0, t1, work, 0 if math.isfinite(total) else 1])
        i += 1
        if t1 - t_start >= seconds and not tracer.pending(i - 1):
            return units


def release(run: Dict) -> Dict:
    kept = run.pop("kept")
    if "last" in run:
        kept["checked"].append(run["last"])
    run.clear()
    return kept


def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap, over the largest reference value."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def compare(config: Dict, seed: int, device, kept: Dict) -> Dict[str, float]:
    """The reference over each checked call, from that call's input state at
    the offset the call's index gives; the largest gap of each kind."""
    env, steps = _env_dict(config), config["stepping"]["num_steps"]
    key = seed % (1 << 64)
    gaps = {"stock": 0.0, "return": 0.0, "reward": 0.0, "reward_sum": 0.0, "exact": 0.0}
    for index, state_in, out, total in kept["checked"]:
        want = ref.step_call(env, state_in, steps, key, index * ref.draws_per_call(steps))
        gaps["stock"] = max(gaps["stock"],
                            float((out.stock - want["stock"]).abs().max()) / env["K"])
        gaps["return"] = max(gaps["return"], _gap(out.ep_ret, want["ep_ret"]),
                             _gap(out.ep_ret_sum, want["ep_ret_sum"]))
        gaps["reward"] = max(gaps["reward"], _gap(out.reward, want["reward"]))
        ref_sum = float(want["reward"].double().sum())
        gaps["reward_sum"] = max(gaps["reward_sum"], abs(total - ref_sum) / abs(ref_sum))
        exact = ((out.t != want["t"]) | (out.ep_count != want["ep_count"])
                 | (out.harvest != want["harvest"]))
        gaps["exact"] += float(exact.sum())
    return gaps


class _Out:
    """A call's outputs under the names the program's result carries."""

    def __init__(self, d: Dict[str, torch.Tensor]):
        self.__dict__.update(d)


def control(config: Dict, traffic: Dict, seed: int, device) -> Dict[str, float]:
    """The control: the reference in the precision below the configuration's
    in the program's place, over the first call and two chained ones."""
    dtype = getattr(torch, config["precision"]["control"])
    env, s = _env_dict(config), config["stepping"]
    key = seed % (1 << 64)
    state = {k: v for k, v in inputs.env_state(seed, s["num_envs"], env, device,
                                                 traffic["initial_year"]).items()
             if k != "ep_len"}
    checked = []
    for index in range(3):
        got = ref.step_call(env, state, s["num_steps"], key,
                            index * ref.draws_per_call(s["num_steps"]), dtype)
        checked.append((index, state, _Out(got), float(got["reward"].double().sum())))
        state = {k: got[k] for k in ("stock", "t", "ep_ret", "harvest")}
    return compare(config, seed, device, {"checked": checked})
