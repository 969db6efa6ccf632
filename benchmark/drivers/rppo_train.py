"""Driver `rppo_train`: one trainer in a closed loop over the port's
recurrent PPO train step (`agents/ppo_rnn.py::train_step`) under
sb3-contrib's LSTM actor-critic (``cell="lstm"``) on fishing-v2, float32
products with TF32 off; its plain reference is `reference/rppo_lstm.py`.

Set-up builds one train state from the benchmark's weights (`lstm_weights`)
and env state, and drives it through SETUP_ITERATIONS iterations on draws
made from the seed (`draws`: the action normals, the env's noise planes
and the permutations), which the reference takes too; the first captures
the rollout's and the update's CUDA graphs and replays them, so that what
the check compares comes from the graphs. It keeps the first rollout, the
four states after it, the envs the rollouts zeroed, the first minibatch's
loss and clipped gradients, and the weights after the first and the last,
through the train step's `on_rollout` and `on_minibatch` hooks. Unchecked
iterations on the run's generator follow until the card has left the slow
state a capture leaves it in (`_warm`). In the window
each iteration is chained on the last one's train state, batch state and
LSTM states, draws from the run's generator, and reads its metrics to the
host one by one; the window counts the replayed steps
(`ppo_rnn.replayed_steps`).

A program without the LSTM learner (no ``cell`` in its `RPPOConfig`) fails
at the start of set-up.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

import inputs
import roofline
import roofline_rppo
from drivers import ppo_train as base
from reference import rppo_lstm as ref
from window import closed_loop

SETUP_ITERATIONS = 3     # the first one captures the CUDA graphs; the reference follows all three
# After the capture's idle seconds an H100 runs this cell's iterations ~3.5%
# slower (device time; the clock, power limit and throttle reasons it reports
# unchanged) in most fresh processes, for 2 to 16 iterations and more, then
# fast for good under load.
# On the card the set-up warms until it has seen that drop and SETTLED fast
# iterations after it, or WARM_MAX iterations (~70 s) where it sees none.
WARM_MAX = 40
SLOW_DROP = 0.02         # an iteration this much under the first replayed ones ends the slow state
SETTLED = 3              # iterations within SETTLED_WITHIN of the fastest before the window
SETTLED_WITHIN = 0.01
TRACE_FIRST, TRACE_COUNT = 2, 1   # one iteration: ~3e5 kernels


def _shape(config: Dict):
    p = config["rppo"]
    return 1, p["hidden"], tuple(p["net_arch"]), 1   # obs_dim, hidden, net_arch, act_dim


def facts(config: Dict) -> Dict:
    """Work per unit and the least times the layer metrics divide by."""
    p = config["rppo"]
    obs_dim, hidden, net_arch, act_dim = _shape(config)
    B, T, E, M = p["num_envs"], p["num_steps"], p["epochs"], p["num_minibatches"]
    return {
        "work_per_unit": B * T,
        "flops_per_unit": roofline_rppo.rppo_iteration_flops(B, T, E, obs_dim, hidden,
                                                             net_arch, act_dim),
        "peak_flops": roofline.PEAK["float32"],
        "update_least_ms": roofline_rppo.update_bound(B, T, E, M, obs_dim, hidden, net_arch,
                                                      act_dim)[0],
        "rollout_least_ms": roofline_rppo.rollout_bound(B, T, obs_dim, hidden, net_arch,
                                                        act_dim)[0],
        "ranges": {"rollout": "train_step/rollout", "update": "train_step/update"},
    }


def _env_dict(config: Dict) -> Dict:
    return {k: v for k, v in config["env"].items() if k != "id"}


def lstm_weights(seed: int, hidden: int, net_arch, device) -> Dict[str, torch.Tensor]:
    """sb3-contrib's initialisation, by the program's parameter names: each
    LSTM's entries uniform in [-1/sqrt(H), 1/sqrt(H)] (nn.LSTM's default),
    the MLPs orthogonal with gain sqrt 2, ``action_net`` 0.01 and
    ``value_net`` 1, zero biases, log_std 0; one observation field."""
    gen = inputs.generator(seed, 1, device)
    k = 1.0 / math.sqrt(hidden)
    uniform = lambda *s: (2 * torch.rand(s, generator=gen, device=device) - 1) * k  # noqa: E731
    w = {}
    for net in ("lstm_actor", "lstm_critic"):
        w[f"{net}.weight_ih"] = uniform(4 * hidden, 1)
        w[f"{net}.weight_hh"] = uniform(4 * hidden, hidden)
        w[f"{net}.bias_ih"] = uniform(4 * hidden)
        w[f"{net}.bias_hh"] = uniform(4 * hidden)
    widths = (hidden,) + tuple(net_arch)
    for tower in ("pi_mlp", "vf_mlp"):
        for j, (a, b) in enumerate(zip(widths, widths[1:])):
            w[f"{tower}.{j}.weight"] = inputs._orthogonal(b, a, math.sqrt(2.0), gen, device)
            w[f"{tower}.{j}.bias"] = torch.zeros(b, device=device)
    w["action_net.weight"] = inputs._orthogonal(1, widths[-1], 0.01, gen, device)
    w["action_net.bias"] = torch.zeros(1, device=device)
    w["log_std"] = torch.zeros(1, device=device)
    w["value_net.weight"] = inputs._orthogonal(1, widths[-1], 1.0, gen, device)
    w["value_net.bias"] = torch.zeros(1, device=device)
    return w


def draws(seed: int, config: Dict, device, iterations: int = SETUP_ITERATIONS) -> List[Dict]:
    """Per iteration the draws the program and the reference take: action
    normals ``act [T, B, 1]``, the env's (xi, eta) planes ``env [T, 2, B]``
    and one permutation of the envs per epoch."""
    p = config["rppo"]
    B, T = p["num_envs"], p["num_steps"]
    gen = inputs.generator(seed, 3, device)
    out = []
    for _ in range(iterations):
        act = torch.randn((T, B, 1), generator=gen, device=device)
        env = torch.randn((T, 2, B), generator=gen, device=device)
        perms = [torch.randperm(B, generator=gen, device=device) for _ in range(p["epochs"])]
        out.append({"act": act, "env": env, "perms": perms})
    return out


def _program():
    from gym_fishing_tpu_torch.agents import ppo_rnn
    from gym_fishing_tpu_torch.batch.batch import BatchState
    from gym_fishing_tpu_torch.core.types import EnvState
    from gym_fishing_tpu_torch.registry import make
    return ppo_rnn, BatchState, EnvState, make


def prepare(config: Dict, traffic: Dict, seed: int, device) -> Dict:
    """Set-up: the program's objects, driven through SETUP_ITERATIONS
    iterations on the seed's draws, with what the check needs kept aside."""
    torch.backends.cuda.matmul.allow_tf32 = False   # the stated precision (torch's default)
    ppo_rnn, BatchState, EnvState, make = _program()
    p, env_cfg = config["rppo"], config["env"]
    env, params = make(env_cfg["id"], device=device)
    for k, want in _env_dict(config).items():
        if abs(float(getattr(params, k)) - want) > 1e-6 * max(1.0, abs(want)):
            raise ValueError(f"{env_cfg['id']}'s {k} is {float(getattr(params, k))}, not {want}")
    cfg = ppo_rnn.RPPOConfig(
        num_envs=p["num_envs"], num_steps=p["num_steps"], epochs=p["epochs"],
        num_minibatches=p["num_minibatches"], gamma=p["gamma"], gae_lambda=p["gae_lambda"],
        clip_eps=p["clip_eps"], vf_coef=p["vf_coef"], ent_coef=p["ent_coef"], lr=p["lr"],
        max_grad_norm=p["max_grad_norm"], hidden=p["hidden"], cell=p["cell"],
        net_arch=tuple(p["net_arch"]))
    ts = ppo_rnn.make_rppo_state(env, cfg, torch.Generator().manual_seed(seed % (1 << 63)),
                                 device)
    w0 = lstm_weights(seed, p["hidden"], p["net_arch"], device)
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
    run = {"ppo_rnn": ppo_rnn, "env": env, "params": params, "cfg": cfg, "ts": ts,
           "bstate": bstate, "h": ppo_rnn.init_hidden(cfg, cfg.num_envs, device),
           "gen": torch.Generator(device=device).manual_seed(seed),
           "device": torch.device(device)}
    kept = {"w0": w0, "s0": s0, "metrics": []}
    first: Dict = {}

    def keep_rollout(traj, means):
        first["rollout"] = {"mean": means[..., 0].clone(), "value": traj.value.clone()}

    def keep_step1(j, metrics, grads):
        if j == 0:
            first["loss_step1"] = float(metrics[0])
            first["grads_step1"] = {k: g.detach().float().clone() for k, g in grads.items()}

    resets = ppo_rnn.state_resets()
    replayed = []
    for i, d in enumerate(draws(seed, config, device)):
        hooks = {"on_rollout": keep_rollout, "on_minibatch": keep_step1} if i == 0 else {}
        t0 = time.perf_counter()
        metrics = _iteration(run, act_noise=d["act"], env_noise=d["env"], perms=d["perms"],
                             **hooks)
        if i > 0:
            replayed.append(time.perf_counter() - t0)
        kept["metrics"].append(metrics)
        if i == 0:
            kept["state_after"] = tuple(x.clone() for x in run["h"])
            kept["w1"] = {k: x.detach().float().clone() for k, x in run["ts"].params().items()}
    kept["w_last"] = {k: x.detach().float().clone() for k, x in run["ts"].params().items()}
    kept["resets"] = ppo_rnn.state_resets() - resets
    kept.update(first)
    if run["device"].type == "cuda":     # the slow state follows the graphs' capture
        _warm(run, min(replayed))
    run["kept"] = kept
    return run


def _warm(run: Dict, replayed_s: float) -> int:
    """Unchecked iterations until the card has left its post-capture slow
    state: one at least SLOW_DROP faster than `replayed_s` (the fastest of
    the checked iterations that replayed the graphs), and the last SETTLED
    within SETTLED_WITHIN of the fastest; or WARM_MAX. Returns how many."""
    times: List[float] = []
    while len(times) < WARM_MAX:
        t0 = time.perf_counter()
        _iteration(run)
        times.append(time.perf_counter() - t0)
        fastest = min(times)
        if (fastest < (1 - SLOW_DROP) * replayed_s and len(times) >= SETTLED
                and max(times[-SETTLED:]) <= (1 + SETTLED_WITHIN) * fastest):
            break
    return len(times)


def _iteration(run: Dict, **draws_and_hooks) -> Dict[str, float]:
    """One train step chained on the last, with its metrics read to the
    host one by one."""
    ts, bstate, h, metrics = run["ppo_rnn"].train_step(
        run["env"], run["params"], run["cfg"], run["ts"], run["bstate"], run["h"], run["gen"],
        **draws_and_hooks)
    run["ts"], run["bstate"], run["h"] = ts, bstate, h
    return {k: float(v) for k, v in metrics.items()}


def measure(run: Dict, seconds: float, tracer) -> List[List[float]]:
    """The window: iterations until `seconds` have passed; per iteration
    (start, end, env-steps, failed). off_path is the replayed steps
    expected (epochs x minibatches x T an iteration) less those counted."""
    ppo_rnn, cfg = run["ppo_rnn"], run["cfg"]
    before = ppo_rnn.replayed_steps
    units: List[List[float]] = []
    n = cfg.num_envs * cfg.num_steps
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
            break
    want = len(units) * cfg.epochs * cfg.num_minibatches * cfg.num_steps
    run["kept"]["off_path"] = float(abs(want - (ppo_rnn.replayed_steps - before)))
    return units


release = base.release


def _snapshot(w, m, v):
    return {"w": {k: x.clone() for k, x in w.items()}, "m": {k: x.clone() for k, x in m.items()}}


def _gap(prog: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap over the largest magnitude of the reference's."""
    want = want.double()
    return float((prog.to(want.device).double() - want).abs().max() / want.abs().max())


def compare(config: Dict, seed: int, device, kept: Dict) -> Dict[str, float]:
    """Run the reference over the set-up's iterations from the same weights,
    env state and draws, and return each number compared:

    - rollout_mean, rollout_value: the first rollout's action means (as
      the program's sampler took them) and values, the largest gap over
      the largest magnitude (its log-probabilities are a function of the
      drawn normals alone, so they are not compared);
    - state_after: the four LSTM states after the first rollout, the worst
      of their largest gaps over their largest magnitudes;
    - resets: the envs whose states the set-up's rollouts zeroed less the
      reference's episode ends (exact);
    - loss_step1: the first minibatch's loss, relative gap;
    - grad_step1_median, grad_step1_worst: its clipped gradients, the
      median leaf's and the worst leaf's gap of norms;
    - change_first_median: the parameters' change over the first
      iteration, the median leaf's gap, leaves whose reference gradient is
      under a thousandth of the median leaf's left out;
    - change_last_worst: the change over all the set-up's iterations, the
      worst leaf's gap, the same leaves left out;
    - off_path: the window's replayed steps expected less counted.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = [{"act": x["act"][..., 0], "env": x["env"], "perms": x["perms"]}
         for x in draws(seed, config, device, len(kept["metrics"]))]
    out = ref.run(kept["w0"], kept["s0"], _env_dict(config), config["rppo"], d,
                  keep=_snapshot)
    (m0, first), (_, last) = out[0], out[-1]
    seg, w0 = m0["segment"], kept["w0"]
    median_grad = base._median(sorted(float(x.norm()) for x in first["m"].values()))
    moved = lambda k: float(first["m"][k].norm()) >= 1e-3 * median_grad  # noqa: E731
    change = lambda w: {k: w[k].reshape(w0[k].shape) - w0[k] for k in w0}  # noqa: E731
    grads_gap = base._leaf_gaps(kept["grads_step1"], m0["grads_step1"])
    roll = kept["rollout"]
    return {
        "rollout_mean": _gap(roll["mean"], seg["mean"]),
        "rollout_value": _gap(roll["value"], seg["value"]),
        "state_after": max(_gap(p, r) for p, r in zip(kept["state_after"], m0["state_after"])),
        "resets": float(abs(kept["resets"] - sum(m["dones"] for m, _ in out))),
        "loss_step1": abs(kept["loss_step1"] - m0["loss_step1"]) / abs(m0["loss_step1"]),
        "grad_step1_median": base._median(grads_gap),
        "grad_step1_worst": grads_gap[-1],
        "change_first_median": base._median(base._leaf_gaps(change(kept["w1"]),
                                                            change(first["w"]), moved)),
        "change_last_worst": base._leaf_gaps(change(kept["w_last"]), change(last["w"]),
                                             moved)[-1],
        "off_path": float(kept["off_path"]),
    }


def control(config: Dict, traffic: Dict, seed: int, device) -> Dict[str, float]:
    """The control: the reference with every product's inputs rounded to
    TF32 (the precision below the stated float32), put in the program's
    place (its outputs kept as the program's would be), compared with the
    reference."""
    p = config["rppo"]
    w0 = lstm_weights(seed, p["hidden"], p["net_arch"], device)
    s0 = inputs.env_state(seed, p["num_envs"], _env_dict(config), device,
                          traffic["initial_year"])
    d = [{"act": x["act"][..., 0], "env": x["env"], "perms": x["perms"]}
         for x in draws(seed, config, device)]
    out = ref.run(w0, s0, _env_dict(config), p, d, ref.tf32_rounder(), keep=_snapshot)
    m0, seg = out[0][0], out[0][0]["segment"]
    kept = {"w0": w0, "s0": s0, "metrics": [m for m, _ in out],
            "rollout": {k: seg[k] for k in ("mean", "value")},
            "state_after": m0["state_after"], "resets": sum(m["dones"] for m, _ in out),
            "loss_step1": m0["loss_step1"], "grads_step1": m0["grads_step1"],
            "w1": out[0][1]["w"], "w_last": out[-1][1]["w"], "off_path": 0.0}
    return compare(config, seed, device, kept)
