"""The benchmark's plain categorical PPO reference
(``benchmark/reference/ppo_categorical.py``) against the port on the CPU,
at fishing-v0's proportional grid of 100 quotas with the medium layout
(two tanh layers a tower, the 100-class head beside the value) at hidden
32: its rollout against K4's twin from the same Philox key, its loss and
update against the port's plain categorical PPO step on the same samples
and minibatches, and two whole iterations against the port's fused train
step on the K4 and K3 twins from the same generator. It imports nothing of
the port. K4's wrapper counts its categorical launches apart.
"""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gym_fishing_tpu_torch.agents import ppo, ppo_fused
from gym_fishing_tpu_torch.batch.batch import BatchState
from gym_fishing_tpu_torch.core.types import EnvState
from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
from gym_fishing_tpu_torch.registry import make

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
HIDDEN, N_ACTIONS, NUM_ENVS, NUM_STEPS = 32, 100, 128, 8
ENV = {"n_actions": N_ACTIONS, "r": 0.3, "K": 1.0, "sigma": 0.05, "price": 1.0, "cost": 0.0,
       "init_state": 0.75, "init_harvest": 0.0125, "Tmax": 100, "action_scale": 1.0,
       "collapse_penalty": 0.0}
PPO = {"num_steps": NUM_STEPS, "epochs": 4, "num_minibatches": 8, "gamma": 0.99,
       "gae_lambda": 0.95, "clip_eps": 0.2, "lr": 3e-4, "vf_coef": 0.5, "ent_coef": 0.0,
       "max_grad_norm": 0.5, "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-5}


def _reference():
    """The reference package, imported with the benchmark's folder on the
    path only while it loads."""
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module("reference.ppo_categorical")
    finally:
        sys.path.remove(str(BENCH))


ref = _reference()


def _case(seed=7, ent_coef=0.0):
    """(env, host params, config, train state, reference weights, initial
    state): the port's categorical actor-critic with its own orthogonal
    init, the envs at the reset stock, each at its own year."""
    env, params = make("fishing-v0", device="cpu", n_actions=N_ACTIONS, sigma=ENV["sigma"])
    assert env.config.scheme == "proportional"
    cfg = ppo.PPOConfig(num_envs=NUM_ENVS, num_steps=NUM_STEPS, hidden=HIDDEN,
                        ent_coef=ent_coef, fused_update=True, fused_rollout=True,
                        fused_adam=True)
    ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed), "cpu")
    w0 = {k: x.detach().clone() for k, x in ts.params().items()}
    gen = torch.Generator().manual_seed(seed + 1)
    t = torch.randint(0, ENV["Tmax"], (NUM_ENVS,), generator=gen, dtype=torch.int32)
    s0 = {"stock": torch.full((NUM_ENVS,), ENV["init_state"]), "t": t,
          "harvest": torch.full((NUM_ENVS,), ENV["init_harvest"]),
          "ep_ret": torch.zeros(NUM_ENVS), "ep_len": t.clone()}
    return env, params, cfg, ts, w0, s0


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import reference.ppo_categorical; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, str(BENCH)], capture_output=True,
                         text=True, env=env, cwd=BENCH, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(out.stdout.split())
    assert "torch" in top
    assert not top & {"gym_fishing_tpu_torch", "gym_fishing_tpu", "jax", "jaxlib", "flax"}


def test_the_reference_rollout_is_k4s_twin():
    """From the same weights, state, Philox key and offset, the reference
    draws every class K4's twin draws, and the samples and end state agree
    to float32 rounding."""
    env, params, cfg, ts, w0, s0 = _case()
    seed, offset = 0x1234_5678_9ABC, 40
    samples, end = ref.rollout(w0, s0, ENV, PPO, seed, offset)
    roll = pk.policy_rollout_reference(
        s0["stock"], s0["t"], s0["harvest"], s0["ep_ret"], s0["ep_len"],
        ppo_fused.merged_weights(ts.params(), "categorical"),
        ppo_fused.rollout_scalars(params, seed, offset), NUM_STEPS, scheme="proportional",
        n_actions=N_ACTIONS, gamma=PPO["gamma"], gae_lambda=PPO["gae_lambda"])
    rows = dict(zip(("obs", "action", "logp", "value", "advantage", "return"), roll.packed_t))
    assert torch.equal(rows["action"], samples["action"])
    assert len(set(samples["action"].tolist())) > N_ACTIONS // 2
    for k in ("obs", "logp", "value", "advantage", "return"):
        torch.testing.assert_close(rows[k], samples[k], rtol=1e-5, atol=1e-5, msg=k)
    for k, x in (("stock", roll.stock), ("harvest", roll.harvest), ("ep_ret", roll.ep_ret)):
        torch.testing.assert_close(x, end[k], rtol=1e-5, atol=1e-6, msg=k)
    assert torch.equal(roll.t, end["t"]) and torch.equal(roll.ep_len, end["ep_len"])


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_the_reference_update_is_the_plain_categorical_ppo_step(ent_coef):
    """On the reference rollout's samples and the reference's minibatches
    (its tile permutations as sample permutations), the port's plain form
    (`ppo_loss` under autograd, clip by global norm, Adam) takes the
    reference's 32 steps."""
    env, params, cfg, ts, w0, s0 = _case(seed=11, ent_coef=ent_coef)
    cfg = ppo.PPOConfig(num_envs=NUM_ENVS, num_steps=NUM_STEPS, hidden=HIDDEN,
                        ent_coef=ent_coef)
    p = dict(PPO, ent_coef=ent_coef)
    samples, _ = ref.rollout(w0, s0, ENV, p, 99, 0)
    w = {k: x.clone() for k, x in w0.items()}
    m = {k: torch.zeros_like(x) for k, x in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    count, losses, first = ref.update(w, m, v, 0, samples, p, torch.Generator().manual_seed(5))

    n = NUM_ENVS * NUM_STEPS
    tile = ref.minibatch_tile(n // p["num_minibatches"])
    gen = torch.Generator().manual_seed(5)
    within = torch.arange(tile)
    perms = [(torch.randperm(n // tile, generator=gen)[:, None] * tile + within).reshape(-1)
             for _ in range(p["epochs"])]
    packed = torch.stack([samples[k] for k in ("obs", "action", "logp", "value", "advantage",
                                                "return")], 1)
    mb = packed[perms[0][:n // p["num_minibatches"]]]
    batch = (mb[:, :1], mb[:, 1].to(torch.int32), *mb[:, 2:].unbind(1))
    loss1, _ = ppo.ppo_loss(ts.model, cfg, batch, False)
    names = list(ts.params())
    grads = ppo.clip_by_global_norm(
        dict(zip(names, torch.autograd.grad(loss1, list(ts.params().values())))),
        cfg.max_grad_norm)
    assert float(loss1.detach()) == pytest.approx(float(losses[0]), rel=1e-6, abs=1e-7)
    for k in names:
        torch.testing.assert_close(grads[k], first[k], rtol=1e-4, atol=1e-7, msg=k)
    mets = ppo._plain_epochs(cfg, ts, packed, 1, 1, False, None, perms)
    assert count == ts.count == 32
    torch.testing.assert_close(mets["loss"], torch.stack(losses), rtol=1e-5, atol=1e-6)
    for k, x in ts.params().items():
        torch.testing.assert_close(x.detach(), w[k], rtol=0, atol=1e-6, msg=k)
        torch.testing.assert_close(ts.m[k], m[k], rtol=1e-4, atol=1e-8, msg=k)


def test_the_reference_iterations_are_the_fused_train_step_on_the_twins():
    """Two iterations of the port's train step in its main-path form
    (`fused_rollout`, `fused_update`, `fused_adam`: K4's and K3's twins on
    the CPU, float32) and of the reference, from the same weights, state and
    generator seed: the same losses, classes and weights."""
    env, params, cfg, ts, w0, s0 = _case(seed=3)
    bstate = BatchState(env=EnvState(stock=s0["stock"].clone(), harvest=s0["harvest"].clone(),
                                     t=s0["t"].clone()),
                        episode_return=s0["ep_ret"].clone(), episode_length=s0["ep_len"].clone())
    drawn = []
    collect = ppo_fused.fused_rollout_collect

    def keep(*a, **kw):
        roll, bs = collect(*a, **kw)
        drawn.append(roll.packed_t[1].clone())
        return roll, bs

    gen = torch.Generator().manual_seed(21)
    losses = []
    ppo_fused.fused_rollout_collect = keep
    try:
        for _ in range(2):
            ts, bstate, metrics = ppo.train_step(env, params, cfg, ts, bstate, gen)
            losses.append(float(metrics["loss"]))
    finally:
        ppo_fused.fused_rollout_collect = collect
    out = ref.run(w0, s0, ENV, PPO, torch.Generator().manual_seed(21), 2,
                  keep=lambda w, m, v, state: {k: x.clone() for k, x in w.items()})
    for i in range(2):
        # K4 feeds the input layer the clipped measurement through w1/K, b1 - w1
        differ = (drawn[i] != out[i][2]).float().mean()
        assert differ <= 1.0 / (NUM_ENVS * NUM_STEPS)
        assert losses[i] == pytest.approx(out[i][0]["loss"], rel=1e-5, abs=1e-7)
    moved = {k: (out[-1][1][k] - w0[k]).norm() for k in w0}
    for k, x in ts.params().items():
        gap = (x.detach() - out[-1][1][k]).norm()
        assert gap <= 1e-4 * max(moved[k], 1e-6), k


def test_k4_counts_its_categorical_launches_apart():
    """Each launch adds one to `launches`; one that draws from the
    categorical head's inverse CDF also to `categorical_launches`. The CPU
    twin launches nothing and counts nothing."""
    before = pk.launches, pk.categorical_launches
    for scheme in ("continuous", "proportional", "relative", "continuous"):
        pk._count_launch(scheme)
    assert (pk.launches, pk.categorical_launches) == (before[0] + 4, before[1] + 2)
    env, params, cfg, ts, w0, s0 = _case()
    before = pk.launches, pk.categorical_launches
    pk.policy_rollout(s0["stock"], s0["t"], s0["harvest"], s0["ep_ret"], s0["ep_len"],
                      ppo_fused.merged_weights(ts.params(), "categorical"),
                      ppo_fused.rollout_scalars(params, 1, 0), 2, scheme="proportional",
                      n_actions=N_ACTIONS)
    assert (pk.launches, pk.categorical_launches) == before
