"""The port's LSTM recurrent PPO (agents/ppo_rnn.py with ``cell="lstm"``,
sb3-contrib's MlpLstmPolicy) against the benchmark's plain reference
(``benchmark/reference/rppo_lstm.py``) on the CPU, on fishing-v2 at a small
size: hidden 16, MLPs [8, 8], 8 envs, 12 steps, the envs' years near Tmax
so that every segment holds an episode boundary.

Both sides start from the port's seeded weights and take the same draws.
Tolerances are float32 ones, the two sides computing the same equations in
another order: the LSTM step to 1e-6; the rollout's actions, values and
log-probabilities and the states after it to 1e-6; the loss and its
gradients to 1e-5 relative; the parameters and Adam's moments after one
train step to 1e-5 relative (moments: beside an absolute floor of a
millionth of the leaf's largest entry). Replay against collection is exact:
the same operations on the same shapes.
"""

import dataclasses
import functools
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo_rnn
from gym_fishing_tpu_torch.agents.ppo import action_logp_entropy, compute_gae
from gym_fishing_tpu_torch.batch import BatchState
from gym_fishing_tpu_torch.core.types import EnvState

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
make = functools.partial(gtt.make, device="cpu")
torch.set_num_threads(1)

CFG = ppo_rnn.RPPOConfig(num_envs=8, num_steps=12, epochs=4, num_minibatches=4, hidden=16,
                         cell="lstm", net_arch=(8, 8), ent_coef=0.01)
ENV = {"r": 0.3, "K": 1.0, "sigma": 0.05, "sigma_m": 0.05, "price": 1.0, "cost": 0.0,
       "init_state": 0.75, "init_harvest": 0.0125, "Tmax": 100, "action_scale": 1.0,
       "collapse_penalty": 0.0}
RPPO = {"num_steps": CFG.num_steps, "epochs": CFG.epochs,
        "num_minibatches": CFG.num_minibatches, "gamma": CFG.gamma,
        "gae_lambda": CFG.gae_lambda, "clip_eps": CFG.clip_eps, "lr": CFG.lr,
        "vf_coef": CFG.vf_coef, "ent_coef": CFG.ent_coef, "max_grad_norm": CFG.max_grad_norm,
        "adam_b1": 0.9, "adam_b2": 0.999, "adam_eps": 1e-5}


def _reference():
    """The reference module, imported with the benchmark's folder on the
    path only while it loads."""
    sys.path.insert(0, str(BENCH))
    try:
        return importlib.import_module("reference.rppo_lstm")
    finally:
        sys.path.remove(str(BENCH))


ref = _reference()


def _case(seed=3):
    """(env, params, train state, reference weights, env state, draws): the
    port's LSTM actor-critic from its own seeded initialisation, the envs at
    the reset stock at years 90 .. 99 of 100."""
    env, params = make("fishing-v2")
    ts = ppo_rnn.make_rppo_state(env, CFG, torch.Generator().manual_seed(seed), "cpu")
    w0 = {k: x.detach().clone() for k, x in ts.params().items()}
    gen = torch.Generator().manual_seed(seed + 1)
    B, T = CFG.num_envs, CFG.num_steps
    t = torch.randint(90, 100, (B,), generator=gen, dtype=torch.int32)
    s0 = {"stock": torch.full((B,), 0.75), "t": t, "ep_ret": torch.zeros(B), "ep_len": t.clone()}
    draws = {"act": torch.randn((T, B, 1), generator=gen),
             "env": torch.randn((T, 2, B), generator=gen),
             "perms": [torch.randperm(B, generator=gen) for _ in range(CFG.epochs)]}
    return env, params, ts, w0, s0, draws


def _bstate(s0):
    return BatchState(env=EnvState(stock=s0["stock"].clone(),
                                   harvest=torch.full_like(s0["stock"], 0.0125),
                                   t=s0["t"].clone()),
                      episode_return=s0["ep_ret"].clone(), episode_length=s0["ep_len"].clone())


def _ref_draws(draws):
    return [{"act": draws["act"][:, :, 0], "env": draws["env"], "perms": draws["perms"]}]


def _collect(env, params, ts, s0, draws):
    return ppo_rnn.collect_rollout(env, params, CFG, ts.model, _bstate(s0),
                                   ppo_rnn.init_hidden(CFG, CFG.num_envs, "cpu"),
                                   act_noise=draws["act"], env_noise=draws["env"])


def _check_cell():
    """One LSTM step of the port's cell against the reference's equations
    and torch.nn.LSTM, on random weights (biases included) and inputs."""
    gen = torch.Generator().manual_seed(0)
    cell = ppo_rnn.LSTMCell(3, 16, gen)
    x, h, c = (torch.randn((32, n), generator=gen) for n in (3, 16, 16))
    with torch.no_grad():
        got_h, got_c = cell(x, (h, c))
        w = {f"cell.{k}": p for k, p in cell.named_parameters()}
        want_h, want_c = ref.lstm_step(w, "cell", x, h, c)
        lstm = torch.nn.LSTM(3, 16)
        for k, p in cell.named_parameters():
            getattr(lstm, f"{k}_l0").copy_(p)
        _, (lstm_h, lstm_c) = lstm(x[None], (h[None], c[None]))
    for got, want in ((got_h, want_h), (got_c, want_c), (got_h, lstm_h[0]),
                      (got_c, lstm_c[0])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _check_rollout():
    """The rollout's actions, values, log-probabilities, dones and rewards,
    and the four states after it."""
    env, params, ts, w0, s0, draws = _case()
    _, _, h_last, _, traj, _ = _collect(env, params, ts, s0, draws)
    zeros = tuple(torch.zeros((CFG.num_envs, CFG.hidden)) for _ in range(4))
    seg, _, state, _ = ref.rollout(w0, s0, zeros, ENV, RPPO, draws["act"][:, :, 0],
                                   draws["env"])
    assert bool(seg["done"].any()) and not bool(seg["done"].all())
    np.testing.assert_array_equal(traj.done.numpy(), seg["done"].numpy())
    for name in ("action", "value", "logp", "reward", "obs"):
        got = getattr(traj, name).reshape(seg[name].shape)
        np.testing.assert_allclose(got.numpy(), seg[name].numpy(), rtol=0, atol=1e-6,
                                   err_msg=name)
    for got, want in zip(h_last, state):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


def _check_loss_and_grads():
    """The clipped loss over a minibatch of whole segments replayed from
    their start states, and its gradients, from the port's rollout."""
    env, params, ts, w0, s0, draws = _case()
    _, _, _, h_start, traj, last_value = _collect(env, params, ts, s0, draws)
    adv, ret = compute_gae(CFG, traj, last_value)
    envs = draws["perms"][0][:4]
    batch = (traj.obs[:, envs], traj.action[:, envs], traj.done[:, envs], traj.logp[:, envs],
             traj.value[:, envs], adv[:, envs], ret[:, envs], tuple(s[envs] for s in h_start))
    loss, _ = ppo_rnn.rppo_loss(ts.model, CFG, batch, continuous=True)
    grads = dict(zip(ts.params(), torch.autograd.grad(loss, list(ts.model.parameters()))))
    seg = {"obs": traj.obs[:, envs, 0], "action": traj.action[:, envs, 0],
           "done": traj.done[:, envs], "logp": traj.logp[:, envs], "value": traj.value[:, envs],
           "advantage": adv[:, envs], "return": ret[:, envs]}
    w = {k: x.clone().requires_grad_(True) for k, x in w0.items()}
    want = ref.segment_loss(w, seg, tuple(s[envs] for s in h_start), RPPO)
    want_grads = dict(zip(w, torch.autograd.grad(want, list(w.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(want.detach()), rtol=1e-5)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12, err_msg=k)


def _check_train_step():
    """One train step's parameters and Adam moments (4 epochs x 4
    minibatches of two segments) and the first minibatch's clipped
    gradients."""
    env, params, ts, w0, s0, draws = _case()
    first = {}

    def keep_first(j, metrics, grads):
        if j == 0:
            first.update({k: g.clone() for k, g in grads.items()}, loss=float(metrics[0]))

    ts, _, _, metrics = ppo_rnn.train_step(
        env, params, CFG, ts, _bstate(s0), ppo_rnn.init_hidden(CFG, CFG.num_envs, "cpu"),
        perms=draws["perms"], act_noise=draws["act"], env_noise=draws["env"],
        on_minibatch=keep_first)
    snap = lambda w, m, v: {"w": dict(w), "m": dict(m), "v": dict(v)}  # noqa: E731
    ((want_metrics, want),) = ref.run(w0, s0, ENV, RPPO, _ref_draws(draws), keep=snap)
    assert ts.count == ts.step == CFG.epochs * CFG.num_minibatches
    np.testing.assert_allclose(float(metrics["loss"]), want_metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(first.pop("loss"), want_metrics["loss_step1"], rtol=1e-5)
    for k, g in want_metrics["grads_step1"].items():
        np.testing.assert_allclose(first[k].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()) + 1e-12, err_msg=k)
    for name, got in (("w", ts.params()), ("m", ts.m), ("v", ts.v)):
        for k, x in want[name].items():
            np.testing.assert_allclose(got[k].detach().numpy(), x.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(x.abs().max()) + 1e-12,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("part", ["cell", "rollout", "loss_and_grads", "train_step"])
def test_lstm_learner_agrees_with_the_plain_reference(part):
    {"cell": _check_cell, "rollout": _check_rollout, "loss_and_grads": _check_loss_and_grads,
     "train_step": _check_train_step}[part]()


def test_replay_matches_collection_exactly():
    """Replaying the whole collected segment from its start states with the
    done-reset convention gives the collection's log-probs and values."""
    env, params, ts, _, s0, draws = _case()
    _, _, _, h_start, traj, _ = _collect(env, params, ts, s0, draws)
    assert bool(traj.done.any())
    with torch.no_grad():
        dists, values = ppo_rnn.replay_sequence(ts.model, traj.obs, traj.done, h_start)
        logp, _ = action_logp_entropy(dists, traj.action, continuous=True)
    np.testing.assert_array_equal(logp.numpy(), traj.logp.numpy())
    np.testing.assert_array_equal(values.numpy(), traj.value.numpy())


def test_every_state_is_zeroed_where_an_episode_starts():
    """After a done step all four states of the env are zero, the others'
    are not, and the reset counter moves by the rollout's done count."""
    env, params, ts, _, s0, draws = _case()
    before = ppo_rnn.state_resets()
    _, _, h_last, _, traj, _ = _collect(env, params, ts, s0, draws)
    assert ppo_rnn.state_resets() - before == int(traj.done.sum())
    last = traj.done[-1]
    assert bool(last.any()) and not bool(last.all())
    for s in h_last:
        assert bool((s[last] == 0).all()) and bool((s[~last] != 0).all())
    # the zeroing itself, on any state
    state = tuple(torch.ones((3, 4)) * k for k in range(1, 5))
    out = ppo_rnn._zero_done(state, torch.tensor([True, False, True]))
    for k, s in enumerate(out, start=1):
        np.testing.assert_array_equal(s.numpy(), np.array([[0.0] * 4, [k] * 4, [0.0] * 4]))


def test_predict_threads_the_states_of_both_networks():
    env, params, ts, w0, _, _ = _case()
    pol = ppo_rnn.RecurrentPPOPolicy(env, ts, CFG)
    obs = np.full((4, 1), -0.25, np.float32)
    a1, s1 = pol.predict(obs)
    assert a1.shape == (4, 1) and len(s1) == 4 and all(s.shape == (4, 16) for s in s1)
    mean, _, want = ref.forward(w0, torch.from_numpy(obs[:, 0]),
                                tuple(torch.zeros((4, 16)) for _ in range(4)))
    np.testing.assert_allclose(a1[:, 0], mean.numpy(), rtol=0, atol=1e-6)
    for got, w in zip(s1, want):
        np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-6)
    a2, s2 = pol.predict(obs, state=s1)
    assert all(not np.allclose(x, y) for x, y in zip(s1, s2))   # both networks evolve
    start = np.array([True, False, True, False])
    _, s3 = pol.predict(obs, state=s1, episode_start=start)
    for x1, x2, x3 in zip(s1, s2, s3):
        np.testing.assert_array_equal(x3[start], x1[start])   # reset, then one step
        np.testing.assert_array_equal(x3[~start], x2[~start])


def test_train_runs_the_lstm_and_counts_its_replays():
    env, params = make("fishing-v2")
    cfg = dataclasses.replace(CFG, num_envs=16, num_steps=8, epochs=2, num_minibatches=2)
    before = ppo_rnn.replayed_steps
    ts, hist = ppo_rnn.train(env, cfg, iterations=2, env_params=params, seed=0, device="cpu")
    assert len(hist) == 2 and all(np.isfinite(x["loss"]) for x in hist)
    assert ts.count == 2 * 2 * 2
    assert ppo_rnn.replayed_steps - before == 2 * 2 * 2 * cfg.num_steps
    names = set(ts.params())
    assert {"lstm_actor.weight_hh", "lstm_critic.bias_hh", "pi_mlp.1.weight",
            "vf_mlp.0.bias", "action_net.weight", "value_net.bias", "log_std"} <= names
    with pytest.raises(ValueError, match="no such cell"):
        ppo_rnn.make_rppo_state(env, dataclasses.replace(cfg, cell="rnn"), device="cpu")


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_the_learners_buffers_are_dropped_with_the_model(cell):
    """The rollout's and the update's buffers (on the card, their CUDA graphs
    and memory pools) are kept per model and go with it: nothing they hold
    keeps the model alive."""
    import gc
    import weakref

    env, params = make("fishing-v2")
    cfg = dataclasses.replace(CFG, cell=cell, epochs=1, num_minibatches=2)
    ts = ppo_rnn.make_rppo_state(env, cfg, torch.Generator().manual_seed(0), "cpu")
    ppo_rnn.train_step(env, params, cfg, ts, ppo_rnn.batched_reset(env, params, cfg.num_envs,
                                                                   "cpu"),
                       ppo_rnn.init_hidden(cfg, cfg.num_envs, "cpu"),
                       torch.Generator().manual_seed(1))
    model = weakref.ref(ts.model)
    assert model() in ppo_rnn._rollouts and model() in ppo_rnn._updates
    del ts
    gc.collect()
    assert model() is None
