"""The port's fused-rollout twin against the JAX Pallas kernel and the engine.

On the CPU the port's `rollout` wrapper runs its plain twin
(`rollout_reference`), the float32 PyTorch version of the CUDA kernel.

- Twin vs JAX `pallas_rollout(..., interpret=True)`, over the cases of
  tests/test_kernels.py at its tolerances (stock 2e-6, reward 2e-5, t and
  ep_count exact). The Mosaic interpreter's PRNG yields zero bits on the
  CPU, so the JAX kernel draws z = 0 (confirmed below): the twin is fed zero
  noise planes, which also covers sigma > 0.
- Twin with non-zero noise planes vs the port's engine (`batched_step` with
  auto-reset) fed the same planes, in float32.
- The twin's Philox4x32-10 stream: published known-answer vectors, the
  documented draw order, and chained calls that never replay a stream.

The CUDA kernel itself is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_fishing_tpu as gft
import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu.kernels import make_scalars, pallas_rollout
from gym_fishing_tpu_torch.agents.policies import escapement
from gym_fishing_tpu_torch.batch import batched_reset, batched_step
from gym_fishing_tpu_torch.bench import rollout_instructions
from gym_fishing_tpu_torch.convert import params_from_numpy
from gym_fishing_tpu_torch.kernels import rollout_kernel as rk
from gym_fishing_tpu_torch.spaces.scaling import encode_action

# the port's entry points default to the card; these tests run on the CPU
make = functools.partial(gtt.make, device="cpu")

torch.set_num_threads(1)

B = 1 * 8 * 128  # one (8, 128) f32 tile of the JAX kernel
STOCK_ATOL, REWARD_ATOL = 2e-6, 2e-5  # tests/test_kernels.py


def port_params(jparams, dtype=torch.float32):
    return params_from_numpy(
        {f.name: np.asarray(getattr(jparams, f.name)) for f in dataclasses.fields(jparams)},
        dtype, "cpu",
    )


def jax_kernel(env, params, policy, param, T, stock0, scheme="continuous", **kw):
    scalars = make_scalars(params, param, seed=3, n_actions=env.config.n_actions)
    return pallas_rollout(
        jnp.asarray(stock0, jnp.float32), kw.pop("t", jnp.zeros((B,), jnp.int32)),
        scalars, T, rows_per_block=8, growth=env.config.growth,
        noise_form=env.config.noise_form, policy=policy, scheme=scheme,
        interpret=True, **kw,
    )


def twin(env, params, policy, param, T, stock0, scheme="continuous", obs_noise=False,
         noise=None, t=None, ep_ret=None, harvest=None, **kw):
    stock = torch.as_tensor(np.asarray(stock0), dtype=torch.float32)
    if noise is None:  # the JAX interpreter's draws: z = eta = 0
        noise = torch.zeros((2 if obs_noise else 1, T, B), dtype=torch.float32)
    return rk.rollout(
        stock, torch.zeros(B, dtype=torch.int32) if t is None else t,
        port_params(params), policy, param, T, growth=env.config.growth,
        noise_form=env.config.noise_form, scheme=scheme,
        n_actions=env.config.n_actions, obs_noise=obs_noise, noise=noise,
        ep_ret=ep_ret, harvest=harvest, **kw,
    )


def assert_same(tw, jk, stock_atol=STOCK_ATOL, reward_atol=REWARD_ATOL):
    np.testing.assert_allclose(tw.stock.numpy(), np.asarray(jk.stock), atol=stock_atol)
    np.testing.assert_array_equal(tw.t.numpy(), np.asarray(jk.t))
    np.testing.assert_allclose(tw.reward.numpy(), np.asarray(jk.reward), atol=reward_atol)
    np.testing.assert_allclose(tw.ep_ret_sum.numpy(), np.asarray(jk.ep_ret_sum), atol=reward_atol)
    np.testing.assert_allclose(tw.ep_ret.numpy(), np.asarray(jk.ep_ret), atol=reward_atol)
    np.testing.assert_array_equal(tw.ep_count.numpy(), np.asarray(jk.ep_count))
    np.testing.assert_allclose(tw.harvest.numpy(), np.asarray(jk.harvest), atol=stock_atol)


def uniform_stock(seed):
    return np.random.default_rng(seed).uniform(0.3, 1.2, B).astype(np.float32)


# ------------------------------------------------- twin vs JAX pallas_rollout


@pytest.mark.parametrize("sigma", [0.0, 0.05])
@pytest.mark.parametrize(
    "growth,r", [("logistic", 0.3), ("ricker", 0.3), ("beverton_holt", 0.3),
                 ("allen", 0.3), ("may", 0.75), ("myers", 3.0)]
)
def test_twin_matches_jax_kernel_per_growth_model(growth, r, sigma):
    env, params = gft.make(
        "fishing-v1", dtype=jnp.float32, sigma=sigma, r=r, growth=growth, Tmax=13
    )
    stock0 = uniform_stock(0)
    if growth == "myers":
        # below ~0.4 myers declines through float32 denormals to 0 (a
        # collapse); XLA on the CPU flushes denormals to zero and torch does
        # not, so the collapse step differs. Start where the stock persists.
        stock0 = np.maximum(stock0, np.float32(0.5))
    assert_same(twin(env, params, "escapement", 0.5, 30, stock0),
                jax_kernel(env, params, "escapement", 0.5, 30, stock0))


@pytest.mark.parametrize("growth", ["logistic", "ricker"])
def test_twin_matches_jax_kernel_lognormal_noise(growth):
    env, params = gft.make(
        "fishing-v1", dtype=jnp.float32, sigma=0.1, growth=growth,
        noise_form="lognormal", Tmax=13,
    )
    stock0 = uniform_stock(5)
    assert_same(twin(env, params, "escapement", 0.5, 30, stock0),
                jax_kernel(env, params, "escapement", 0.5, 30, stock0))


@pytest.mark.parametrize("model_idx", [3, 2.9, 5])
def test_twin_matches_jax_kernel_mixture(model_idx):
    """model_idx selects the model; a non-integer index truncates/floors to
    the same model on both sides."""
    env, params = gft.make(
        "fishing-v1", dtype=jnp.float32, sigma=0.0, growth="mixture",
        model_idx=model_idx, Tmax=13,
    )
    stock0 = uniform_stock(1)
    assert_same(twin(env, params, "escapement", 0.5, 30, stock0),
                jax_kernel(env, params, "escapement", 0.5, 30, stock0))


def test_twin_matches_jax_kernel_constant_mortality():
    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.0, Tmax=50)
    stock0 = np.full(B, 0.75, np.float32)
    tw = twin(env, params, "constant_mortality", 0.15, 40, stock0)
    assert_same(tw, jax_kernel(env, params, "constant_mortality", 0.15, 40, stock0))
    # per-step reward approaches r*K/4 at the MSY equilibrium
    assert float(tw.reward.mean()) / 40 == pytest.approx(0.075, abs=0.01)


@pytest.mark.parametrize("policy,param", [("escapement", 0.5), ("constant_mortality", 0.15)])
def test_twin_matches_jax_kernel_relative_scheme(policy, param):
    env, params = gft.make("fishing-v0", dtype=jnp.float32, sigma=0.0, Tmax=13)
    assert env.config.scheme == "relative"
    stock0 = uniform_stock(1)
    assert_same(twin(env, params, policy, param, 30, stock0, scheme="relative"),
                jax_kernel(env, params, policy, param, 30, stock0, scheme="relative"))


def test_twin_matches_jax_kernel_relative_scheme_chained():
    env, params = gft.make("fishing-v0", dtype=jnp.float32, sigma=0.0, Tmax=50)
    stock0 = np.full(B, 0.75, np.float32)
    j1 = jax_kernel(env, params, "escapement", 0.5, 10, stock0, scheme="relative")
    j2 = jax_kernel(env, params, "escapement", 0.5, 10, j1.stock, scheme="relative",
                    t=j1.t, ep_ret=j1.ep_ret, harvest=j1.harvest)
    t1 = twin(env, params, "escapement", 0.5, 10, stock0, scheme="relative")
    t2 = twin(env, params, "escapement", 0.5, 10, t1.stock, scheme="relative",
              t=t1.t, ep_ret=t1.ep_ret, harvest=t1.harvest)
    assert_same(t1, j1)
    assert_same(t2, j2)


def test_twin_matches_jax_kernel_autoreset_at_Tmax():
    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.0, Tmax=7)
    stock0 = np.full(B, 0.75, np.float32)
    tw = twin(env, params, "constant", 0.02, 20, stock0)
    assert_same(tw, jax_kernel(env, params, "constant", 0.02, 20, stock0))
    assert (tw.t.numpy() == 6).all() and (tw.ep_count.numpy() == 2).all()
    np.testing.assert_allclose(tw.ep_ret_sum.numpy(), 2 * 7 * 0.02, atol=1e-5)


def test_twin_matches_jax_kernel_harvest_cost():
    env, params = gft.make(
        "fishing-v1", dtype=jnp.float32, sigma=0.0, growth="ricker", cost=0.35, Tmax=17
    )
    stock0 = uniform_stock(2)
    tw = twin(env, params, "constant_mortality", 0.12, 30, stock0)
    assert_same(tw, jax_kernel(env, params, "constant_mortality", 0.12, 30, stock0))
    free = twin(env, params.replace(cost=0.0), "constant_mortality", 0.12, 30, stock0)
    assert float(tw.reward.mean()) < float(free.reward.mean()) - 1e-4


def test_twin_matches_jax_kernel_proportional_scheme():
    env, params = gft.make("fishing-v0", dtype=jnp.float32, sigma=0.0, Tmax=19, n_actions=10)
    assert env.config.scheme == "proportional"
    stock0 = uniform_stock(3)
    tw = twin(env, params, "escapement", 0.5, 30, stock0, scheme="proportional")
    assert_same(tw, jax_kernel(env, params, "escapement", 0.5, 30, stock0,
                               scheme="proportional"))
    cont = twin(env, params, "escapement", 0.5, 30, stock0)
    assert not np.allclose(tw.stock.numpy(), cont.stock.numpy(), atol=1e-4)


def test_twin_chained_rollouts_resume_exactly():
    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.0, Tmax=9)
    stock0 = np.full(B, 0.9, np.float32)
    whole = twin(env, params, "constant", 0.05, 24, stock0)
    first = twin(env, params, "constant", 0.05, 12, stock0)
    second = twin(env, params, "constant", 0.05, 12, first.stock, t=first.t,
                  ep_ret=first.ep_ret)
    assert_same(whole, jax_kernel(env, params, "constant", 0.05, 24, stock0))
    np.testing.assert_allclose(second.stock.numpy(), whole.stock.numpy(), atol=1e-6)
    np.testing.assert_array_equal(second.t.numpy(), whole.t.numpy())
    np.testing.assert_allclose((first.ep_ret_sum + second.ep_ret_sum).numpy(),
                               whole.ep_ret_sum.numpy(), atol=1e-5)
    np.testing.assert_array_equal((first.ep_count + second.ep_count).numpy(),
                                  whole.ep_count.numpy())


def test_twin_matches_jax_kernel_obs_noise():
    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.05, sigma_m=0.1, Tmax=13)
    stock0 = np.full(B, 0.8, np.float32)
    assert_same(twin(env, params, "escapement", 0.5, 20, stock0, obs_noise=True),
                jax_kernel(env, params, "escapement", 0.5, 20, stock0, obs_noise=True))


def test_twin_matches_jax_kernel_collapse_penalty():
    env, params = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.0, collapse_penalty=2.5)
    stock0 = np.full(B, 0.75, np.float32)
    tw = twin(env, params, "constant", 2.0, 2, stock0)
    assert_same(tw, jax_kernel(env, params, "constant", 2.0, 2, stock0))
    np.testing.assert_allclose(tw.reward.numpy(), 0.75 - 2.5 + 0.75 - 2.5, atol=1e-6)


def test_twin_matches_jax_kernel_nonstationary_drift():
    env, params = gft.make("fishing-nonstationary-v1", dtype=jnp.float32, sigma=0.0, Tmax=13)
    stock0 = uniform_stock(4)
    assert_same(twin(env, params, "escapement", 0.5, 30, stock0),
                jax_kernel(env, params, "escapement", 0.5, 30, stock0))


def test_jax_interpreter_draws_zero_noise():
    """The premise of the zero planes: in interpret mode on the CPU the JAX
    kernel's PRNG gives zero bits, hence z = 0, so sigma does not matter."""
    env0, p0 = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.0, Tmax=13)
    env1, p1 = gft.make("fishing-v1", dtype=jnp.float32, sigma=0.3, Tmax=13)
    stock0 = uniform_stock(6)
    a = jax_kernel(env0, p0, "escapement", 0.5, 20, stock0)
    b = jax_kernel(env1, p1, "escapement", 0.5, 20, stock0)
    np.testing.assert_array_equal(np.asarray(a.stock), np.asarray(b.stock))
    np.testing.assert_array_equal(np.asarray(a.reward), np.asarray(b.reward))


# ------------------------------------------- twin vs the port's engine (f32)


def engine_reference(env, params, quota_fn, T, stock0, noise, obs_noise=False):
    """The port's batched_step with auto-reset, driven by the same planes;
    the policy reads the (optionally measured) true stock as the kernel's
    does. Returns a KernelRollout-shaped tuple."""
    state = batched_reset(env, params, B)
    state = state.replace(env=state.env.replace(stock=torch.as_tensor(stock0)))
    rew = torch.zeros(B)
    eps = torch.zeros(B)
    epc = torch.zeros(B, dtype=torch.int32)
    for k in range(T):
        eta = noise[1, k] if obs_noise else torch.zeros(B)
        x_obs = state.env.stock * torch.exp(params.sigma_m * eta) if obs_noise else state.env.stock
        action = encode_action(env.config, params, state.env.harvest, quota_fn(x_obs))
        state, ts = batched_step(env, params, state, action, torch.stack([noise[0, k], eta]))
        rew = rew + ts.reward
        eps = eps + torch.where(ts.done, ts.episode_return, torch.zeros(()))
        epc = epc + ts.done.to(torch.int32)
    return state, rew, eps, epc


def planes(seed, n, T):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, T, B)).astype(np.float32))


@pytest.mark.parametrize("noise_form", ["additive", "lognormal"])
@pytest.mark.parametrize(
    "growth,r", [("logistic", 0.3), ("ricker", 0.3), ("beverton_holt", 0.3),
                 ("allen", 0.3), ("myers", 2.0), ("may", 0.75), ("mixture", 0.3)]
)
def test_twin_matches_port_engine_with_noise_planes(growth, r, noise_form):
    env, params = make("fishing-v1", sigma=0.1, r=r, growth=growth,
                           noise_form=noise_form, Tmax=13, model_idx=1)
    stock0 = uniform_stock(7)
    noise = planes(8, 1, 30)
    tw = twin(env, params, "escapement", 0.5, 30, stock0, noise=noise)
    state, rew, eps, epc = engine_reference(
        env, params, lambda x: torch.clamp(x - 0.5, min=0.0), 30, stock0, noise
    )
    np.testing.assert_allclose(tw.stock.numpy(), state.env.stock.numpy(), atol=STOCK_ATOL)
    np.testing.assert_array_equal(tw.t.numpy(), state.env.t.numpy())
    np.testing.assert_allclose(tw.reward.numpy(), rew.numpy(), atol=REWARD_ATOL)
    np.testing.assert_allclose(tw.ep_ret_sum.numpy(), eps.numpy(), atol=REWARD_ATOL)
    np.testing.assert_allclose(tw.ep_ret.numpy(), state.episode_return.numpy(), atol=REWARD_ATOL)
    np.testing.assert_array_equal(tw.ep_count.numpy(), epc.numpy())


@pytest.mark.parametrize(
    "env_id,scheme,policy,param,overrides",
    [
        ("fishing-v0", "relative", "escapement", 0.5, {}),
        ("fishing-v0", "relative", "constant_mortality", 0.15, {"cost": 0.2}),
        ("fishing-v0", "proportional", "escapement", 0.5, {"n_actions": 10}),
        ("fishing-may-obs-v1", "continuous", "escapement", 0.4, {"sigma_m": 0.1}),
        ("fishing-nonstationary-v1", "continuous", "constant_mortality", 0.1, {}),
    ],
)
def test_twin_matches_port_engine_schemes_and_obs_noise(env_id, scheme, policy, param, overrides):
    env, params = make(env_id, sigma=0.1, Tmax=11, **overrides)
    assert env.config.scheme == scheme
    obs_noise = float(params.sigma_m) > 0
    quota_fn = {
        "escapement": lambda x: torch.clamp(x - param, min=0.0),
        "constant_mortality": lambda x: param * x,
    }[policy]
    stock0 = uniform_stock(9)
    noise = planes(10, 2 if obs_noise else 1, 30)
    tw = twin(env, params, policy, param, 30, stock0, scheme=scheme, obs_noise=obs_noise,
              noise=noise)
    state, rew, eps, epc = engine_reference(env, params, quota_fn, 30, stock0, noise, obs_noise)
    np.testing.assert_allclose(tw.stock.numpy(), state.env.stock.numpy(), atol=STOCK_ATOL)
    np.testing.assert_array_equal(tw.t.numpy(), state.env.t.numpy())
    np.testing.assert_allclose(tw.reward.numpy(), rew.numpy(), atol=REWARD_ATOL)
    np.testing.assert_allclose(tw.ep_ret_sum.numpy(), eps.numpy(), atol=REWARD_ATOL)
    np.testing.assert_array_equal(tw.ep_count.numpy(), epc.numpy())
    if scheme == "relative":
        np.testing.assert_allclose(tw.harvest.numpy(), state.env.harvest.numpy(), atol=STOCK_ATOL)


def test_kernel_policy_reads_unclipped_stock_unlike_engine_obs():
    """The kernel's escapement reads the raw stock; the engine's policy sees
    an obs clipped to [-1, 1], i.e. at most 2K of stock. Under myers at r=3
    (asymptote rK = 3) noise lifts the stock past 2K: exactly the envs that
    passed 2K part, the others agree."""
    env, params = make("fishing-myers-v1", sigma=0.03, Tmax=50)
    assert float(params.r) == 3.0
    pol = escapement(env, params)
    noise = planes(12, 1, 6)
    tw = twin(env, params, "escapement", float(pol.x_star), 6, np.full(B, 0.75, np.float32),
              noise=noise)
    state = batched_reset(env, params, B)
    obs = env.get_obs(params, state.env)
    peak = state.env.stock.clone()
    for k in range(6):
        state, ts = batched_step(env, params, state, pol.act(obs),
                                 torch.stack([noise[0, k], torch.zeros(B)]))
        obs = ts.obs
        peak = torch.maximum(peak, state.env.stock)
    passed = (peak > 2.0 * float(params.K)).numpy()
    assert 0.05 < passed.mean() < 0.95
    gap = np.abs(tw.stock.numpy() - state.env.stock.numpy())
    assert gap[passed].max() > 1e-2
    assert gap[~passed].max() <= STOCK_ATOL


# ------------------------------------------------------------- Philox stream


@pytest.mark.parametrize(
    "ctr,key,expected",
    [  # Random123's published Philox4x32-10 known-answer vectors
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(ctr, key, expected):
    out = rk._philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(o) for o in out) == expected


def test_uniform_from_bits_matches_jax_kernel_transform():
    bits = np.random.default_rng(0).integers(0, 2**32, size=100_000, dtype=np.uint32)
    expected = 2.0 - ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = rk._uniform_from_bits(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(u.numpy(), expected)
    assert u.min() > 0.0 and u.max() <= 1.0


def test_philox_normals_statistics():
    z = rk.philox_normals(seed=12345, offset=7, num_envs=1 << 16, device="cpu").double()
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n**0.5
    assert abs(float(z.std()) - 1.0) < 5 * (0.5 / n) ** 0.5
    assert abs(float((z**3).mean())) < 5 * (15 / n) ** 0.5
    # neighbouring envs and the four draws of one block are uncorrelated
    for a, b in ((z[0, :-1], z[0, 1:]), (z[0], z[1]), (z[0], z[2])):
        assert abs(float(torch.corrcoef(torch.stack([a, b]))[0, 1])) < 5 / a.numel() ** 0.5


@pytest.mark.parametrize("obs_noise,T", [(False, 8), (False, 10), (True, 6), (True, 7)])
def test_twin_seeded_stream_is_the_documented_draw_order(obs_noise, T):
    """From a seed the twin uses Philox block (env, offset + d): without
    obs_noise its four normals feed four steps, with it the pairs (z, eta)
    feed two. Rebuilt as planes, the same stream gives the same rollout."""
    env, params = make("fishing-v1", sigma=0.1, sigma_m=0.1, Tmax=5)
    stock0 = uniform_stock(11)
    seed, offset = 2**40 + 3, 2**33 - 1
    idx = torch.arange(B, dtype=torch.int64)
    ndraws = rk.draws_per_call(T, obs_noise)
    z = torch.cat([torch.stack(rk._philox_normals_reference(seed, offset + d, idx))
                   for d in range(ndraws)])  # [4 * ndraws, B]
    noise = torch.stack([z[0::2][:T], z[1::2][:T]]) if obs_noise else z[:T][None]
    a = rk.rollout(torch.from_numpy(stock0), torch.zeros(B, dtype=torch.int32), params,
                   "escapement", 0.5, T, obs_noise=obs_noise, seed=seed, offset=offset)
    b = twin(env, params, "escapement", 0.5, T, stock0, obs_noise=obs_noise,
             noise=noise.contiguous())
    for x, y in zip(a[:7], b[:7]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.next_offset == offset + ndraws and b.next_offset == 0


def test_chained_calls_draw_fresh_noise():
    env, params = make("fishing-v1", sigma=0.1)
    stock = torch.full((B,), 0.75)
    t = torch.zeros(B, dtype=torch.int32)
    first = rk.rollout(stock, t, params, "escapement", 0.5, 10, seed=1, offset=0)
    assert first.next_offset == rk.draws_per_call(10, False) == 3
    again = rk.rollout(stock, t, params, "escapement", 0.5, 10, seed=1, offset=0)
    fresh = rk.rollout(stock, t, params, "escapement", 0.5, 10, seed=1,
                       offset=first.next_offset)
    torch.testing.assert_close(again.stock, first.stock, rtol=0, atol=0)
    assert (fresh.stock != first.stock).float().mean() > 0.99


# ------------------------------------------------------------------ wrapper


@pytest.mark.parametrize(
    "change,message",
    [
        ({"stock": torch.zeros(B, dtype=torch.float64)}, "stock must be"),
        ({"t": torch.zeros(B, dtype=torch.int64)}, "t must be"),
        ({"stock": torch.zeros(2 * B)[::2]}, "contiguous"),
        ({"num_steps": 7}, "even"),
        ({"policy": "greedy"}, "unknown policy"),
        ({"scheme": "grid"}, "unknown scheme"),
        ({"growth": "gompertz"}, "unknown growth"),
        ({"noise": torch.zeros(2, 10, B)}, "noise must be"),
        ({"seed": -1}, "unsigned"),
    ],
)
def test_wrapper_rejects_bad_arguments(change, message):
    env, params = make("fishing-v1")
    args = dict(stock=torch.zeros(B), t=torch.zeros(B, dtype=torch.int32), params=params,
                policy="escapement", policy_param=0.5, num_steps=10)
    args.update(change)
    with pytest.raises(ValueError, match=message):
        rk.rollout(**args)


def test_wrapper_accepts_ragged_batch_and_counts_no_cpu_launch():
    env, params = make("fishing-v1")
    before = rk.launches
    out = rk.rollout(torch.full((37,), 0.75), torch.zeros(37, dtype=torch.int32), params,
                     "escapement", 0.5, 4, seed=5)
    assert out.stock.shape == (37,) and out.stock.dtype == torch.float32
    assert out.t.dtype == torch.int32 and out.ep_count.dtype == torch.int32
    assert rk.launches == before


# ------------------------------------------- the instruction count's own parts

def test_specialise_fixes_every_switch_of_the_step():
    """bench/rollout_instructions.py counts the shipped fishing-v1 library as
    it is built, since every switch of the step is a compile-time constant of
    the source: none may be a runtime read of the parameter struct."""
    from gym_fishing_tpu_torch.kernels import _build

    source = (_build.CSRC / "rollout_kernel.cu").read_text()
    kernel = source[source.index("struct EnvCarry"):source.index("static int grid_for")]
    for field in ("policy", "scheme", "noise_form", "obs_noise", "has_noise", "growth",
                  "model_idx"):
        assert f"p.{field} " not in kernel and f"p.{field})" not in kernel
        assert f"p->{field}" in source            # the launcher checks it instead
    assert "p.policy_param" in kernel and "switch" not in kernel
    for flag in rk.CONFIG_FLAGS:
        assert f"#ifndef {flag}\n" in source and flag in kernel
    assert not hasattr(rollout_instructions, "specialise")


_LISTING = """
\tFunction : _Z25philox_normal_fill_kernelyyxPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BRA 0x0 ;
\tFunction : _Z14rollout_kernel13RolloutParamsPKf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   IMAD R2, R3, R4, R5 ;
        /*0020*/              @!P0 BRA 0x60 ;
        /*0030*/                   STL [R1], R2 ;
        /*0040*/                   CALL.REL.NOINC 0x200 ;
        /*0050*/                   BRA 0x20 ;
        /*0060*/                   BSSY B0, 0xb0 ;
        /*0070*/               @P1 BRA 0xa0 ;
        /*0080*/                   FFMA R2, R2, R2, R2 ;
        /*0090*/                   BRA 0xa0 ;
        /*00a0*/                   BSYNC B0 ;
        /*00b0*/               @P2 BRA 0x10 ;
        /*00c0*/                   EXIT ;
"""


def test_step_loop_and_fast_path_of_a_listing():
    loop = rollout_instructions.step_loop(_LISTING)
    # the widest backward branch of rollout_kernel, not the slow path's own
    # loop and not the other kernel's
    assert [a for a, _ in loop] == list(range(0x10, 0xc0, 0x10))
    fast = rollout_instructions.fast_path(loop)
    # the leaf block that stores to local memory and calls is jumped over; the
    # plain conditional branch at 0x70 falls through; the jump at 0x90 is taken
    assert [a for a, _ in fast] == [0x10, 0x20, 0x60, 0x70, 0x80, 0x90, 0xa0, 0xb0]
    assert [rollout_instructions.opcode(t) for _, t in fast[:3]] == ["IMAD", "BRA", "BSSY"]


# ------------------------------------------- one library per configuration

_NO_BUILD = "a configuration must be found without building anything"


@pytest.mark.parametrize("noise_form", rk.NOISE_FORMS)
@pytest.mark.parametrize("growth", rk._GROWTHS)
def test_every_call_maps_to_its_own_configuration(growth, noise_form):
    """The dispatch key computed on the host: every combination of the
    switches maps to a configuration whose fields are in range (so its
    library exists: the source asserts the same ranges), distinct calls map
    to distinct configurations, and none maps to a generic one."""
    seen = {}
    for policy in rk.POLICIES:
        for scheme in rk.SCHEMES:
            for obs_noise in (False, True):
                for planes in (False, True):
                    for r_drift in (0.0, 1e-3):
                        cfg = rk.configuration(growth, 2, noise_form, policy, scheme, obs_noise,
                                               planes, r_drift)
                        assert all(0 <= v < n for v, n in zip(cfg, rk.CONFIG_SIZES)), cfg
                        assert cfg.growth == (2 if growth == "mixture"
                                              else rk.GROWTH_MODELS.index(growth))
                        assert cfg[1:] == (rk.NOISE_FORMS.index(noise_form),
                                           rk.POLICIES.index(policy), rk.SCHEMES.index(scheme),
                                           int(obs_noise), int(planes), int(r_drift != 0))
                        seen[cfg] = seen.get(cfg, 0) + 1
    assert len(seen) == 3 * 3 * 2 * 2 * 2 and set(seen.values()) == {1}


@pytest.mark.parametrize("model_idx,model", [(-1, 0), (0, 0), (1, 1), (2, 2), (3, 3), (4, 4),
                                             (5, 5), (6, 0), (7, 0), (100, 0)])
def test_mixture_is_resolved_on_the_host(model_idx, model):
    """The mixture's index names one of the six models; out of range it
    selects logistic, as the where-chain of the JAX mixture does. The
    configuration never holds the mixture itself."""
    cfg = rk.configuration("mixture", model_idx, "additive", "escapement", "continuous", False,
                           False, 0.0)
    assert cfg.growth == model < len(rk.GROWTH_MODELS)
    assert cfg == rk.configuration(rk.GROWTH_MODELS[model], 0, "additive", "escapement",
                                   "continuous", False, False, 0.0)


def test_mixture_index_agrees_with_the_twin():
    """The host's rule and the twin's where-chain pick the same model."""
    env, params = make("fishing-mixture-v1", sigma=0.0)
    stock = torch.from_numpy(uniform_stock(3))
    t = torch.zeros(B, dtype=torch.int32)
    for model_idx in (-1, 0, 1, 3, 5, 6):
        p = params.replace(model_idx=torch.tensor(model_idx, dtype=torch.int32))
        mixed = rk.rollout(stock, t, p, "escapement", 0.5, 4, growth="mixture")
        cfg = rk.configuration("mixture", model_idx, "additive", "escapement", "continuous",
                               False, False, 0.0)
        alone = rk.rollout(stock, t, p, "escapement", 0.5, 4,
                           growth=rk.GROWTH_MODELS[cfg.growth])
        torch.testing.assert_close(mixed.stock, alone.stock, rtol=0, atol=0)


def test_configuration_defines_and_library_names():
    from gym_fishing_tpu_torch.kernels import _build

    cfg = rk.configuration("may", 0, "lognormal", "constant", "relative", True, False, 0.1)
    assert cfg.defines() == ("K1_GROWTH=5", "K1_NOISE_FORM=1", "K1_POLICY=2", "K1_SCHEME=2",
                             "K1_OBS_NOISE=1", "K1_PLANES=0", "K1_DRIFT=1")
    assert rk.DEFAULT_CONFIGURATION == rk.configuration(
        "logistic", 0, "additive", "escapement", "continuous", False, False, 0.0)
    paths = {_build.library_path("rollout_kernel", c.defines())
             for c in (cfg, rk.DEFAULT_CONFIGURATION, cfg._replace(drift=0))}
    paths.add(_build.library_path("rollout_kernel"))
    paths.add(_build.library_path("rollout_kernel", cfg.defines() + ("K1_IEEE=0",)))
    assert len(paths) == 5                     # the flags are part of the name
    source = (_build.CSRC / "rollout_kernel.cu").read_text()
    listed = source[source.index("const int cfg[7]"):]
    order = [listed.index(flag) for flag in rk.CONFIG_FLAGS]
    assert order == sorted(order)              # rollout_configuration reports them in order


@pytest.mark.parametrize("bad", [dict(growth=6), dict(growth=-1), dict(noise_form=2),
                                 dict(policy=3), dict(scheme=3), dict(obs_noise=2),
                                 dict(planes=-1), dict(drift=2)])
def test_library_refuses_a_configuration_out_of_range(monkeypatch, bad):
    """No generic kernel: a configuration outside the source's ranges raises
    before anything is built."""
    from gym_fishing_tpu_torch.kernels import _build

    def refuse(*args):
        raise AssertionError(_NO_BUILD)

    monkeypatch.setattr(_build, "load", refuse)
    with pytest.raises(ValueError, match="no such configuration"):
        rk.library(rk.DEFAULT_CONFIGURATION._replace(**bad))


def test_params_struct_matches_the_source():
    """The ctypes mirror follows the struct, the round keys included."""
    import ctypes

    from gym_fishing_tpu_torch.kernels import _build

    source = (_build.CSRC / "rollout_kernel.cu").read_text()
    assert f"sizeof(RolloutParams) == {ctypes.sizeof(rk._Params)}" in source
    assert rk._Params.keys.size == 80 and rk._Params.keys.offset == 128


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1, 2**40 + 3, 2**64 - 1])
def test_round_keys_are_the_twin_s_key_schedule(seed):
    keys = rk._round_keys(seed)
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    for rnd in range(10):
        if rnd > 0:   # as _philox4x32_10 bumps its key
            k0 = (k0 + rk._PHILOX_W[0]) & 0xFFFFFFFF
            k1 = (k1 + rk._PHILOX_W[1]) & 0xFFFFFFFF
        assert (keys[rnd][0], keys[rnd][1]) == (k0, k1)


def test_normals_from_bits_is_the_stream_s_box_muller():
    idx = torch.arange(B, dtype=torch.int64)
    seed, counter = 2**40 + 3, 2**33 + 1
    bits = torch.stack(rk._philox4x32_10(
        (idx, torch.zeros_like(idx), torch.full_like(idx, counter & 0xFFFFFFFF),
         torch.full_like(idx, counter >> 32)), (seed & 0xFFFFFFFF, seed >> 32)))
    z = rk.normals_from_bits(bits)
    want = torch.stack(rk._philox_normals_reference(seed, counter, idx))
    torch.testing.assert_close(z, want, rtol=0, atol=0)
    exact = torch.stack(rollout_instructions.box_muller_float64(rk, tuple(bits)))
    assert exact.dtype == torch.float64 and float((z.double() - exact).abs().max()) < 5e-6
    with pytest.raises(ValueError, match="unknown path"):
        rk.normals_from_bits(bits, "fast")
    with pytest.raises(ValueError, match="bits must be"):
        rk.normals_from_bits(bits.to(torch.int32))


def test_edge_uniforms_give_finite_draws_in_the_twin():
    """u = 1 gives a radius of 0 and u = 2^-23 the largest one, about 5.65;
    the bench's edge blocks hold both ends in both places."""
    bits, n_edge = rollout_instructions.edge_bits(np.random.default_rng(0))
    assert bits.shape == (4, n_edge + (1 << 22)) and bits.min() >= 0 and bits.max() < 2**32
    edge = torch.from_numpy(bits[:, :n_edge])
    z = rk.normals_from_bits(edge)
    assert bool(torch.isfinite(z).all())
    u = rk._uniform_from_bits(edge[0])
    assert float(u.max()) == 1.0 and float(u.min()) == 2.0 ** -23
    assert float(z[:2, u == 1.0].abs().max()) == 0.0
    assert 5.6 < float(torch.hypot(z[0], z[1]).max()) < 5.7


def test_float64_rollout_of_the_bench_agrees_with_the_twin(monkeypatch):
    monkeypatch.setattr(rollout_instructions, "T", 40)
    env, params = make("fishing-v1", sigma=0.05)
    x_star = float(escapement(env, params).x_star)
    stock = torch.from_numpy(uniform_stock(5))
    t0 = torch.zeros(B, dtype=torch.int32)
    run = lambda: rk.rollout(stock, t0, params, "escapement", x_star, 40, seed=9)  # noqa: E731
    table = rollout_instructions.main_path_errors(rk, run, params, x_star, stock, t0, 9)
    assert set(table) == {"kernel stock", "kernel reward", "twin_float32 stock",
                          "twin_float32 reward"}
    assert table["kernel stock"]["max"] < 2e-6 and table["kernel reward"]["max"] < 2e-5
    assert table["kernel stock"] == table["twin_float32 stock"]   # on the CPU both are the twin


_PTXAS = """
ptxas info    : Compiling entry function '_Z14rollout_kernel13RolloutParamsPKf' for 'sm_90a'
ptxas info    : Function properties for _Z14rollout_kernel13RolloutParamsPKf
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 37 registers, 744 bytes cmem[0]
ptxas info    : Compiling entry function '_Z25philox_normal_fill_kernel10PhiloxKeysyxPf' for 'sm_90a'
ptxas info    : Function properties for _Z25philox_normal_fill_kernel10PhiloxKeysyxPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, 632 bytes cmem[0]
"""


def test_resources_and_occupancy_of_a_build_report():
    assert rollout_instructions.kernel_resources(_PTXAS) == (37, 12)
    assert rollout_instructions.kernel_resources("") == (None, 0)
    # 37 registers are allocated as 40 a thread: 6 CTAs of 256 threads fit in 65536
    ctas, waves = rollout_instructions.occupancy(37, 256, 132)
    assert ctas == 6 and waves == pytest.approx(8192 / (6 * 132))
    assert rollout_instructions.occupancy(32, 256, 132)[0] == 8      # the thread limit
    assert rollout_instructions.occupancy(45, 256, 132)[0] == 5
    assert rollout_instructions.occupancy(24, 64, 132)[0] == 32      # the CTA limit


def test_bench_hook_sets_the_other_arithmetic(monkeypatch):
    """--models builds each configuration with K1_IEEE set against its
    default, through the wrapper's private loader and no global of it."""
    asked = []
    monkeypatch.setattr(rk, "_library", lambda config, extra: asked.append((config, extra)))
    other = rollout_instructions.other_arithmetic(rk)
    other()
    other(rk.DEFAULT_CONFIGURATION._replace(scheme=rk.SCHEMES.index("relative")))
    assert asked == [(rk.DEFAULT_CONFIGURATION, ("K1_IEEE=1",)),
                     (rk.DEFAULT_CONFIGURATION._replace(scheme=2), ("K1_IEEE=0",))]
    source = (rollout_instructions.ROOT / "gym_fishing_tpu_torch/csrc/rollout_kernel.cu").read_text()
    assert "#define K1_IEEE (K1_SCHEME != CONTINUOUS)" in source
    # the one macro a caller may set beyond the configuration's
    assert source.count("#ifndef") == len(rk.CONFIG_FLAGS) + 1


def test_k1_bound_is_a_count_of_the_main_path():
    """chip_smoke's operation count of K1: no drift term, the pipes side by
    side, and below what the shipped kernel was measured to execute."""
    import chip_smoke as cs

    assert cs.K1_OPS == {"float32": 23, "int32": 15, "special": 2}
    n = cs.B_MAIN * cs.T_MAIN
    ms, by = cs.rollout_kernel_bound(cs.B_MAIN, cs.T_MAIN)
    assert by == "operations"
    # the schedulers' rate for all 40 is the longest of the pipes' times
    assert ms == pytest.approx(40 * n / (128 * 132 * 1.98e9) * 1e3)
    assert ms == pytest.approx(cs.issue_ms(40, cs.B_MAIN, cs.T_MAIN))
    assert cs.issue_ms(46.25, cs.B_MAIN, cs.T_MAIN) > ms
    assert cs.rollout_kernel_bound(1, 2)[1] == "bytes"


@pytest.mark.parametrize("ops,longest", [
    ({"float32": 128, "int32": 1}, 129 / 128), ({"int32": 64, "float32": 8}, 1.0),
    ({"special": 32, "float32": 64, "int32": 32}, 2.0)])
def test_pipes_overlap_in_the_bound(ops, longest):
    import chip_smoke as cs

    assert cs.pipes_s(ops) == pytest.approx(longest / cs.SM_CLOCKS_PER_S)
