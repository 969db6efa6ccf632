"""The port's CUDA kernels against their plain twins, on the card: the
rollout kernel (K1), the fused PPO update kernels (K2, K3) and the fused
policy rollout (K4).

These tests need a CUDA device and skip without one. They import neither
JAX nor tests/conftest.py's JAX setup, so on a machine with a card and no
JAX they run with:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances, K1: float32 with a different libm, FMA contraction and
operation order, and under the continuous scheme draws and functions of the
special-function units, so values agree to rounding (stock atol 1e-5, sums
over 64 steps atol 1e-4) while t and ep_count agree exactly. K2/K3: each gradient
buffer within 2e-4 * max|twin| + 2e-6 and the metric sums within rtol 2e-4,
since float32 sums over thousands of samples run in another order; under
compute="float32" the kernel's split-TF32 products must also keep float32
accuracy: against the twin evaluated in float64, each buffer's error is at
most 4x the float32 twin's own (or two float32 ulps of the buffer's largest
entry, where the twin happens to land closer than that: several buffers are
single sums that cancel over the samples). K4: the
packed rows and end states within 1e-4 (rounding carried through the
dependent steps and the GAE pass), t and ep_len exactly, and under bfloat16
within 5e-3 (a mean of 1e-4); an env that a rounding difference carries
across a discontinuity (a categorical CDF boundary, a quota that harvests
the whole stock) follows another trajectory, so such envs (at most 1e-3 of
them) are left out of the comparison.
"""

import numpy as np
import pytest
import torch

import gym_fishing_tpu_torch as gtt
from gym_fishing_tpu_torch.agents import ppo_fused
from gym_fishing_tpu_torch.agents.ppo import ActorCritic, sample_action
from gym_fishing_tpu_torch.core.tree import tree_leaves
from gym_fishing_tpu_torch.kernels import policy_rollout_kernel as pk
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk
from gym_fishing_tpu_torch.kernels import rollout_kernel as rk

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _assert_close(ker, ref):
    torch.cuda.synchronize()
    np.testing.assert_allclose(ker.stock.cpu().numpy(), ref.stock.cpu().numpy(), atol=1e-5)
    np.testing.assert_array_equal(ker.t.cpu().numpy(), ref.t.cpu().numpy())
    np.testing.assert_allclose(ker.reward.cpu().numpy(), ref.reward.cpu().numpy(), atol=1e-4)
    np.testing.assert_allclose(ker.ep_ret_sum.cpu().numpy(), ref.ep_ret_sum.cpu().numpy(),
                               atol=1e-4)
    np.testing.assert_array_equal(ker.ep_count.cpu().numpy(), ref.ep_count.cpu().numpy())
    assert ker.next_offset == ref.next_offset


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["planes", "philox"])
@pytest.mark.parametrize("env_id,policy,param", [
    ("fishing-v1", "escapement", 0.5),
    ("fishing-v0", "constant_mortality", 0.15),
    ("fishing-may-obs-v1", "escapement", 0.4),
])
def test_kernel_matches_twin(cuda, env_id, policy, param, source):
    env, params = gtt.make(env_id, sigma=0.1, Tmax=13, device="cpu")  # the kernel reads them
    cfg = env.config
    obs_noise = float(params.sigma_m) > 0
    n, T = 4096 + 37, 64
    rng = np.random.default_rng(0)
    stock = torch.from_numpy(rng.uniform(0.3, 1.2, n).astype(np.float32)).to(cuda)
    t = torch.zeros(n, dtype=torch.int32, device=cuda)
    kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
              n_actions=cfg.n_actions, obs_noise=obs_noise)
    if source == "planes":
        shape = (2 if obs_noise else 1, T, n)
        kw["noise"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    else:
        kw.update(seed=9, offset=4)
    before = rk.launches
    ker = rk.rollout(stock, t, params, policy, param, T, **kw)
    assert rk.launches == before + 1
    ref = rk.rollout_reference(stock, t, params, policy, param, T, **kw)
    _assert_close(ker, ref)


@pytest.mark.cuda
def test_philox_fill_matches_twin_stream(cuda):
    z = rk.philox_normals(seed=5, offset=2**40, num_envs=1 << 16, device=cuda)
    ref = rk.philox_normals(seed=5, offset=2**40, num_envs=1 << 16, device="cpu")
    np.testing.assert_allclose(z.cpu().numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["sfu", "ieee"])
def test_draw_path_at_the_ends_of_the_uniform(cuda, path):
    """Box-Muller on the special-function units where they are weakest: every
    u within 16 ulps of 1 (where lg2's absolute error would swamp -2 ln u, and
    a short series takes over) and of 0 (the largest radius, 5.65, times the
    units' sine and cosine), beside random partners and 2^20 random blocks:
    no NaN, and within 1e-5 of the twin."""
    from gym_fishing_tpu_torch.bench.rollout_instructions import box_muller_float64, edge_bits

    bits, n_edge = edge_bits(np.random.default_rng(3))
    bits = torch.from_numpy(bits[:, :n_edge + (1 << 20)])
    z = rk.normals_from_bits(bits.to(cuda), path).cpu()
    ref = rk.normals_from_bits(bits)
    assert not bool(torch.isnan(z).any())
    np.testing.assert_allclose(z.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    exact = torch.stack(box_muller_float64(rk, tuple(bits)))
    assert float((z.double() - exact).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 37, 255, 257, 3 * 256 + 17])
def test_rollout_kernel_ragged_batch(cuda, n):
    """Batches smaller than a warp, one short of and one over a CTA of 256
    threads, and one that ends inside its last CTA."""
    env, params = gtt.make("fishing-v1", sigma=0.1, Tmax=13, device="cpu")
    rng = np.random.default_rng(n)
    stock = torch.from_numpy(rng.uniform(0.3, 1.2, n).astype(np.float32)).to(cuda)
    t = torch.from_numpy(rng.integers(0, 13, n).astype(np.int32)).to(cuda)
    ker = rk.rollout(stock, t, params, "escapement", 0.5, 62, seed=5, offset=2**32 - 2)
    ref = rk.rollout_reference(stock, t, params, "escapement", 0.5, 62, seed=5,
                               offset=2**32 - 2)
    assert ker.stock.shape == (n,)
    _assert_close(ker, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("env_id,policy,param", [("fishing-v1", "escapement", 0.5),
                                                 ("fishing-v0", "constant_mortality", 0.15),
                                                 ("fishing-may-obs-v1", "escapement", 0.4)])
def test_rollout_kernel_is_deterministic(cuda, env_id, policy, param):
    """One thread per env and no atomics: the same inputs give the same bits."""
    env, params = gtt.make(env_id, sigma=0.1, Tmax=13, device="cpu")
    cfg = env.config
    n = 4096 + 37
    stock = torch.from_numpy(np.random.default_rng(1).uniform(0.3, 1.2, n).astype(np.float32))
    stock, t = stock.to(cuda), torch.zeros(n, dtype=torch.int32, device=cuda)
    kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
              n_actions=cfg.n_actions, obs_noise=float(params.sigma_m) > 0, seed=9, offset=4)
    a, b = (rk.rollout(stock, t, params, policy, param, 64, **kw) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(a[:7], b[:7]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_a_library_runs_its_own_configuration_only(cuda, monkeypatch):
    """Each configuration's library reports the switches it was compiled
    with, and there is no generic kernel behind it: given the parameters of
    another configuration, the launcher refuses and nothing is launched."""
    ricker = rk.configuration("ricker", 0, "lognormal", "constant", "relative", False, False, 0.0)
    for config in (rk.DEFAULT_CONFIGURATION, ricker):
        built = (rk.ctypes.c_int * len(rk.CONFIG_FLAGS))()
        rk.library(config).rollout_configuration(built)
        assert tuple(built) == tuple(config)
    assert rk.library(ricker) is not rk.library()
    default = rk.library()
    monkeypatch.setattr(rk, "library", lambda config=None: default)
    env, params = gtt.make("fishing-v1", device="cpu")
    stock = torch.full((64,), 0.75, device=cuda)
    t = torch.zeros(64, dtype=torch.int32, device=cuda)
    before = rk.launches
    for other in (dict(growth="ricker"), dict(noise_form="lognormal"), dict(scheme="relative"),
                  dict(obs_noise=True), dict(noise=torch.zeros(1, 8, 64, device=cuda))):
        with pytest.raises(RuntimeError, match="invalid"):
            rk.rollout(stock, t, params, "escapement", 0.5, 8, **other)
    with pytest.raises(RuntimeError, match="invalid"):
        rk.rollout(stock, t, params, "constant", 0.5, 8)
    assert rk.launches == before
    assert rk.rollout(stock, t, params, "escapement", 0.5, 8).stock.shape == (64,)


def _ppo_case(head, n, hidden, seed, obs_dim=1, act_dim=None):
    """A jittered random ActorCritic (merged weights) and n packed samples
    drawn from it, with old log-probs and values spread so every clip branch
    is visited."""
    gen = torch.Generator().manual_seed(seed)
    gauss = head == "gaussian"
    a = act_dim or (1 if gauss else 3)
    model = ActorCritic(obs_dim, a, gauss, hidden, generator=gen)
    randn = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * randn(*p.shape))
        if gauss:
            model.log_std.fill_(-0.4)
        obs = 0.7 * randn(n, obs_dim)
        dist, value = model(obs)
        action, logp = sample_action(dist, gauss, generator=gen)
    packed = torch.cat([obs, action.float().reshape(n, -1), (logp + 0.3 * randn(n))[:, None],
                        (value + 0.3 * randn(n))[:, None], randn(n, 1),
                        (value + randn(n))[:, None]], 1)
    weights = ppo_fused.merged_weights(dict(model.named_parameters()), head)
    return weights, ppo_fused.pack_feature_major(packed), a


def _towers(merged):
    """The 13 split-tower arrays of merged weights or gradients: K2 computes
    no cross-tower block (its are zero), the twin the whole products."""
    return uk.unmerge_weights(merged, merged[2].shape[0] // 2, merged[4].shape[1] - 1)


def _assert_buffers_close(got, ref):
    for g, r in zip(got, ref):
        g, r = g.cpu().double(), r.cpu().double()
        tol = 2e-4 * float(r.abs().max()) + 2e-6
        assert float((g - r).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 64])
@pytest.mark.parametrize("head,ent_coef", [("gaussian", 0.0), ("gaussian", 0.01),
                                           ("categorical", 0.0), ("categorical", 0.01)])
def test_ppo_grad_kernel_matches_twin(cuda, head, ent_coef, hidden, compute):
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=1)
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.tensor([9, 0, 63, 17, 5, 40, 33, 2], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.05, 1.1], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=ent_coef, obs_dim=1, act_dim=a, tile=256,
              head=head, compute=compute)
    before = uk.grad_launches
    g, met = uk.fused_minibatch_grad(data, order, weights, adv_stats, **kw)
    assert uk.grad_launches == before + 1
    g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights, adv_stats, **kw)
    torch.cuda.synchronize()
    _assert_buffers_close(_towers(g), _towers(g_ref))
    np.testing.assert_allclose(met.cpu().numpy(), met_ref.cpu().numpy(), rtol=2e-4, atol=1e-6)


def _assert_k2_k3_match_twins(cuda, weights, data, a, obs_dim, head, compute, count5=False):
    """K2 and K3 on 8 tiles of 256 samples against their twins, under the
    obs_dim = 1 bars; one launch each. K3 starts from zero moments at the
    first count, or with `count5` from small random moments at count 5 (as
    the wide-width test and chip_smoke phase 9 do)."""
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.tensor([9, 0, 63, 17, 5, 40, 33, 2], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.05, 1.1], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=obs_dim, act_dim=a, tile=256,
              head=head, compute=compute)
    before = uk.grad_launches, uk.adam_launches
    g, met = uk.fused_minibatch_grad(data, order, weights, adv_stats, **kw)
    g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights, adv_stats, **kw)
    w = weights
    if count5:
        gen = torch.Generator().manual_seed(3)
        m = tuple((0.01 * torch.randn(x.shape, generator=gen)).to(cuda) for x in w)
        v = tuple((1e-4 * torch.rand(x.shape, generator=gen)).to(cuda) for x in w)
        akw = dict(kw, lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5, max_grad_norm=0.5)
    else:
        m = v = tuple(torch.zeros_like(x) for x in w)
        akw = dict(kw, lr=3e-4, bc1=0.1, bc2=0.001, max_grad_norm=0.5)
    *new, met_a = uk.fused_minibatch_grad_adam(data, order, w, m, v, adv_stats, **akw)
    *ref, _ = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, adv_stats, **akw)
    assert (uk.grad_launches, uk.adam_launches) == (before[0] + 1, before[1] + 1)
    torch.cuda.synchronize()
    _assert_buffers_close(_towers(g), _towers(g_ref))
    np.testing.assert_allclose(met.cpu().numpy(), met_ref.cpu().numpy(), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(met_a.cpu().numpy(), met.cpu().numpy())
    _assert_buffers_close([n - o for n, o in zip(new[0], w)], [r - o for r, o in zip(ref[0], w)])
    for got, want in zip(new[1:], ref[1:]):
        _assert_buffers_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("head,obs_dim,act_dim,rows", [
    ("gaussian", 4, 1, 16),       # stack_observations(env, 4): 9 fields
    ("categorical", 4, 3, 16),
    ("gaussian", 2, 9, 16),
    ("gaussian", 4, 16, 24),      # the widest Gaussian action the kernel takes
])
def test_ppo_grad_kernels_take_16_and_24_rows(cuda, head, obs_dim, act_dim, rows, compute):
    """K2 and K3 read packed matrices of 16 and 24 rows (Gaussian actions up
    to 16) and equal their twins there, under the obs_dim = 1 bars."""
    weights, data, a = _ppo_case(head, 64 * 256, 64, seed=8, obs_dim=obs_dim, act_dim=act_dim)
    assert data.shape[0] == rows
    _assert_k2_k3_match_twins(cuda, weights, data, a, obs_dim, head, compute)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("obs_dim,rows", [(6, 16), (12, 24), (19, 24)])
@pytest.mark.parametrize("hidden,head,act_dim", [
    (64, "gaussian", None), (64, "categorical", None),     # ppo_grad_tiles
    (256, "gaussian", None), (64, "categorical", 100),     # the wide path
])
def test_ppo_grad_kernels_take_long_observations(cuda, hidden, head, act_dim, obs_dim, rows,
                                                 compute):
    """Observation windows of more than 4 fields (6 is pomdp_policies.py's
    default window, 19 the most that 24 rows hold beside one action column)
    on both paths of the kernel: K2 and K3 equal their twins. K3 from
    moments at count 5: a first Adam step from zero moments moves each
    weight by g / (|g| + eps) lr, which for the many dW1c entries within a
    bf16 rounding of eps = 1e-5 turns a rounding of g into a step of order
    lr."""
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=9, obs_dim=obs_dim,
                                 act_dim=act_dim)
    assert data.shape[0] == rows
    _assert_k2_k3_match_twins(cuda, weights, data, a, obs_dim, head, compute, count5=True)


@pytest.mark.cuda
def test_ppo_grad_kernel_refuses_20_observation_fields_before_the_launch(cuda):
    weights, data, a = _ppo_case("gaussian", 64 * 256, 64, seed=8, obs_dim=20)
    before = uk.grad_launches
    with pytest.raises(ValueError, match="the CUDA kernel takes obs_dim <= 19"):
        uk.fused_minibatch_grad(data.to(cuda), torch.arange(4, dtype=torch.int32, device=cuda),
                                tuple(w.to(cuda) for w in weights),
                                torch.tensor([0.0, 1.0], device=cuda), clip_eps=0.2,
                                vf_coef=0.5, ent_coef=0.0, obs_dim=20, act_dim=a, tile=256)
    assert uk.grad_launches == before


@pytest.mark.cuda
def test_ppo_grad_kernel_refuses_32_rows_before_the_launch(cuda):
    weights, data, a = _ppo_case("gaussian", 64 * 256, 64, seed=8)
    data = torch.cat([data, torch.zeros((24, data.shape[1]))]).to(cuda)
    before = uk.grad_launches
    with pytest.raises(ValueError, match="at most 24 packed rows"):
        uk.fused_minibatch_grad(data, torch.arange(4, dtype=torch.int32, device=cuda),
                                tuple(w.to(cuda) for w in weights),
                                torch.tensor([0.0, 1.0], device=cuda), clip_eps=0.2,
                                vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=a, tile=256)
    assert uk.grad_launches == before


WIDE_CASES = [(128, "gaussian", None), (256, "gaussian", None), (128, "categorical", 100),
              (256, "categorical", 100), (64, "categorical", 100), (32, "categorical", 17),
              (256, "categorical", 128), (128, "categorical", 17), (256, "categorical", 17),
              (256, "categorical", None), (256, "categorical", 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,head,act_dim", WIDE_CASES)
def test_ppo_grad_kernels_match_twin_at_the_wide_widths(cuda, hidden, head, act_dim, compute):
    """Hidden 128 and 256, and categorical heads of 17 to 128 classes at any
    hidden size, take the wide path: K2 and K3 equal their twins there under
    the bars above, each launching ``ppo_grad_tower`` where `tower_path`
    says (bfloat16 at hidden 64 and above), its logits two runs at a time
    where `logit_pair_path` says, and a second K3 step from the same inputs
    gives the same bits."""
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=5, act_dim=act_dim)
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.tensor([9, 0, 63, 17, 5, 40, 33, 2], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.05, 1.1], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a, tile=256,
              head=head, compute=compute)
    before = uk.grad_launches, uk.adam_launches, uk.tower_launches, uk.logit_pair_launches
    g, met = uk.fused_minibatch_grad(data, order, weights, adv_stats, **kw)
    g_ref, met_ref = uk.fused_minibatch_grad_reference(data, order, weights, adv_stats, **kw)
    w = weights
    gen = torch.Generator().manual_seed(3)
    m = tuple((0.01 * torch.randn(x.shape, generator=gen)).to(cuda) for x in w)
    v = tuple((1e-4 * torch.rand(x.shape, generator=gen)).to(cuda) for x in w)
    akw = dict(kw, lr=3e-4, bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5, max_grad_norm=0.5)
    *new, met_a = uk.fused_minibatch_grad_adam(data, order, w, m, v, adv_stats, **akw)
    *ref, _ = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, adv_stats, **akw)
    towers = 2 if uk.tower_path(hidden, a, compute) else 0
    pairs = 2 if uk.logit_pair_path(hidden, a, compute, head) else 0
    assert (uk.grad_launches, uk.adam_launches, uk.tower_launches, uk.logit_pair_launches) == (
        before[0] + 1, before[1] + 1, before[2] + towers, before[3] + pairs)
    *again, met_b = uk.fused_minibatch_grad_adam(data, order, w, m, v, adv_stats, **akw)
    torch.cuda.synchronize()
    for x, y in zip([t for group in new for t in group] + [met_a],
                    [t for group in again for t in group] + [met_b]):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    _assert_buffers_close(_towers(g), _towers(g_ref))
    np.testing.assert_allclose(met.cpu().numpy(), met_ref.cpu().numpy(), rtol=2e-4, atol=1e-6)
    np.testing.assert_array_equal(met_a.cpu().numpy(), met.cpu().numpy())
    _assert_buffers_close([n - o for n, o in zip(new[0], w)], [r - o for r, o in zip(ref[0], w)])
    for got, want in zip(new[1:], ref[1:]):
        _assert_buffers_close(got, want)


# (hidden, head, act_dim, visited tiles, tile): 24 tiles of 256 samples
# (three ranges) at every wide size; the main path's minibatch at hidden 256
# (128 tiles of 2048: 128 ranges, 2 x 2 tiles a tower under bfloat16); and
# 75 tiles of 512, 19 ranges of 31 or 32 blocks of 64 samples
SPLIT_CASES = ([(*c, 24, 256) for c in WIDE_CASES]
               + [(256, "gaussian", None, 128, 2048), (256, "categorical", 100, 128, 2048),
                  (256, "gaussian", None, 75, 512), (128, "gaussian", None, 75, 512)])


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,head,act_dim,num_tiles,tile", SPLIT_CASES)
def test_dw2c_split_matches_its_plain_version(cuda, hidden, head, act_dim, num_tiles, tile,
                                              compute):
    """On `num_tiles` shuffled tiles: the wide path's stage 1 writes h1 and
    g_p2 in minibatch order as the twin computes them (to float32 rounding;
    under bfloat16 to one bf16 rounding, 2^-8 of the entry, where a last-bit
    difference of the float32 value rounds to the neighbouring bf16 value),
    and dw2c_split's partial of each range, from that scratch, equals
    `dw2c_split_reference`'s: sums of up to 2048 products in another order
    (1e-5 of the range's largest entry; under bfloat16 the tensor cores'
    truncating accumulator inside blocks of 64 samples, 2e-5). The rows past
    the ranges, the cross-tower blocks and every entry outside dW2c are left
    as they were."""
    total = max(64, num_tiles * 4 // 3)
    weights, data, a = _ppo_case(head, total * tile, hidden, seed=5, act_dim=act_dim)
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.randperm(total, generator=torch.Generator().manual_seed(1))[:num_tiles]
    order = order.to(cuda, torch.int32)
    stats = torch.tensor([0.05, 1.1], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a, tile=tile,
              head=head, compute=compute)
    merged = weights
    n, h2 = num_tiles * tile, 2 * hidden
    act, ws = uk.wide_stage1(data, order, merged, stats, **kw)
    _, _, h1, gp2 = uk._grad_merged_parts(data, order, merged, stats, **kw)
    torch.cuda.synchronize()
    rel = 2.0 ** -8 if compute == "bfloat16" else 1e-5
    for got, want in zip(act.float().view(2, n, h2), (h1.T, gp2.T)):
        assert bool(((got - want).abs() <= rel * want.abs() + 1e-5 * float(want.abs().max())
                     + 1e-7).all())
    ranges = uk.split_k_ranges(num_tiles, tile)
    assert len(ranges) == -(-n // 2048)
    out = torch.zeros_like(ws)
    before = uk.split_launches
    uk.dw2c_split(act, out, hidden=hidden, obs_dim=1, act_dim=a, num_tiles=num_tiles, tile=tile,
                  head=head, compute=compute)
    assert uk.split_launches == before + 1
    part = uk.dw2c_split_reference(*act.float().view(2, n, h2), hidden, num_tiles, tile)
    torch.cuda.synchronize()
    l_w2 = h2 + h2
    w2 = out[:, l_w2:l_w2 + h2 * h2].reshape(-1, h2, h2)
    assert float(out[:, :l_w2].abs().sum()) == 0.0
    assert float(out[:, l_w2 + h2 * h2:].abs().sum()) == 0.0
    assert float(w2[len(ranges):].abs().sum()) == 0.0
    bar = 2e-5 if compute == "bfloat16" else 1e-5
    for j in range(len(ranges)):
        err = float((w2[j] - part[j]).abs().max())
        assert err <= bar * float(part[j].abs().max()) + 1e-7, (j, err)


@pytest.mark.cuda
def test_tower_path_agrees_with_the_library(cuda):
    """The wrapper counts ``ppo_grad_tower``'s launches by `tower_path`, and
    those whose logits take two runs at a time by `logit_pair_path`; the
    library takes both at the same sizes."""
    lib = uk.library()
    for hidden in uk.KERNEL_HIDDEN:
        for act_dim in (1, 3, 16, 17, 100, 128):
            for ci, compute in enumerate(uk.COMPUTES):
                assert bool(lib.ppo_grad_tower_path(hidden, act_dim, ci)) == uk.tower_path(
                    hidden, act_dim, compute), (hidden, act_dim, compute)
                for hi, head in enumerate(uk.HEADS):
                    assert bool(lib.ppo_grad_logit_pair_path(hidden, act_dim, ci, hi)) == (
                        uk.logit_pair_path(hidden, act_dim, compute, head)), (
                        hidden, act_dim, compute, head)


@pytest.mark.cuda
def test_logit_pair_launches_count_the_categorical_k3_calls(cuda):
    """One K3 call with 100 classes at hidden 256 under bfloat16 (the
    100-class cell's) adds one to `tower_launches` and one to
    `logit_pair_launches`; a Gaussian call adds one to the first and none
    to the second."""
    for head, act_dim, pairs in (("categorical", 100, 1), ("gaussian", None, 0)):
        weights, data, a = _ppo_case(head, 64 * 256, 256, seed=5, act_dim=act_dim)
        data, w = data.to(cuda), tuple(x.to(cuda) for x in weights)
        order = torch.tensor([9, 0, 63, 17], dtype=torch.int32, device=cuda)
        m = tuple(torch.zeros_like(x) for x in w)
        v = tuple(torch.zeros_like(x) for x in w)
        before = uk.tower_launches, uk.logit_pair_launches
        uk.fused_minibatch_grad_adam(
            data, order, w, m, v, torch.tensor([0.05, 1.1], device=cuda), clip_eps=0.2,
            vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a, tile=256, head=head,
            compute="bfloat16", lr=3e-4, bc1=0.1, bc2=0.001, max_grad_norm=0.5)
        torch.cuda.synchronize()
        assert (uk.tower_launches, uk.logit_pair_launches) == (before[0] + 1, before[1] + pairs)


@pytest.mark.cuda
def test_act_scratch_and_ranges_agree_with_the_library(cuda):
    """The wrapper's activation scratch and split-K ranges are the kernel's."""
    lib = uk.library()
    for hidden, act_dim in ((32, 17), (64, 100), (128, 1), (256, 128), (64, 3), (32, 1)):
        for ci, compute in enumerate(uk.COMPUTES):
            for num_tiles, tile in ((1, 64), (8, 256), (128, 2048), (3, 1024)):
                n = num_tiles * tile
                shape = uk.act_scratch(hidden, act_dim, n, compute)
                size = 0 if shape is None else shape[0] * shape[1].itemsize
                assert lib.ppo_grad_act_bytes(hidden, act_dim, ci, n) == size
                assert lib.ppo_grad_ksplit_count(n, uk.stage1_rows(num_tiles)) == len(
                    uk.split_k_ranges(num_tiles, tile))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,act_dim", [(512, 1), (48, 1), (64, 129)])
def test_ppo_grad_kernel_refuses_wider_sizes_before_the_launch(cuda, hidden, act_dim):
    head = "gaussian" if act_dim == 1 else "categorical"
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=8, act_dim=act_dim)
    before = uk.grad_launches
    with pytest.raises(ValueError, match="the CUDA kernel takes"):
        uk.fused_minibatch_grad(data.to(cuda), torch.arange(4, dtype=torch.int32, device=cuda),
                                tuple(w.to(cuda) for w in weights),
                                torch.tensor([0.0, 1.0], device=cuda), clip_eps=0.2,
                                vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=a, tile=256,
                                head=head)
    assert uk.grad_launches == before


def _float32_accuracy_case(cuda, head, hidden, act_dim, obs_dim=1):
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=6, obs_dim=obs_dim,
                                 act_dim=act_dim)
    _assert_float32_accuracy(cuda, weights, data, a, head, obs_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,head,act_dim", [(32, "gaussian", None), (64, "gaussian", None),
                                                 (32, "categorical", None),
                                                 (64, "categorical", None),
                                                 *[c for c in WIDE_CASES if c[0] != 32]])
def test_ppo_grad_kernel_float32_keeps_float32_accuracy(cuda, head, hidden, act_dim):
    """The float32 mode stays float32-accurate: a TF32 pass in any of its
    products would keep three digits and fail this bar by ~1000x, and even
    the tensor cores' truncating accumulator fails it in the value tower."""
    _float32_accuracy_case(cuda, head, hidden, act_dim)


@pytest.mark.cuda
@pytest.mark.parametrize("obs_dim", [6, 12, 19])
@pytest.mark.parametrize("hidden,head,act_dim", [(64, "gaussian", None), (256, "gaussian", None),
                                                 (64, "categorical", 100)])
def test_ppo_grad_kernel_float32_accuracy_on_long_observations(cuda, head, hidden, act_dim,
                                                              obs_dim):
    """The same bar where dW1c's entries are owned by the threads (more than
    4 observation fields): each chunk's share is summed once, not sample by
    sample into a running float32 sum."""
    _float32_accuracy_case(cuda, head, hidden, act_dim, obs_dim)


def _assert_float32_accuracy(cuda, weights, data, a, head, obs_dim):
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.arange(0, 64, dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([0.05, 1.1], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=obs_dim, act_dim=a, tile=256,
              head=head, compute="float32")
    g, _ = uk.fused_minibatch_grad(data, order, weights, adv_stats, **kw)
    twin, _ = uk.fused_minibatch_grad_reference(data, order, weights, adv_stats, **kw)
    exact, _ = uk._grad_merged_reference(
        data.double(), order, tuple(x.double() for x in weights), adv_stats.double(), **kw)
    torch.cuda.synchronize()
    over = {}
    named = [ppo_fused.params_from_merged(x, head) for x in (g, twin, exact)]
    for name, got, tw, ex in ((k, *(d[k] for d in named)) for k in named[2]):
        err, err_twin = float((got - ex).abs().max()), float((tw - ex).abs().max())
        ulp = float(ex.abs().max()) * 2.0 ** -23
        if not err <= 4 * max(err_twin, 2 * ulp):
            over[name] = (err, err_twin, ulp)
    assert not over, over


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm", [1e6, 1e-3])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_ppo_grad_adam_kernel_matches_twin(cuda, head, max_grad_norm):
    weights, data, a = _ppo_case(head, 64 * 256, 64, seed=2)
    data = data.to(cuda)
    w = tuple(x.to(cuda) for x in weights)
    gen = torch.Generator().manual_seed(3)
    m = tuple((0.01 * torch.randn(x.shape, generator=gen)).to(cuda) for x in w)
    v = tuple((1e-4 * torch.rand(x.shape, generator=gen)).to(cuda) for x in w)
    order = torch.tensor([3, 1, 60, 12], dtype=torch.int32, device=cuda)
    adv_stats = torch.tensor([-0.02, 0.9], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, lr=3e-4, bc1=1 - 0.9 ** 5,
              bc2=1 - 0.999 ** 5, obs_dim=1, act_dim=a, tile=256, head=head,
              max_grad_norm=max_grad_norm)
    before = uk.adam_launches
    *new, met = uk.fused_minibatch_grad_adam(data, order, w, m, v, adv_stats, **kw)
    assert uk.adam_launches == before + 1
    *ref, met_ref = uk.fused_minibatch_grad_adam_reference(data, order, w, m, v, adv_stats, **kw)
    torch.cuda.synchronize()
    # the weights through their update (~lr), the moments as they are
    _assert_buffers_close([n - o for n, o in zip(new[0], w)], [r - o for r, o in zip(ref[0], w)])
    for got, want in zip(new[1:], ref[1:]):
        _assert_buffers_close(got, want)
    np.testing.assert_allclose(met.cpu().numpy(), met_ref.cpu().numpy(), rtol=2e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,head,act_dim,compute", [
    (64, "gaussian", None, "float32"), (64, "categorical", None, "bfloat16"),
    (256, "gaussian", None, "bfloat16"), (256, "categorical", 100, "bfloat16")])
def test_chained_k3_calls_equal_calls_on_fresh_copies(cuda, hidden, head, act_dim, compute):
    """K3 returns its weights and moments as views of its output buffers,
    which the next call takes as they are: two calls chained so give the
    same bits as the same calls fed freshly concatenated copies."""
    weights, data, a = _ppo_case(head, 64 * 256, hidden, seed=12, act_dim=act_dim)
    data = data.to(cuda)
    w = uk.merge_weights(tuple(x.to(cuda) for x in _towers(weights)))
    m = v = uk.merge_weights(tuple(torch.zeros_like(x) for x in _towers(w)))
    order = torch.arange(0, 64, 3, dtype=torch.int32, device=cuda)
    stats = torch.tensor([0.05, 1.1], device=cuda)

    def k3(w, m, v, count):
        return uk.fused_minibatch_grad_adam(
            data, order, w, m, v, stats, clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, lr=3e-4,
            bc1=1 - 0.9 ** count, bc2=1 - 0.999 ** count, obs_dim=1, act_dim=a, tile=256,
            head=head, compute=compute, max_grad_norm=0.5)

    def copies(*merged):
        return (tuple(x.clone() for x in t) for t in merged)

    first = k3(w, m, v, 1)
    assert all(isinstance(t, uk.MergedWeights) for t in first[:3])
    chained = k3(*first[:3], 2)
    fresh = k3(*copies(w, m, v), 1)
    fresh = (fresh, k3(*copies(*fresh[:3]), 2))
    torch.cuda.synchronize()
    for got, want in zip((first, chained), fresh):
        for x, y in zip([*got[0], *got[1], *got[2], got[3]], [*want[0], *want[1], *want[2],
                                                              want[3]]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("max_grad_norm", [1e6, 1e-3, "half"])
@pytest.mark.parametrize("head,act_dim", [("gaussian", None), ("categorical", 100)])
@pytest.mark.parametrize("hidden", [64, 128, 256])
def test_clip_adam_matches_its_twin(cuda, hidden, head, act_dim, max_grad_norm):
    """K3's stage 3 alone (`clip_adam`: the grid-wide masked norm, clip and
    Adam) equals its twin on the same buffers under the K3 bars (the weights
    through their update, the moments as they are; the norm is summed in
    another order), below the clip threshold and clipped, and ("half") from
    a zero first moment with the threshold at half the norm, where m =
    (1 - beta1) g scale: a norm off by one CTA's partial sum of squares
    moves the largest entries of m past the bar; the cross-tower
    blocks of the new weights and moments stay exactly zero, the
    categorical log_std and its moments pass through bit for bit, and two
    launches give the same bits."""
    weights, _, a = _ppo_case(head, 256, hidden, seed=9, act_dim=act_dim)
    w = tuple(x.to(cuda) for x in weights)
    gen = torch.Generator().manual_seed(4)
    m_w2c, m_whc = uk._block_diag_masks(hidden, a, cuda)
    masks = [None, None, m_w2c, None, m_whc, None, None]
    # moments as training leaves them: none on the cross-tower blocks
    m, v = [], []
    for x, mask in zip(w, masks):
        mx = (0.01 * torch.randn(x.shape, generator=gen)).to(cuda)
        vx = (1e-4 * torch.rand(x.shape, generator=gen)).to(cuda)
        m.append(mx if mask is None else mx * mask)
        v.append(vx if mask is None else vx * mask)
    n_par = sum(x.numel() for x in w)
    gout = (0.01 * torch.randn(n_par + 4, generator=gen)).to(cuda)
    flat = [uk.flatten_merged(t) for t in (w, m, v)]
    kw = dict(obs_dim=1, hidden=hidden, act_dim=a, head=head, ent_coef=0.01, lr=3e-4,
              bc1=1 - 0.9 ** 5, bc2=1 - 0.999 ** 5, max_grad_norm=max_grad_norm)
    if max_grad_norm == "half":
        m = [torch.zeros_like(x) for x in w]
        flat[1] = uk.flatten_merged(m)
        kw["max_grad_norm"] = 0.5 * uk.clip_norm_reference(gout, obs_dim=1, hidden=hidden,
                                                           act_dim=a, head=head, ent_coef=0.01)
    before = uk.clip_adam_launches
    got = uk.clip_adam(gout, *flat, **kw)
    again = uk.clip_adam(gout, *flat, **kw)
    assert uk.clip_adam_launches == before + 2
    want = uk.clip_adam_reference(gout, *flat, **kw)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    new = [uk.unflatten_merged(x, 1, hidden, a) for x in got]
    ref = [uk.unflatten_merged(x, 1, hidden, a) for x in want]
    _assert_buffers_close([n - o for n, o in zip(new[0], w)], [r - o for r, o in zip(ref[0], w)])
    for g_t, r_t in zip(new[1:], ref[1:]):
        _assert_buffers_close(g_t, r_t)
    for t in new:
        assert not bool((t[2] * (1 - m_w2c)).any()) and not bool((t[4] * (1 - m_whc)).any())
    if head == "categorical":
        for t, old in zip(new, (w, m, v)):
            assert torch.equal(t[6], old[6])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,compute", [(64, "float32"), (256, "float32"),
                                            (256, "bfloat16")])
@pytest.mark.parametrize("adam", [False, True])
def test_ppo_update_kernels_are_deterministic(cuda, adam, hidden, compute):
    """Stage 2 sums the workspace rows in index order and no float atomic is
    used (the wide path adds dWhc chunk by chunk into its CTA's own row, and
    dw2c_split writes each range's dW2c into a row of its own, every CTA
    summing its samples in one order): two identical launches give identical
    bits, also where bfloat16 puts the wide path's dW2c on the tensor cores."""
    _assert_deterministic(cuda, adam, hidden, obs_dim=1, compute=compute)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,compute", [(64, "float32"), (256, "float32"),
                                            (256, "bfloat16")])
@pytest.mark.parametrize("adam", [False, True])
def test_ppo_update_kernels_are_deterministic_at_24_rows(cuda, adam, hidden, compute):
    """The same at 12 observation fields (24 rows), where the threads own
    dW1c's entries."""
    _assert_deterministic(cuda, adam, hidden, obs_dim=12, compute=compute)


def _assert_deterministic(cuda, adam, hidden, obs_dim, compute):
    weights, data, a = _ppo_case("gaussian", 64 * 256, hidden, seed=4, obs_dim=obs_dim)
    data, weights = data.to(cuda), tuple(w.to(cuda) for w in weights)
    order = torch.arange(0, 64, 2, dtype=torch.int32, device=cuda)
    stats = torch.tensor([0.0, 1.0], device=cuda)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=obs_dim, act_dim=a, tile=256,
              compute=compute)
    if adam:
        w = weights
        zeros = tuple(torch.zeros_like(x) for x in w)
        runs = [uk.fused_minibatch_grad_adam(data, order, w, zeros, zeros, stats, lr=3e-4,
                                             bc1=0.1, bc2=0.001, **kw) for _ in range(2)]
        flat = [torch.cat([x.reshape(-1) for group in r[:3] for x in group] + [r[3]])
                for r in runs]
    else:
        runs = [uk.fused_minibatch_grad(data, order, weights, stats, **kw) for _ in range(2)]
        flat = [torch.cat([x.reshape(-1) for x in r[0]] + [r[1]]) for r in runs]
    torch.cuda.synchronize()
    assert torch.equal(flat[0], flat[1])


def _k4_case(env_id, hidden, source, dev, B=2048 + 5, T=32, **overrides):
    """Jittered random weights, desynchronised start states and either noise
    planes or a seed: (positional args, keyword args) of policy_rollout."""
    env, params = gtt.make(env_id, device="cpu", **overrides)  # the kernel reads them
    cfg = env.config
    gauss = cfg.scheme == "continuous"
    a = 1 if gauss else cfg.n_actions
    gen = torch.Generator().manual_seed(7)
    model = ActorCritic(1, a, gauss, hidden, generator=gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        if gauss:
            model.pi_mean.bias.sub_(0.5)
    weights = ppo_fused.merged_weights({k: x.to(dev) for k, x in model.named_parameters()},
                                       "gaussian" if gauss else "categorical")
    rng = np.random.default_rng(1)
    tmax = int(params.Tmax)
    state = (torch.from_numpy(rng.uniform(0.3, 1.2, B).astype(np.float32)).to(dev),
             torch.from_numpy(rng.integers(0, tmax, B).astype(np.int32)).to(dev),
             torch.full((B,), 0.02, device=dev), torch.zeros(B, device=dev),
             torch.from_numpy(rng.integers(0, tmax, B).astype(np.int32)).to(dev))
    obs_noise = float(params.sigma_m) > 0
    kw = dict(growth=cfg.growth, noise_form=cfg.noise_form, scheme=cfg.scheme,
              n_actions=cfg.n_actions, obs_noise=obs_noise, fold_obs=True)
    if source == "planes":
        planes = [rng.standard_normal((T, B)) if gauss else rng.random((T, B)),
                  rng.standard_normal((T, B))]
        if obs_noise:
            planes.append(np.exp(float(params.sigma_m) * rng.standard_normal((T, B))))
        kw["noise"] = torch.from_numpy(np.stack(planes).astype(np.float32)).to(dev)
    seed = (0, 0) if source == "planes" else (99, 3)
    return (*state, weights, ppo_fused.rollout_scalars(params, *seed), T), kw


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", ["planes", "philox"])
@pytest.mark.parametrize("env_id,hidden,overrides", [
    ("fishing-v1", 64, dict(sigma=0.1)),
    ("fishing-v0", 64, dict(sigma=0.1)),
    ("fishing-v0", 32, dict(sigma=0.1, n_actions=8)),
    ("fishing-may-obs-v1", 64, {}),
])
def test_policy_rollout_kernel_matches_twin(cuda, env_id, hidden, overrides, source, compute):
    args, kw = _k4_case(env_id, hidden, source, cuda, **overrides)
    kw["compute"] = compute
    _assert_k4_matches_twin(args, kw, 3 + args[-1] if source == "philox" else 0)


def _assert_k4_matches_twin(args, kw, next_offset):
    compute, categorical = kw["compute"], kw["scheme"] != "continuous"
    before = pk.launches, pk.categorical_launches
    ker = pk.policy_rollout(*args, **kw)
    assert (pk.launches, pk.categorical_launches) == (before[0] + 1, before[1] + categorical)
    ref = pk.policy_rollout_reference(*args, **kw)
    torch.cuda.synchronize()
    T, B = args[-1], args[0].shape[0]
    P, R = ker.packed_t.view(8, T, B), ref.packed_t.view(8, T, B)
    # bf16: a one-ulp tanh difference can move a rounded input by 2^-8, so
    # the largest error is 5e-3 and the mean stays 1e-4; envs that rounding
    # carries across a discontinuity (a categorical CDF boundary, harvesting
    # the whole stock) are left out, at most 1e-3 of them (see chip_smoke.py)
    atol = 5e-3 if compute == "bfloat16" else 1e-4
    same = ((P[:6] - R[:6]).abs().amax((0, 1)) <= atol) & (ker.t == ref.t)
    if categorical:
        same &= (P[1] == R[1]).all(0)
    assert int((~same).sum()) <= 1e-3 * B
    pairs = [(P[r][:, same], R[r][:, same]) for r in range(6)]
    pairs += [(getattr(ker, n)[same], getattr(ref, n)[same]) for n in ("stock", "harvest",
                                                                       "ep_ret")]
    for got, want in pairs:
        diff = (got.double() - want.double()).abs()
        assert float(diff.max()) <= atol and float(diff.mean()) <= 1e-4
    assert not P[6:].any()
    for name in ("t", "ep_len"):
        assert torch.equal(getattr(ker, name)[same], getattr(ref, name)[same])
    if bool(same.all()):
        assert float(ker.stats[0]) == float(ref.stats[0])
        np.testing.assert_allclose(ker.stats.cpu().numpy(), ref.stats.cpu().numpy(),
                                   rtol=1e-3 if compute == "bfloat16" else 1e-4, atol=1e-3)
    assert ker.next_offset == ref.next_offset == next_offset


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
@pytest.mark.parametrize("B", [5, 37, 3 * pk.KERNEL_ENVS_PER_CTA + 17])
def test_policy_rollout_kernel_ragged_batch(cuda, B, env_id, compute):
    """A batch smaller than one CTA, smaller than one warp's envs, and one
    that ends inside a warp of its last CTA."""
    args, kw = _k4_case(env_id, 64, "philox", cuda, B=B, sigma=0.1)
    kw["compute"] = compute
    _assert_k4_matches_twin(args, kw, 3 + args[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_actions", [9, 16])
def test_policy_rollout_kernel_wide_categorical_head(cuda, n_actions, compute):
    """More than 8 logits: the bf16 head's second n-tile of policy outputs, up
    to the kernel's limit."""
    args, kw = _k4_case("fishing-v0", 64, "planes", cuda, sigma=0.1, n_actions=n_actions)
    kw["compute"] = compute
    _assert_k4_matches_twin(args, kw, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", ["planes", "philox"])
@pytest.mark.parametrize("env_id,hidden,overrides", [
    ("fishing-v1", 128, dict(sigma=0.1)),
    ("fishing-v1", 256, dict(sigma=0.1)),
    ("fishing-v0", 256, dict(sigma=0.1, n_actions=100)),   # the proportional grid
    ("fishing-v0", 64, dict(sigma=0.1, n_actions=100)),
    ("fishing-v0", 128, dict(sigma=0.1)),                  # relative, 3 classes
    ("fishing-may-obs-v1", 256, {}),
])
def test_policy_rollout_kernel_matches_twin_at_the_wide_widths(cuda, env_id, hidden, overrides,
                                                                source, compute):
    """Hidden 128 and 256, and up to 128 classes at any hidden size, take the
    wide path: K4 equals its twin there under the bars above."""
    args, kw = _k4_case(env_id, hidden, source, cuda, **overrides)
    kw["compute"] = compute
    _assert_k4_matches_twin(args, kw, 3 + args[-1] if source == "philox" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [5, 3 * 64 + 17, 3 * 128 + 17])
def test_policy_rollout_wide_ragged_batch(cuda, B, compute):
    """Batches that end inside the last CTA of either plan of the wide path
    (64 envs a CTA under float32, 128 on the tensor cores)."""
    args, kw = _k4_case("fishing-v0", 128, "philox", cuda, B=B, sigma=0.1, n_actions=100)
    kw["compute"] = compute
    _assert_k4_matches_twin(args, kw, 3 + args[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("n_actions", [0, 100])
@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_policy_rollout_bf16_products_equal_float32_on_exact_inputs(cuda, hidden, n_actions):
    """The tensor-core path against the FMA path, without the twin between
    them, on the narrow kernel (hidden 32 and 64 with the Gaussian head)
    and on the wide path (hidden 128 and 256, and 100 classes at every
    width; at hidden 32 its bf16 products stay FMA). Hidden activations are
    tanh values and cannot be held representable in bf16 in general, so the
    case saturates them: W1 = 0 and b1 = +-20 make every h1 exactly +-1, and
    W2 = +-32 with b2 = 16 makes every pre-activation a multiple of 64 plus
    16, so every h2 is exactly +-1, its sign decided by the whole product
    through W2. With the heads rounded to bf16 beforehand neither mode
    rounds anything, and the two kernels differ only in the order of their
    float32 sums: the float32 bar holds, for no env left out. The 100
    logits, whose last bits could move a draw across a class boundary, are
    made exact in any order: the policy head's weights are multiples of
    2^-6 below 1, so every partial sum of +-1 times them is a float32."""
    if n_actions:
        args, kw = _k4_case("fishing-v0", hidden, "philox", cuda, sigma=0.1, n_actions=n_actions)
    else:
        args, kw = _k4_case("fishing-v1", hidden, "philox", cuda, sigma=0.1)
    gen = torch.Generator().manual_seed(hidden)

    def sign(shape):
        return (torch.randint(0, 2, shape, generator=gen).float() * 2 - 1).to(cuda)

    # per tower: w1, b1, w2, b2, head weight (policy at 0-4, value at 7-11)
    w = [x.clone() for x in _towers(args[5])]
    for base in (0, 7):
        w[base].zero_()
        w[base + 1].copy_(20.0 * sign(w[base + 1].shape))
        w[base + 2].copy_(32.0 * sign(w[base + 2].shape))
        w[base + 3].fill_(16.0)
        w[base + 4].copy_(w[base + 4].to(torch.bfloat16).float())
    if n_actions:
        w[4].copy_(torch.round(w[4].clamp(-0.98, 0.98) * 64.0) / 64.0)
    args = (*args[:5], uk.merge_weights(w), *args[6:])
    runs = {c: pk.policy_rollout(*args, **dict(kw, compute=c)) for c in ("float32", "bfloat16")}
    torch.cuda.synchronize()
    f32, bf16 = runs["float32"], runs["bfloat16"]
    np.testing.assert_allclose(bf16.packed_t.cpu().numpy(), f32.packed_t.cpu().numpy(),
                               atol=1e-4, rtol=0)
    for name in ("stock", "harvest", "ep_ret"):
        np.testing.assert_allclose(getattr(bf16, name).cpu().numpy(),
                                   getattr(f32, name).cpu().numpy(), atol=1e-4, rtol=0)
    assert torch.equal(bf16.t, f32.t) and torch.equal(bf16.ep_len, f32.ep_len)
    # and the products did decide something: the value is not the bias alone
    assert float((f32.packed_t[3] - w[12][0, 0]).abs().max()) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["split", "hidden", "n_actions"])
def test_policy_rollout_wrapper_refuses_before_the_launch(cuda, which):
    """The kernel has fixed sizes and one weight format: the wrapper takes
    the 7 merged arrays only and raises on the 13 split-tower arrays and on
    sizes the kernel does not take, so the card never sees such input."""
    if which == "split":
        args, kw = _k4_case("fishing-v1", 64, "philox", cuda, sigma=0.1)
        args, match = (*args[:5], _towers(args[5]), *args[6:]), "7 merged arrays"
    elif which == "hidden":
        (args, kw), match = _k4_case("fishing-v1", 512, "philox", cuda, sigma=0.1), "hidden"
    else:
        (args, kw), match = _k4_case("fishing-v0", 64, "philox", cuda, sigma=0.1,
                                     n_actions=129), "n_actions"
    before = pk.launches
    with pytest.raises(ValueError, match=match):
        pk.policy_rollout(*args, **kw)
    assert pk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,compute", [(64, "float32"), (256, "float32"),
                                            (256, "bfloat16")])
@pytest.mark.parametrize("env_id,overrides", [("fishing-v1", {}), ("fishing-v0", {}),
                                              ("fishing-v0", dict(n_actions=100))])
def test_policy_rollout_kernel_is_deterministic(cuda, env_id, overrides, hidden, compute):
    """The statistics are summed per CTA and then over the CTAs in index
    order, with no float atomics: two identical calls give identical bits,
    also on the wide path's tensor cores and at 100 classes."""
    args, kw = _k4_case(env_id, hidden, "philox", cuda, sigma=0.1, **overrides)
    kw["compute"] = compute
    a, b = (pk.policy_rollout(*args, **kw) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(a[:-1], b[:-1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,n_actions", [(32, 100), (64, 100), (128, 0), (256, 0),
                                              (256, 100)])
def test_wide_prep_lays_out_the_weights_as_its_plain_version(cuda, hidden, n_actions, compute):
    """wide_prep's regions, at the offsets the library exports, bit for bit
    against wide_prep_reference, and its fragment-ordered bf16 copies (FWB,
    MPB; written where the wide path runs on the tensor cores, bfloat16 at
    hidden 64 and above) entry by entry against the kernel's own float32
    regions rounded to bf16, read through frag_index: the MPB copy of the
    policy head, zero in its padding classes, is what the bf16 head
    multiplies. W2B is the update kernels' copy, which K4 does not write."""
    if n_actions:
        args, _ = _k4_case("fishing-v0", hidden, "philox", cuda, sigma=0.1, n_actions=n_actions)
    else:
        args, _ = _k4_case("fishing-v1", hidden, "philox", cuda, sigma=0.1)
    weights = args[5]
    got = pk.wide_prep(weights, compute)
    torch.cuda.synchronize()
    got = pk.WidePrep(*(x.cpu() for x in got))
    want = pk.wide_prep_reference(weights, compute)
    mma = compute == "bfloat16" and hidden >= 64
    names = [f for f in pk.WidePrep._fields if f != "w2b"] if mma else pk.WidePrep._fields[:5]
    for name in names:
        g, w = getattr(got, name), getattr(want, name)
        bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
        assert g.shape == w.shape and torch.equal(g.view(bits), w.view(bits)), name
    if not mma:
        return
    H, A, AP = hidden, weights[4].shape[1] - 1, got.mp.shape[1]
    for dense, copy in ((got.fw, got.fwb), (got.mp, got.mpb)):
        n_cols = dense.shape[1]
        k = torch.arange(H).repeat_interleave(n_cols)
        n = torch.arange(n_cols).repeat(H)
        entries = copy[pk.frag_index(k, n, H)].view(H, n_cols)
        assert torch.equal(entries.view(torch.int16), dense.to(torch.bfloat16).view(torch.int16))
    assert not got.mp[:, A:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,act_dim,compute,envs", [
    (32, 1, "bfloat16", 64), (64, 16, "bfloat16", 64),        # the narrow kernel
    (32, 17, "bfloat16", 64), (32, 100, "float32", 64),       # wide, FMA
    (128, 1, "float32", 64), (256, 100, "float32", 64),
    (64, 17, "bfloat16", 128), (128, 1, "bfloat16", 128),     # wide, tensor cores
    (256, 100, "bfloat16", 128)])
def test_policy_rollout_envs_per_cta_by_path(cuda, hidden, act_dim, compute, envs):
    """The envs a CTA takes, which the wrapper reads from the library to size
    the statistics' scratch: 128 on the wide path's tensor cores (bfloat16
    at hidden 64 and above), 64 elsewhere; the wide path lays out its
    weights, the narrow kernel (hidden 32 and 64, at most 16 logits) none."""
    lib = pk.library()
    assert lib.policy_rollout_envs_per_cta(hidden, act_dim, pk.COMPUTES.index(compute)) == envs
    wide = hidden > 64 or act_dim > 16
    assert (lib.policy_rollout_prep_floats(hidden, act_dim) > 0) == wide


def _train(env, params, cfg, ts, bstate, gen, n):
    from gym_fishing_tpu_torch.agents import ppo

    mets = []
    for _ in range(n):
        ts, bstate, met = ppo.train_step(env, params, cfg, ts, bstate, gen)
        mets.append([float(x) for x in met.values()])
    return ts, bstate, np.array(mets)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 6])
def test_stacked_update_adam_step_equals_plain(cuda, k):
    """One train step on an observation window of 4 or 6 (16 packed rows; 6
    takes the instantiations for more than 4 observation fields) at 1 epoch
    x 1 minibatch: K3's step equals the plain form's from the same draws,
    under chip_smoke.py phase 10's bars."""
    import dataclasses

    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.envs.wrappers import stack_observations

    env, params = gtt.make("fishing-may-obs-v1", device=cuda)
    env = stack_observations(env, k)
    base = ppo.PPOConfig(num_envs=2048, num_steps=32, epochs=1, num_minibatches=1)
    out = {}
    before = uk.adam_launches
    for name, cfg in (("off", base),
                      ("adam", dataclasses.replace(base, fused_update=True, fused_adam=True))):
        ts = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(1), device=cuda)
        out[name], _, _ = _train(env, params, cfg, ts, batched_reset(env, params, 2048),
                                 torch.Generator(device=cuda).manual_seed(2), 1)
    assert uk.adam_launches == before + 1
    for p, q in zip(out["adam"].model.parameters(), out["off"].model.parameters()):
        p, q = p.detach(), q.detach()
        assert bool(((p - q).abs() <= 1e-6 + 5e-4 * q.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["full+adam", "stacked update+adam"])
def test_resume_is_bit_exact_on_the_card(cuda, tmp_path, form):
    """Saved after 2 iterations and restored into a fresh state and fresh
    generators, the run continues bit for bit as the run that never
    stopped: the kernels reduce in a fixed order and the CUDA generator's
    state carries the Philox seed and offset."""
    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.envs.wrappers import stack_observations
    from gym_fishing_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    stacked = form.startswith("stacked")
    env, params = gtt.make("fishing-may-obs-v1" if stacked else "fishing-v1",
                           device=cuda if stacked else "cpu")   # K4 reads host params
    if stacked:
        env = stack_observations(env, 4)
    cfg = ppo.PPOConfig(num_envs=2048, num_steps=32, fused_update=True, fused_adam=True,
                        fused_rollout=not stacked)

    def fresh(seed):
        return {"ts": ppo.make_train_state(env, cfg, torch.Generator().manual_seed(seed),
                                           device=cuda),
                "bs": batched_reset(env, params, cfg.num_envs, cuda),
                "gen": torch.Generator(device=cuda).manual_seed(seed + 1)}

    def run(tup, n):
        ts, bs, mets = _train(env, params, cfg, tup["ts"], tup["bs"], tup["gen"], n)
        return dict(tup, ts=ts, bs=bs), mets

    tup, _ = run(fresh(0), 2)
    save_checkpoint(str(tmp_path), tup, step=2)
    straight, mets = run(tup, 2)
    restored, _ = restore_checkpoint(str(tmp_path), fresh(9))
    resumed, mets_r = run(restored, 2)
    np.testing.assert_array_equal(mets_r, mets)
    for a, b in ((straight["ts"].model.parameters(), resumed["ts"].model.parameters()),
                 (straight["ts"].m.values(), resumed["ts"].m.values()),
                 (straight["ts"].v.values(), resumed["ts"].v.values())):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert (straight["ts"].count, straight["ts"].step) == (resumed["ts"].count,
                                                           resumed["ts"].step)
    for x, y in zip(tree_leaves(straight["bs"]), tree_leaves(resumed["bs"])):
        assert torch.equal(x, y)
    assert torch.equal(straight["gen"].get_state(), resumed["gen"].get_state())


# ------------------------------------------------------------ multi-device path
# One process on the card can join NCCL only at world size 1: there the
# sharded paths must be the single device's bit for bit (chip_smoke.py's
# phase 33 holds two gloo ranks on one card against the single process).

@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    import torch.distributed as dist

    from gym_fishing_tpu_torch.shard import distributed_init, make_mesh

    distributed_init(f"file://{tmp_path}/rendezvous", 1, 0, device=cuda)
    assert dist.get_backend() == "nccl"
    yield make_mesh(device=cuda)
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("env_id", ["fishing-v1", "fishing-v0"])
def test_sharded_fused_step_at_nccl_world_1_is_the_full_form(nccl_mesh, env_id):
    from gym_fishing_tpu_torch.agents import ppo
    from gym_fishing_tpu_torch.batch import batched_reset
    from gym_fishing_tpu_torch.shard.fused_ppo import make_sharded_fused_train_step

    dev = nccl_mesh.device
    env, params = gtt.make(env_id, sigma=0.05, device="cpu")
    cfg = ppo.PPOConfig(num_envs=2048, num_steps=32, fused_update=True, fused_rollout=True)
    ts0 = ppo.make_train_state(env, cfg, torch.Generator().manual_seed(0), dev)
    step = make_sharded_fused_train_step(env, params, cfg, nccl_mesh)
    out = []
    for sharded in (True, False):
        ts, bs = ts0.clone(), batched_reset(env, params, cfg.num_envs, dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        for _ in range(2):
            ts, bs, met = (step(ts, bs, gen) if sharded
                           else ppo.train_step(env, params, cfg, ts, bs, gen))
        out.append((ts, bs, met))
    (ts_a, bs_a, met_a), (ts_b, bs_b, met_b) = out
    for x, y in zip(ts_a.model.parameters(), ts_b.model.parameters()):
        assert torch.equal(x, y)
    for k in ts_b.m:
        assert torch.equal(ts_a.m[k], ts_b.m[k]) and torch.equal(ts_a.v[k], ts_b.v[k])
    for x, y in zip(tree_leaves(bs_a), tree_leaves(bs_b)):
        assert torch.equal(x, y)
    for k in met_b:
        assert torch.equal(met_a[k], met_b[k]) or (met_a[k].isnan() & met_b[k].isnan()), k


@pytest.mark.cuda
def test_sharded_rollout_at_nccl_world_1_is_the_kernel(nccl_mesh):
    from gym_fishing_tpu_torch.kernels.sharded import sharded_rollout

    dev = nccl_mesh.device
    env, params = gtt.make("fishing-v1", sigma=0.05, device="cpu")
    stock = torch.full((1 << 16,), 0.75, device=dev)
    t = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
    a = sharded_rollout(nccl_mesh, stock, t, params, "escapement", 0.5, 64, seed=11)
    b = rk.rollout(stock, t, params, "escapement", 0.5, 64, seed=11)
    torch.cuda.synchronize()
    for name in rk.KernelRollout._fields[:-1]:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_lstm_learner_on_its_graphs_matches_the_reference(cuda, monkeypatch):
    """The LSTM recurrent PPO (sb3-contrib's actor-critic at hidden 64, MLPs
    [16, 16]) through three train steps on fishing-v2, 256 envs x 32 steps,
    2 epochs x 4 minibatches, the envs at years 40 .. 99 so that episodes
    end inside the segments: on the card the rollout replays 2T + 2 CUDA
    graphs from its first run on and the update three a minibatch, which
    give the eager path's bits (the same phases called, `_graphs` patched),
    on given draws and on the generator's;
    against the benchmark's plain reference (float32, TF32 off) on the card
    from the same weights and draws, the weights after the first two steps
    within 1e-4 of each leaf's largest entry (float32 sums in another order,
    carried through 16 Adam steps), the state resets exactly."""
    import importlib
    import sys
    from pathlib import Path

    from gym_fishing_tpu_torch.agents import ppo_rnn
    from gym_fishing_tpu_torch.batch import BatchState
    from gym_fishing_tpu_torch.core.types import EnvState

    bench = str(Path(__file__).resolve().parent.parent / "benchmark")
    sys.path.insert(0, bench)
    try:
        ref = importlib.import_module("reference.rppo_lstm")
    finally:
        sys.path.remove(bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ppo_rnn.RPPOConfig(num_envs=256, num_steps=32, epochs=2, num_minibatches=4,
                             hidden=64, cell="lstm", net_arch=(16, 16))
    env, params = gtt.make("fishing-v2", device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, T = cfg.num_envs, cfg.num_steps
    draws = [{"act": torch.randn((T, B, 1), generator=gen, device=cuda),
              "env": torch.randn((T, 2, B), generator=gen, device=cuda),
              "perms": [torch.randperm(B, generator=gen, device=cuda) for _ in range(2)]}
             for _ in range(2)]
    ts0 = ppo_rnn.make_rppo_state(env, cfg, torch.Generator().manual_seed(2), cuda)
    w0 = {k: x.detach().clone() for k, x in ts0.params().items()}
    t0 = torch.randint(40, 100, (B,), generator=gen, device=cuda, dtype=torch.int32)
    s0 = {"stock": torch.full((B,), 0.75, device=cuda), "t": t0,
          "ep_ret": torch.zeros(B, device=cuda), "ep_len": t0.clone()}
    out = {}
    for graphs in (True, False):
        monkeypatch.setattr(ppo_rnn, "_graphs", lambda device, graphs=graphs: graphs)
        bs = BatchState(env=EnvState(stock=s0["stock"].clone(), harvest=torch.full_like(
            s0["stock"], 0.0125), t=s0["t"].clone()), episode_return=s0["ep_ret"].clone(),
            episode_length=s0["ep_len"].clone())
        ts, h = ts0.clone(), ppo_rnn.init_hidden(cfg, B)
        before = ppo_rnn.state_resets()
        for d in draws:
            ts, bs, h, met = ppo_rnn.train_step(env, params, cfg, ts, bs, h, perms=d["perms"],
                                                act_noise=d["act"], env_noise=d["env"])
        w2, resets = {k: x.detach().clone() for k, x in ts.params().items()}, (
            ppo_rnn.state_resets() - before)
        upd, roll = ppo_rnn._updates[ts.model], ppo_rnn._rollouts[ts.model]
        assert (upd.graphs is not None and len(upd.graphs) == 3) == graphs
        assert (roll.graphs is not None and len(roll.graphs) == 2 * T + 2) == graphs
        # a third step on the generator's draws
        ts, bs, h, met = ppo_rnn.train_step(env, params, cfg, ts, bs, h,
                                            torch.Generator(device=cuda).manual_seed(9))
        out[graphs] = (ts, met, resets, w2, h)
    (ts_g, met_g, resets, w_g, h_g), (ts_e, met_e, resets_e, w_e, h_e) = out[True], out[False]
    for k in w0:
        assert torch.equal(w_g[k], w_e[k]), k
        assert torch.equal(ts_g.params()[k], ts_e.params()[k]), k
        assert torch.equal(ts_g.m[k], ts_e.m[k]) and torch.equal(ts_g.v[k], ts_e.v[k]), k
    for k in met_g:
        assert torch.equal(met_g[k], met_e[k]), k
    assert all(torch.equal(x, y) for x, y in zip(h_g, h_e))
    env_d = {"r": 0.3, "K": 1.0, "sigma": 0.05, "sigma_m": 0.05, "price": 1.0, "cost": 0.0,
             "init_state": 0.75, "Tmax": 100, "action_scale": 1.0, "collapse_penalty": 0.0}
    rppo = {"num_steps": T, "epochs": 2, "num_minibatches": 4, "gamma": cfg.gamma,
            "gae_lambda": cfg.gae_lambda, "clip_eps": cfg.clip_eps, "lr": cfg.lr,
            "vf_coef": cfg.vf_coef, "ent_coef": cfg.ent_coef,
            "max_grad_norm": cfg.max_grad_norm, "adam_b1": 0.9, "adam_b2": 0.999,
            "adam_eps": 1e-5}
    ref_draws = [{"act": d["act"][..., 0], "env": d["env"], "perms": d["perms"]} for d in draws]
    res = ref.run(w0, s0, env_d, rppo, ref_draws, keep=lambda w, m, v: dict(w))
    assert resets == resets_e == sum(m["dones"] for m, _ in res) > 0
    w_ref = res[-1][1]
    for k in w0:
        gap = float((w_g[k] - w_ref[k]).abs().max())
        assert gap <= 1e-4 * float(w_ref[k].abs().max()) + 1e-12, (k, gap)
