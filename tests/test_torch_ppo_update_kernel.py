"""The fused PPO update kernels' plain twins (K2, K3) against the JAX kernels.

The JAX kernels run as tests/test_update_kernel.py runs them on the CPU
(Mosaic interpret mode), on that file's own inputs; the port starts from the
same weights, converted from the flax tree. Both sides sum in float32 in
different orders, so gradients agree at rtol 2e-4 / atol 2e-6 (the JAX
file's own bar) and whole epoch scans at rtol 1e-4 / atol 2e-6.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_update_kernel import _setup, _setup_categorical

from gym_fishing_tpu.agents import ppo as jppo
from gym_fishing_tpu.agents import ppo_fused as jfused
from gym_fishing_tpu.kernels import ppo_update_kernel as jk
from gym_fishing_tpu_torch.agents import ppo, ppo_fused
from gym_fishing_tpu_torch.convert import (
    actor_critic_from_numpy,
    actor_critic_to_numpy,
    adam_state_from_numpy,
)
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

# the port's entry points default to the card; these tests run on the CPU
actor_critic_from_numpy = functools.partial(actor_critic_from_numpy, device="cpu")

torch.set_num_threads(1)


def _case(head, ent_coef=0.0, seed=0, n=256):
    """(cfg, ts, params, batch, packed, n_actions or 1) from the JAX file."""
    if head == "gaussian":
        return (*_setup(ent_coef=ent_coef, seed=seed, n=n), 1)
    return _setup_categorical(ent_coef=ent_coef, seed=seed, n=n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _packed_t(packed) -> torch.Tensor:
    return ppo_fused.pack_feature_major(_torch(packed))


def _assert_trees_close(got, want, rtol, atol):
    want = _np(want)
    paths = jax.tree.leaves_with_path(want)
    got_leaves = {jax.tree_util.keystr(k): v for k, v in jax.tree.leaves_with_path(got)}
    assert len(got_leaves) == len(paths)
    for k, ref in paths:
        np.testing.assert_allclose(got_leaves[jax.tree_util.keystr(k)], ref, rtol=rtol,
                                   atol=atol, err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_twin_grad_matches_jax_kernel_and_autodiff(head, ent_coef):
    cfg, ts, params, batch, packed, a = _case(head, ent_coef)
    (_, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(ts.apply_fn, p, cfg, batch, head == "gaussian"), has_aux=True,
    )(params)
    k_grads, k_met = jfused.fused_grad(
        params, jfused.pack_feature_major(packed), cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
        obs_dim=1, act_dim=a, tile=128, head=head, interpret=True)

    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(
        dict(model.named_parameters()), _packed_t(packed), cfg.clip_eps, cfg.vf_coef,
        cfg.ent_coef, obs_dim=1, act_dim=a, tile=128, head=head)
    got = actor_critic_to_numpy(grads)
    for want in (ref_grads, k_grads):
        _assert_trees_close(got, want, rtol=2e-4, atol=2e-6)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        for want in (ref_metrics, k_met):
            np.testing.assert_allclose(float(met[name]), float(want[name]), rtol=2e-4,
                                       atol=2e-6, err_msg=name)


def test_twin_tile_order_subset():
    """tile_order names a strict subset: the gradient is autodiff's over
    exactly those tiles' samples."""
    cfg, ts, params, _, packed, _ = _case("gaussian", seed=5, n=512)
    tile = 128
    rows = jnp.concatenate([packed[3 * tile:4 * tile], packed[0:tile]], axis=0)
    sub = (rows[:, :1], rows[:, 1:2], rows[:, 2], rows[:, 3], rows[:, 4], rows[:, 5])
    (_, ref_metrics), ref_grads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(ts.apply_fn, p, cfg, sub, True), has_aux=True)(params)
    adv = np.asarray(rows[:, 4], np.float32)
    stats = torch.tensor([adv.mean(), 1.0 / (adv.std() + 1e-8)], dtype=torch.float32)
    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(
        dict(model.named_parameters()), _packed_t(packed), cfg.clip_eps, cfg.vf_coef,
        cfg.ent_coef, obs_dim=1, act_dim=1, tile=tile,
        tile_order=torch.tensor([3, 0], dtype=torch.int32), adv_stats=stats)
    _assert_trees_close(actor_critic_to_numpy(grads), ref_grads, rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(float(met["loss"]), float(ref_metrics["loss"]), rtol=2e-4)


def test_twin_multi_tile_accumulation():
    """Four tiles of 128 give the gradient of one tile of 512."""
    cfg, _, params, _, packed, _ = _case("gaussian", seed=3, n=512)
    named = dict(actor_critic_from_numpy(_np(params)).named_parameters())
    data = _packed_t(packed)
    g1, m1 = ppo_fused.fused_grad(named, data, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                                  obs_dim=1, act_dim=1, tile=512)
    g4, m4 = ppo_fused.fused_grad(named, data, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                                  obs_dim=1, act_dim=1, tile=128)
    for k in g1:
        np.testing.assert_allclose(g1[k].numpy(), g4[k].numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)


@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_twin_bfloat16_matches_jax_bfloat16_and_tracks_f32(head):
    """compute="bfloat16": the three 2H-contractions take bf16-rounded
    inputs and sum in f32. The twin matches the JAX kernel in the same mode
    (both round the same values, so only the summation order differs) and
    keeps the f32 gradient's direction (cosine > 0.999)."""
    cfg, _, params, _, packed, a = _case(head, seed=5, n=512)
    named = dict(actor_critic_from_numpy(_np(params)).named_parameters())
    data = _packed_t(packed)
    kw = dict(obs_dim=1, act_dim=a, tile=128, head=head)
    g16, m16 = ppo_fused.fused_grad(named, data, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                                    compute="bfloat16", **kw)
    g32, m32 = ppo_fused.fused_grad(named, data, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef, **kw)
    j16, jm16 = jfused.fused_grad(params, jfused.pack_feature_major(packed), cfg.clip_eps,
                                  cfg.vf_coef, cfg.ent_coef, compute="bfloat16",
                                  interpret=True, **kw)
    _assert_trees_close(actor_critic_to_numpy(g16), j16, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(float(m16["loss"]), float(jm16["loss"]), rtol=2e-4)
    x = torch.cat([g.reshape(-1) for g in g32.values()]).double()
    y = torch.cat([g.reshape(-1) for g in g16.values()]).double()
    assert float(x @ y / (x.norm() * y.norm())) > 0.999
    np.testing.assert_allclose(float(m16["loss"]), float(m32["loss"]), rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("max_grad_norm", [1e6, 1e-3])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_twin_adam_matches_jax_kernel(head, max_grad_norm):
    """One K3 launch from non-zero moments at count 5, below and above the
    clip threshold: new weights, moments and metric sums."""
    cfg, _, params, _, packed, a = _case(head, ent_coef=0.01, seed=3, n=512)
    jw = jk.merge_weights(jfused.kernel_weights(params, head))
    rng = np.random.default_rng(0)
    m_np = [0.01 * rng.standard_normal(x.shape).astype(np.float32) for x in jw]
    v_np = [1e-4 * rng.random(x.shape).astype(np.float32) for x in jw]
    for arrs in (m_np, v_np):   # no moment on the cross-tower blocks
        arrs[2] = arrs[2] * np.asarray(jk._block_diag_masks(64, a)[0])
        arrs[4] = arrs[4] * np.asarray(jk._block_diag_masks(64, a)[1])
    order = np.array([3, 1], np.int32)
    mu, inv_std, lr = 0.03, 0.95, 3e-4
    bc1, bc2 = 1.0 - 0.9 ** 5, 1.0 - 0.999 ** 5
    scal = np.zeros(jk.ADAM_NUM_SCALARS, np.float32)
    scal[:6] = [cfg.clip_eps, cfg.vf_coef, 1.0 / 256, mu, inv_std, cfg.ent_coef]
    scal[8:11] = [lr, bc1, bc2]
    j_w, j_m, j_v, j_met = jk.fused_minibatch_grad_adam(
        jfused.pack_feature_major(packed), jnp.asarray(order), jw,
        tuple(map(jnp.asarray, m_np)), tuple(map(jnp.asarray, v_np)), jnp.asarray(scal),
        obs_dim=1, act_dim=a, tile=128, head=head, max_grad_norm=max_grad_norm,
        interpret=True)

    w = tuple(_torch(x) for x in jw)
    *new, met = uk.fused_minibatch_grad_adam(
        _packed_t(packed), torch.from_numpy(order), w, tuple(map(torch.from_numpy, m_np)),
        tuple(map(torch.from_numpy, v_np)), torch.tensor([mu, inv_std]),
        clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, lr=lr, bc1=bc1,
        bc2=bc2, obs_dim=1, act_dim=a, tile=128, head=head, max_grad_norm=max_grad_norm)
    for got, want, old in zip(new[0], j_w, w):   # weights through their ~lr update
        np.testing.assert_allclose((got - old).numpy(), np.asarray(want) - old.numpy(),
                                   rtol=1e-3, atol=1e-8)
    for got_t, want_t in ((new[1], j_m), (new[2], j_v)):
        for got, want in zip(got_t, want_t):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(met.numpy(), np.asarray(j_met), rtol=2e-4, atol=1e-6)
    if head == "categorical":   # no log_std parameter: passed through
        assert torch.equal(new[0][6], w[6]) and torch.equal(new[2][6], _torch(v_np[6]))


def _port_state(ts) -> ppo.TrainState:
    adam = jfused._find_adam_state(ts.opt_state)
    m, v, count = adam_state_from_numpy(_np(adam.mu), _np(adam.nu), adam.count)
    return ppo.TrainState(model=actor_critic_from_numpy(_np(ts.params)), m=m, v=v,
                          count=count, step=int(ts.step))


@pytest.mark.parametrize("form,head,anneal", [
    ("update", "gaussian", False), ("adam", "gaussian", False),
    ("update", "categorical", False), ("adam", "categorical", False),
    ("update", "gaussian", True), ("adam", "gaussian", True),
])
def test_epoch_scan_matches_jax(form, head, anneal):
    """fused_epoch_scan (K2 + clip + Adam by hand) and fused_epoch_scan_adam
    (K3) against the JAX scans over 2 epochs x 2 minibatches with the JAX
    tile permutations: parameters, Adam moments and count, metrics."""
    cfg, ts, params, _, packed, a = _case(head, ent_coef=0.01, seed=3, n=512)
    cfg = dataclasses.replace(cfg, epochs=2, num_minibatches=2, anneal_lr=anneal,
                              total_iterations=2)
    if anneal:   # the scheduled optimizer
        env_id = "fishing-v1" if head == "gaussian" else "fishing-v0"
        from gym_fishing_tpu import registry

        ts = jppo.make_train_state(registry.make(env_id)[0], cfg, jax.random.key(0))
    ts = ts.replace(params=params)
    key = jax.random.key(42)
    num_tiles = 2   # N = 512, minibatch 256 -> tile 256
    perms = [np.asarray(jax.random.permutation(k, num_tiles))
             for k in jax.random.split(key, cfg.epochs)]
    j_scan = jfused.fused_epoch_scan_adam if form == "adam" else jfused.fused_epoch_scan
    j_ts, j_met = j_scan(cfg, ts, jfused.pack_feature_major(packed), 1, a, key, head=head,
                         interpret=True)

    port_ts = _port_state(ts)
    scan = ppo_fused.fused_epoch_scan_adam if form == "adam" else ppo_fused.fused_epoch_scan
    met = scan(ppo.PPOConfig(**dataclasses.asdict(cfg)), port_ts, _packed_t(packed), 1, a,
               head=head, perms=[torch.from_numpy(np.array(p)) for p in perms])

    _assert_trees_close(actor_critic_to_numpy(port_ts.model), j_ts.params, rtol=1e-4,
                        atol=2e-6)
    adam = jfused._find_adam_state(j_ts.opt_state)
    _assert_trees_close(actor_critic_to_numpy(port_ts.m), adam.mu, rtol=1e-4, atol=2e-6)
    _assert_trees_close(actor_critic_to_numpy(port_ts.v), adam.nu, rtol=1e-4, atol=2e-7)
    assert port_ts.count == int(adam.count) == 4 and port_ts.step == int(j_ts.step) == 4
    for name in ("pg_loss", "v_loss", "approx_kl", "loss", "entropy"):
        np.testing.assert_allclose(met[name].numpy(), np.asarray(j_met[name]).reshape(-1),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_merge_layout_and_masks_match_jax():
    _, _, params, _, _, _ = _case("gaussian")
    split = jfused.kernel_weights(params)
    model = actor_critic_from_numpy(_np(params))
    port_split = ppo_fused.kernel_weights(dict(model.named_parameters()))
    for got, want in zip(port_split, split):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    merged = uk.merge_weights(port_split)
    for got, want in zip(merged, jk.merge_weights(split)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(uk.unmerge_weights(merged, 64, 1), split):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = uk.flatten_merged(merged)
    assert flat.numel() == 17027   # the ~17k merged parameters at hidden 64
    for got, want in zip(uk.unflatten_merged(flat, 1, 64, 1), merged):
        assert torch.equal(got, want)
    for got, want in zip(uk._block_diag_masks(64, 3), jk._block_diag_masks(64, 3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _concatenated(split):
    """The 7 merged arrays concatenated from the 13 split-tower arrays, as
    the JAX package builds them."""
    (w1p, b1p, w2p, b2p, wm, bm, ls, w1v, b1v, w2v, b2v, wv, bv) = split
    h, a = w1p.shape[1], wm.shape[1]
    w2c = torch.cat([torch.cat([w2p, torch.zeros(h, h)], 1),
                     torch.cat([torch.zeros(h, h), w2v], 1)])
    whc = torch.cat([torch.cat([wm, torch.zeros(h, 1)], 1),
                     torch.cat([torch.zeros(h, a), wv], 1)])
    return (torch.cat([w1p, w1v], 1), torch.cat([b1p, b1v]), w2c, torch.cat([b2p, b2v]), whc,
            torch.cat([bm, bv]), ls)


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_merged_weights_are_views_of_one_buffer(head, hidden):
    """`merge_weights` gives the concatenated arrays bit for bit, as views of
    one flat buffer in the kernels' order, which `flatten_merged` hands over
    without a copy; `unflatten_merged`'s views (K2's and K3's outputs) do
    the same, and a plain tuple is concatenated into the same bits."""
    model = ppo.ActorCritic(1, 1 if head == "gaussian" else 100, head == "gaussian", hidden,
                            generator=torch.Generator().manual_seed(5))
    split = ppo_fused.kernel_weights(dict(model.named_parameters()), head)
    merged = uk.merge_weights(split)
    flat = uk.flatten_merged(merged)
    assert isinstance(merged, uk.MergedWeights) and len(merged) == 7
    assert flat is merged.flat and flat.is_contiguous()
    a = split[4].shape[1]
    assert flat.shape == (sum(r * c for r, c in uk.merged_shapes(1, hidden, a)),)
    offset = 0
    for got, want in zip(merged, _concatenated(split)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert got.data_ptr() == flat.data_ptr() + 4 * offset and got.is_contiguous()
        offset += got.numel()
    assert offset == flat.numel()
    assert torch.equal(uk.flatten_merged(tuple(merged)).view(torch.int32),
                       flat.view(torch.int32))
    out = torch.cat([flat, torch.ones(4)])   # a K2 output: the gradients, then 4 sums
    views = uk.unflatten_merged(out, 1, hidden, a)
    assert uk.flatten_merged(views).data_ptr() == out.data_ptr()
    assert all(x.data_ptr() == y.data_ptr() - flat.data_ptr() + out.data_ptr()
               for x, y in zip(views, merged))


def test_cpu_wrappers_never_load_the_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"tried to build/load {name}")

    monkeypatch.setattr(_build, "load", refuse)
    cfg, _, params, _, packed, _ = _case("gaussian")
    w = uk.merge_weights(ppo_fused.kernel_weights(
        dict(actor_critic_from_numpy(_np(params)).named_parameters())))
    zeros = tuple(torch.zeros_like(x) for x in w)
    before = (uk.grad_launches, uk.adam_launches)
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=1, tile=128)
    order, stats = torch.tensor([1], dtype=torch.int32), torch.tensor([0.0, 1.0])
    uk.fused_minibatch_grad(_packed_t(packed), order, w, stats, **kw)
    uk.fused_minibatch_grad_adam(_packed_t(packed), order, w, zeros, zeros, stats, lr=1e-3,
                                 bc1=0.1, bc2=0.001, **kw)
    assert (uk.grad_launches, uk.adam_launches) == before
    assert "ppo_update_kernel" not in _build._LIBS


@pytest.mark.parametrize("bad", ["rows", "ragged", "order_dtype", "stats", "head"])
def test_wrapper_rejects_bad_inputs(bad):
    _, _, params, _, packed, _ = _case("gaussian")
    weights = ppo_fused.merged_weights(
        dict(actor_critic_from_numpy(_np(params)).named_parameters()))
    data, order = _packed_t(packed), torch.tensor([0], dtype=torch.int32)
    stats = torch.tensor([0.0, 1.0])
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=1, act_dim=1, tile=128)
    if bad == "rows":
        data = data[:6]
    elif bad == "ragged":
        kw["tile"] = 100
    elif bad == "order_dtype":
        order = order.long()
    elif bad == "stats":
        stats = stats[:1]
    else:
        kw["head"] = "beta"
    with pytest.raises(ValueError):
        uk.fused_minibatch_grad(data, order, weights, stats, **kw)


# ------------------------------------------------ 16 packed rows (obs_dim 4)

def _case_obs4(head, ent_coef=0.01, seed=0, n=512, k=4):
    """A stacked env's minibatch: obs windows of k (default 4, so 9 fields,
    Gaussian or categorical with the class index as one column, that pad to
    16 rows). (cfg, params, packed [n, k + 5], act_dim)."""
    from gym_fishing_tpu import registry
    from gym_fishing_tpu.envs.wrappers import stack_observations

    env = stack_observations(registry.make("fishing-may-obs-v1" if head == "gaussian"
                                           else "fishing-v0")[0], k)
    cfg = jppo.PPOConfig(hidden=64, ent_coef=ent_coef)
    keys = jax.random.split(jax.random.key(seed), 8)
    ts = jppo.make_train_state(env, cfg, keys[0])
    leaves, tdef = jax.tree.flatten(ts.params)
    params = jax.tree.unflatten(tdef, [
        x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
        for x, k in zip(leaves, jax.random.split(keys[1], len(leaves)))])
    obs = 0.7 * jax.random.normal(keys[2], (n, k), jnp.float32)
    dist, value = ts.apply_fn(params, obs)
    if head == "gaussian":
        log_std = params["params"]["log_std"]
        action = dist[0] + jnp.exp(log_std) * jax.random.normal(keys[3], (n, 1), jnp.float32)
        logp = jppo._normal_logp(action, dist[0], log_std)
        act_col, a = action, 1
    else:
        action = jax.random.categorical(keys[3], dist[0])
        logp = jax.nn.log_softmax(dist[0])[jnp.arange(n), action]
        act_col, a = action[:, None].astype(jnp.float32), env.config.n_actions
    packed = jnp.concatenate([
        obs, act_col, (logp + 0.3 * jax.random.normal(keys[4], (n,)))[:, None],
        (value + 0.3 * jax.random.normal(keys[5], (n,)))[:, None],
        jax.random.normal(keys[6], (n, 1)), (value + jax.random.normal(keys[7], (n,)))[:, None],
    ], axis=1).astype(jnp.float32)
    return cfg, params, packed, a


def test_pack_feature_major_pads_9_fields_to_16_rows_as_jax():
    _, _, packed, _ = _case_obs4("gaussian")
    assert packed.shape[1] == 9
    got = _packed_t(packed)
    want = np.asarray(jfused.pack_feature_major(packed))
    assert got.shape == want.shape == (16, packed.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert uk.packed_rows(8) == 8 and uk.packed_rows(9) == 16 and uk.packed_rows(24) == 24


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
def test_twin_at_obs_dim_4_matches_jax_kernel(head, compute):
    """K2's twin reads the 16-row matrix of obs_dim 4 and equals the JAX
    kernel (interpret mode) there, under the obs_dim = 1 tolerances."""
    cfg, params, packed, a = _case_obs4(head, seed=2)
    kw = dict(obs_dim=4, act_dim=a, tile=128, head=head, compute=compute)
    j_grads, j_met = jfused.fused_grad(params, jfused.pack_feature_major(packed), cfg.clip_eps,
                                       cfg.vf_coef, cfg.ent_coef, interpret=True, **kw)
    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(dict(model.named_parameters()), _packed_t(packed),
                                      cfg.clip_eps, cfg.vf_coef, cfg.ent_coef, **kw)
    tol = dict(rtol=2e-4, atol=2e-6) if compute == "float32" else dict(rtol=2e-3, atol=2e-5)
    _assert_trees_close(actor_critic_to_numpy(grads), j_grads, **tol)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["gaussian", "categorical"])
@pytest.mark.parametrize("k,rows", [(6, 16), (12, 24)])
def test_twin_at_long_observations_matches_jax_kernel(k, rows, head, compute):
    """Windows of 6 and 12 observations (11 and 17 fields: 16 and 24 rows),
    which the CUDA kernel takes since it owns dW1c's entries by thread: the
    twin equals the JAX kernel (interpret mode) under the obs_dim = 1
    tolerances."""
    cfg, params, packed, a = _case_obs4(head, seed=5, k=k)
    assert _packed_t(packed).shape[0] == rows
    kw = dict(obs_dim=k, act_dim=a, tile=128, head=head, compute=compute)
    j_grads, j_met = jfused.fused_grad(params, jfused.pack_feature_major(packed), cfg.clip_eps,
                                       cfg.vf_coef, cfg.ent_coef, interpret=True, **kw)
    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(dict(model.named_parameters()), _packed_t(packed),
                                      cfg.clip_eps, cfg.vf_coef, cfg.ent_coef, **kw)
    tol = dict(rtol=2e-4, atol=2e-6) if compute == "float32" else dict(rtol=2e-3, atol=2e-5)
    _assert_trees_close(actor_critic_to_numpy(grads), j_grads, **tol)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


def test_twin_adam_at_obs_dim_4_matches_jax_kernel():
    cfg, params, packed, a = _case_obs4("gaussian", seed=4)
    jw = jk.merge_weights(jfused.kernel_weights(params, "gaussian"))
    zeros = tuple(jnp.zeros_like(x) for x in jw)
    scal = np.zeros(jk.ADAM_NUM_SCALARS, np.float32)
    scal[:6] = [cfg.clip_eps, cfg.vf_coef, 1.0 / 256, 0.02, 1.1, cfg.ent_coef]
    scal[8:11] = [3e-4, 0.1, 0.001]
    order = np.array([2, 0], np.int32)
    j_w, j_m, j_v, j_met = jk.fused_minibatch_grad_adam(
        jfused.pack_feature_major(packed), jnp.asarray(order), jw, zeros, zeros,
        jnp.asarray(scal), obs_dim=4, act_dim=a, tile=128, max_grad_norm=0.5, interpret=True)
    w = tuple(_torch(x) for x in jw)
    tz = tuple(torch.zeros_like(x) for x in w)
    *new, met = uk.fused_minibatch_grad_adam(
        _packed_t(packed), torch.from_numpy(order), w, tz, tz, torch.tensor([0.02, 1.1]),
        clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, lr=3e-4, bc1=0.1,
        bc2=0.001, obs_dim=4, act_dim=a, tile=128, max_grad_norm=0.5)
    for got, want, old in zip(new[0], j_w, w):
        np.testing.assert_allclose((got - old).numpy(), np.asarray(want) - old.numpy(),
                                   rtol=1e-3, atol=1e-8)
    for got_t, want_t in ((new[1], j_m), (new[2], j_v)):
        for got, want in zip(got_t, want_t):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(met.numpy(), np.asarray(j_met), rtol=2e-4, atol=1e-6)


def test_wrapper_takes_only_as_many_rows_as_fit():
    """The twin takes any multiple of 8 rows that holds the fields; fewer
    rows than fields raise before any arithmetic."""
    _, params, packed, _ = _case_obs4("gaussian")
    weights = ppo_fused.merged_weights(
        dict(actor_critic_from_numpy(_np(params)).named_parameters()))
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.0, obs_dim=4, act_dim=1, tile=128)
    data, order, stats = _packed_t(packed), torch.tensor([0], dtype=torch.int32), \
        torch.tensor([0.0, 1.0])
    g16, m16 = uk.fused_minibatch_grad(data, order, weights, stats, **kw)
    g32, m32 = uk.fused_minibatch_grad(torch.cat([data, torch.zeros_like(data)]), order,
                                       weights, stats, **kw)
    assert all(torch.equal(x, y) for x, y in zip(g16, g32)) and torch.equal(m16, m32)
    with pytest.raises(ValueError, match="must fit 8 rows"):
        uk.fused_minibatch_grad(data[:8], order, weights, stats, **kw)


# ------------------------------ hidden 128 and 256, categorical heads of 100

def _case_wide(head, hidden, seed=0, n=256):
    """A minibatch at the widths of the kernels' wide path: fishing-v1's
    Gaussian head, or fishing-v0's proportional grid of 100 quotas (the
    categorical head of 100 classes), at `hidden`. (cfg, params, packed [n, 6],
    act_dim)."""
    from gym_fishing_tpu import registry

    env = registry.make("fishing-v1" if head == "gaussian" else "fishing-v0",
                        **({} if head == "gaussian" else {"n_actions": 100}))[0]
    cfg = jppo.PPOConfig(hidden=hidden, ent_coef=0.01)
    keys = jax.random.split(jax.random.key(seed), 8)
    ts = jppo.make_train_state(env, cfg, keys[0])
    leaves, tdef = jax.tree.flatten(ts.params)
    params = jax.tree.unflatten(tdef, [
        x + 0.05 * jax.random.normal(k, x.shape, x.dtype)
        for x, k in zip(leaves, jax.random.split(keys[1], len(leaves)))])
    obs = 0.7 * jax.random.normal(keys[2], (n, 1), jnp.float32)
    dist, value = ts.apply_fn(params, obs)
    if head == "gaussian":
        log_std = params["params"]["log_std"]
        action = dist[0] + jnp.exp(log_std) * jax.random.normal(keys[3], (n, 1), jnp.float32)
        logp = jppo._normal_logp(action, dist[0], log_std)
        act_col, a = action, 1
    else:
        action = jax.random.categorical(keys[3], dist[0])
        logp = jax.nn.log_softmax(dist[0])[jnp.arange(n), action]
        act_col, a = action[:, None].astype(jnp.float32), env.config.n_actions
    packed = jnp.concatenate([
        obs, act_col, (logp + 0.3 * jax.random.normal(keys[4], (n,)))[:, None],
        (value + 0.3 * jax.random.normal(keys[5], (n,)))[:, None],
        jax.random.normal(keys[6], (n, 1)), (value + jax.random.normal(keys[7], (n,)))[:, None],
    ], axis=1).astype(jnp.float32)
    return cfg, params, packed, a


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,head", [(128, "gaussian"), (256, "gaussian"),
                                         (128, "categorical"), (256, "categorical")])
def test_twin_at_the_wide_widths_matches_jax_kernel(hidden, head, compute):
    """K2's twin at hidden 128 and 256, Gaussian and 100 classes, equals the
    JAX kernel (interpret mode), under the obs_dim = 4 tolerances."""
    cfg, params, packed, a = _case_wide(head, hidden, seed=hidden)
    assert a == (1 if head == "gaussian" else 100)
    kw = dict(obs_dim=1, act_dim=a, tile=128, head=head, compute=compute)
    j_grads, j_met = jfused.fused_grad(params, jfused.pack_feature_major(packed), cfg.clip_eps,
                                       cfg.vf_coef, cfg.ent_coef, interpret=True, **kw)
    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(dict(model.named_parameters()), _packed_t(packed),
                                      cfg.clip_eps, cfg.vf_coef, cfg.ent_coef, **kw)
    tol = dict(rtol=2e-4, atol=2e-6) if compute == "float32" else dict(rtol=2e-3, atol=2e-5)
    _assert_trees_close(actor_critic_to_numpy(grads), j_grads, **tol)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("hidden,head", [(256, "gaussian"), (128, "categorical")])
def test_twin_adam_at_the_wide_widths_matches_jax_kernel(hidden, head):
    cfg, params, packed, a = _case_wide(head, hidden, seed=3)
    jw = jk.merge_weights(jfused.kernel_weights(params, head))
    zeros = tuple(jnp.zeros_like(x) for x in jw)
    scal = np.zeros(jk.ADAM_NUM_SCALARS, np.float32)
    scal[:6] = [cfg.clip_eps, cfg.vf_coef, 1.0 / 256, 0.02, 1.1, cfg.ent_coef]
    scal[8:11] = [3e-4, 0.1, 0.001]
    order = np.array([1, 0], np.int32)
    j_w, j_m, j_v, j_met = jk.fused_minibatch_grad_adam(
        jfused.pack_feature_major(packed), jnp.asarray(order), jw, zeros, zeros,
        jnp.asarray(scal), obs_dim=1, act_dim=a, tile=128, max_grad_norm=0.5, head=head,
        interpret=True)
    w = tuple(_torch(x) for x in jw)
    tz = tuple(torch.zeros_like(x) for x in w)
    *new, met = uk.fused_minibatch_grad_adam(
        _packed_t(packed), torch.from_numpy(order), w, tz, tz, torch.tensor([0.02, 1.1]),
        clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, lr=3e-4, bc1=0.1,
        bc2=0.001, obs_dim=1, act_dim=a, tile=128, max_grad_norm=0.5, head=head)
    # Adam's first step from zero moments divides each gradient by its own
    # size: among the 2^16 entries of a tower's W2 block at hidden 256 a few
    # gradients are small enough that the summation order moves their step
    # by ~3e-8 (lr / 10^4), hence atol 1e-7 here where hidden 64 keeps 1e-8
    for got, want, old in zip(new[0], j_w, w):
        np.testing.assert_allclose((got - old).numpy(), np.asarray(want) - old.numpy(),
                                   rtol=1e-3, atol=1e-7)
    for got_t, want_t in ((new[1], j_m), (new[2], j_v)):
        for got, want in zip(got_t, want_t):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-9)
    np.testing.assert_allclose(met.numpy(), np.asarray(j_met), rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("max_grad_norm", [1e6, 1e-3, "half"])
@pytest.mark.parametrize("hidden,head", [(64, "gaussian"), (64, "categorical"),
                                         (256, "gaussian"), (256, "categorical")])
def test_clip_adam_alone_matches_k3_and_jax(hidden, head, max_grad_norm):
    """K3's stage 3 alone (`clip_adam`, here its twin on CPU tensors), from
    the merged gradients as stage 2 lays them out, equals
    `fused_minibatch_grad_adam_reference`'s optimizer step bit for bit and
    JAX's K3 (interpret mode) under test_twin_adam_matches_jax_kernel's bars:
    one step from non-zero moments at count 5, below and above the clip
    threshold, and ("half") from a zero first moment with the threshold at
    half the gradient's masked norm, where m = (1 - beta1) g scale holds the
    norm in every entry; at hidden 64 and 256, fishing-v1's Gaussian head
    and 100 classes."""
    cfg, params, packed, a = _case_wide(head, hidden, seed=7)
    jw = jk.merge_weights(jfused.kernel_weights(params, head))
    rng = np.random.default_rng(1)
    m_np = [0.01 * rng.standard_normal(x.shape).astype(np.float32) for x in jw]
    v_np = [1e-4 * rng.random(x.shape).astype(np.float32) for x in jw]
    masks = [np.asarray(x) for x in jk._block_diag_masks(hidden, a)]
    for arrs in (m_np, v_np):   # no moment on the cross-tower blocks
        arrs[2] = arrs[2] * masks[0]
        arrs[4] = arrs[4] * masks[1]
    order = np.array([1, 0], np.int32)
    mu, inv_std, lr = 0.03, 0.95, 3e-4
    bc1, bc2 = 1.0 - 0.9 ** 5, 1.0 - 0.999 ** 5
    w = tuple(_torch(x) for x in jw)
    data, order_t, stats = _packed_t(packed), torch.from_numpy(order), torch.tensor([mu, inv_std])
    kw = dict(clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef, obs_dim=1,
              act_dim=a, tile=128, head=head)
    g, met = uk._grad_merged_reference(data, order_t, w, stats, compute="float32", **kw)
    gout = torch.cat([uk.flatten_merged(g), met])
    if max_grad_norm == "half":
        m_np = [np.zeros_like(x) for x in m_np]
        max_grad_norm = 0.5 * uk.clip_norm_reference(gout, obs_dim=1, hidden=hidden, act_dim=a,
                                                     head=head, ent_coef=cfg.ent_coef)
    scal = np.zeros(jk.ADAM_NUM_SCALARS, np.float32)
    scal[:6] = [cfg.clip_eps, cfg.vf_coef, 1.0 / 256, mu, inv_std, cfg.ent_coef]
    scal[8:11] = [lr, bc1, bc2]
    j_w, j_m, j_v, _ = jk.fused_minibatch_grad_adam(
        jfused.pack_feature_major(packed), jnp.asarray(order), jw,
        tuple(map(jnp.asarray, m_np)), tuple(map(jnp.asarray, v_np)), jnp.asarray(scal),
        obs_dim=1, act_dim=a, tile=128, head=head, max_grad_norm=max_grad_norm,
        interpret=True)

    m, v = tuple(map(torch.from_numpy, m_np)), tuple(map(torch.from_numpy, v_np))
    adam = dict(lr=lr, bc1=bc1, bc2=bc2, max_grad_norm=max_grad_norm)
    before = uk.clip_adam_launches
    flat = uk.clip_adam(gout, *(uk.flatten_merged(t) for t in (w, m, v)), obs_dim=1,
                        hidden=hidden, act_dim=a, head=head, ent_coef=cfg.ent_coef, **adam)
    assert uk.clip_adam_launches == before   # the twin launches nothing
    *ref, _ = uk.fused_minibatch_grad_adam_reference(data, order_t, w, m, v, stats, **kw, **adam)
    for got, want in zip(flat, ref):
        assert torch.equal(got, uk.flatten_merged(want))
    new = [uk.unflatten_merged(x, 1, hidden, a) for x in flat]
    for got, want, old in zip(new[0], j_w, w):   # weights through their ~lr update
        np.testing.assert_allclose((got - old).numpy(), np.asarray(want) - old.numpy(),
                                   rtol=1e-3, atol=1e-8)
    for got_t, want_t in ((new[1], j_m), (new[2], j_v)):
        for got, want in zip(got_t, want_t):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-9)
