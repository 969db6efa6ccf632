"""Glue between the ActorCritic parameters and the fused kernels.

Counterpart of ``gym_fishing_tpu/agents/ppo_fused.py``. Every kernel wrapper
takes the weights merged block-diagonally (`merged_weights`: ``[in, out]``
matrices, ``[n, 1]`` biases, views of one flat buffer), the update kernels
the feature-major ``[R, N]`` sample matrix (R a multiple of 8);
`torch.nn.Linear` stores ``[out, in]`` and 1-D biases. The glue converts
once each way per rollout and per epoch scan.

Parameters travel as a name -> tensor mapping (``dict(model.named_parameters())``
or Adam's moments, which share the names), the counterpart of the flax tree.

`fused_rollout_collect` runs the policy-rollout kernel
(``kernels/policy_rollout_kernel.py``, K4) in place of collect_rollout +
compute_gae + packing; its packed output feeds the update kernels directly.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from gym_fishing_tpu_torch.agents.ppo import apply_gradients, learning_rate
from gym_fishing_tpu_torch.batch.batch import BatchState
from gym_fishing_tpu_torch.core.types import EnvParams, EnvState
from gym_fishing_tpu_torch.kernels.policy_rollout_kernel import (
    FLOAT_FIELDS,
    PolicyRollout,
    RolloutScalars,
    draws_per_call,
    policy_rollout,
)
from gym_fishing_tpu_torch.kernels.ppo_update_kernel import (
    ADAM_B1,
    ADAM_B2,
    LOG_2PI_E,
    MergedWeights,
    fused_minibatch_grad,
    fused_minibatch_grad_adam,
    merge_weights,
    packed_rows,
    unmerge_weights,
)
from gym_fishing_tpu_torch.shard.mesh import Mesh, fold_rank
from gym_fishing_tpu_torch.utils.trace import span


def _pi_head(head: str) -> str:
    return "pi_mean" if head == "gaussian" else "pi_logits"


def kernel_weights(params: Mapping[str, torch.Tensor], head: str = "gaussian") -> tuple:
    """Named parameters -> the 13 kernel-layout arrays (`merge_weights`' input).

    The categorical head has no log_std parameter: its slot gets a zeros
    [A, 1] placeholder that the kernel never reads."""
    pi = _pi_head(head)
    col = lambda v: v.detach().reshape(-1, 1).float()  # noqa: E731
    mat = lambda name: params[f"{name}.weight"].detach().float().T  # noqa: E731
    bias = lambda name: col(params[f"{name}.bias"])  # noqa: E731
    log_std = (col(params["log_std"]) if head == "gaussian"
               else torch.zeros_like(bias(pi)))
    return (mat("pi_d1"), bias("pi_d1"), mat("pi_d2"), bias("pi_d2"), mat(pi), bias(pi), log_std,
            mat("v_d1"), bias("v_d1"), mat("v_d2"), bias("v_d2"), mat("v_out"), bias("v_out"))


def params_from_kernel(split: tuple, head: str = "gaussian") -> Dict[str, torch.Tensor]:
    """Inverse of `kernel_weights`: 13 kernel-layout arrays -> named tensors
    in `torch.nn.Linear` layout (no log_std for the categorical head)."""
    (w1p, b1p, w2p, b2p, wm, bm, ls, w1v, b1v, w2v, b2v, wv, bv) = split
    out = {}
    for name, w, b in (("pi_d1", w1p, b1p), ("pi_d2", w2p, b2p), (_pi_head(head), wm, bm),
                       ("v_d1", w1v, b1v), ("v_d2", w2v, b2v), ("v_out", wv, bv)):
        out[f"{name}.weight"] = w.T
        out[f"{name}.bias"] = b.reshape(-1)
    if head == "gaussian":
        out["log_std"] = ls.reshape(-1)
    return out


def merged_weights(params: Mapping[str, torch.Tensor], head: str = "gaussian") -> MergedWeights:
    """Named parameters (or Adam's moments) -> the kernels' merged weights."""
    return merge_weights(kernel_weights(params, head))


def params_from_merged(merged: tuple, head: str = "gaussian") -> Dict[str, torch.Tensor]:
    """Inverse of `merged_weights`: named tensors in `torch.nn.Linear` layout."""
    h, a = merged[2].shape[0] // 2, merged[4].shape[1] - 1
    return params_from_kernel(unmerge_weights(merged, h, a), head)


def pack_feature_major(mb: torch.Tensor) -> torch.Tensor:
    """[N, C] sample-major matrix -> contiguous feature-major [R, N],
    zero-padded to R = ceil(C / 8) * 8 rows, as JAX pads them."""
    n, c = mb.shape
    out = torch.zeros((packed_rows(c), n), dtype=torch.float32, device=mb.device)
    out[:c] = mb.T
    return out


def fused_grad(params: Mapping[str, torch.Tensor], data_t: torch.Tensor, clip_eps: float,
               vf_coef: float, ent_coef: float, obs_dim: int, act_dim: int, tile: int = 2048,
               tile_order: Optional[torch.Tensor] = None,
               adv_stats: Optional[torch.Tensor] = None, head: str = "gaussian",
               compute: str = "float32", reduce=None):
    """Full PPO minibatch gradient + metrics through K2 -> (grads by name,
    metrics dict of 0-d tensors), the quantities autograd of `ppo_loss`
    gives.

    With `tile_order` the minibatch is those tiles of `data_t`; without it,
    the whole buffer. `adv_stats` (mu, 1/(std + 1e-8)) as a (2,) tensor is
    required when `tile_order` subsets the data; otherwise it is computed
    here over the whole buffer (population std). `reduce` is
    `fused_minibatch_grad`'s: a sharded step's all-reduce of K2's output,
    scaled so that the result is the global minibatch's."""
    n = data_t.shape[1]
    tile = min(tile, n)
    na = act_dim if head == "gaussian" else 1
    if tile_order is None:
        if n % tile:
            raise ValueError(f"N = {n} must be a multiple of tile = {tile}")
        tile_order = torch.arange(n // tile, dtype=torch.int32, device=data_t.device)
    n_mb = tile_order.shape[0] * tile
    if adv_stats is None:
        if n_mb != n:
            raise ValueError("adv_stats is required when tile_order subsets the data")
        adv = data_t[obs_dim + na + 2]
        adv_stats = torch.stack([adv.mean(), 1.0 / (adv.std(correction=0) + 1e-8)])
    g, met = fused_minibatch_grad(
        data_t, tile_order, merged_weights(params, head), adv_stats, clip_eps=clip_eps,
        vf_coef=vf_coef, ent_coef=ent_coef, obs_dim=obs_dim, act_dim=act_dim, tile=tile,
        head=head, compute=compute, reduce=reduce)
    grads = params_from_merged(g, head)
    # Gaussian: the loss's entropy term, -ent_coef * mean(sum_a(log_std + c)),
    # is data-independent and its gradient, -ent_coef per action dim, joins
    # here; the categorical entropy gradient is already in dWm / dbm
    if head == "gaussian":
        grads["log_std"] = grads["log_std"] - ent_coef
    grads = {name: grads[name].reshape(p.shape) for name, p in params.items()}
    if head == "gaussian":
        entropy = torch.sum(params["log_std"].detach() + 0.5 * LOG_2PI_E)
    else:
        entropy = met[3] / n_mb
    pg_loss, v_loss = met[0] / n_mb, met[1] / n_mb
    return grads, {
        "pg_loss": pg_loss,
        "v_loss": v_loss,
        "entropy": entropy,
        "approx_kl": met[2] / n_mb,
        "loss": pg_loss + vf_coef * v_loss - ent_coef * entropy,
    }


def _tiling(cfg, packed_t: torch.Tensor, obs_dim: int, act_dim: int, head: str):
    """(tile, tiles per minibatch, per-tile advantage sums and sums of
    squares) for zero-copy tile-shuffled minibatches."""
    n = packed_t.shape[1]
    mb = n // cfg.num_minibatches
    tile = next((t for t in (2048, 1024, 512, 256, 128) if mb % t == 0), None)
    if tile is None:
        raise ValueError(f"fused_update needs minibatch size {mb} divisible by 128")
    na = act_dim if head == "gaussian" else 1
    adv_tiles = packed_t[obs_dim + na + 2].reshape(n // tile, tile)
    return tile, mb // tile, adv_tiles.sum(1), (adv_tiles * adv_tiles).sum(1)


def _tile_perm(e: int, num_tiles: int, generator, perms, device) -> torch.Tensor:
    perm = perms[e] if perms is not None else torch.randperm(
        num_tiles, generator=generator, device=device)
    return perm.to(device=device, dtype=torch.int32)


def _adv_sums(tile_sum, tile_sumsq, order) -> torch.Tensor:
    """The minibatch's advantage sum and sum of squares from per-tile sums."""
    idx = order.long()
    return torch.stack([tile_sum[idx].sum(), tile_sumsq[idx].sum()])


def _adv_stats_from_sums(sums: torch.Tensor, n: int) -> torch.Tensor:
    """Advantage mean and 1/(std + 1e-8) of n samples from their sum and
    sum of squares: var = ss/n - mu^2 (one pass, as the reference computes
    it)."""
    mu = sums[0] / n
    var = sums[1] / n - mu * mu
    return torch.stack([mu, 1.0 / (torch.sqrt(torch.clamp(var, min=0.0)) + 1e-8)])


def _adv_stats(tile_sum, tile_sumsq, order, n: int) -> torch.Tensor:
    """Exact minibatch advantage mean and 1/(std + 1e-8) from per-tile sums."""
    return _adv_stats_from_sums(_adv_sums(tile_sum, tile_sumsq, order), n)


def fused_epoch_scan(cfg, ts, packed_t: torch.Tensor, obs_dim: int, act_dim: int,
                     generator: Optional[torch.Generator] = None, head: str = "gaussian",
                     perms: Optional[Sequence[torch.Tensor]] = None,
                     mesh: Optional[Mesh] = None):
    """cfg.epochs x cfg.num_minibatches updates over `packed_t`: each
    minibatch is a random set of tiles (one tile permutation per epoch, from
    `generator` or `perms`), its gradient comes from K2 and the optimizer is
    the plain form's clip + Adam. Updates `ts` in place; returns metrics
    stacked over the minibatches.

    With `mesh`, `packed_t` is the rank's share and every rank permutes its
    own tiles with the same permutation (the generator's state is shared).
    Each minibatch then all-reduces the advantage sums before its mean and
    1/(std + 1e-8) are formed (over the global minibatch), and K2's one
    output buffer (gradients, then metric sums) divided by the world size:
    over equal shares that is the global minibatch's gradient, and the
    metric sums over the local count are the global means. Every rank takes
    the same clip + Adam step. At one rank the buffer is used as the
    collective leaves it, so the step is the single device's bit for bit."""
    with span("train_step/update/merge"):
        tile, per_mb, tile_sum, tile_sumsq = _tiling(cfg, packed_t, obs_dim, act_dim, head)
    n_mb = per_mb * tile * (1 if mesh is None else mesh.world)
    reduce = None
    if mesh is not None:
        def all_reduce(buf):
            with span("train_step/update/allreduce"):
                return mesh.all_reduce(buf)

        def reduce(buf):
            all_reduce(buf)
            return buf if mesh.world == 1 else buf.mul_(1.0 / mesh.world)
    history = []
    for e in range(cfg.epochs):
        perm = _tile_perm(e, tile_sum.shape[0], generator, perms, packed_t.device)
        for i in range(cfg.num_minibatches):
            with span("train_step/update/minibatch"):
                with span("train_step/update/adv_stats"):
                    order = perm[i * per_mb:(i + 1) * per_mb]
                    sums = _adv_sums(tile_sum, tile_sumsq, order)
                    if mesh is not None:
                        sums = all_reduce(sums)
                    adv_stats = _adv_stats_from_sums(sums, n_mb)
                with span("train_step/update/k2"):
                    grads, mets = fused_grad(
                        ts.params(), packed_t, cfg.clip_eps, cfg.vf_coef, cfg.ent_coef,
                        obs_dim=obs_dim, act_dim=act_dim, tile=tile, tile_order=order,
                        adv_stats=adv_stats, head=head, compute=cfg.compute_dtype,
                        reduce=reduce)
                with span("train_step/update/adam"):
                    apply_gradients(ts, grads, cfg)
            history.append(mets)
    with span("train_step/update/metrics"):
        return {k: torch.stack([h[k] for h in history]) for k in history[0]}


def fused_epoch_scan_adam(cfg, ts, packed_t: torch.Tensor, obs_dim: int, act_dim: int,
                          generator: Optional[torch.Generator] = None, head: str = "gaussian",
                          perms: Optional[Sequence[torch.Tensor]] = None,
                          mesh: Optional[Mesh] = None):
    """`fused_epoch_scan` with clip + Adam inside the kernel (K3).

    Single-device, as in JAX: the optimizer runs inside the kernel, before
    any gradient could be reduced over ranks, so a `mesh` raises.

    The merged weights and moments are built once, carried through every
    minibatch launch (each takes the last one's output buffers as they
    are), and written back to `ts` once at the end. lr (with
    anneal_lr, optax.linear_schedule at the count BEFORE the increment) and
    the bias corrections come from the Python-int count.

    The Gaussian ``entropy`` metric (and so ``loss``) uses log_std as it was
    at entry, while the plain optimizer path recomputes it each minibatch:
    with ent_coef > 0 those two metrics drift slightly between the forms
    (the parameters do not: the kernel differentiates the true entropy)."""
    if mesh is not None:
        raise NotImplementedError("fused_epoch_scan_adam is single-device: the sharded step "
                                  "reduces K2's gradients before the optimizer "
                                  "(fused_epoch_scan(mesh=))")
    with span("train_step/update/merge"):
        tile, per_mb, tile_sum, tile_sumsq = _tiling(cfg, packed_t, obs_dim, act_dim, head)
        n_mb = per_mb * tile
        params = ts.params()
        log_std0 = params["log_std"].detach().clone() if head == "gaussian" else None
        w, m, v = (merged_weights(x, head) for x in (params, ts.m, ts.v))
    count = ts.count
    mets = []
    for e in range(cfg.epochs):
        perm = _tile_perm(e, tile_sum.shape[0], generator, perms, packed_t.device)
        for i in range(cfg.num_minibatches):
            with span("train_step/update/minibatch"):
                with span("train_step/update/adv_stats"):
                    order = perm[i * per_mb:(i + 1) * per_mb]
                    adv_stats = _adv_stats(tile_sum, tile_sumsq, order, n_mb)
                count1 = count + 1
                with span("train_step/update/k3"):
                    w, m, v, met = fused_minibatch_grad_adam(
                        packed_t, order, w, m, v, adv_stats, clip_eps=cfg.clip_eps,
                        vf_coef=cfg.vf_coef, ent_coef=cfg.ent_coef,
                        lr=learning_rate(cfg, count), bc1=1.0 - ADAM_B1 ** count1,
                        bc2=1.0 - ADAM_B2 ** count1, obs_dim=obs_dim, act_dim=act_dim,
                        tile=tile, head=head, compute=cfg.compute_dtype,
                        max_grad_norm=cfg.max_grad_norm)
            mets.append(met)
            count = count1

    with span("train_step/update/writeback"):
        with torch.no_grad():
            for name, val in params_from_merged(w, head).items():
                params[name].copy_(val.reshape(params[name].shape))
        for store, merged in ((ts.m, m), (ts.v, v)):
            for name, val in params_from_merged(merged, head).items():
                store[name] = val.reshape(params[name].shape).contiguous()
        ts.count = count
        ts.step += cfg.epochs * cfg.num_minibatches

    with span("train_step/update/metrics"):
        met = torch.stack(mets) / n_mb                       # [E*M, 4]
        if head == "gaussian":
            entropy = torch.sum(log_std0 + 0.5 * LOG_2PI_E).expand(met.shape[0])
        else:
            entropy = met[:, 3]
        return {
            "pg_loss": met[:, 0],
            "v_loss": met[:, 1],
            "entropy": entropy,
            "approx_kl": met[:, 2],
            "loss": met[:, 0] + cfg.vf_coef * met[:, 1] - cfg.ent_coef * entropy,
        }


# ------------------------------------------------------------ fused rollout

# XORed into the generator's seed to key the rollout's Philox stream, so it
# never coincides with torch's own Philox draws from the same generator
_ROLLOUT_KEY = 0x9E3779B97F4A7C15


def rollout_scalars(params: EnvParams, seed: int, offset: int = 0) -> RolloutScalars:
    """EnvParams -> the policy-rollout kernel's typed scalar record, with
    the Philox seed and offset (the 22-slot f32 vector of the JAX kernel).

    The fields are read to the host in one transfer: one sync if `params`
    lie on the card, none for host params. Per-env parameters (shape
    (num_envs,)) do not fit the record and raise."""
    names = FLOAT_FIELDS + ("Tmax", "model_idx")
    vals = []
    for name in names:
        v = torch.as_tensor(getattr(params, name))
        if v.numel() != 1:
            raise ValueError(f"the fused rollout takes scalar env params; {name} has shape "
                             f"{tuple(v.shape)}")
        vals.append(v.to(device=params.device, dtype=torch.float64).reshape(()))
    host = dict(zip(names, torch.stack(vals).tolist()))
    return RolloutScalars(**{n: host[n] for n in FLOAT_FIELDS}, Tmax=int(host["Tmax"]),
                          model_idx=int(math.floor(host["model_idx"])), seed=seed,
                          offset=offset)


def rollout_seed_offset(generator: Optional[torch.Generator], device,
                        num_steps: int) -> Tuple[int, int]:
    """(seed, offset) of the next rollout's Philox stream, taken from
    `generator`'s state without a host sync, and the generator advanced
    past the `num_steps` counters the rollout uses.

    A CUDA generator gives its seed (keyed apart from torch's own stream)
    and its Philox offset; a CPU generator, which has no offset, draws a
    fresh 63-bit seed. None means the device's default generator."""
    device = torch.device(device)
    if generator is None and device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        generator = torch.cuda.default_generators[index]
    elif generator is None:
        generator = torch.default_generator
    if generator.device.type == "cuda":
        offset = generator.get_offset()
        # torch's Philox offsets advance in multiples of 4
        generator.set_offset(offset + -(-draws_per_call(num_steps) // 4) * 4)
        return generator.initial_seed() ^ _ROLLOUT_KEY, offset
    return int(torch.randint(0, (1 << 63) - 1, (), generator=generator)), 0


def rollout_noise_from_draws(act_noise: torch.Tensor, env_noise: torch.Tensor, sigma_m: float,
                             obs_noise: bool) -> torch.Tensor:
    """The plain rollout's injected draws for the Gaussian head (act_noise
    [T, B, 1], env_noise [T, 2, B]) as the policy-rollout kernel's noise
    planes: [action z, process z] and, with obs noise, exp(sigma_m eta)."""
    planes = [act_noise[:, :, 0], env_noise[:, 0]]
    if obs_noise:
        planes.append(torch.exp(torch.tensor(sigma_m, dtype=torch.float32) * env_noise[:, 1]))
    return torch.stack(planes).float().contiguous()


def _concrete_sigma_m(params: EnvParams) -> None:
    """Refuse a sigma_m that cannot decide the obs-noise path on the host:
    missing, per-env, symbolic, or under a tracer."""
    sm = params.sigma_m
    if (sm is None or torch.jit.is_tracing() or torch.compiler.is_compiling()
            or (isinstance(sm, torch.Tensor) and (sm.device.type == "meta" or sm.numel() != 1))):
        raise NotImplementedError(
            "fused_rollout needs a concrete scalar sigma_m to decide the obs-noise kernel "
            "path; pass env params with real scalar values, outside any tracing")


def fused_rollout_collect(env, env_params: EnvParams, cfg, ts, bstate: BatchState,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[torch.Tensor] = None, rank: int = 0
                          ) -> Tuple[PolicyRollout, BatchState]:
    """Run the policy-rollout kernel and rebuild the BatchState.

    Returns (PolicyRollout, next BatchState). The kernel replaces
    collect_rollout + compute_gae + packing for every decode scheme (the
    Gaussian head for continuous, the categorical head otherwise). The
    Philox seed and offset come from `generator` (`rollout_seed_offset`);
    `noise` planes replace them. obs_noise is on when sigma_m > 0. Pass
    host `env_params` to keep the call free of host syncs. A sharded step
    passes its `rank`, which is folded into the seed (`shard.fold_rank`;
    rank 0's is the seed itself) while the offset stays the shared one."""
    _concrete_sigma_m(env_params)
    scheme = env.config.scheme
    head = "gaussian" if scheme == "continuous" else "categorical"
    device = bstate.episode_return.device
    with span("train_step/rollout/prep"):
        seed, offset = ((0, 0) if noise is not None
                        else rollout_seed_offset(generator, device, cfg.num_steps))
        seed = fold_rank(seed, rank)
        scalars = rollout_scalars(env_params, seed, offset)
        state = (bstate.env.stock.float().contiguous(),
                 bstate.env.t.to(torch.int32).contiguous(),
                 bstate.env.harvest.float().contiguous(),
                 bstate.episode_return.float().contiguous(),
                 bstate.episode_length.to(torch.int32).contiguous())
        merged = merged_weights(ts.params(), head)
    with span("train_step/rollout/k4"):
        roll = policy_rollout(
            *state,
            merged,
            scalars,
            cfg.num_steps,
            growth=env.config.growth,
            noise_form=env.config.noise_form,
            gamma=cfg.gamma,
            gae_lambda=cfg.gae_lambda,
            scheme=scheme,
            n_actions=env.config.n_actions,
            obs_noise=scalars.sigma_m > 0.0,
            compute=cfg.compute_dtype,
            fold_obs=cfg.rollout_fold_obs,
            noise=noise,
        )
    with span("train_step/rollout/state"):
        dtype = env_params.dtype
        new_bstate = BatchState(
            env=EnvState(stock=roll.stock.to(dtype), harvest=roll.harvest.to(dtype), t=roll.t),
            episode_return=roll.ep_ret.to(dtype),
            episode_length=roll.ep_len,
        )
    return roll, new_bstate
