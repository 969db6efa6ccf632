"""Fused PPO policy rollout (K4): CUDA kernel and plain twin.

Counterpart of ``gym_fishing_tpu/kernels/policy_rollout_kernel.py``. One call
runs T steps of B envs under the actor-critic, given in the update kernels'
merged block-diagonal format at obs_dim 1 (the 7 arrays of
``kernels/ppo_update_kernel.py::merge_weights``, whose flat buffer the
kernel reads): forward, Gaussian or inverse-CDF categorical sampling, the
continuous, proportional or relative decode, the dynamics with auto-reset and
observation noise, then the reverse GAE pass, and returns the update
kernels' packed sample matrix ``[8, T*B]`` (rows: obs, action, logp, value,
advantage, return, two zero rows; sample ``t*B + env``), the final env
state and the episode statistics ``(n_done, sum of returns and of lengths
of the episodes that ended, sum of rewards)``.

- `policy_rollout` is the wrapper: on a CUDA tensor it launches
  ``csrc/policy_rollout_kernel.cu`` without synchronising (and adds one to
  `launches`, and under a categorical head one to `categorical_launches`),
  on a CPU tensor it runs `policy_rollout_reference`.
- `policy_rollout_reference` is the plain PyTorch twin: a Python loop over
  the T steps with the same arithmetic in float32 and the same Philox
  stream, so from the same seed or planes it agrees with the kernel to
  float32 rounding.

Semantics are the JAX kernel's: the first input is noise-free; with
``fold_obs`` the input layer takes the clipped raw measurement through
``w1/K, b1 - w1`` and the obs row is rebuilt as ``m/K - 1``; the relative
decode looks up ``harvest * RELATIVE_MULTIPLIERS[a]``; the carried harvest
is the pre-min quota under the relative scheme and the realised harvest
otherwise; GAE bootstraps from the value of the final post-reset input.
Under ``compute="bfloat16"`` the inputs of the two H-contractions per tower
(W2c and h1, Whc and h2) are rounded to bf16 and summed in float32; the
kernel runs them on the tensor cores at hidden 32 and 64 with at most 16
actions. Hidden 128 and 256, and up to `KERNEL_MAX_ACTIONS` classes at any
hidden size, take the kernel's wide path (``csrc/wide_mlp.cuh``), which
reads the weights from L2 every step as ``wide_prep`` lays them out
(`wide_prep_reference` is its plain version): under bfloat16 at hidden 64
and above its W2c product and policy head run on the tensor cores, 128 envs
a CTA; otherwise its products are float32 FMA on the same rounded inputs,
64 envs a CTA (the library's ``policy_rollout_envs_per_cta`` says which).

The kernel multiplies W2c and Whc per tower and relies on their cross-tower
blocks being zero, as `merge_weights` builds them and K3's masked update
keeps them (it traps on any other); the twin takes any blocks.

Noise: Philox4x32-10 with key = `seed` and counter = (env index, `offset` +
t), one block of four uint32 per env and step (`draws_per_call`). Gaussian
head: (u0, u1) give the Box-Muller pair (action z = rad cos, process z =
rad sin); with `obs_noise` (u2, u3) give eta = rad cos. Categorical head:
u0 is the inverse-CDF uniform, and (u1, u2) give the pair (eta = rad cos,
process z = rad sin). The call returns `next_offset` so that chained calls
never replay a stream. `noise`, planes of shape (3 if obs_noise else 2, T,
B) holding [action z or uniform, process z, exp(sigma_m eta)], replaces
Philox for parity tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from gym_fishing_tpu_torch.core.types import NOISE_FORMS, RELATIVE_MULTIPLIERS, EnvParams
from gym_fishing_tpu_torch.dynamics.growth import get_growth_fn
from gym_fishing_tpu_torch.dynamics.noise import apply_process_noise
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.kernels.ppo_update_kernel import (
    COMPUTES,
    LOG_2PI,
    flatten_merged,
    merged_shapes,
)
from gym_fishing_tpu_torch.kernels.rollout_kernel import (
    _GROWTHS,
    _MASK32,
    _TWO_PI,
    _U64,
    SCHEMES,
    _philox4x32_10,
    _uniform_from_bits,
)

PACKED_ROWS = 8
_SOURCE = "policy_rollout_kernel"

# Limits of the CUDA kernel (the twin takes any size).
KERNEL_HIDDEN = (32, 64, 128, 256)
KERNEL_MAX_ACTIONS = 128
# Envs a CTA of the narrow kernel takes; the wrapper sizes the statistics'
# scratch rows by the library's policy_rollout_envs_per_cta, which gives each
# path's
KERNEL_ENVS_PER_CTA = 64

# Kernel launches made by `policy_rollout` (the CPU twin does not count):
# all of them, and those that draw from the categorical head's inverse CDF.
launches = 0
categorical_launches = 0


class RolloutScalars(NamedTuple):
    """The kernel's scalar inputs as host numbers: the env parameters the
    rollout reads (agents/ppo_fused.rollout_scalars builds it from
    EnvParams), the Philox seed and offset."""

    r: float
    r_drift: float
    K: float
    sigma: float
    sigma_m: float
    price: float
    cost: float
    action_scale: float
    init_state: float
    init_harvest: float
    A: float
    B: float
    C: float
    theta: float
    a: float
    b: float
    q: float
    collapse_penalty: float
    Tmax: int
    model_idx: int
    seed: int
    offset: int


FLOAT_FIELDS = RolloutScalars._fields[:18]


class PolicyRollout(NamedTuple):
    """Fused rollout results (per-env tensors shaped (B,))."""

    packed_t: torch.Tensor  # [8, T*B] f32: the update kernels' sample matrix
    stock: torch.Tensor     # f32 post-rollout (post-reset) stock
    t: torch.Tensor         # i32 post-rollout years passed
    harvest: torch.Tensor   # f32 post-rollout carried harvest
    ep_ret: torch.Tensor    # f32 running return of the in-flight episode
    ep_len: torch.Tensor    # i32 running length of the in-flight episode
    stats: torch.Tensor     # (4,) f32: n_done, sum ep_ret at done, sum ep_len at done,
                            #           sum reward
    next_offset: int        # Philox offset for the next chained call


class _Params(ctypes.Structure):
    """Mirror of `struct PolicyRolloutParams` in csrc/policy_rollout_kernel.cu."""

    _fields_ = (
        [(n, ctypes.c_float) for n in FLOAT_FIELDS + ("gamma", "gamma_lambda")]
        + [(n, ctypes.c_int) for n in (
            "Tmax", "model_idx", "growth", "noise_form", "scheme", "n_actions", "act_dim",
            "hidden", "compute", "obs_noise", "fold_obs", "has_noise", "num_steps", "pad0",
        )]
        + [("num_envs", ctypes.c_longlong), ("seed", ctypes.c_ulonglong),
           ("offset", ctypes.c_ulonglong)]
    )


def draws_per_call(num_steps: int) -> int:
    """Philox blocks one env draws in a call of `num_steps` steps."""
    return num_steps


def _check(stock, t, harvest, ep_ret, ep_len, merged, scalars, num_steps, growth, noise_form,
           scheme, n_actions, obs_noise, compute, noise):
    """Validate the arguments; returns (hidden, A) with A the head width
    (1 for the Gaussian head, n_actions for the categorical one)."""
    if growth not in _GROWTHS:
        raise ValueError(f"unknown growth model {growth!r}")
    if noise_form not in NOISE_FORMS:
        raise ValueError(f"unknown noise form {noise_form!r}")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    if compute not in COMPUTES:
        raise ValueError(f"unknown compute {compute!r}")
    if num_steps < 1:
        raise ValueError(f"num_steps must be positive: {num_steps}")
    if not (0 <= scalars.seed < _U64 and 0 <= scalars.offset < _U64):
        raise ValueError("seed and offset must be unsigned 64-bit integers")
    if stock.dim() != 1 or stock.shape[0] < 1:
        raise ValueError(f"stock must have shape (B,), got {tuple(stock.shape)}")
    B = stock.shape[0]
    A = 1 if scheme == "continuous" else n_actions
    if A < 2 and scheme != "continuous":
        raise ValueError("n_actions must be >= 2")
    if len(merged) != 7:
        raise ValueError("the weights must be the 7 merged arrays (merge_weights)")
    hidden = merged[0].shape[1] // 2
    expect = [("stock", stock, torch.float32, (B,)), ("t", t, torch.int32, (B,)),
              ("harvest", harvest, torch.float32, (B,)),
              ("ep_ret", ep_ret, torch.float32, (B,)), ("ep_len", ep_len, torch.int32, (B,))]
    expect += [(f"merged[{i}]", x, torch.float32, shape)
               for i, (x, shape) in enumerate(zip(merged, merged_shapes(1, hidden, A)))]
    if noise is not None:
        expect.append(("noise", noise, torch.float32, (3 if obs_noise else 2, num_steps, B)))
    for name, x, dtype, shape in expect:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
        if x.device != stock.device:
            raise ValueError(f"{name} is on {x.device}, stock on {stock.device}")
    if stock.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on CUDA or CPU tensors, not {stock.device}")
    return hidden, A


def check_kernel_limits(hidden: int, act_dim: int) -> None:
    """Raise on sizes the CUDA kernel does not take (the twin takes any);
    `act_dim` is the head width, 1 for the Gaussian head."""
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel takes hidden in {KERNEL_HIDDEN}, not {hidden}")
    if act_dim > KERNEL_MAX_ACTIONS:
        raise ValueError(f"the CUDA kernel takes n_actions <= {KERNEL_MAX_ACTIONS}, "
                         f"not {act_dim}")


def policy_rollout(
    stock: torch.Tensor,      # (B,) f32
    t: torch.Tensor,          # (B,) i32 years passed
    harvest: torch.Tensor,    # (B,) f32 carried harvest
    ep_ret: torch.Tensor,     # (B,) f32 running return
    ep_len: torch.Tensor,     # (B,) i32 running length
    merged: tuple,            # 7 merged weight arrays (merge_weights)
    scalars: RolloutScalars,
    num_steps: int,
    *,
    growth: str = "logistic",
    noise_form: str = "additive",
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    scheme: str = "continuous",
    n_actions: int = 3,
    obs_noise: bool = False,
    compute: str = "float32",
    fold_obs: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> PolicyRollout:
    """Fused `num_steps`-step PPO rollout + GAE of B envs (any B); see
    PolicyRollout and the module doc.

    `scheme` selects the head: "continuous" is the Gaussian head (of width
    1), "proportional" and "relative" the categorical head of width
    `n_actions`, whose action row holds the class index. On a CUDA
    tensor this launches the kernel on the current stream without
    synchronising; on a CPU tensor it runs `policy_rollout_reference`.
    """
    kw = dict(growth=growth, noise_form=noise_form, gamma=gamma, gae_lambda=gae_lambda,
              scheme=scheme, n_actions=n_actions, obs_noise=obs_noise, compute=compute,
              fold_obs=fold_obs, noise=noise)
    if stock.device.type == "cpu":
        return policy_rollout_reference(stock, t, harvest, ep_ret, ep_len, merged, scalars,
                                        num_steps, **kw)
    hidden, A = _check(stock, t, harvest, ep_ret, ep_len, merged, scalars, num_steps, growth,
                       noise_form, scheme, n_actions, obs_noise, compute, noise)
    check_kernel_limits(hidden, A)
    given = (stock, t, harvest, ep_ret, ep_len, *(() if noise is None else (noise,)))
    if not all(x.is_contiguous() for x in given):
        raise ValueError("state and noise must be contiguous")
    B = stock.shape[0]
    s = scalars._asdict()
    p = _Params(
        **{n: s[n] for n in FLOAT_FIELDS}, gamma=gamma, gamma_lambda=gamma * gae_lambda,
        Tmax=s["Tmax"], model_idx=s["model_idx"], growth=_GROWTHS.index(growth),
        noise_form=NOISE_FORMS.index(noise_form), scheme=SCHEMES.index(scheme),
        n_actions=n_actions, act_dim=A, hidden=hidden, compute=COMPUTES.index(compute),
        obs_noise=int(obs_noise), fold_obs=int(fold_obs), has_noise=int(noise is not None),
        num_steps=num_steps, pad0=0, num_envs=B, seed=s["seed"], offset=s["offset"],
    )
    dev = stock.device
    w = flatten_merged(merged)
    packed = torch.empty((PACKED_ROWS, num_steps * B), dtype=torch.float32, device=dev)
    out_f = [torch.empty_like(stock) for _ in range(3)]  # stock, harvest, ep_ret
    out_t, out_len = torch.empty_like(t), torch.empty_like(ep_len)
    lib = library()
    ws = torch.empty((-(-B // lib.policy_rollout_envs_per_cta(hidden, A, p.compute)), 4),
                     dtype=torch.float32, device=dev)
    stats = torch.empty((4,), dtype=torch.float32, device=dev)
    # the wide path's weights laid out for its streamed products (none otherwise)
    n_prep = lib.policy_rollout_prep_floats(hidden, A)
    prep = torch.empty((n_prep,), dtype=torch.float32, device=dev) if n_prep else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.policy_rollout_launch(
            ctypes.addressof(p), ptr(w), ptr(stock), ptr(t), ptr(harvest), ptr(ep_ret),
            ptr(ep_len), ptr(noise), ptr(packed), ptr(out_f[0]), ptr(out_t), ptr(out_f[1]),
            ptr(out_f[2]), ptr(out_len), ptr(ws), ptr(stats), ptr(prep), stream,
        )
    _build.check(lib, err, "policy_rollout_kernel launch")
    _count_launch(scheme)
    used = 0 if noise is not None else draws_per_call(num_steps)
    return PolicyRollout(packed, out_f[0], out_t, out_f[1], out_f[2], out_len, stats,
                         (scalars.offset + used) % _U64)


def _count_launch(scheme: str) -> None:
    """Count one kernel launch under `scheme` in `launches` and, for the
    categorical head, in `categorical_launches`."""
    global launches, categorical_launches
    launches += 1
    if scheme != "continuous":
        categorical_launches += 1


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load csrc/policy_rollout_kernel.cu, with its
    launcher's ctypes signature set."""
    lib = _build.load(_SOURCE)
    if lib.policy_rollout_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("struct PolicyRolloutParams and _Params disagree in size")
    lib.policy_rollout_envs_per_cta.argtypes = [ctypes.c_int] * 3
    lib.policy_rollout_envs_per_cta.restype = ctypes.c_int
    lib.policy_rollout_launch.argtypes = [ctypes.c_void_p] * 18
    lib.policy_rollout_launch.restype = ctypes.c_int
    lib.policy_rollout_wide_prep.argtypes = [ctypes.c_void_p] * 4
    lib.policy_rollout_wide_prep.restype = ctypes.c_int
    lib.policy_rollout_prep_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.policy_rollout_prep_floats.restype = ctypes.c_int
    lib.policy_rollout_prep_layout.argtypes = [ctypes.c_int, ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
    lib.policy_rollout_prep_layout.restype = None
    return lib


# ------------------------------------------------------------ wide_prep

class WidePrep(NamedTuple):
    """``wide_prep``'s output by region, for tower width H and the head
    padded to AP = 8 ceil(A / 8) classes (``csrc/wide_mlp.cuh::wide_prep_layout``
    places them): float32 FW [H][2H], GW [H][2H], MP [H][AP], MT [AP][H]
    and WV [H], then FWB (2H x H bf16) and, after W2B, MPB (AP x H bf16),
    bf16 copies of FW and MP in the order of an mma.sync B fragment
    (`frag_index`); W2B, W2c's two tower blocks as bf16 [2][H][H] row-major,
    is the update kernels' copy, which this wrapper's kernel never writes."""

    fw: torch.Tensor
    gw: torch.Tensor
    mp: torch.Tensor
    mt: torch.Tensor
    wv: torch.Tensor
    fwb: torch.Tensor
    w2b: torch.Tensor
    mpb: torch.Tensor


def frag_index(k, n, hidden: int):
    """Where entry (k, n) of a [hidden][N] operand lies in its bf16 copy:
    column n's values in blocks of 16 k, each block ordered as the lanes
    t = 0..3 of an m16n8k16 B fragment take them, (2t, 2t + 1, 2t + 8,
    2t + 9) (``csrc/wide_mlp.cuh::frag_index``); ints or integer tensors."""
    r = k % 16
    return ((n * (hidden // 16) + k // 16) * 4 + r % 8 // 2) * 4 + r // 8 * 2 + r % 2


def _bf16_copy(m: torch.Tensor, hidden: int) -> torch.Tensor:
    """The [hidden][N] operand m as bf16 in fragment order (`frag_index`)."""
    k = torch.arange(hidden).repeat_interleave(m.shape[1])
    n = torch.arange(m.shape[1]).repeat(hidden)
    out = torch.empty(m.numel(), dtype=torch.bfloat16)
    out[frag_index(k, n, hidden)] = m.reshape(-1).to(torch.bfloat16)
    return out


def wide_prep_reference(merged: tuple, compute: str = "float32") -> WidePrep:
    """Plain version of ``wide_prep``: the regions it lays out from the 7
    merged arrays (merge_weights), on the CPU, rounded to bf16 under
    bfloat16, the head zero in its padding classes."""
    w2c, whc = (x.detach().cpu() for x in merged[2:5:2])
    H, A = w2c.shape[0] // 2, whc.shape[1] - 1
    AP = -(-A // 8) * 8
    rnd = ((lambda x: x.to(torch.bfloat16).to(torch.float32)) if compute == "bfloat16"
           else (lambda x: x))
    fw = rnd(torch.cat([w2c[:H, :H], w2c[H:, H:]], 1))     # FW[k][t H + n] = W2c[t H + k][t H + n]
    gw = rnd(torch.cat([w2c[:H, :H].T, w2c[H:, H:].T], 1))  # GW[k][t H + n] = W2c[t H + n][t H + k]
    mp = torch.zeros(H, AP)
    mp[:, :A] = rnd(whc[:H, :A])
    w2b = torch.stack([w2c[:H, :H], w2c[H:, H:]]).reshape(-1).to(torch.bfloat16)
    return WidePrep(fw, gw, mp, mp.T.contiguous(), rnd(whc[H:, A]).contiguous(),
                    _bf16_copy(fw, H), w2b, _bf16_copy(mp, H))


def wide_prep(merged: tuple, compute: str = "float32") -> WidePrep:
    """``wide_prep``'s output for the 7 merged arrays (merge_weights) at sizes
    that take the wide path, by region: views of the scratch the kernel reads,
    at the offsets the library exports. The kernel writes the bf16 copies
    only where the wide path runs on the tensor cores; elsewhere they hold
    whatever the scratch held. On a CUDA tensor it launches
    ``policy_rollout_wide_prep`` (the wide path's first launch, alone), on
    a CPU tensor it runs `wide_prep_reference`."""
    if compute not in COMPUTES:
        raise ValueError(f"unknown compute {compute!r}")
    if merged[0].device.type == "cpu":
        return wide_prep_reference(merged, compute)
    hidden, A = merged[0].shape[1] // 2, merged[4].shape[1] - 1
    check_kernel_limits(hidden, A)
    lib = library()
    n_prep = lib.policy_rollout_prep_floats(hidden, A)
    if not n_prep:
        raise ValueError(f"hidden {hidden} with {A} head outputs takes the narrow kernel")
    p = _Params(hidden=hidden, act_dim=A, compute=COMPUTES.index(compute))
    dev = merged[0].device
    w = flatten_merged(merged)
    prep = torch.empty((n_prep,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.policy_rollout_wide_prep(ctypes.addressof(p), w.data_ptr(), prep.data_ptr(),
                                           torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "policy_rollout_wide_prep launch")
    offs = (ctypes.c_int * 9)()
    lib.policy_rollout_prep_layout(hidden, A, offs)
    H, AP = hidden, (offs[3] - offs[2]) // hidden
    region = [prep[offs[i]:offs[i + 1]] for i in range(8)]
    dense = [r.view(*shape) for r, shape in zip(region, ((H, 2 * H), (H, 2 * H), (H, AP),
                                                         (AP, H), (H,)))]
    return WidePrep(*dense, *(r.view(torch.bfloat16) for r in region[5:]))


# --------------------------------------------------------------------- twin

def _philox_uniforms(seed: int, counter: int, env_idx: torch.Tensor):
    """The kernel's four uniforms of Philox block (env, counter) for every
    env index in `env_idx`."""
    counter %= _U64
    bits = _philox4x32_10(
        (env_idx & _MASK32, env_idx >> 32, torch.full_like(env_idx, counter & _MASK32),
         torch.full_like(env_idx, counter >> 32)),
        (seed & _MASK32, seed >> 32),
    )
    return [_uniform_from_bits(b) for b in bits]


def _box_muller(u_rad, u_theta):
    """(rad cos, rad sin) of one Box-Muller pair."""
    rad = torch.sqrt(-2.0 * torch.log(u_rad))
    theta = _TWO_PI * u_theta
    return rad * torch.cos(theta), rad * torch.sin(theta)


def policy_rollout_reference(
    stock: torch.Tensor,
    t: torch.Tensor,
    harvest: torch.Tensor,
    ep_ret: torch.Tensor,
    ep_len: torch.Tensor,
    merged: tuple,
    scalars: RolloutScalars,
    num_steps: int,
    *,
    growth: str = "logistic",
    noise_form: str = "additive",
    gamma: float = 0.99,
    gae_lambda: float = 0.95,
    scheme: str = "continuous",
    n_actions: int = 3,
    obs_noise: bool = False,
    compute: str = "float32",
    fold_obs: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> PolicyRollout:
    """Plain PyTorch twin of the kernel: same signature, outputs and noise."""
    _, A = _check(stock, t, harvest, ep_ret, ep_len, merged, scalars, num_steps, growth,
                  noise_form, scheme, n_actions, obs_noise, compute, noise)
    dev, f32 = stock.device, torch.float32
    B, T = stock.shape[0], num_steps
    gauss = scheme == "continuous"
    s = scalars
    # the kernel's parameter struct as float32 scalars on the device
    p = EnvParams(**{n: torch.tensor(getattr(s, n), dtype=f32, device=dev)
                     for n in FLOAT_FIELDS},
                  Tmax=s.Tmax, model_idx=torch.tensor(s.model_idx, dtype=torch.int32, device=dev))
    grow = get_growth_fn(growth)
    zero = torch.zeros((), dtype=f32, device=dev)
    K = p.K
    inv_K = 1.0 / K
    rnd = ((lambda x: x.to(torch.bfloat16).to(f32)) if compute == "bfloat16"
           else (lambda x: x))

    w1c, b1c, w2c, b2c, whc, bhc, ls = merged
    w1, b1 = w1c[0], b1c[:, 0]
    if fold_obs:   # obs = clip(m, 0, 2K)/K - 1 enters the input layer as w/K and b - w
        w1, b1 = w1 * inv_K, b1 - w1
    w2, wh = rnd(w2c), rnd(whc)
    b2, bh = b2c[:, 0], bhc[:, 0]

    def forward(inp):
        """(head outputs [B, A], value [B]) of the merged actor-critic."""
        h1 = torch.tanh(w1 * inp[:, None] + b1)
        h2 = torch.tanh(rnd(h1) @ w2 + b2)
        out = rnd(h2) @ wh + bh
        return out[:, :A], out[:, A]

    def first_input(m):
        if fold_obs:
            return torch.clamp(m, zero, 2.0 * K)
        return torch.clamp(m / K - 1.0, -1.0, 1.0)

    log_std = ls[0, 0]
    std = torch.exp(log_std)
    mults = torch.zeros(max(A, len(RELATIVE_MULTIPLIERS)), dtype=f32, device=dev)
    mults[:len(RELATIVE_MULTIPLIERS)] = torch.tensor(RELATIVE_MULTIPLIERS, dtype=f32)
    env_idx = torch.arange(B, dtype=torch.int64, device=dev)

    x, tt, h = stock.clone(), t.clone(), harvest.clone()
    cur_ret, cur_len = ep_ret.clone(), ep_len.clone()
    inp = first_input(x)
    rows = torch.zeros((PACKED_ROWS, T, B), dtype=f32, device=dev)
    done_rows = torch.zeros((T, B), dtype=torch.bool, device=dev)
    nd = sr = sl = srw = zero
    for k in range(T):
        head, value = forward(inp)
        if noise is not None:
            za, zp = noise[0, k], noise[1, k]
            nf = noise[2, k] if obs_noise else None
        else:
            u = _philox_uniforms(s.seed, s.offset + k, env_idx)
            if gauss:
                za, zp = _box_muller(u[0], u[1])
                nf = torch.exp(p.sigma_m * _box_muller(u[2], u[3])[0]) if obs_noise else None
            else:
                za = u[0]
                eta, zp = _box_muller(u[1], u[2])
                nf = torch.exp(p.sigma_m * eta) if obs_noise else None

        if gauss:
            act = head[:, 0] + std * za
            logp = -0.5 * (za * za) - log_std - 0.5 * LOG_2PI
            quota = (torch.clamp(act, -1.0, 1.0) + 1.0) * K * p.action_scale
        else:
            zl = head - head.max(1, keepdim=True).values
            se = torch.exp(zl).sum(1, keepdim=True)
            cdf = torch.cumsum(torch.exp(zl) / se, 1)
            cls = torch.clamp((cdf < za[:, None]).sum(1), max=A - 1)
            act = cls.to(f32)
            logp = (zl - torch.log(se)).gather(1, cls[:, None])[:, 0]
            if scheme == "proportional":
                quota = act / float(n_actions) * K
            else:
                quota = h * mults[cls]

        hv = torch.minimum(x, quota)
        x1 = x - hv
        r_eff = p.r + p.r_drift * tt.to(f32)
        mu = grow(p.replace(r=r_eff), x1)
        x2 = apply_process_noise(noise_form, p, mu, x1, zp)
        xn = torch.where(x2 < 0.0, zero, x2)
        collapsed = xn <= 0.0
        rew = p.price * hv - p.cost * quota * quota
        rew = rew - torch.where(collapsed, p.collapse_penalty, zero)
        tn = tt + 1
        done = (tn >= s.Tmax) | collapsed
        done_f = done.to(f32)
        ep_ret_now = cur_ret + rew
        ep_len_now = cur_len + 1

        rows[0, k] = inp * inv_K - 1.0 if fold_obs else inp
        rows[1, k], rows[2, k], rows[3, k] = act, logp, value
        rows[6, k] = rew
        done_rows[k] = done
        nd = nd + done_f.sum()
        sr = sr + (ep_ret_now * done_f).sum()
        sl = sl + (ep_len_now.to(f32) * done_f).sum()
        srw = srw + rew.sum()

        # auto-reset; the carried harvest is the pre-min quota under the
        # relative scheme and the realised harvest otherwise
        xn = torch.where(done, p.init_state, xn)
        tt = torch.where(done, torch.zeros_like(tn), tn)
        h = torch.where(done, p.init_harvest, quota if scheme == "relative" else hv)
        cur_ret = torch.where(done, zero, ep_ret_now)
        cur_len = torch.where(done, torch.zeros_like(ep_len_now), ep_len_now)
        x = xn
        # the next input: measured with noise for live envs, noise-free after a reset
        meas = torch.where(done, xn, xn * nf) if obs_noise else xn
        inp = first_input(meas)

    # GAE, bootstrapped from the value of the final (post-reset) input
    gae = torch.zeros_like(x)
    next_value = forward(inp)[1]
    for k in reversed(range(T)):
        nonterm = 1.0 - done_rows[k].to(f32)
        value = rows[3, k]
        delta = rows[6, k] + gamma * next_value * nonterm - value
        gae = delta + gamma * gae_lambda * nonterm * gae
        rows[4, k], rows[5, k] = gae, gae + value
        next_value = value
    rows[6] = 0.0
    used = 0 if noise is not None else draws_per_call(num_steps)
    return PolicyRollout(rows.reshape(PACKED_ROWS, T * B), x, tt, h, cur_ret, cur_len,
                         torch.stack([nd, sr, sl, srw]), (s.offset + used) % _U64)
