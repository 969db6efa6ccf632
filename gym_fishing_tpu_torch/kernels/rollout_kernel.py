"""Fused T-step rollout under a closed-form policy: CUDA kernel + plain twin.

Counterpart of ``gym_fishing_tpu/kernels/rollout_kernel.py``. The kernel
(``csrc/rollout_kernel.cu``) runs one thread per env and keeps the env state
in registers for the whole T-step rollout: the policy (escapement, constant
mortality or constant quota) on the optionally noisy stock, the proportional
or relative snap, harvest, growth with r drift, process noise, the reward,
auto-reset and per-episode accounting. Its semantics are those of the JAX
kernel, including where that kernel differs from the engine: the policy
reads the unclipped stock, and under a scheme other than relative the
carried harvest passes through unchanged.

What is uniform for a call is fixed when the kernel is compiled, as a JAX
trace fixes its static arguments: `configuration` maps a call's switches to
a `Configuration`, and `library` builds ``csrc/rollout_kernel.cu`` with that
configuration's ``-D`` flags at its first use (a few seconds of nvcc, into
the package's ``_build/``) and loads it. There is no generic kernel: a
configuration either builds or raises.

- `rollout` is the wrapper: on a CUDA tensor it launches the kernel (and
  adds one to `launches`), on a CPU tensor it runs `rollout_reference`.
- `rollout_reference` is the plain PyTorch twin: a Python loop over the T
  steps with the same arithmetic in float32 and the same Philox4x32-10 noise
  stream, so on the same inputs it agrees with the kernel to float32
  rounding.

Noise: Philox4x32-10 with key = `seed` and counter = (env index,
`offset` + draw index); one draw is one Philox block of four uint32, which
Box-Muller turns into four N(0,1): two (cos, sin) pairs. Without
`obs_noise` one pair feeds two steps (a draw feeds four steps, so
`num_steps` must be even); with it one pair is (process z, measurement eta)
of one step. A call uses `draws_per_call(num_steps, obs_noise)` draws and
returns `next_offset`, the offset a chained call must pass so that it never
replays a stream. `noise`, pre-generated planes of shape
(2 if obs_noise else 1, num_steps, num_envs), replaces Philox for parity
tests.
"""

from __future__ import annotations

import ctypes
import functools
import math
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import torch

from gym_fishing_tpu_torch.core.types import (
    GROWTH_MODELS,
    MIXTURE,
    NOISE_FORMS,
    EnvParams,
)
from gym_fishing_tpu_torch.dynamics.growth import get_growth_fn
from gym_fishing_tpu_torch.dynamics.noise import apply_process_noise
from gym_fishing_tpu_torch.kernels import _build
from gym_fishing_tpu_torch.utils.trace import span

POLICIES = ("escapement", "constant_mortality", "constant")
SCHEMES = ("continuous", "proportional", "relative")
_GROWTHS = GROWTH_MODELS + (MIXTURE,)
_SOURCE = "rollout_kernel"
_U64 = 1 << 64

# Kernel launches made by `rollout` (the CPU twin does not count).
launches = 0


class KernelRollout(NamedTuple):
    """Per-env results of a fused T-step rollout (tensors shaped (B,))."""

    stock: torch.Tensor       # f32 post-rollout stock
    t: torch.Tensor           # i32 post-rollout years passed
    ep_ret: torch.Tensor      # f32 running return of the in-flight episode
    reward: torch.Tensor      # f32 reward accumulated THIS call
    ep_ret_sum: torch.Tensor  # f32 sum of completed-episode returns this call
    ep_count: torch.Tensor    # i32 number of episodes completed this call
    harvest: torch.Tensor     # f32 carried harvest (relative-scheme state)
    next_offset: int          # Philox offset for the next chained call


class Configuration(NamedTuple):
    """What the kernel fixes at compile time: one library per value."""

    growth: int      # index into GROWTH_MODELS, the mixture already resolved
    noise_form: int  # index into NOISE_FORMS
    policy: int      # index into POLICIES
    scheme: int      # index into SCHEMES
    obs_noise: int   # 0 or 1
    planes: int      # 1: noise from pre-generated planes, 0: Philox
    drift: int       # 1: r_drift != 0

    def defines(self) -> Tuple[str, ...]:
        """The ``NAME=value`` macros of this configuration."""
        return tuple(f"{flag}={value}" for flag, value in zip(CONFIG_FLAGS, self))


CONFIG_FLAGS = ("K1_GROWTH", "K1_NOISE_FORM", "K1_POLICY", "K1_SCHEME", "K1_OBS_NOISE",
                "K1_PLANES", "K1_DRIFT")
# how many values each field of a Configuration takes
CONFIG_SIZES = Configuration(len(GROWTH_MODELS), len(NOISE_FORMS), len(POLICIES), len(SCHEMES),
                             2, 2, 2)
# fishing-v1 under escapement, noise from Philox: the stepping bench's
DEFAULT_CONFIGURATION = Configuration(0, 0, 0, 0, 0, 0, 0)


def configuration(growth: str, model_idx: int, noise_form: str, policy: str, scheme: str,
                  obs_noise: bool, planes: bool, r_drift: float) -> Configuration:
    """The compile-time configuration of a call. The mixture is resolved
    here: its `model_idx` names one of the six models, and an index out of
    range selects logistic, as the where-chain of the JAX mixture does."""
    model = _GROWTHS.index(growth)
    if growth == MIXTURE:
        model = model_idx if 0 < model_idx < len(GROWTH_MODELS) else 0
    return Configuration(model, NOISE_FORMS.index(noise_form), POLICIES.index(policy),
                         SCHEMES.index(scheme), int(bool(obs_noise)), int(bool(planes)),
                         int(r_drift != 0.0))


class _Params(ctypes.Structure):
    """Mirror of `struct RolloutParams` in csrc/rollout_kernel.cu."""

    _fields_ = (
        [(n, ctypes.c_float) for n in (
            "r", "r_drift", "K", "sigma", "sigma_m", "price", "cost", "init_state",
            "init_harvest", "A", "B", "C", "theta", "a", "b", "q", "collapse_penalty",
            "policy_param",
        )]
        + [(n, ctypes.c_int) for n in (
            "Tmax", "model_idx", "n_actions", "growth", "noise_form", "policy", "scheme",
            "obs_noise", "num_steps", "has_noise",
        )]
        + [("num_envs", ctypes.c_longlong), ("offset", ctypes.c_ulonglong),
           ("keys", (ctypes.c_uint32 * 2) * 10)]   # the seed, as its ten round keys
    )


_FLOAT_FIELDS = tuple(n for n, ty in _Params._fields_ if ty is ctypes.c_float)


def _round_keys(seed: int):
    """The ten round keys of Philox4x32-10 under the 64-bit key `seed`
    (`struct PhiloxKeys`): key + round * Weyl constant, mod 2^32 per half."""
    keys = ((ctypes.c_uint32 * 2) * 10)()
    for rnd in range(10):
        keys[rnd][0] = ((seed & _MASK32) + rnd * _PHILOX_W[0]) & _MASK32
        keys[rnd][1] = ((seed >> 32) + rnd * _PHILOX_W[1]) & _MASK32
    return keys


def draws_per_call(num_steps: int, obs_noise: bool) -> int:
    """Philox blocks one env draws in a call of `num_steps` steps."""
    return (num_steps + 1) // 2 if obs_noise else (num_steps + 3) // 4


def _check_args(stock, t, ep_ret, harvest, noise, num_steps, growth, noise_form,
                policy, scheme, n_actions, obs_noise, seed, offset) -> None:
    if growth not in _GROWTHS:
        raise ValueError(f"unknown growth model {growth!r}")
    if noise_form not in NOISE_FORMS:
        raise ValueError(f"unknown noise form {noise_form!r}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "proportional" and n_actions < 2:
        raise ValueError("n_actions must be >= 2")
    if num_steps < 1 or (not obs_noise and num_steps % 2):
        raise ValueError(f"num_steps must be positive, and even unless obs_noise: {num_steps}")
    if not (0 <= seed < _U64 and 0 <= offset < _U64):
        raise ValueError("seed and offset must be unsigned 64-bit integers")
    if stock.dim() != 1 or stock.shape[0] < 1:
        raise ValueError(f"stock must have shape (B,), got {tuple(stock.shape)}")
    B = stock.shape[0]
    expect = [("stock", stock, torch.float32, (B,)), ("t", t, torch.int32, (B,)),
              ("ep_ret", ep_ret, torch.float32, (B,)),
              ("harvest", harvest, torch.float32, (B,))]
    if noise is not None:
        expect.append(("noise", noise, torch.float32, (2 if obs_noise else 1, num_steps, B)))
    for name, x, dtype, shape in expect:
        if x is None:
            continue
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} of shape {shape}, got "
                             f"{x.dtype} of shape {tuple(x.shape)}")
        if x.device != stock.device:
            raise ValueError(f"{name} is on {x.device}, stock on {stock.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _scalars(params: EnvParams, policy_param) -> dict:
    """The kernel's float scalars and int fields, read on the host (one sync
    per field if `params` lie on the card: pass host params)."""
    vals = {n: float(getattr(params, n)) for n in _FLOAT_FIELDS if n != "policy_param"}
    vals["policy_param"] = float(policy_param)
    vals["Tmax"] = int(params.Tmax)
    vals["model_idx"] = int(math.floor(float(params.model_idx)))
    return vals


def rollout(
    stock: torch.Tensor,
    t: torch.Tensor,
    params: EnvParams,
    policy: str,
    policy_param,
    num_steps: int,
    *,
    growth: str = "logistic",
    noise_form: str = "additive",
    scheme: str = "continuous",
    n_actions: int = 3,
    obs_noise: bool = False,
    ep_ret: Optional[torch.Tensor] = None,
    harvest: Optional[torch.Tensor] = None,
    seed: int = 0,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> KernelRollout:
    """Fused `num_steps`-step rollout of B envs; see KernelRollout.

    `stock` (f32) and `t` (i32) are shaped (B,), any B. Pass the previous
    call's `ep_ret`, `harvest` and `next_offset` back in to chain rollouts
    with exact episode accounting and a fresh noise stream; `ep_ret`
    defaults to 0 and `harvest` to `params.init_harvest`. On a CUDA tensor
    this launches the kernel on the current stream without synchronising;
    on a CPU tensor it runs `rollout_reference`.
    """
    global launches
    with span("rollout_kernel/rollout"):
        if stock.device.type == "cpu":
            _check_args(stock, t, ep_ret, harvest, noise, num_steps, growth, noise_form,
                        policy, scheme, n_actions, obs_noise, seed, offset)
            return rollout_reference(
                stock, t, params, policy, policy_param, num_steps, growth=growth,
                noise_form=noise_form, scheme=scheme, n_actions=n_actions,
                obs_noise=obs_noise, ep_ret=ep_ret, harvest=harvest, seed=seed,
                offset=offset, noise=noise,
            )
        with span("rollout_kernel/prep"):
            _check_args(stock, t, ep_ret, harvest, noise, num_steps, growth, noise_form,
                        policy, scheme, n_actions, obs_noise, seed, offset)
            if stock.device.type != "cuda":
                raise ValueError(f"rollout runs on CUDA or CPU tensors, not {stock.device}")
            s = _scalars(params, policy_param)
            B = stock.shape[0]
            if ep_ret is None:
                ep_ret = torch.zeros_like(stock)
            if harvest is None:
                harvest = torch.full_like(stock, s["init_harvest"])
            p = _Params(
                **s, n_actions=n_actions, growth=_GROWTHS.index(growth),
                noise_form=NOISE_FORMS.index(noise_form), policy=POLICIES.index(policy),
                scheme=SCHEMES.index(scheme), obs_noise=int(obs_noise), num_steps=num_steps,
                has_noise=int(noise is not None), num_envs=B, offset=offset,
                keys=_round_keys(seed),
            )
            # stock, ep_ret, reward, eps, harvest
            out_f = [torch.empty_like(stock) for _ in range(5)]
            out_t, out_epc = torch.empty_like(t), torch.empty_like(t)
            lib = library(configuration(growth, s["model_idx"], noise_form, policy, scheme,
                                        obs_noise, noise is not None, p.r_drift))
        with span("rollout_kernel/launch"):
            with torch.cuda.device(stock.device):
                stream = torch.cuda.current_stream(stock.device).cuda_stream
                err = lib.rollout_launch(
                    ctypes.addressof(p), stock.data_ptr(), t.data_ptr(), ep_ret.data_ptr(),
                    harvest.data_ptr(), None if noise is None else noise.data_ptr(),
                    out_f[0].data_ptr(), out_t.data_ptr(), out_f[1].data_ptr(),
                    out_f[2].data_ptr(), out_f[3].data_ptr(), out_epc.data_ptr(),
                    out_f[4].data_ptr(), stream,
                )
            _build.check(lib, err, "rollout_kernel launch")
        launches += 1
        used = 0 if noise is not None else draws_per_call(num_steps, obs_noise)
        return KernelRollout(out_f[0], out_t, out_f[1], out_f[2], out_f[3], out_epc,
                             out_f[4], (offset + used) % _U64)


def philox_normals(seed: int, offset: int, num_envs: int, device) -> torch.Tensor:
    """The four N(0,1) of Philox block (env i, `offset`) for every env, as a
    (4, num_envs) f32 tensor: the rollout's own draw path. On a CUDA device
    a small kernel of the same source computes it; on the CPU the twin's
    `_philox_normals_reference` does."""
    if not (0 <= seed < _U64 and 0 <= offset < _U64) or num_envs < 1:
        raise ValueError("seed and offset must be unsigned 64-bit integers, num_envs >= 1")
    device = torch.device(device)
    if device.type == "cpu":
        idx = torch.arange(num_envs, dtype=torch.int64)
        return torch.stack(_philox_normals_reference(seed, offset, idx))
    out = torch.empty((4, num_envs), dtype=torch.float32, device=device)
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.philox_normal_fill(_round_keys(seed), offset, num_envs, out.data_ptr(),
                                     stream)
    _build.check(lib, err, "philox_normal_fill launch")
    return out


def normals_from_bits(bits: torch.Tensor, path: str = "sfu") -> torch.Tensor:
    """Box-Muller alone: the four N(0,1) of each column of `bits`, a (4, n)
    int64 tensor of uint32 values (one Philox block a column), as (4, n) f32.
    On a CUDA tensor `path` picks the kernel's function: "sfu", the rollout's
    own draw path on the special-function units, or "ieee", the same formulas
    with IEEE logf, sqrtf and sincosf. On a CPU tensor the twin's float32
    arithmetic runs whatever the path."""
    if path not in ("sfu", "ieee"):
        raise ValueError(f"unknown path {path!r}")
    if bits.dtype != torch.int64 or bits.dim() != 2 or bits.shape[0] != 4 or bits.shape[1] < 1:
        raise ValueError(f"bits must be int64 of shape (4, n), got {bits.dtype} "
                         f"{tuple(bits.shape)}")
    if bits.device.type == "cpu":
        return torch.stack(_box_muller_reference(tuple(bits)))
    words = ((bits + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32).contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    lib = library()
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        err = lib.box_muller_fill(words.data_ptr(), bits.shape[1], int(path == "sfu"),
                                  out.data_ptr(), stream)
    _build.check(lib, err, "box_muller_fill launch")
    return out


def library(config: Configuration = DEFAULT_CONFIGURATION) -> ctypes.CDLL:
    """Build (on first use) and load csrc/rollout_kernel.cu for `config`,
    with its launchers' ctypes signatures set."""
    return _library(config, ())


@functools.cache
def _library(config: Configuration, extra_defines: Tuple[str, ...]) -> ctypes.CDLL:
    """`library` for `config` plus further macros of the source, which no
    caller in the package passes (the bench measures with one)."""
    if any(not 0 <= value < size for value, size in zip(config, CONFIG_SIZES)):
        raise ValueError(f"no such configuration: {config}")
    lib = _build.load(_SOURCE, config.defines() + extra_defines)
    for size in (lib.rollout_params_size, lib.rollout_threads):
        size.argtypes = []
        size.restype = ctypes.c_int
    if lib.rollout_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError("struct RolloutParams and _Params disagree in size")
    built = (ctypes.c_int * len(CONFIG_FLAGS))()
    lib.rollout_configuration.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rollout_configuration.restype = None
    lib.rollout_configuration(built)
    if tuple(built) != tuple(config):
        raise RuntimeError(f"the library was built for {tuple(built)}, not for {config}")
    ptr = ctypes.c_void_p
    lib.rollout_launch.argtypes = [ptr] * 14
    lib.rollout_launch.restype = ctypes.c_int
    lib.philox_normal_fill.argtypes = [ptr, ctypes.c_ulonglong, ctypes.c_longlong, ptr, ptr]
    lib.philox_normal_fill.restype = ctypes.c_int
    lib.box_muller_fill.argtypes = [ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr]
    lib.box_muller_fill.restype = ctypes.c_int
    return lib


def build(configs) -> None:
    """Build and load the libraries of several configurations at once, one
    nvcc process each, 8 at a time."""
    todo = sorted(set(configs))
    with ThreadPoolExecutor(max(1, min(8, len(todo)))) as pool:
        list(pool.map(library, todo))


# --------------------------------------------------------------------- twin

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_TWO_PI = 6.283185307179586


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors a < 2^32 and m <
    2^32, in 16-bit pieces so no int64 product overflows."""
    pl = a * (m & 0xFFFF)  # < 2^48
    ph = a * (m >> 16)     # < 2^48
    lo = (((ph & 0xFFFF) << 16) + pl) & _MASK32
    hi = (ph + (pl >> 16)) >> 16
    return hi, lo


def _philox4x32_10(ctr, key):
    """Philox4x32-10 on int64 tensors holding uint32 values."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> f32 uniform in (0, 1], as the kernel does."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return 2.0 - f


def _box_muller_reference(bits):
    """Box-Muller of the four uint32 tensors `bits` (held in int64), as
    `_philox_normals_reference` computes it."""
    u = [_uniform_from_bits(b) for b in bits]
    rad0 = torch.sqrt(-2.0 * torch.log(u[0]))
    th0 = _TWO_PI * u[1]
    rad1 = torch.sqrt(-2.0 * torch.log(u[2]))
    th1 = _TWO_PI * u[3]
    return rad0 * torch.cos(th0), rad0 * torch.sin(th0), rad1 * torch.cos(th1), rad1 * torch.sin(th1)


def _philox_normals_reference(seed: int, counter: int, env_idx: torch.Tensor):
    """The kernel's `philox_normals` for every env index in `env_idx`."""
    counter %= _U64
    ctr_lo = torch.full_like(env_idx, counter & _MASK32)
    ctr_hi = torch.full_like(env_idx, counter >> 32)
    bits = _philox4x32_10(
        (env_idx & _MASK32, env_idx >> 32, ctr_lo, ctr_hi),
        (seed & _MASK32, seed >> 32),
    )
    u = [_uniform_from_bits(b) for b in bits]
    rad0 = torch.sqrt(-2.0 * torch.log(u[0]))
    th0 = _TWO_PI * u[1]
    rad1 = torch.sqrt(-2.0 * torch.log(u[2]))
    th1 = _TWO_PI * u[3]
    return rad0 * torch.cos(th0), rad0 * torch.sin(th0), rad1 * torch.cos(th1), rad1 * torch.sin(th1)


def rollout_reference(
    stock: torch.Tensor,
    t: torch.Tensor,
    params: EnvParams,
    policy: str,
    policy_param,
    num_steps: int,
    *,
    growth: str = "logistic",
    noise_form: str = "additive",
    scheme: str = "continuous",
    n_actions: int = 3,
    obs_noise: bool = False,
    ep_ret: Optional[torch.Tensor] = None,
    harvest: Optional[torch.Tensor] = None,
    seed: int = 0,
    offset: int = 0,
    noise: Optional[torch.Tensor] = None,
) -> KernelRollout:
    """Plain PyTorch twin of the kernel: same signature, outputs and noise."""
    _check_args(stock, t, ep_ret, harvest, noise, num_steps, growth, noise_form,
                policy, scheme, n_actions, obs_noise, seed, offset)
    s = _scalars(params, policy_param)
    dev, f32 = stock.device, torch.float32
    # the kernel's parameter struct as float32 scalars on the device
    p = EnvParams(**{n: torch.tensor(s[n], dtype=f32, device=dev)
                     for n in _FLOAT_FIELDS if n != "policy_param"},
                  Tmax=s["Tmax"],
                  model_idx=torch.tensor(s["model_idx"], dtype=torch.int32, device=dev))
    pp = torch.tensor(s["policy_param"], dtype=f32, device=dev)
    grow = get_growth_fn(growth)
    zero = torch.zeros((), dtype=f32, device=dev)
    mults = [torch.tensor(m, dtype=f32, device=dev) for m in (1.0, 1.2, 0.8)]

    x, tt = stock.clone(), t.clone()
    cur = torch.zeros_like(stock) if ep_ret is None else ep_ret.clone()
    h = torch.full_like(stock, s["init_harvest"]) if harvest is None else harvest.clone()
    rew, eps = torch.zeros_like(stock), torch.zeros_like(stock)
    epc = torch.zeros_like(t)
    env_idx = torch.arange(stock.shape[0], dtype=torch.int64, device=dev)
    per_draw = 2 if obs_noise else 4
    draws = ()
    for k in range(num_steps):
        if noise is not None:
            z = noise[0, k]
            eta = noise[1, k] if obs_noise else zero
        else:
            if k % per_draw == 0:
                draws = _philox_normals_reference(seed, offset + k // per_draw, env_idx)
            if obs_noise:
                j = 2 * (k % 2)
                z, eta = draws[j], draws[j + 1]
            else:
                z, eta = draws[k % 4], zero

        x_obs = x * torch.exp(p.sigma_m * eta) if obs_noise else x
        if policy == "escapement":
            quota = torch.maximum(x_obs - pp, zero)
        elif policy == "constant_mortality":
            quota = pp * x_obs
        else:
            quota = pp.expand_as(x)
        if scheme == "proportional":
            n = float(n_actions)
            a = torch.clamp(torch.round(quota * n / p.K), 0.0, n - 1.0)
            quota = a / n * p.K
        elif scheme == "relative":
            best = h * mults[0]
            bestd = torch.abs(best - quota)
            for m in mults[1:]:
                c = h * m
                d = torch.abs(c - quota)
                take = d < bestd
                best = torch.where(take, c, best)
                bestd = torch.where(take, d, bestd)
            quota = best
        hv = torch.minimum(x, quota)
        x1 = x - hv
        r_eff = p.r + p.r_drift * tt.to(f32)
        mu = grow(p.replace(r=r_eff), x1)
        x2 = apply_process_noise(noise_form, p, mu, x1, z)
        x_next = torch.where(x2 < 0.0, zero, x2)
        collapsed = x_next <= 0.0
        step_rew = p.price * hv - p.cost * quota * quota
        step_rew = step_rew - torch.where(collapsed, p.collapse_penalty, zero)
        rew = rew + step_rew
        cur = cur + step_rew
        t_next = tt + 1
        done = (t_next >= s["Tmax"]) | collapsed
        eps = eps + torch.where(done, cur, zero)
        epc = epc + done.to(torch.int32)
        cur = torch.where(done, zero, cur)
        x = torch.where(done, p.init_state, x_next)
        tt = torch.where(done, torch.zeros_like(t_next), t_next)
        if scheme == "relative":
            h = torch.where(done, p.init_harvest, quota)

    used = 0 if noise is not None else draws_per_call(num_steps, obs_noise)
    return KernelRollout(x, tt, cur, rew, eps, epc, h, (offset + used) % _U64)
