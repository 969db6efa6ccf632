"""Fused PPO minibatch gradient (K2) and gradient + clip + Adam (K3): CUDA
kernels and their plain twins.

Counterpart of ``gym_fishing_tpu/kernels/ppo_update_kernel.py``. One pass
over the feature-major packed samples ``data[R, N]`` (rows: obs, action,
old logp, old value, advantage, return, zero padding up to R, a multiple of
`C_PAD`: 8, 16 or 24 rows for the CUDA kernel) reads the tiles that
``tile_order`` names, runs the merged block-diagonal actor-critic forward
(``W1c [D, 2H]``, ``W2c [2H, 2H]``, ``Whc [2H, A+1]``), the Gaussian or
categorical log-prob, the clipped surrogate and the clipped value loss, and
the hand-derived backward, and sums 7 merged gradient buffers and 4 metric
sums ``[sum -pg, sum 0.5 v, sum (ratio - 1 - log ratio), sum ent or value]``.
K3 then masks the cross-tower blocks, clips by global norm and applies Adam.

- `fused_minibatch_grad` and `fused_minibatch_grad_adam` are the wrappers:
  on a CUDA tensor they launch ``csrc/ppo_update_kernel.cu`` (and add one to
  `grad_launches` or `adam_launches`), on a CPU tensor they run the twin.
- `fused_minibatch_grad_reference` and `fused_minibatch_grad_adam_reference`
  are the twins: the same arithmetic as plain tensor ops over the gathered
  tiles. Under ``compute="bfloat16"`` the three 2H-contractions (forward
  through W2c, dW2c and the gradient into h1) take bf16-rounded inputs and
  sum in float32, in both kernel and twin.

On the card the work is bound by operations, not bytes, and almost all of
them are the three 2H-contractions. W2c's cross-tower blocks are zero and
no parameter, so the kernel's stage 1 runs each product per tower (49 152
FLOP against 32 bytes per sample at hidden 64, half the merged matrix's):
on the tensor cores under ``compute="bfloat16"`` (``csrc/mma_tiles.cuh``,
bf16 inputs, float32 sums), and as register-tiled float32 FMA under
``compute="float32"``. The float32 mode uses no TF32: one pass keeps three
digits, and the split product that `split3_matmul_reference` states (three
TF32 passes of ``hi = tf32(a)`` and ``lo = tf32(a - hi)``) was measured on
the H100 and not kept, because the tensor cores' accumulator rounds towards
zero and the value tower's cancelling sums collect that bias (the kernel
source's note on numerics has the numbers). Each visited tile is shared by
`KERNEL_SPLIT` CTAs of 16 warps that walk chunks of `KERNEL_CHUNK` samples;
every CTA writes one workspace row (`stage1_rows`), stage 2 sums the rows in
index order (no float atomics: identical calls give identical bits), and
K3's stage 3 clips and applies Adam in one CTA. Hidden 128 and 256, and
categorical heads of 17 to `KERNEL_MAX_LOGITS` classes at any hidden size,
take the kernel's wide path (``csrc/wide_mlp.cuh``): the same grid and
workspace rows, every weight matrix streamed from L2 in k-slabs, products
as float32 FMA in both modes (bf16-rounded inputs under bfloat16). What bounds the kernel
beside the products is the float32 work around them: the tanh of both
hidden layers, the head and the loss.

Up to 4 observation fields each thread of stage 1 keeps its column's dW1c
sums in registers; longer observations (windows of stacked observations, up
to `KERNEL_MAX_OBS_DIM` fields) take instantiations whose threads own the
entries of the ``[D, 2H]`` block instead and read W1c from L2.

The kernel takes merged weights whose cross-tower blocks of W2c are zero, as
`merge_weights` builds them and K3's masked update keeps them, and traps on
any other; the twins take any W2c.

The advantage statistics ``adv_stats = (mu, 1/(std + 1e-8))`` arrive as a
2-element tensor on the data's device, so a minibatch loop never syncs with
the host; lr and the Adam bias corrections are host floats derived from the
Python-int Adam count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from gym_fishing_tpu_torch.kernels import _build

C_PAD = 8          # the packed sample matrix's rows come in multiples of this
LOG_2PI = 1.8378770664093453    # log(2 pi)
LOG_2PI_E = 2.837877066409345   # log(2 pi e): a unit Gaussian's entropy is half of it
HEADS = ("gaussian", "categorical")
COMPUTES = ("float32", "bfloat16")

# Adam hyperparameters: the one source for the plain optimizer
# (agents/ppo.py), the fused epoch scan (agents/ppo_fused.py) and the K3
# launcher below.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5

# Limits of the CUDA kernel (the twin takes any size).
KERNEL_HIDDEN = (32, 64, 128, 256)
KERNEL_MAX_ROWS = 24         # packed rows: obs_dim + action columns + 4 must fit them
KERNEL_MAX_OBS_DIM = KERNEL_MAX_ROWS - 5   # 19: one action column and the 4 fixed rows
KERNEL_MAX_ACT_DIM = 16      # Gaussian action columns
KERNEL_MAX_LOGITS = 128      # categorical classes
KERNEL_CHUNK = 64  # samples per chunk inside a tile
KERNEL_SPLIT = 2   # CTAs, and workspace rows, per visited tile

_SOURCE = "ppo_update_kernel"

# Kernel launches made by the wrappers (the CPU twin does not count).
grad_launches = 0
adam_launches = 0


class PPOGrads(NamedTuple):
    """Gradient buffers in kernel layout (split towers)."""

    dW1p: torch.Tensor   # [D, H]
    db1p: torch.Tensor   # [H, 1]
    dW2p: torch.Tensor   # [H, H]
    db2p: torch.Tensor   # [H, 1]
    dWm: torch.Tensor    # [H, A]
    dbm: torch.Tensor    # [A, 1]
    dlog_std: torch.Tensor  # [A, 1]
    dW1v: torch.Tensor   # [D, H]
    db1v: torch.Tensor   # [H, 1]
    dW2v: torch.Tensor   # [H, H]
    db2v: torch.Tensor   # [H, 1]
    dWv: torch.Tensor    # [H, 1]
    dbv: torch.Tensor    # [1, 1]


class _GradParams(ctypes.Structure):
    """Mirror of `struct GradParams` in csrc/ppo_update_kernel.cu."""

    _fields_ = (
        [(n, ctypes.c_float) for n in ("clip_eps", "vf_coef", "inv_n", "ent_coef")]
        + [(n, ctypes.c_int) for n in (
            "obs_dim", "act_dim", "head", "compute", "hidden", "tile", "num_tiles", "rows",
        )]
        + [("n_cols", ctypes.c_longlong)]
    )


class _AdamParams(ctypes.Structure):
    """Mirror of `struct AdamParams` in csrc/ppo_update_kernel.cu."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "lr", "bc1", "bc2", "max_grad_norm", "beta1", "beta2", "one_minus_b1",
        "one_minus_b2", "adam_eps", "pad0",
    )]


# ------------------------------------------------------------ merged layout

def merge_weights(weights: tuple) -> tuple:
    """13 split-tower kernel-layout arrays -> 7 merged block-diagonal arrays:
    W1c [D, 2H], b1c [2H, 1], W2c [2H, 2H], b2c [2H, 1], Whc [2H, A+1],
    bhc [A+1, 1], log_std [A, 1]. The zero off-diagonal blocks of W2c and Whc
    correspond to no parameter."""
    (w1p, b1p, w2p, b2p, wm, bm, ls, w1v, b1v, w2v, b2v, wv, bv) = weights
    h, a = w1p.shape[1], wm.shape[1]
    z = functools.partial(torch.zeros, dtype=torch.float32, device=w1p.device)
    w2c = torch.cat([torch.cat([w2p, z(h, h)], 1), torch.cat([z(h, h), w2v], 1)], 0)
    whc = torch.cat([torch.cat([wm, z(h, 1)], 1), torch.cat([z(h, a), wv], 1)], 0)
    return (torch.cat([w1p, w1v], 1), torch.cat([b1p, b1v], 0), w2c,
            torch.cat([b2p, b2v], 0), whc, torch.cat([bm, bv], 0), ls)


def unmerge_weights(merged: tuple, h: int, a: int) -> tuple:
    """Inverse of merge_weights (drops the zero off-diagonal blocks)."""
    w1c, b1c, w2c, b2c, whc, bhc, ls = merged
    return (
        w1c[:, :h], b1c[:h], w2c[:h, :h], b2c[:h], whc[:h, :a], bhc[:a], ls,
        w1c[:, h:], b1c[h:], w2c[h:, h:], b2c[h:], whc[h:, a:], bhc[a:],
    )


def _block_diag_masks(h: int, a: int, device=None):
    """f32 masks zeroing the cross-tower blocks of dW2c [2H, 2H] and
    dWhc [2H, A+1]."""
    r2 = torch.arange(2 * h, device=device)[:, None]
    c2 = torch.arange(2 * h, device=device)[None, :]
    m_w2c = ((r2 < h) & (c2 < h)) | ((r2 >= h) & (c2 >= h))
    ch = torch.arange(a + 1, device=device)[None, :]
    m_whc = ((r2 < h) & (ch < a)) | ((r2 >= h) & (ch == a))
    return m_w2c.to(torch.float32), m_whc.to(torch.float32)


def merged_shapes(obs_dim: int, hidden: int, act_dim: int):
    """Shapes of the 7 merged arrays, in the order of the kernel's flat buffer."""
    h2, a = 2 * hidden, act_dim
    return [(obs_dim, h2), (h2, 1), (h2, h2), (h2, 1), (h2, a + 1), (a + 1, 1), (a, 1)]


def flatten_merged(merged: tuple) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in merged])


def unflatten_merged(flat: torch.Tensor, obs_dim: int, hidden: int, act_dim: int) -> tuple:
    """Views of the flat buffer as the 7 merged arrays."""
    shapes = merged_shapes(obs_dim, hidden, act_dim)
    sizes = [r * c for r, c in shapes]
    return tuple(x.view(s) for x, s in zip(torch.split(flat[:sum(sizes)], sizes), shapes))


def _split_grads(merged_g: tuple, h: int, a: int) -> PPOGrads:
    return PPOGrads(*unmerge_weights(merged_g, h, a))


# ------------------------------------------------------------------ checks

def packed_rows(fields: int) -> int:
    """Rows of the packed matrix for `fields` sample fields: rounded up to a
    multiple of `C_PAD`, as the JAX package pads them."""
    return -(-fields // C_PAD) * C_PAD


def _check(data, tile_order, merged, adv_stats, obs_dim, act_dim, tile, head, compute):
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}")
    if compute not in COMPUTES:
        raise ValueError(f"unknown compute {compute!r}")
    na = act_dim if head == "gaussian" else 1
    if (data.dim() != 2 or data.shape[0] < C_PAD or data.shape[0] % C_PAD
            or data.dtype != torch.float32):
        raise ValueError(f"data must be float32 [R, N] with R a multiple of {C_PAD}, got "
                         f"{data.dtype} {tuple(data.shape)}")
    rows = data.shape[0]
    if obs_dim < 1 or act_dim < 1 or obs_dim + na + 4 > rows:
        raise ValueError(f"obs_dim {obs_dim} + action columns {na} + 4 must fit {rows} rows")
    if tile < 1 or data.shape[1] % tile:
        raise ValueError(f"N = {data.shape[1]} must be a multiple of tile = {tile}")
    if (tile_order.dim() != 1 or tile_order.shape[0] < 1
            or tile_order.dtype != torch.int32):
        raise ValueError("tile_order must be a non-empty int32 vector")
    if adv_stats.shape != (2,) or adv_stats.dtype != torch.float32:
        raise ValueError("adv_stats must be float32 of shape (2,): (mu, 1/(std + 1e-8))")
    hidden = merged[0].shape[1] // 2
    for x, shape in zip(merged, merged_shapes(obs_dim, hidden, act_dim)):
        if tuple(x.shape) != shape or x.dtype != torch.float32:
            raise ValueError(f"merged weight must be float32 {shape}, got {x.dtype} "
                             f"{tuple(x.shape)}")
    for x in (tile_order, adv_stats, *merged):
        if x.device != data.device:
            raise ValueError(f"a tensor is on {x.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"runs on CUDA or CPU tensors, not {data.device}")
    if data.device.type == "cuda":
        if not all(x.is_contiguous() for x in (data, tile_order, adv_stats)):
            raise ValueError("data, tile_order and adv_stats must be contiguous")
        check_kernel_limits(hidden, obs_dim, act_dim, tile, rows, head)
    return hidden


def check_kernel_limits(hidden: int, obs_dim: int, act_dim: int, tile: int,
                        rows: int = C_PAD, head: str = "gaussian") -> None:
    """Raise on sizes the CUDA kernel does not take (the twin takes any):
    `act_dim` is the Gaussian action columns or the categorical classes."""
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel takes hidden in {KERNEL_HIDDEN}, not {hidden}")
    if obs_dim > KERNEL_MAX_OBS_DIM:
        raise ValueError(f"the CUDA kernel takes obs_dim <= {KERNEL_MAX_OBS_DIM}, not {obs_dim}")
    if head == "gaussian" and act_dim > KERNEL_MAX_ACT_DIM:
        raise ValueError(f"the CUDA kernel takes act_dim <= {KERNEL_MAX_ACT_DIM} Gaussian "
                         f"action columns, not {act_dim}")
    if head == "categorical" and act_dim > KERNEL_MAX_LOGITS:
        raise ValueError(f"the CUDA kernel takes at most {KERNEL_MAX_LOGITS} categorical "
                         f"classes, not {act_dim}")
    if rows > KERNEL_MAX_ROWS:
        raise ValueError(f"the CUDA kernel reads at most {KERNEL_MAX_ROWS} packed rows, "
                         f"not {rows}")
    if tile % KERNEL_CHUNK:
        raise ValueError(f"the CUDA kernel takes tiles that are multiples of {KERNEL_CHUNK}")


def _check_adam(data, tile_order, merged_w, merged_m, merged_v, adv_stats, obs_dim, act_dim,
                tile, head, compute):
    hidden = _check(data, tile_order, merged_w, adv_stats, obs_dim, act_dim, tile, head,
                    compute)
    for group in (merged_m, merged_v):
        for x, w in zip(group, merged_w):
            if x.shape != w.shape or x.dtype != w.dtype or x.device != w.device:
                raise ValueError("Adam moments must match the weights' shapes and device")
    return hidden


# ---------------------------------------------------------------- wrappers

def fused_minibatch_grad(
    data: torch.Tensor,        # [R, N] f32 feature-major packed samples, R = 8, 16, 24
    tile_order: torch.Tensor,  # (G,) i32: the tiles this pass visits
    weights: tuple,            # 13 kernel-layout arrays, see PPOGrads order
    adv_stats: torch.Tensor,   # (2,) f32: (mu, 1/(std + 1e-8)) of the minibatch
    *,
    clip_eps: float,
    vf_coef: float,
    ent_coef: float,
    obs_dim: int,
    act_dim: int,
    tile: int = 2048,
    head: str = "gaussian",
    compute: str = "float32",
    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[PPOGrads, torch.Tensor]:
    """One fused pass -> (PPOGrads, metric sums (4,)).

    `reduce` takes the pass's one flat output (the 7 merged gradients, then
    the 4 metric sums) before it is split, and returns it reduced: the
    sharded step all-reduces it over the ranks there, in one collective.

    The minibatch is the ``G * tile`` samples of the tiles `tile_order`
    names, read in place (zero-copy shuffling); ``inv_n = 1 / (G * tile)``.
    `act_dim` is the action dimensionality (Gaussian) or n_actions
    (categorical, whose action row holds the class index as f32). On a CUDA
    tensor this launches the kernel on the current stream without syncing.
    """
    global grad_launches
    scal = dict(clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef, obs_dim=obs_dim,
                act_dim=act_dim, tile=tile, head=head, compute=compute)
    if data.device.type == "cpu":
        return fused_minibatch_grad_reference(data, tile_order, weights, adv_stats, **scal,
                                              reduce=reduce)
    merged = merge_weights(weights)
    hidden = _check(data, tile_order, merged, adv_stats, obs_dim, act_dim, tile, head, compute)
    gout = _launch(data, tile_order, flatten_merged(merged), adv_stats, hidden, **scal)
    grad_launches += 1
    if reduce is not None:
        gout = reduce(gout)
    g = unflatten_merged(gout, obs_dim, hidden, act_dim)
    return _split_grads(g, hidden, act_dim), gout[-4:]


def fused_minibatch_grad_adam(
    data: torch.Tensor,
    tile_order: torch.Tensor,
    merged_w: tuple,           # 7 merged weight arrays (merge_weights)
    merged_m: tuple,           # 7 merged Adam first moments
    merged_v: tuple,           # 7 merged Adam second moments
    adv_stats: torch.Tensor,
    *,
    clip_eps: float,
    vf_coef: float,
    ent_coef: float,
    lr: float,
    bc1: float,                # 1 - beta1^t at the new count t
    bc2: float,                # 1 - beta2^t
    obs_dim: int,
    act_dim: int,
    tile: int = 2048,
    head: str = "gaussian",
    compute: str = "float32",
    beta1: float = ADAM_B1,
    beta2: float = ADAM_B2,
    adam_eps: float = ADAM_EPS,
    max_grad_norm: float = 0.5,
):
    """One minibatch: gradient + clip-by-global-norm + Adam.

    Returns (new merged_w, new merged_m, new merged_v, metric sums (4,)), with
    optax.chain(clip_by_global_norm, adam) semantics: the cross-tower blocks
    are masked out of the norm and the update, the Gaussian head's
    data-independent entropy gradient ``-ent_coef`` joins ``log_std``'s before
    clipping, and the categorical head passes ``log_std`` and its moments
    through. On a CUDA tensor this launches the kernel without syncing.
    """
    global adam_launches
    scal = dict(clip_eps=clip_eps, vf_coef=vf_coef, ent_coef=ent_coef, obs_dim=obs_dim,
                act_dim=act_dim, tile=tile, head=head, compute=compute)
    if data.device.type == "cpu":
        return fused_minibatch_grad_adam_reference(
            data, tile_order, merged_w, merged_m, merged_v, adv_stats, lr=lr, bc1=bc1, bc2=bc2,
            beta1=beta1, beta2=beta2, adam_eps=adam_eps, max_grad_norm=max_grad_norm, **scal)
    hidden = _check_adam(data, tile_order, merged_w, merged_m, merged_v, adv_stats, obs_dim,
                         act_dim, tile, head, compute)
    w, m, v = (flatten_merged(x) for x in (merged_w, merged_m, merged_v))
    outs = [torch.empty_like(w) for _ in range(3)]
    q = _AdamParams(lr=lr, bc1=bc1, bc2=bc2, max_grad_norm=max_grad_norm, beta1=beta1,
                    beta2=beta2, one_minus_b1=1.0 - beta1, one_minus_b2=1.0 - beta2,
                    adam_eps=adam_eps, pad0=0.0)
    gout = _launch(data, tile_order, w, adv_stats, hidden, adam=(q, m, v, *outs), **scal)
    adam_launches += 1
    new = tuple(unflatten_merged(o, obs_dim, hidden, act_dim) for o in outs)
    return (*new, gout[-4:])


def _grad_params(data, tile_order, hidden, clip_eps, vf_coef, ent_coef, obs_dim, act_dim,
                 tile, head, compute) -> _GradParams:
    g = tile_order.shape[0]
    return _GradParams(
        clip_eps=clip_eps, vf_coef=vf_coef, inv_n=1.0 / (g * tile), ent_coef=ent_coef,
        obs_dim=obs_dim, act_dim=act_dim, head=HEADS.index(head),
        compute=COMPUTES.index(compute), hidden=hidden, tile=tile, num_tiles=g,
        rows=data.shape[0],
        n_cols=data.shape[1],
    )


def stage1_rows(num_tiles: int) -> int:
    """Rows of stage 1's workspace: one per CTA, `KERNEL_SPLIT` CTAs per
    visited tile, each taking a contiguous share of the tile's chunks."""
    return num_tiles * KERNEL_SPLIT


def _launch(data, tile_order, w_flat, adv_stats, hidden, adam=None, **scal):
    """Stage 1 (`KERNEL_SPLIT` CTAs per visited tile -> partials), stage 2
    (fixed-order reduce) and, with ``adam = (AdamParams, m, v, w_out, m_out, v_out)``,
    stage 3 (clip + Adam into the outputs). Returns the reduced [P + 4]
    buffer: merged gradients, then the 4 metric sums. A tile index outside
    the data traps the kernel (checking it here would sync with the card)."""
    p = _grad_params(data, tile_order, hidden, **scal)
    n_par = w_flat.numel()
    dev = data.device
    ws = torch.empty((stage1_rows(tile_order.shape[0]), n_par + 4), dtype=torch.float32,
                     device=dev)
    gout = torch.empty((n_par + 4,), dtype=torch.float32, device=dev)
    lib = library()
    # the wide path's weights laid out for its streamed products (none otherwise)
    n_prep = lib.ppo_grad_prep_floats(hidden, scal["act_dim"])
    prep = torch.empty((n_prep,), dtype=torch.float32, device=dev) if n_prep else None
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if adam is None:
            err = lib.ppo_grad_launch(ctypes.addressof(p), ptr(data), ptr(tile_order),
                                      ptr(w_flat), ptr(prep), ptr(adv_stats), ptr(ws),
                                      ptr(gout), stream)
            what = "ppo_grad_kernel launch"
        else:
            q, m, v, w_out, m_out, v_out = adam
            err = lib.ppo_grad_adam_launch(
                ctypes.addressof(p), ctypes.addressof(q), ptr(data),
                ptr(tile_order), ptr(w_flat), ptr(m), ptr(v), ptr(prep), ptr(adv_stats),
                ptr(ws), ptr(gout), ptr(w_out), ptr(m_out), ptr(v_out), stream)
            what = "ppo_grad_adam_kernel launch"
    _build.check(lib, err, what)
    return gout


@functools.cache
def library() -> ctypes.CDLL:
    """Build (on first use) and load csrc/ppo_update_kernel.cu, with its
    launchers' ctypes signatures set."""
    lib = _build.load(_SOURCE)
    if lib.ppo_grad_params_size() != ctypes.sizeof(_GradParams):
        raise RuntimeError("struct GradParams and _GradParams disagree in size")
    if lib.ppo_adam_params_size() != ctypes.sizeof(_AdamParams):
        raise RuntimeError("struct AdamParams and _AdamParams disagree in size")
    if (lib.ppo_grad_chunk(), lib.ppo_grad_split()) != (KERNEL_CHUNK, KERNEL_SPLIT):
        raise RuntimeError("the kernel's chunk and split disagree with KERNEL_CHUNK, KERNEL_SPLIT")
    ptr = ctypes.c_void_p
    lib.ppo_grad_launch.argtypes = [ptr] * 9
    lib.ppo_grad_launch.restype = ctypes.c_int
    lib.ppo_grad_adam_launch.argtypes = [ptr] * 15
    lib.ppo_grad_adam_launch.restype = ctypes.c_int
    lib.ppo_grad_prep_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ppo_grad_prep_floats.restype = ctypes.c_int
    return lib


# -------------------------------------------------------------------- twins

def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half a TF32 ulp to the
    magnitude's bits and clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split3_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as three TF32 passes would take a float32 product on the
    tensor cores: each input split into ``hi = tf32(x)`` and
    ``lo = tf32(x - hi)``, then ``(lo_a hi_b + hi_a lo_b) + hi_a hi_b`` with
    float32 sums. Only ``lo_a lo_b`` (2^-22 relative) is dropped, so with
    sums rounded to nearest it is as accurate as a float32 product; a single
    pass is not. States the arithmetic that was measured for the float32 mode
    (see the module note); nothing on the main path calls it."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _grad_merged_reference(data, tile_order, merged, adv_stats, *, clip_eps, vf_coef,
                           ent_coef, obs_dim, act_dim, tile, head, compute):
    """The kernel's pass as plain tensor ops on merged weights: (7 merged
    gradients, metric sums (4,))."""
    dev = data.device
    cols = (tile_order.to(torch.int64)[:, None] * tile
            + torch.arange(tile, device=dev)).reshape(-1)
    x = data[:, cols]
    n = cols.shape[0]
    inv_n = 1.0 / n
    D, A = obs_dim, act_dim
    gauss = head == "gaussian"
    na = A if gauss else 1
    obs, act = x[0:D], x[D:D + na]
    old_logp, old_v, adv, ret = x[D + na], x[D + na + 1], x[D + na + 2], x[D + na + 3]
    adv_mu, adv_inv_std = adv_stats[0], adv_stats[1]
    w1c, b1c, w2c, b2c, whc, bhc, ls = merged
    rnd = _bf16_round if compute == "bfloat16" else (lambda t: t)

    h1c = torch.tanh(w1c.T @ obs + b1c)                  # [2H, n]
    h2c = torch.tanh(rnd(w2c).T @ rnd(h1c) + b2c)        # [2H, n]
    out = whc.T @ h2c + bhc                              # [A+1, n]
    pi_out, value = out[:A], out[A]

    if gauss:
        inv_var = torch.exp(-2.0 * ls)                   # [A, 1]
        diff = act - pi_out
        logp = (-0.5 * (diff * diff * inv_var + 2.0 * ls + LOG_2PI)).sum(0)
    else:
        z = pi_out - pi_out.max(0, keepdim=True).values
        logp_all = z - torch.log(torch.exp(z).sum(0, keepdim=True))
        probs = torch.exp(logp_all)
        onehot = (torch.arange(A, device=dev, dtype=torch.float32)[:, None] == act).float()
        logp = (onehot * logp_all).sum(0)
        ent = -(probs * logp_all).sum(0)

    logr = logp - old_logp
    ratio = torch.exp(logr)
    adv_n = (adv - adv_mu) * adv_inv_std
    u1 = ratio * adv_n
    u2 = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv_n
    pg_each = torch.minimum(u1, u2)
    inside = (ratio > 1.0 - clip_eps) & (ratio < 1.0 + clip_eps)
    zero = torch.zeros((), device=dev)
    g_logp = torch.where((u1 <= u2) | inside, ratio * adv_n, zero) * (-inv_n)

    dv = value - old_v
    e1 = value - ret
    e2 = old_v + torch.clamp(dv, -clip_eps, clip_eps) - ret
    v_each = torch.maximum(e1 * e1, e2 * e2)
    inside_v = (dv > -clip_eps) & (dv < clip_eps)
    g_value = torch.where(e1 * e1 >= e2 * e2, e1, torch.where(inside_v, e2, zero)) * (
        vf_coef * inv_n)

    met = torch.stack([(-pg_each).sum(), (0.5 * v_each).sum(), (ratio - 1.0 - logr).sum(),
                       value.sum() if gauss else ent.sum()])

    if gauss:
        g_mean = g_logp * diff * inv_var
        dls = (g_logp * (diff * diff * inv_var - 1.0)).sum(1, keepdim=True)
    else:
        g_mean = g_logp * (onehot - probs) + (ent_coef * inv_n) * probs * (logp_all + ent)
        dls = torch.zeros_like(ls)

    g_top = torch.cat([g_mean, g_value[None]], 0)       # [A+1, n]
    dwhc = h2c @ g_top.T
    dbhc = g_top.sum(1, keepdim=True)
    g_p2c = (whc @ g_top) * (1.0 - h2c * h2c)
    dw2c = rnd(h1c) @ rnd(g_p2c).T
    db2c = g_p2c.sum(1, keepdim=True)
    g_p1c = (rnd(w2c) @ rnd(g_p2c)) * (1.0 - h1c * h1c)
    dw1c = obs @ g_p1c.T
    db1c = g_p1c.sum(1, keepdim=True)
    return (dw1c, db1c, dw2c, db2c, dwhc, dbhc, dls), met


def _clip_adam_reference(g, w, m, v, *, head, ent_coef, lr, bc1, bc2, beta1, beta2, adam_eps,
                         max_grad_norm):
    """K3's optimizer step on merged triples: masked global-norm clip + Adam."""
    h = w[2].shape[0] // 2
    a = w[4].shape[1] - 1
    m_w2c, m_whc = _block_diag_masks(h, a, w[0].device)
    gauss = head == "gaussian"
    g = list(g)
    g[2] = g[2] * m_w2c
    g[4] = g[4] * m_whc
    g[6] = g[6] - ent_coef if gauss else torch.zeros_like(g[6])
    n_buf = 7 if gauss else 6
    norm = torch.sqrt(sum((x * x).sum() for x in g[:n_buf]))
    scale = torch.where(norm < max_grad_norm, torch.ones_like(norm), max_grad_norm / norm)
    new_w, new_m, new_v = [], [], []
    for i in range(7):
        if i == 6 and not gauss:
            new_w.append(w[6])
            new_m.append(m[6])
            new_v.append(v[6])
            continue
        gi = g[i] * scale
        mi = beta1 * m[i] + (1.0 - beta1) * gi
        vi = beta2 * v[i] + (1.0 - beta2) * (gi * gi)
        new_w.append(w[i] - lr * (mi / bc1) / (torch.sqrt(vi / bc2) + adam_eps))
        new_m.append(mi)
        new_v.append(vi)
    return tuple(new_w), tuple(new_m), tuple(new_v)


def fused_minibatch_grad_reference(data, tile_order, weights, adv_stats, *, clip_eps, vf_coef,
                                   ent_coef, obs_dim, act_dim, tile=2048, head="gaussian",
                                   compute="float32", reduce=None):
    """Plain PyTorch twin of `fused_minibatch_grad`: same signature and outputs."""
    merged = merge_weights(weights)
    hidden = _check(data, tile_order, merged, adv_stats, obs_dim, act_dim, tile, head, compute)
    g, met = _grad_merged_reference(
        data, tile_order, merged, adv_stats, clip_eps=clip_eps, vf_coef=vf_coef,
        ent_coef=ent_coef, obs_dim=obs_dim, act_dim=act_dim, tile=tile, head=head,
        compute=compute)
    if reduce is not None:
        flat = reduce(torch.cat([flatten_merged(g), met]))
        g, met = unflatten_merged(flat, obs_dim, hidden, act_dim), flat[-4:]
    return _split_grads(g, hidden, act_dim), met


def fused_minibatch_grad_adam_reference(data, tile_order, merged_w, merged_m, merged_v,
                                        adv_stats, *, clip_eps, vf_coef, ent_coef, lr, bc1, bc2,
                                        obs_dim, act_dim, tile=2048, head="gaussian",
                                        compute="float32", beta1=ADAM_B1, beta2=ADAM_B2,
                                        adam_eps=ADAM_EPS, max_grad_norm=0.5):
    """Plain PyTorch twin of `fused_minibatch_grad_adam`: same signature and
    outputs."""
    _check_adam(data, tile_order, merged_w, merged_m, merged_v, adv_stats, obs_dim, act_dim,
                tile, head, compute)
    g, met = _grad_merged_reference(
        data, tile_order, merged_w, adv_stats, clip_eps=clip_eps, vf_coef=vf_coef,
        ent_coef=ent_coef, obs_dim=obs_dim, act_dim=act_dim, tile=tile, head=head,
        compute=compute)
    new = _clip_adam_reference(g, merged_w, merged_m, merged_v, head=head, ent_coef=ent_coef,
                               lr=lr, bc1=bc1, bc2=bc2, beta1=beta1, beta2=beta2,
                               adam_eps=adam_eps, max_grad_norm=max_grad_norm)
    return (*new, met)
