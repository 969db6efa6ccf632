"""The wide path's dW2c as a split-K product (``csrc/ppo_update_kernel.cu::
dw2c_split``): its geometry, its scratch and its plain pipeline against the
JAX kernel.

On the wide path (hidden 128 and 256, and categorical heads of more than
16 classes) stage 1 writes h1 and g_p2 [n, 2H] to an activation scratch
(bf16 under bfloat16), and ``dw2c_split`` sums h1^T g_p2 per tower over
ranges of the samples into the workspace rows, which stage 2 adds in its
fixed order. Here the plain version of that pipeline
(`fused_minibatch_grad_split_reference`) runs through `ppo_fused.fused_grad`
in place of the kernel and is held against JAX's ``fused_grad`` (the Pallas
kernel in interpret mode, as tests/test_torch_ppo_update_kernel.py runs it),
at several ranges, under that file's wide-width tolerances: rtol 2e-4 /
atol 2e-6 in float32 (sums in another order), 2e-3 / 2e-5 under bfloat16
(a float32 difference of one ulp can round an input of a product to the
neighbouring bf16 value). The card tests (tests/test_torch_cuda.py) hold
the kernel against the same plain version.
"""

import functools

import numpy as np
import pytest
import torch
from test_torch_ppo_update_kernel import _assert_trees_close, _case_wide, _np, _packed_t

from gym_fishing_tpu.agents import ppo_fused as jfused
from gym_fishing_tpu_torch.agents import ppo_fused
from gym_fishing_tpu_torch.convert import actor_critic_from_numpy, actor_critic_to_numpy
from gym_fishing_tpu_torch.kernels import ppo_update_kernel as uk

actor_critic_from_numpy = functools.partial(actor_critic_from_numpy, device="cpu")

torch.set_num_threads(1)


def test_split_plan_matches_the_cuda_source():
    """The block, the range and the narrow path's widest head as the CUDA
    source states them; its tile edge is the tower's, up to 128."""
    from test_torch_device import _cuda_constant

    assert _cuda_constant("kKBlock") == uk.KERNEL_KBLOCK
    assert _cuda_constant("kKSplitSamples") == uk.KERNEL_KSPLIT_SAMPLES
    assert _cuda_constant("kMaxA") == uk.KERNEL_MAX_NARROW_LOGITS
    src = (uk._build.CSRC / "ppo_update_kernel.cu").read_text()
    assert "constexpr int dw_tile(int H) { return H < 128 ? H : 128; }" in src
    assert ("static bool wide_path(int hidden, int act_dim) { return hidden > 64 || "
            "act_dim > kMaxA; }") in src


@pytest.mark.parametrize("hidden,act_dim,compute,tower", [
    (256, 1, "bfloat16", True), (128, 1, "bfloat16", True), (64, 100, "bfloat16", True),
    (256, 128, "bfloat16", True), (32, 17, "bfloat16", False), (64, 16, "bfloat16", False),
    (256, 1, "float32", False), (64, 100, "float32", False),
])
def test_tower_path_matches_the_cuda_source(hidden, act_dim, compute, tower):
    """Stage 1 runs ``ppo_grad_tower`` (a CTA a tower, W2c's block resident)
    on the wide path under bfloat16 at hidden 64 and above, where the W2c
    products are on the tensor cores (``kWideMma``), and ``ppo_grad_wide``
    elsewhere on the wide path: the rule `tower_path` states, which the
    wrapper counts launches by, is the one the library exports and the one
    its launcher takes."""
    src = (uk._build.CSRC / "ppo_update_kernel.cu").read_text()
    mma = (uk._build.CSRC / "mma_tiles.cuh").read_text()
    assert ("  return wide_path(hidden, act_dim) && compute == BFLOAT16 && hidden >= 64;"
            in src)
    assert "  constexpr bool TOWER = kWideMma<H2, BF>;" in src
    assert "inline constexpr bool kWideMma = BF && H2 >= 128;" in mma
    assert uk.tower_path(hidden, act_dim, compute) is tower


@pytest.mark.parametrize("hidden,act_dim,compute,head,pairs", [
    (256, 17, "bfloat16", "categorical", True), (256, 33, "bfloat16", "categorical", True),
    (256, 100, "bfloat16", "categorical", True), (256, 128, "bfloat16", "categorical", True),
    (256, 3, "bfloat16", "categorical", True), (256, 1, "bfloat16", "gaussian", False),
    (256, 100, "float32", "categorical", False), (128, 100, "bfloat16", "categorical", False),
    (128, 17, "bfloat16", "categorical", False), (128, 64, "bfloat16", "categorical", False),
    (64, 100, "bfloat16", "categorical", False), (64, 17, "bfloat16", "categorical", False),
    (64, 16, "bfloat16", "categorical", False), (32, 17, "bfloat16", "categorical", False),
])
def test_logit_pair_path_matches_the_cuda_source(hidden, act_dim, compute, head, pairs):
    """``ppo_grad_tower``'s categorical logits take two runs of 32 rows of
    Wm at once at the hidden width where two runs of the widest head fit the
    activation buffer they pass through (act0, 32 x (H + 8) floats) and the
    runs pair up: hidden 256, at every class count; elsewhere (hidden 64 and
    128, the Gaussian head, float32, ``ppo_grad_wide``, the narrow path)
    not. The rule `logit_pair_path` states, which the wrapper counts
    `logit_pair_launches` by, is the one the library exports and the kernel
    takes."""
    src = (uk._build.CSRC / "ppo_update_kernel.cu").read_text()
    wide = (uk._build.CSRC / "wide_mlp.cuh").read_text()
    assert "  return H % 64 == 0 && 2 * 32 * kWideMaxA <= kWideChunk * (H + 8);" in src
    assert ("  return ppo_grad_tower_path(hidden, act_dim, compute) && head == CATEGORICAL &&\n"
            "         logit_pairs(hidden);") in src
    assert "  if constexpr (logit_pairs(H)) {" in src
    assert "H <= kThreads && RING == S * (H + 8)," in src
    assert "constexpr int kWideChunk = 32;" in src
    assert "constexpr int kWideMaxA = 128;" in wide
    assert uk.KERNEL_MAX_LOGITS == 128
    assert uk.logit_pair_path(hidden, act_dim, compute, head) is pairs


def test_optimizer_and_ring_plans_match_the_cuda_source():
    """K3's stage 3 cuts the merged buffer into runs of kAdamRun floats (2
    float4 a thread of kAdamThreads) and blocks of kAdamHeadRows rows of Whc
    (2 a warp); the bf16 dw2c_split keeps kDwRing stages of one block of
    KERNEL_KBLOCK samples, at least 4 (the 32 KB of one stage in flight
    behind the one being read) and within a CTA's shared memory, a CTA a
    tile of 128 at hidden 128 and 256 (64 below), as ``split_k_tiles``
    lists them, with no cluster."""
    from test_torch_device import _cuda_constant

    threads, run, rows = (_cuda_constant(k) for k in ("kAdamThreads", "kAdamRun",
                                                       "kAdamHeadRows"))
    assert (threads, run, rows) == (256, 2048, 16)
    assert run == 8 * threads and rows == 2 * threads // 32
    ring = _cuda_constant("kDwRing")
    stage = 2 * 2 * uk.KERNEL_KBLOCK * 64 * 2   # two boxes of h1 and two of g_p2, bf16
    assert ring == 6 and ring * stage + 1024 <= 232448
    src = (uk._build.CSRC / "ppo_update_kernel.cu").read_text()
    assert "constexpr int dw_bf_tile(int H) { return H <= 64 ? 64 : 128; }" in src
    assert ("const int tile = BM > H ? 0 : blockIdx.x % per_tower, tr = tile >> 1, "
            "tc = tile & 1;") in src
    assert [t[3] for t in uk.split_k_tiles(256)] == [128] * 8
    assert "cluster_ctarank" not in src and "ClusterDimension" not in src


def _adam_visits(obs_dim, hidden, act_dim, gauss):
    """A plain mirror of stage 3's region plan (``body_entry``,
    ``head_entry`` and ``tail_grad`` in csrc/ppo_update_kernel.cu): (flat
    index, masked, parameter) of every entry each CTA visits, in the
    kernel's own terms: float4 runs over W1c, b1c, W2c and b2c with W2c's
    mask from the float4's first entry by shifts, rows of Whc walked a warp
    a row in chunks of 32 columns, then bhc and log_std. Returns (indices,
    masked, parameter, CTAs)."""
    from test_torch_device import _cuda_constant

    threads, run, rows = (_cuda_constant(k) for k in ("kAdamThreads", "kAdamRun",
                                                       "kAdamHeadRows"))
    h, h2, a1 = hidden, 2 * hidden, act_dim + 1
    w2 = obs_dim * h2 + h2
    b2 = w2 + h2 * h2
    wh = b2 + h2
    bh = wh + h2 * a1
    ls = bh + a1
    n_par = ls + act_dim
    lg = h2.bit_length() - 1
    assert 1 << lg == h2 and w2 % 4 == 0 and wh % 4 == 0
    body, head = -(-wh // run), h2 // rows
    idx, masked, param = [], [], []
    for cta in range(body):
        i = cta * run + 4 * np.arange(run // 4)   # k * threads + tid, in float4s
        i = i[i < wh]
        e = i - w2
        cross = (i >= w2) & (i < b2) & (((e >> lg) < h) != ((e & (h2 - 1)) < h))
        for q in range(4):
            idx.append(i + q)
            masked.append(cross)
            param.append(np.ones_like(cross))
    for cta in range(head):
        for warp in range(threads // 32):
            for rr in range(2):
                r = cta * rows + 2 * warp + rr
                c = (np.arange(32)[None, :] + 32 * np.arange(-(-129 // 32))[:, None]).ravel()
                c = c[c < a1]   # chunk k of 32 columns, lanes 0-31, up to 129 columns
                keep = c < act_dim if r < h else c == act_dim
                idx.append(wh + r * a1 + c)
                masked.append(~keep)
                param.append(np.ones_like(keep))
    tail = np.arange(bh, n_par)
    idx.append(tail)
    masked.append(np.zeros(tail.shape, bool))
    param.append((tail < ls) | gauss)
    return (np.concatenate(idx), np.concatenate(masked), np.concatenate(param),
            body + head + 1)


@pytest.mark.parametrize("obs_dim,hidden,act_dim,head", [
    (1, 64, 1, "gaussian"), (1, 256, 1, "gaussian"), (1, 256, 100, "categorical"),
    (6, 128, 3, "gaussian"), (1, 32, 17, "categorical"), (12, 64, 128, "categorical")])
def test_clip_adam_region_plan_masks_as_the_block_diag_masks(obs_dim, hidden, act_dim, head):
    """Stage 3's CTAs visit every merged entry exactly once; the entries the
    plan masks are exactly the cross-tower blocks of `_block_diag_masks`
    (dW2c and dWhc), everything else passes its gradient through, and the one
    entry block that is no parameter is the categorical head's log_std."""
    gauss = head == "gaussian"
    idx, masked, param, ctas = _adam_visits(obs_dim, hidden, act_dim, gauss)
    shapes = uk.merged_shapes(obs_dim, hidden, act_dim)
    n_par = sum(r * c for r, c in shapes)
    np.testing.assert_array_equal(np.bincount(idx, minlength=n_par), np.ones(n_par, np.int64))
    order = np.argsort(idx)
    m_w2c, m_whc = uk._block_diag_masks(hidden, act_dim)
    keep = uk.flatten_merged([torch.ones(s) for s in shapes[:2]] + [m_w2c, torch.ones(shapes[3]),
                              m_whc] + [torch.ones(s) for s in shapes[5:]])
    np.testing.assert_array_equal(masked[order], keep.numpy() == 0)
    is_ls = np.arange(n_par) >= n_par - act_dim
    np.testing.assert_array_equal(param[order], ~is_ls | gauss)
    assert ctas == -(-(n_par - (2 * act_dim + 1) - 2 * hidden * (act_dim + 1))
                     // 2048) + 2 * hidden // 16 + 1


@pytest.mark.parametrize("num_tiles,tile", [(1, 64), (2, 128), (8, 256), (3, 1024), (64, 256),
                                            (128, 2048), (5, 192), (1, 4096)])
def test_split_ranges_cover_every_sample_once(num_tiles, tile):
    """The ranges are whole blocks of KERNEL_KBLOCK samples, at most
    KERNEL_KSPLIT_SAMPLES each, at most one per workspace row, contiguous
    and in order from 0 to n."""
    n = num_tiles * tile
    ranges = uk.split_k_ranges(num_tiles, tile)
    assert 1 <= len(ranges) <= uk.stage1_rows(num_tiles)
    assert len(ranges) == min(-(-n // uk.KERNEL_KSPLIT_SAMPLES), uk.stage1_rows(num_tiles))
    covered = np.zeros(n, np.int64)
    for k0, k1 in ranges:
        assert k0 % uk.KERNEL_KBLOCK == 0 and k1 % uk.KERNEL_KBLOCK == 0 and k1 > k0
        covered[k0:k1] += 1
    assert (covered == 1).all()
    assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
    if len(ranges) < uk.stage1_rows(num_tiles):
        assert max(k1 - k0 for k0, k1 in ranges) <= uk.KERNEL_KSPLIT_SAMPLES


@pytest.mark.parametrize("hidden", [32, 64, 128, 256])
def test_split_tiles_cover_each_tower_block_once(hidden):
    """The output tiles cover each tower's [H, H] block of dW2c exactly once
    and no cross-tower entry."""
    seen = np.zeros((2 * hidden, 2 * hidden), np.int64)
    for tw, r0, c0, bm in uk.split_k_tiles(hidden):
        assert bm == min(hidden, 128) and hidden % bm == 0
        seen[tw * hidden + r0:tw * hidden + r0 + bm, tw * hidden + c0:tw * hidden + c0 + bm] += 1
    block = np.zeros_like(seen)
    block[:hidden, :hidden] = block[hidden:, hidden:] = 1
    np.testing.assert_array_equal(seen, block)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,act_dim,num_tiles,tile", [
    (128, 1, 8, 256), (256, 1, 128, 2048), (64, 100, 3, 1024), (32, 17, 2, 64)])
def test_scratch_size_is_what_the_split_reads(hidden, act_dim, num_tiles, tile, compute):
    """The activation scratch the wrapper allocates holds exactly the h1 and
    g_p2 rows that the ranges read, in the mode's type: 2 x n x 2H entries,
    and the narrow path allocates none."""
    n = num_tiles * tile
    size, dtype = uk.act_scratch(hidden, act_dim, n, compute)
    assert dtype == (torch.bfloat16 if compute == "bfloat16" else torch.float32)
    end = max(k1 for _, k1 in uk.split_k_ranges(num_tiles, tile))
    assert size == 2 * end * 2 * hidden == 2 * n * 2 * hidden
    assert uk.act_scratch(64, 3, n, compute) is None
    assert uk.act_scratch(32, 16, n, compute) is None


@pytest.mark.parametrize("num_tiles,tile", [(8, 256), (12, 512)])
def test_dw2c_split_cpu_wrapper_fills_the_rows_of_its_ranges(num_tiles, tile):
    """On CPU tensors `dw2c_split` runs its plain version: row j of the
    workspace gets range j's partial in its dW2c block, the other rows and
    entries are left as they were, and stage 2's order of the rows gives
    h1^T g_p2 per tower."""
    hidden, obs_dim, act_dim = 128, 1, 1
    n = num_tiles * tile
    rng = np.random.default_rng(0)
    act = torch.from_numpy(rng.standard_normal(2 * n * 2 * hidden).astype(np.float32))
    p = sum(r * c for r, c in uk.merged_shapes(obs_dim, hidden, act_dim))
    ws = torch.zeros((uk.stage1_rows(num_tiles), p + 4))
    before = uk.split_launches
    uk.dw2c_split(act, ws, hidden=hidden, obs_dim=obs_dim, act_dim=act_dim,
                  num_tiles=num_tiles, tile=tile)
    assert uk.split_launches == before
    ranges = uk.split_k_ranges(num_tiles, tile)
    l_w2, h2 = obs_dim * 2 * hidden + 2 * hidden, 2 * hidden
    w2 = ws[:, l_w2:l_w2 + h2 * h2].reshape(-1, h2, h2)
    assert float(ws[:, :l_w2].abs().sum()) == 0.0
    assert float(ws[:, l_w2 + h2 * h2:].abs().sum()) == 0.0
    assert float(w2[len(ranges):].abs().sum()) == 0.0
    assert float(w2[:, :hidden, hidden:].abs().sum()) == float(w2[:, hidden:, :hidden].abs().sum())
    assert float(w2[:, :hidden, hidden:].abs().sum()) == 0.0
    h1, gp2 = act.view(2, n, h2).double()
    want = h1.T @ gp2
    want[:hidden, hidden:] = want[hidden:, :hidden] = 0.0
    # float32 sums of up to 6144 products of unit normals, against float64
    got = uk.reduce_rows_reference(w2).double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    for j, (k0, k1) in enumerate(ranges):
        part = h1[k0:k1, :hidden].T @ gp2[k0:k1, :hidden]
        np.testing.assert_allclose(w2[j, :hidden, :hidden].double().numpy(), part.numpy(),
                                   rtol=0, atol=1e-5 * float(part.abs().max()))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,head", [(128, "gaussian"), (256, "gaussian"),
                                         (128, "categorical"), (256, "categorical")])
def test_split_pipeline_matches_jax_kernel(hidden, head, compute, monkeypatch):
    """Stage 1's h1 and g_p2, dw2c_split's plain version over three ranges of
    2048 samples and stage 2's order of the rows, with the other buffers as
    the twin gives them, equal JAX's fused gradient (interpret mode) at
    hidden 128 and 256, the Gaussian head and 100 classes."""
    n, tile = 6144, 1024
    assert len(uk.split_k_ranges(n // tile, tile)) == 3
    cfg, params, packed, a = _case_wide(head, hidden, seed=hidden + 1, n=n)
    kw = dict(obs_dim=1, act_dim=a, tile=tile, head=head, compute=compute)
    j_grads, j_met = jfused.fused_grad(params, jfused.pack_feature_major(packed), cfg.clip_eps,
                                       cfg.vf_coef, cfg.ent_coef, interpret=True, **kw)
    monkeypatch.setattr(ppo_fused, "fused_minibatch_grad",
                        uk.fused_minibatch_grad_split_reference)
    model = actor_critic_from_numpy(_np(params))
    grads, met = ppo_fused.fused_grad(dict(model.named_parameters()), _packed_t(packed),
                                      cfg.clip_eps, cfg.vf_coef, cfg.ent_coef, **kw)
    tol = dict(rtol=2e-4, atol=2e-6) if compute == "float32" else dict(rtol=2e-3, atol=2e-5)
    _assert_trees_close(actor_critic_to_numpy(grads), j_grads, **tol)
    for name in ("loss", "pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(float(met[name]), float(j_met[name]), rtol=2e-4, atol=2e-6,
                                   err_msg=name)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden,head,a", [(256, "gaussian", 1), (64, "categorical", 100)])
def test_split_pipeline_equals_the_twin_over_many_ranges(hidden, head, a, compute):
    """Over a minibatch of 24 tiles of 512 samples (6 ranges) in shuffled
    order, the plain pipeline's dW2c equals the twin's single product to
    float32 rounding, and every other buffer and metric sum bit for bit."""
    from test_torch_cuda import _ppo_case, _towers

    weights, data, a_ = _ppo_case(head, 32 * 512, hidden, seed=11,
                                  act_dim=None if head == "gaussian" else a)
    weights = tuple(w.detach() for w in weights)
    order = torch.from_numpy(np.random.default_rng(2).permutation(32)[:24].astype(np.int32))
    assert len(uk.split_k_ranges(24, 512)) == 6
    kw = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01, obs_dim=1, act_dim=a_, tile=512,
              head=head, compute=compute)
    stats = torch.tensor([0.05, 1.1])
    got, met = uk.fused_minibatch_grad_split_reference(data, order, weights, stats, **kw)
    want, met_ref = uk.fused_minibatch_grad_reference(data, order, weights, stats, **kw)
    for i, (g, w) in enumerate(zip(_towers(got), _towers(want))):   # the split arrays
        if i in (2, 9):   # dW2p, dW2v
            tol = 1e-5 * float(w.abs().max()) + 1e-9
            assert float((g - w).abs().max()) <= tol, i
        else:
            assert torch.equal(g, w), i
    assert torch.equal(met, met_ref)
