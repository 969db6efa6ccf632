// Fused PPO minibatch gradient (K2) and gradient + clip + Adam (K3), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels gym_fishing_tpu/kernels/ppo_update_kernel.py::
// _ppo_grad_kernel (body _grad_tile) and ::_ppo_grad_adam_kernel. The Python
// wrappers are gym_fishing_tpu_torch/kernels/ppo_update_kernel.py::
// fused_minibatch_grad and ::fused_minibatch_grad_adam; their plain PyTorch
// twins there are fused_minibatch_grad_reference and
// fused_minibatch_grad_adam_reference.
//
// What it computes, per visited tile of the feature-major sample matrix
// data[8, N] (rows: obs[D], action[na], old logp, old value, advantage,
// return): the merged block-diagonal actor-critic forward
//   h1 = tanh(W1c^T x + b1c), h2 = tanh(W2c^T h1 + b2c), out = Whc^T h2 + bhc
// (W1c [D, 2H], W2c [2H, 2H], Whc [2H, A+1]; rows of out: policy mean or
// logits, then the value), the Gaussian or categorical log-prob, the clipped
// surrogate and clipped value loss, and the hand-derived backward, summed into
// the 7 merged gradient buffers and 4 metric sums.
//
// What bounds it on this card: float32 FMA throughput. Per sample the three
// 2H-contractions (forward through W2c, dW2c, and the gradient into h1) cost
// 3 x 2 x 128 x 128 = 98,304 FLOP at hidden = 64, against 32 bytes of input
// read once; the rank-1 input layer and the (A+1)-wide head add ~2%. A
// minibatch of 2^18 samples is ~2.6e10 FLOP (computed) against 8 MB read, so
// memory is far from the limit.
//
// What the design does about it:
// - Stage 1: one CTA of 256 threads per visited tile (tile_order picks the
//   tile, so shuffling stays zero-copy). W2c and its transpose sit in
//   shared memory (2 x 64 KiB at 2H = 128, above the 48 KiB default, hence
//   cudaFuncSetAttribute); the tile streams through in chunks of 32 samples
//   whose activations stay in shared memory. The products are register-tiled
//   (4 samples x 4 outputs per thread for the two activation products,
//   8 x 8 of dW2c per thread, accumulated in registers over the whole tile).
//   Each CTA writes its partial gradients and metric sums to a workspace
//   row [G, P + 4].
// - Stage 2: one thread per gradient entry sums the G rows in index order.
//   No float atomics anywhere, so two identical steps give identical bits.
// - Stage 3 (K3 only): one CTA takes the masked global norm in a fixed
//   reduction order, clips, and applies Adam to the ~17k merged parameters.
//
// Numerics: float32 IEEE arithmetic (FMA contraction allowed, no TF32, no
// --use_fast_math). Under compute = bfloat16 the inputs of the three
// 2H-contractions are rounded with __float2bfloat16_rn and summed in float32,
// as the TPU kernel's bf16 inputs with f32 accumulation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "merged_mlp.cuh"

struct GradParams {
  float clip_eps, vf_coef, inv_n, ent_coef;
  int obs_dim, act_dim, head, compute, hidden, tile, num_tiles, pad0;
  long long n_cols;
};
static_assert(sizeof(GradParams) == 56, "GradParams layout must match ctypes");

struct AdamParams {
  float lr, bc1, bc2, max_grad_norm, beta1, beta2, one_minus_b1, one_minus_b2, adam_eps, pad0;
};
static_assert(sizeof(AdamParams) == 40, "AdamParams layout must match ctypes");

// Indices into the Python tuples HEADS and COMPUTES.
enum { GAUSSIAN = 0, CATEGORICAL = 1 };
enum { FLOAT32 = 0, BFLOAT16 = 1 };

#define LOG_2PI_F 1.8378770664093453f

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // samples per chunk
constexpr int kRows = 8;    // C_PAD
constexpr int kMaxD = 4;
constexpr int kMaxA = 16;   // logits width
constexpr int kMaxA1 = kMaxA + 1;
constexpr int kMaxGaussA = 3;  // Gaussian action columns that fit 8 rows

// Shared-memory plan of stage 1 (offsets in floats).
template <int H2>
struct Smem {
  static constexpr int LD = kActLD<H2>;
  static constexpr int W2 = 0;                       // [H2][H2]
  static constexpr int W2T = W2 + H2 * H2;           // [H2][H2]
  static constexpr int H1 = W2T + H2 * H2;           // [kChunk][LD]
  static constexpr int B = H1 + kChunk * LD;         // h2, then g_p1
  static constexpr int G = B + kChunk * LD;          // g_p2
  static constexpr int W1 = G + kChunk * LD;         // [kMaxD][H2]
  static constexpr int B1 = W1 + kMaxD * H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int WH = B2 + H2;                 // [H2][A1]
  static constexpr int BH = WH + H2 * kMaxA1;
  static constexpr int LS = BH + kMaxA1;
  static constexpr int X = LS + kMaxA;               // [kRows][kChunk]
  static constexpr int OUT = X + kRows * kChunk;     // [kChunk][kMaxA1]
  static constexpr int GTOP = OUT + kChunk * kMaxA1; // [kChunk][kMaxA1]
  static constexpr int DWH = GTOP + kChunk * kMaxA1; // [H2][A1] accumulators
  static constexpr int TOTAL = DWH + H2 * kMaxA1;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};
static_assert(Smem<128>::BYTES <= 232448, "stage 1 exceeds the shared memory of a CTA");

template <int H2, bool BF>
__global__ void __launch_bounds__(kThreads, 1)
    ppo_grad_tiles(const GradParams p, const float* __restrict__ data,
                   const int* __restrict__ order, const float* __restrict__ w,
                   const float* __restrict__ adv_stats, float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  using S = Smem<H2>;
  constexpr int LD = S::LD;
  constexpr int CPT = H2 / 32;   // columns per thread in the activation products
  constexpr int RW = H2 / 16;    // dW2c thread tile is RW x RW
  float* sW2 = sm + S::W2;
  float* sW2T = sm + S::W2T;
  float* sH1 = sm + S::H1;
  float* sB = sm + S::B;
  float* sG = sm + S::G;
  float* sW1 = sm + S::W1;
  float* sb1 = sm + S::B1;
  float* sb2 = sm + S::B2;
  float* sWh = sm + S::WH;
  float* sbh = sm + S::BH;
  float* sls = sm + S::LS;
  float* sX = sm + S::X;
  float* sOut = sm + S::OUT;
  float* sGtop = sm + S::GTOP;
  float* sdWh = sm + S::DWH;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.obs_dim, A = p.act_dim, A1 = A + 1;
  const bool gauss = p.head == GAUSSIAN;
  const int na = gauss ? A : 1;
  const Layout L = make_layout(D, H2, A);
  const long long N = p.n_cols;
  const int tile_idx = order[blockIdx.x];
  if (tile_idx < 0 || (long long)(tile_idx + 1) * p.tile > N) __trap();
  const long long base = (long long)tile_idx * p.tile;

  for (int i = tid; i < H2 * H2; i += kThreads) {
    const float v = in_round<BF>(w[L.w2 + i]);
    sW2[i] = v;
    sW2T[(i % H2) * H2 + i / H2] = v;
  }
  for (int i = tid; i < D * H2; i += kThreads) sW1[i] = w[L.w1 + i];
  for (int i = tid; i < H2; i += kThreads) {
    sb1[i] = w[L.b1 + i];
    sb2[i] = w[L.b2 + i];
  }
  for (int i = tid; i < H2 * A1; i += kThreads) {
    sWh[i] = w[L.wh + i];
    sdWh[i] = 0.0f;
  }
  for (int i = tid; i < A1; i += kThreads) sbh[i] = w[L.bh + i];
  for (int i = tid; i < A; i += kThreads) sls[i] = w[L.ls + i];
  const float adv_mu = adv_stats[0], adv_inv_std = adv_stats[1];
  const float eps = p.clip_eps, inv_n = p.inv_n;
  const float g_value_scale = p.vf_coef * inv_n, ent_scale = p.ent_coef * inv_n;

  // accumulators that persist over the tile's chunks
  const int j0 = (tid >> 4) * RW, k0 = (tid & 15) * RW;
  float acc_w2[RW][RW];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < RW; ++c) acc_w2[i][c] = 0.0f;
  float acc_b1 = 0.0f, acc_b2 = 0.0f, acc_bh = 0.0f;
  float acc_w1[kMaxD] = {0.0f, 0.0f, 0.0f, 0.0f};
  float met[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dls[kMaxGaussA] = {0.0f, 0.0f, 0.0f};
  const int s0 = warp * 4, c0 = lane * CPT;
  __syncthreads();

  for (int chunk = 0; chunk < p.tile / kChunk; ++chunk) {
    const long long col0 = base + (long long)chunk * kChunk;
    for (int i = tid; i < kRows * kChunk; i += kThreads)
      sX[i] = data[(long long)(i / kChunk) * N + col0 + i % kChunk];
    __syncthreads();

    // h1 = tanh(W1c^T x + b1c)
    for (int i = tid; i < kChunk * H2; i += kThreads) {
      const int s = i / H2, j = i % H2;
      float z = 0.0f;
      for (int d = 0; d < D; ++d) z = fmaf(sW1[d * H2 + j], sX[d * kChunk + s], z);
      sH1[s * LD + j] = tanhf(z + sb1[j]);
    }
    __syncthreads();

    // h2 = tanh(W2c^T h1 + b2c)
    {
      float acc[4][CPT];
      chunk_product<H2, BF>(sH1, sW2, s0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sB[(s0 + i) * LD + c0 + c] = tanhf(acc[i][c] + sb2[c0 + c]);
    }
    __syncthreads();

    // heads: out[s][a] = Whc[:, a] . h2[s] + bhc[a], one warp per (s, a)
    for (int q = warp; q < kChunk * A1; q += kWarps) {
      const int s = q / A1, a = q % A1;
      float z = 0.0f;
      for (int k = lane; k < H2; k += 32) z = fmaf(sWh[k * A1 + a], sB[s * LD + k], z);
      z = warp_sum(z);
      if (lane == 0) sOut[s * kMaxA1 + a] = z + sbh[a];
    }
    __syncthreads();

    // per-sample loss and the gradient at the head's outputs (warp 0)
    if (warp == 0) {
      const int s = lane;
      const float* x = sX + s;
      const float old_logp = x[(D + na) * kChunk], old_v = x[(D + na + 1) * kChunk];
      const float adv = x[(D + na + 2) * kChunk], ret = x[(D + na + 3) * kChunk];
      const float* out = sOut + s * kMaxA1;
      const float value = out[A];
      float* gtop = sGtop + s * kMaxA1;
      float logp = 0.0f, ent = 0.0f;
      float diff[kMaxGaussA], inv_var[kMaxGaussA];
      float logp_all[kMaxA], probs[kMaxA];
      if (gauss) {
#pragma unroll
        for (int a = 0; a < kMaxGaussA; ++a) {
          if (a < A) {
            inv_var[a] = expf(-2.0f * sls[a]);
            diff[a] = x[(D + a) * kChunk] - out[a];
            logp += -0.5f * (diff[a] * diff[a] * inv_var[a] + 2.0f * sls[a] + LOG_2PI_F);
          }
        }
      } else {
        float mx = out[0];
        for (int a = 1; a < A; ++a) mx = fmaxf(mx, out[a]);
        float se = 0.0f;
#pragma unroll
        for (int a = 0; a < kMaxA; ++a)
          if (a < A) se += expf(out[a] - mx);
        const float lse = logf(se);
        const float act = x[D * kChunk];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          if (a < A) {
            logp_all[a] = (out[a] - mx) - lse;
            probs[a] = expf(logp_all[a]);
            if ((float)a == act) logp += logp_all[a];
            ent -= probs[a] * logp_all[a];
          }
        }
      }
      const float logr = logp - old_logp;
      const float ratio = expf(logr);
      const float adv_n = (adv - adv_mu) * adv_inv_std;
      const float rc = fminf(fmaxf(ratio, 1.0f - eps), 1.0f + eps);
      const float u1 = ratio * adv_n, u2 = rc * adv_n;
      const bool inside = ratio > 1.0f - eps && ratio < 1.0f + eps;
      const float g_logp = ((u1 <= u2) || inside ? ratio * adv_n : 0.0f) * (-inv_n);
      const float dv = value - old_v;
      const float e1 = value - ret;
      const float e2 = old_v + fminf(fmaxf(dv, -eps), eps) - ret;
      const bool inside_v = dv > -eps && dv < eps;
      const float g_value =
          (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.0f)) * g_value_scale;
      met[0] -= fminf(u1, u2);
      met[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
      met[2] += ratio - 1.0f - logr;
      met[3] += gauss ? value : ent;
      if (gauss) {
#pragma unroll
        for (int a = 0; a < kMaxGaussA; ++a) {
          if (a < A) {
            gtop[a] = g_logp * diff[a] * inv_var[a];
            dls[a] += g_logp * (diff[a] * diff[a] * inv_var[a] - 1.0f);
          }
        }
      } else {
        const float act = x[D * kChunk];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          if (a < A) {
            const float onehot = (float)a == act ? 1.0f : 0.0f;
            gtop[a] = g_logp * (onehot - probs[a]) + ent_scale * probs[a] * (logp_all[a] + ent);
          }
        }
      }
      gtop[A] = g_value;
    }
    __syncthreads();

    // head backward: dWhc, dbhc and g_p2 = (Whc g_top) * (1 - h2^2)
    for (int q = tid; q < H2 * A1; q += kThreads) {
      const int k = q / A1, a = q % A1;
      float z = 0.0f;
      for (int s = 0; s < kChunk; ++s) z = fmaf(sB[s * LD + k], sGtop[s * kMaxA1 + a], z);
      sdWh[q] += z;
    }
    if (tid < A1) {
      float z = 0.0f;
      for (int s = 0; s < kChunk; ++s) z += sGtop[s * kMaxA1 + tid];
      acc_bh += z;
    }
    for (int i = tid; i < kChunk * H2; i += kThreads) {
      const int s = i / H2, k = i % H2;
      float g = 0.0f;
      for (int a = 0; a < A1; ++a) g = fmaf(sWh[k * A1 + a], sGtop[s * kMaxA1 + a], g);
      const float h2 = sB[s * LD + k];
      sG[s * LD + k] = g * (1.0f - h2 * h2);
    }
    __syncthreads();

    // dW2c += h1^T g_p2 (registers), db2c, and g_p1 = (W2c g_p2) * (1 - h1^2)
#pragma unroll 4
    for (int s = 0; s < kChunk; ++s) {
      float a[RW], b[RW];
      load_row<RW>(sH1 + s * LD + j0, a);
      load_row<RW>(sG + s * LD + k0, b);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float ai = in_round<BF>(a[i]);
#pragma unroll
        for (int c = 0; c < RW; ++c) acc_w2[i][c] = fmaf(ai, in_round<BF>(b[c]), acc_w2[i][c]);
      }
    }
    if (tid < H2) {
      float z = 0.0f;
      for (int s = 0; s < kChunk; ++s) z += sG[s * LD + tid];
      acc_b2 += z;
    }
    {
      float acc[4][CPT];
      chunk_product<H2, BF>(sG, sW2T, s0, c0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float h1 = sH1[(s0 + i) * LD + c0 + c];
          sB[(s0 + i) * LD + c0 + c] = acc[i][c] * (1.0f - h1 * h1);
        }
    }
    __syncthreads();

    // input layer: db1c, dW1c
    if (tid < H2) {
      float zb = 0.0f, zw[kMaxD] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int s = 0; s < kChunk; ++s) {
        const float g = sB[s * LD + tid];
        zb += g;
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < D) zw[d] = fmaf(sX[d * kChunk + s], g, zw[d]);
      }
      acc_b1 += zb;
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) acc_w1[d] += zw[d];
    }
    __syncthreads();
  }

  // this tile's partial sums -> workspace row blockIdx.x
  float* out = ws + (long long)blockIdx.x * (L.P + 4);
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < RW; ++c) out[L.w2 + (j0 + i) * H2 + k0 + c] = acc_w2[i][c];
  if (tid < H2) {
    out[L.b1 + tid] = acc_b1;
    out[L.b2 + tid] = acc_b2;
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) out[L.w1 + d * H2 + tid] = acc_w1[d];
  }
  for (int q = tid; q < H2 * A1; q += kThreads) out[L.wh + q] = sdWh[q];
  if (tid < A1) out[L.bh + tid] = acc_bh;
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < 4; ++m) met[m] = warp_sum(met[m]);
#pragma unroll
    for (int a = 0; a < kMaxGaussA; ++a) dls[a] = warp_sum(dls[a]);
    if (lane == 0) {
#pragma unroll
      for (int m = 0; m < 4; ++m) out[L.P + m] = met[m];
      if (gauss) {
#pragma unroll
        for (int a = 0; a < kMaxGaussA; ++a)
          if (a < A) out[L.ls + a] = dls[a];
      } else {
        for (int a = 0; a < A; ++a) out[L.ls + a] = 0.0f;  // no log_std parameter
      }
    }
  }
}

// Stage 2: out[i] = sum over the G workspace rows, in row order.
__global__ void __launch_bounds__(256) reduce_rows(const float* __restrict__ ws, int G, int PW,
                                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PW) return;
  float z = 0.0f;
  for (int g = 0; g < G; ++g) z += ws[(long long)g * PW + i];
  out[i] = z;
}

// Stage 3: masked global-norm clip + Adam over the merged buffer, one CTA.
constexpr int kAdamThreads = 1024;

__global__ void __launch_bounds__(kAdamThreads) clip_adam(
    const GradParams p, const AdamParams q, const float* __restrict__ grad,
    const float* __restrict__ w, const float* __restrict__ m, const float* __restrict__ v,
    float* __restrict__ w_out, float* __restrict__ m_out, float* __restrict__ v_out) {
  __shared__ float red[kAdamThreads];
  const int tid = threadIdx.x;
  const int H2 = 2 * p.hidden, H = p.hidden, A = p.act_dim, A1 = A + 1;
  const bool gauss = p.head == GAUSSIAN;
  const Layout L = make_layout(p.obs_dim, H2, A);
  // the gradient of entry i: cross-tower blocks masked, the Gaussian
  // entropy term joined to log_std's; the categorical log_std is no parameter
  auto masked = [&](int i) -> float {
    float g = grad[i];
    if (i >= L.w2 && i < L.b2) {
      const int r = (i - L.w2) / H2, c = (i - L.w2) % H2;
      if (!((r < H && c < H) || (r >= H && c >= H))) g = 0.0f;
    } else if (i >= L.wh && i < L.bh) {
      const int r = (i - L.wh) / A1, c = (i - L.wh) % A1;
      if (!((r < H && c < A) || (r >= H && c == A))) g = 0.0f;
    } else if (i >= L.ls) {
      g = gauss ? g - p.ent_coef : 0.0f;
    }
    return g;
  };
  float ss = 0.0f;
  for (int i = tid; i < L.P; i += kAdamThreads) {
    const float g = masked(i);
    ss = fmaf(g, g, ss);
  }
  red[tid] = ss;
  __syncthreads();
  for (int s = kAdamThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float norm = sqrtf(red[0]);
  const float scale = norm < q.max_grad_norm ? 1.0f : q.max_grad_norm / norm;
  for (int i = tid; i < L.P; i += kAdamThreads) {
    if (!gauss && i >= L.ls) {
      w_out[i] = w[i];
      m_out[i] = m[i];
      v_out[i] = v[i];
      continue;
    }
    const float g = masked(i) * scale;
    const float mn = q.beta1 * m[i] + q.one_minus_b1 * g;
    const float vn = q.beta2 * v[i] + q.one_minus_b2 * (g * g);
    const float mhat = mn / q.bc1, vhat = vn / q.bc2;
    w_out[i] = w[i] - q.lr * mhat / (sqrtf(vhat) + q.adam_eps);
    m_out[i] = mn;
    v_out[i] = vn;
  }
}

static int check_params(const GradParams* p) {
  const int na = p->head == GAUSSIAN ? p->act_dim : 1;
  if ((p->hidden != 32 && p->hidden != 64) || p->obs_dim < 1 || p->obs_dim > kMaxD ||
      p->act_dim < 1 || p->act_dim > kMaxA || (p->head == GAUSSIAN && p->act_dim > kMaxGaussA) ||
      (p->head != GAUSSIAN && p->head != CATEGORICAL) ||
      (p->compute != FLOAT32 && p->compute != BFLOAT16) || p->obs_dim + na + 4 > kRows ||
      p->tile < kChunk || p->tile % kChunk || p->num_tiles < 1 || p->n_cols < p->tile ||
      p->n_cols % p->tile)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int H2, bool BF>
static int launch_tiles(const GradParams* p, const float* data, const int* order,
                        const float* w, const float* adv, float* ws, cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(ppo_grad_tiles<H2, BF>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)Smem<H2>::BYTES);
  if (e != cudaSuccess) return (int)e;
  ppo_grad_tiles<H2, BF><<<p->num_tiles, kThreads, Smem<H2>::BYTES, st>>>(*p, data, order, w,
                                                                          adv, ws);
  return (int)cudaGetLastError();
}

// Stages 1 and 2: gout[P + 4] = (merged gradients, metric sums).
static int grad_stages(const GradParams* p, const float* data, const int* order, const float* w,
                       const float* adv, float* ws, float* gout, cudaStream_t st) {
  int err = check_params(p);
  if (err) return err;
  const bool bf = p->compute == BFLOAT16;
  if (p->hidden == 64)
    err = bf ? launch_tiles<128, true>(p, data, order, w, adv, ws, st)
             : launch_tiles<128, false>(p, data, order, w, adv, ws, st);
  else
    err = bf ? launch_tiles<64, true>(p, data, order, w, adv, ws, st)
             : launch_tiles<64, false>(p, data, order, w, adv, ws, st);
  if (err) return err;
  const int PW = make_layout(p->obs_dim, 2 * p->hidden, p->act_dim).P + 4;
  reduce_rows<<<(PW + 255) / 256, 256, 0, st>>>(ws, p->num_tiles, PW, gout);
  return (int)cudaGetLastError();
}

extern "C" int ppo_grad_launch(const GradParams* p, const float* data, const int* order,
                               const float* w, const float* adv, float* ws, float* gout,
                               void* stream) {
  return grad_stages(p, data, order, w, adv, ws, gout, (cudaStream_t)stream);
}

extern "C" int ppo_grad_adam_launch(const GradParams* p, const AdamParams* q, const float* data,
                                    const int* order, const float* w, const float* m,
                                    const float* v, const float* adv, float* ws, float* gout,
                                    float* w_out, float* m_out, float* v_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = grad_stages(p, data, order, w, adv, ws, gout, st);
  if (err) return err;
  clip_adam<<<1, kAdamThreads, 0, st>>>(*p, *q, gout, w, m, v, w_out, m_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int ppo_grad_params_size(void) { return (int)sizeof(GradParams); }

extern "C" int ppo_adam_params_size(void) { return (int)sizeof(AdamParams); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
