// Fused PPO policy rollout (K4) for Hopper (sm_90a): T steps of the merged
// actor-critic forward, action sampling, decode and env dynamics with
// auto-reset, then the reverse GAE pass, written straight into the update
// kernels' packed sample matrix.
//
// Replaces the Pallas TPU kernel gym_fishing_tpu/kernels/policy_rollout_kernel.py::
// _policy_rollout_kernel. The Python wrapper is gym_fishing_tpu_torch/kernels/
// policy_rollout_kernel.py::policy_rollout; its plain PyTorch twin there is
// policy_rollout_reference.
//
// What it computes, per env and step t (input m: the observation, or the
// clipped raw measurement when the obs map is folded into the input layer):
//   h1 = tanh(W1c m + b1c), h2 = tanh(W2c^T h1 + b2c), out = Whc^T h2 + bhc
// (merged block-diagonal weights, kernels/ppo_update_kernel.py::merge_weights;
// rows of out: the Gaussian mean or the A logits, then the value); a Gaussian
// sample a = mean + std z, or an inverse-CDF categorical sample
// a = min(#{cdf_k < u}, A - 1); the continuous, proportional or relative
// decode; harvest, growth with r drift, additive or lognormal process noise,
// reward, collapse and horizon, auto-reset, the carried harvest, and the next
// input measured with exp(sigma_m eta) for live envs. Rows 0-3 of
// packed[8, T*B] (obs, action, logp, value) are written at column t*B + env;
// the reward and done flag go to rows 6-7 as scratch. After T steps the value
// of the final input bootstraps a reverse GAE pass per env that writes rows
// 4-5 (advantage, return) and zeroes rows 6-7. Episode statistics
// (n_done, sum of returns and lengths of the episodes that ended, sum of
// rewards) are summed per CTA, then over the CTAs in index order by a second
// launch: no float atomics, so two identical calls give identical bits.
//
// What bounds it on this card: the product through W2c, 2 x 128 x 128 =
// 32,768 FLOP per env and step at hidden 64 (6.9e10 FLOP at B = 16384,
// T = 128), issued as float32 FMAs, and the latency of T dependent steps. Per
// env and step the kernel moves 24 bytes (rows 0-3 and 6-7) and reads 12 back
// in the GAE pass, ~100 MB per call at that size, so memory is not the limit.
//
// What the design does about it: a CTA of 256 threads takes 32 envs, and each
// warp owns 4 of them for the whole rollout. W2c (64 KiB at 2H = 128) sits in
// shared memory once per CTA; a warp's activations [4][2H] are written and
// read only by that warp, so a step needs no block-wide barrier, only
// __syncwarp between its phases: the rank-1 input layer (all 32 lanes), the
// register-tiled product through W2c (merged_mlp.cuh::chunk_product, 4 envs x
// 2H/32 columns per lane), the (A+1)-wide head by warp sums, then lanes 0-3 run
// sampling, decode and dynamics for their env, holding its state in registers
// from the first step to the last. Two CTAs fit an SM (~109 KiB of shared
// memory each), so 16 warps per SM hide each other's latency.
//
// RNG: one Philox4x32-10 block per env and step, key = 64-bit seed, counter =
// (env, offset + t) (fishing_dynamics.cuh). Gaussian head: (u0, u1) give the
// Box-Muller pair (action z, process z); with obs noise (u2, u3) give eta.
// Categorical head: u0 is the uniform of the inverse CDF, (u1, u2) give the
// pair (eta, process z). Optional pre-generated planes [za or u, zp, nf]
// (nf = exp(sigma_m eta)) replace Philox for parity tests.
//
// Numerics: float32 IEEE arithmetic (FMA contraction allowed, no
// --use_fast_math). Under compute = bfloat16 the inputs of the two
// 2H-contractions (W2c and h1, Whc and h2) are rounded with
// __float2bfloat16_rn and summed in float32, as the TPU kernel's bf16 inputs
// with f32 accumulation; the input layer, the tanh, sampling and dynamics stay
// float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fishing_dynamics.cuh"
#include "merged_mlp.cuh"

struct PolicyRolloutParams {
  float r, r_drift, K, sigma, sigma_m, price, cost, action_scale, init_state, init_harvest;
  float A, B, C, theta, a, b, q, collapse_penalty, gamma, gamma_lambda;
  int Tmax, model_idx, growth, noise_form, scheme, n_actions, act_dim, hidden;
  int compute, obs_noise, fold_obs, has_noise, num_steps, pad0;
  long long num_envs;
  unsigned long long seed, offset;
};
static_assert(sizeof(PolicyRolloutParams) == 160, "PolicyRolloutParams layout must match ctypes");

// Index into the Python tuple COMPUTES.
enum { FLOAT32 = 0, BFLOAT16 = 1 };

#define LOG_2PI_F 1.8378770664093453f

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEnvsPerWarp = 4;  // chunk_product's samples per warp
constexpr int kEnvs = kWarps * kEnvsPerWarp;  // envs per CTA
constexpr int kMaxA = 16;   // logits width
constexpr int kMaxA1 = kMaxA + 1;
constexpr int kStats = 4;   // n_done, sum ep_ret at done, sum ep_len at done, sum reward

// Shared-memory plan (offsets in floats).
template <int H2>
struct RollSmem {
  static constexpr int LD = kActLD<H2>;
  static constexpr int W2 = 0;                        // [H2][H2]
  static constexpr int H1 = W2 + H2 * H2;             // [kEnvs][LD]
  static constexpr int HH = H1 + kEnvs * LD;          // [kEnvs][LD] h2
  static constexpr int W1 = HH + kEnvs * LD;          // [H2] (folded when fold_obs)
  static constexpr int B1 = W1 + H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int WHT = B2 + H2;                 // [kMaxA1][H2] Whc transposed
  static constexpr int BH = WHT + kMaxA1 * H2;        // [kMaxA1]
  static constexpr int OUT = BH + kMaxA1;             // [kEnvs][kMaxA1]
  static constexpr int STAT = OUT + kEnvs * kMaxA1;   // [kEnvs][kStats]
  static constexpr int TOTAL = STAT + kEnvs * kStats;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};
// two CTAs per SM: 2 x (BYTES + 1 KiB reserved) within the SM's 228 KiB
static_assert(2 * (RollSmem<128>::BYTES + 1024) <= 233472, "two CTAs must fit an SM");

struct SmemPtrs {
  float *w2, *h1, *hh, *w1, *b1, *b2, *wht, *bh, *out, *stat;
};

// One warp's forward for its 4 envs (inputs in lanes 0-3 of `inp`): fills
// out[s][a] for a in [a_begin, A1) of the warp's rows s0..s0+3.
template <int H2, bool BF>
__device__ __forceinline__ void warp_forward(const SmemPtrs& S, int s0, int lane, float inp,
                                             int a_begin, int A1) {
  constexpr int LD = kActLD<H2>;
  constexpr int CPT = H2 / 32;
  // rank-1 input layer, written as the twin computes it: w * m + b, then tanh
#pragma unroll
  for (int i = 0; i < kEnvsPerWarp; ++i) {
    const float m = __shfl_sync(0xffffffffu, inp, i);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = lane + 32 * c;
      S.h1[(s0 + i) * LD + j] = tanhf(__fadd_rn(__fmul_rn(S.w1[j], m), S.b1[j]));
    }
  }
  __syncwarp();
  {
    const int c0 = lane * CPT;
    float acc[4][CPT];
    chunk_product<H2, BF>(S.h1, S.w2, s0, c0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        S.hh[(s0 + i) * LD + c0 + c] = tanhf(acc[i][c] + S.b2[c0 + c]);
  }
  __syncwarp();
  // heads: one warp sum per (env, output)
  for (int a = a_begin; a < A1; ++a) {
    float z[kEnvsPerWarp];
#pragma unroll
    for (int i = 0; i < kEnvsPerWarp; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int k = lane + 32 * c;
        acc = fmaf(in_round<BF>(S.hh[(s0 + i) * LD + k]), S.wht[a * H2 + k], acc);
      }
      z[i] = warp_sum(acc);
    }
    if (lane < kEnvsPerWarp) {
      float mine = z[0];
#pragma unroll
      for (int i = 1; i < kEnvsPerWarp; ++i)
        if (lane == i) mine = z[i];
      S.out[(s0 + lane) * kMaxA1 + a] = mine + S.bh[a];
    }
  }
  __syncwarp();
}

template <int H2, bool BF>
__global__ void __launch_bounds__(kThreads, 2) policy_rollout_kernel(
    const PolicyRolloutParams p, const float* __restrict__ w,
    const float* __restrict__ stock_in, const int* __restrict__ t_in,
    const float* __restrict__ hv_in, const float* __restrict__ ret_in,
    const int* __restrict__ len_in, const float* __restrict__ noise, float* __restrict__ packed,
    float* __restrict__ stock_out, int* __restrict__ t_out, float* __restrict__ hv_out,
    float* __restrict__ ret_out, int* __restrict__ len_out, float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  using L_ = RollSmem<H2>;
  const SmemPtrs S = {sm + L_::W2, sm + L_::H1,  sm + L_::HH, sm + L_::W1,  sm + L_::B1,
                      sm + L_::B2, sm + L_::WHT, sm + L_::BH, sm + L_::OUT, sm + L_::STAT};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool gauss = p.scheme == CONTINUOUS;
  const int A = p.act_dim, A1 = A + 1;
  const Layout L = make_layout(1, H2, A);
  const float K = p.K, inv_K = 1.0f / K, two_K = 2.0f * K;
  const bool fold = p.fold_obs != 0, obs_noise = p.obs_noise != 0;

  for (int i = tid; i < H2 * H2; i += kThreads) S.w2[i] = in_round<BF>(w[L.w2 + i]);
  for (int i = tid; i < H2; i += kThreads) {
    // fold: obs = clip(m, 0, 2K)/K - 1 enters the input layer as w/K and b - w
    const float w1 = w[L.w1 + i], b1 = w[L.b1 + i];
    S.w1[i] = fold ? w1 * inv_K : w1;
    S.b1[i] = fold ? b1 - w1 : b1;
    S.b2[i] = w[L.b2 + i];
  }
  for (int i = tid; i < H2 * A1; i += kThreads)
    S.wht[(i % A1) * H2 + i / A1] = in_round<BF>(w[L.wh + i]);
  for (int i = tid; i < A1; i += kThreads) S.bh[i] = w[L.bh + i];
  const float log_std = gauss ? w[L.ls] : 0.0f;
  const float std_a = expf(log_std);
  __syncthreads();

  const long long B = p.num_envs;
  const int T = p.num_steps;
  const long long TB = (long long)T * B;
  const int s0 = warp * kEnvsPerWarp;
  const long long env = (long long)blockIdx.x * kEnvs + s0 + lane;
  const bool active = lane < kEnvsPerWarp && env < B;
  const int model = p.growth == MIXTURE ? p.model_idx : p.growth;

  float x = 0.0f, h = 0.0f, cur_ret = 0.0f;
  int tt = 0, cur_len = 0;
  if (active) {
    x = stock_in[env];
    tt = t_in[env];
    h = hv_in[env];
    cur_ret = ret_in[env];
    cur_len = len_in[env];
  }
  // the first input is noise-free
  float inp = fold ? fminf(fmaxf(x, 0.0f), two_K) : fminf(fmaxf(x / K - 1.0f, -1.0f), 1.0f);
  float nd = 0.0f, sr = 0.0f, sl = 0.0f, srw = 0.0f;

  for (int t = 0; t < T; ++t) {
    warp_forward<H2, BF>(S, s0, lane, inp, 0, A1);
    if (active) {
      const float* out = S.out + (s0 + lane) * kMaxA1;
      const float value = out[A];
      const long long col = (long long)t * B + env;
      float za, zp, nf = 1.0f;  // za: action normal (Gaussian) or uniform (categorical)
      if (p.has_noise) {
        za = noise[col];
        zp = noise[TB + col];
        if (obs_noise) nf = noise[2 * TB + col];
      } else {
        const uint4 bits = philox_bits(p.seed, (unsigned long long)env,
                                       p.offset + (unsigned long long)t);
        float s, c;
        if (gauss) {
          const float rad = sqrtf(-2.0f * logf(uniform_from_bits(bits.x)));
          sincosf(TWO_PI_F * uniform_from_bits(bits.y), &s, &c);
          za = rad * c;
          zp = rad * s;
          if (obs_noise) {
            const float rad2 = sqrtf(-2.0f * logf(uniform_from_bits(bits.z)));
            sincosf(TWO_PI_F * uniform_from_bits(bits.w), &s, &c);
            nf = expf(p.sigma_m * (rad2 * c));
          }
        } else {
          za = uniform_from_bits(bits.x);
          const float rad = sqrtf(-2.0f * logf(uniform_from_bits(bits.y)));
          sincosf(TWO_PI_F * uniform_from_bits(bits.z), &s, &c);
          zp = rad * s;
          if (obs_noise) nf = expf(p.sigma_m * (rad * c));
        }
      }

      float act, logp, quota;
      if (gauss) {
        act = out[0] + std_a * za;
        logp = -0.5f * (za * za) - log_std - 0.5f * LOG_2PI_F;
        quota = (fminf(fmaxf(act, -1.0f), 1.0f) + 1.0f) * K * p.action_scale;
      } else {
        float mx = out[0];
        for (int k = 1; k < A; ++k) mx = fmaxf(mx, out[k]);
        float se = 0.0f;
        for (int k = 0; k < A; ++k) se += expf(out[k] - mx);
        // inverse CDF: a = #{k : cdf_k < u}, the CDF a running sum of the softmax
        float cdf = 0.0f;
        int n_below = 0;
        for (int k = 0; k < A; ++k) {
          cdf += expf(out[k] - mx) / se;
          n_below += cdf < za ? 1 : 0;
        }
        const int k = n_below < A - 1 ? n_below : A - 1;
        act = (float)k;
        logp = (out[k] - mx) - logf(se);
        if (p.scheme == PROPORTIONAL) {
          quota = act / (float)p.n_actions * K;
        } else {
          // RELATIVE_MULTIPLIERS[a]: a pure lookup of the carried harvest
          const float mult = k == 0 ? 1.0f : (k == 1 ? 1.2f : (k == 2 ? 0.8f : 0.0f));
          quota = h * mult;
        }
      }

      const float hv = fminf(x, quota);
      const float x1 = x - hv;
      const float r_eff = p.r + p.r_drift * (float)tt;
      const float mu = growth(p, model, x1, r_eff);
      const float x2 = p.noise_form == ADDITIVE ? mu + p.sigma * x1 * zp
                                                : mu * expf(p.sigma * zp);
      float xn = x2 < 0.0f ? 0.0f : x2;  // keeps a NaN visible
      const bool collapsed = xn <= 0.0f;
      float rew = p.price * hv - p.cost * quota * quota;
      rew = rew - (collapsed ? p.collapse_penalty : 0.0f);
      int tn = tt + 1;
      const bool done = tn >= p.Tmax || collapsed;
      const float done_f = done ? 1.0f : 0.0f;
      const float ep_ret_now = cur_ret + rew;
      const int ep_len_now = cur_len + 1;

      packed[col] = fold ? inp * inv_K - 1.0f : inp;
      packed[TB + col] = act;
      packed[2 * TB + col] = logp;
      packed[3 * TB + col] = value;
      packed[6 * TB + col] = rew;
      packed[7 * TB + col] = done_f;

      nd += done_f;
      sr += ep_ret_now * done_f;
      sl += (float)ep_len_now * done_f;
      srw += rew;

      // auto-reset; the carried harvest is the pre-min quota under the
      // relative scheme and the realised harvest otherwise
      xn = done ? p.init_state : xn;
      tn = done ? 0 : tn;
      const float new_h = p.scheme == RELATIVE ? quota : hv;
      h = done ? p.init_harvest : new_h;
      cur_ret = done ? 0.0f : ep_ret_now;
      cur_len = done ? 0 : ep_len_now;
      x = xn;
      tt = tn;
      // the next input: measured with noise for live envs, noise-free after a reset
      const float meas = obs_noise && !done ? xn * nf : xn;
      inp = fold ? fminf(fmaxf(meas, 0.0f), two_K) : fminf(fmaxf(meas / K - 1.0f, -1.0f), 1.0f);
    }
  }

  // GAE, bootstrapped from the value of the final (post-reset) input
  warp_forward<H2, BF>(S, s0, lane, inp, A, A1);
  if (active) {
    float gae = 0.0f;
    float next_value = S.out[(s0 + lane) * kMaxA1 + A];
    for (int t = T - 1; t >= 0; --t) {
      const long long col = (long long)t * B + env;
      const float rew = packed[6 * TB + col];
      const float nonterm = 1.0f - packed[7 * TB + col];
      const float value = packed[3 * TB + col];
      const float delta = rew + p.gamma * next_value * nonterm - value;
      gae = delta + p.gamma_lambda * nonterm * gae;
      packed[4 * TB + col] = gae;
      packed[5 * TB + col] = gae + value;
      packed[6 * TB + col] = 0.0f;
      packed[7 * TB + col] = 0.0f;
      next_value = value;
    }
    stock_out[env] = x;
    t_out[env] = tt;
    hv_out[env] = h;
    ret_out[env] = cur_ret;
    len_out[env] = cur_len;
  }

  // episode statistics: this CTA's sums in env order -> ws row blockIdx.x
  if (lane < kEnvsPerWarp) {
    float* st = S.stat + (s0 + lane) * kStats;
    st[0] = nd;
    st[1] = sr;
    st[2] = sl;
    st[3] = srw;
  }
  __syncthreads();
  if (tid < kStats) {
    float z = 0.0f;
    for (int s = 0; s < kEnvs; ++s) z += S.stat[s * kStats + tid];
    ws[(long long)blockIdx.x * kStats + tid] = z;
  }
}

// Second stage: stats[m] = sum over the G CTA rows of ws, in row order.
__global__ void __launch_bounds__(32) reduce_stats(const float* __restrict__ ws, int G,
                                                   float* __restrict__ stats) {
  const int m = threadIdx.x;
  if (m >= kStats) return;
  float z = 0.0f;
  for (int g = 0; g < G; ++g) z += ws[(long long)g * kStats + m];
  stats[m] = z;
}

static int check_params(const PolicyRolloutParams* p) {
  const bool gauss = p->scheme == CONTINUOUS;
  if ((p->hidden != 32 && p->hidden != 64) || p->num_steps < 1 || p->num_envs < 1 ||
      (p->num_envs + kEnvs - 1) / kEnvs > 0x7FFFFFFFLL ||
      (p->scheme != CONTINUOUS && p->scheme != PROPORTIONAL && p->scheme != RELATIVE) ||
      (gauss ? p->act_dim != 1 : (p->act_dim < 2 || p->act_dim > kMaxA)) ||
      p->growth < LOGISTIC || p->growth > MIXTURE ||
      (p->noise_form != ADDITIVE && p->noise_form != LOGNORMAL) ||
      (p->compute != FLOAT32 && p->compute != BFLOAT16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int H2, bool BF>
static int launch(const PolicyRolloutParams* p, const float* w, const float* stock_in,
                  const int* t_in, const float* hv_in, const float* ret_in, const int* len_in,
                  const float* noise, float* packed, float* stock_out, int* t_out, float* hv_out,
                  float* ret_out, int* len_out, float* ws, unsigned grid, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(policy_rollout_kernel<H2, BF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)RollSmem<H2>::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(policy_rollout_kernel<H2, BF>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  policy_rollout_kernel<H2, BF><<<grid, kThreads, RollSmem<H2>::BYTES, st>>>(
      *p, w, stock_in, t_in, hv_in, ret_in, len_in, noise, packed, stock_out, t_out, hv_out,
      ret_out, len_out, ws);
  return (int)cudaGetLastError();
}

// ws: [ceil(B / 32)][4] scratch; stats: [4].
extern "C" int policy_rollout_launch(const PolicyRolloutParams* p, const float* w,
                                     const float* stock_in, const int* t_in, const float* hv_in,
                                     const float* ret_in, const int* len_in, const float* noise,
                                     float* packed, float* stock_out, int* t_out, float* hv_out,
                                     float* ret_out, int* len_out, float* ws, float* stats,
                                     void* stream) {
  int err = check_params(p);
  if (err) return err;
  if (p->has_noise && noise == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((p->num_envs + kEnvs - 1) / kEnvs);
  const bool bf = p->compute == BFLOAT16;
  if (p->hidden == 64)
    err = bf ? launch<128, true>(p, w, stock_in, t_in, hv_in, ret_in, len_in, noise, packed,
                                 stock_out, t_out, hv_out, ret_out, len_out, ws, grid, st)
             : launch<128, false>(p, w, stock_in, t_in, hv_in, ret_in, len_in, noise, packed,
                                  stock_out, t_out, hv_out, ret_out, len_out, ws, grid, st);
  else
    err = bf ? launch<64, true>(p, w, stock_in, t_in, hv_in, ret_in, len_in, noise, packed,
                                stock_out, t_out, hv_out, ret_out, len_out, ws, grid, st)
             : launch<64, false>(p, w, stock_in, t_in, hv_in, ret_in, len_in, noise, packed,
                                 stock_out, t_out, hv_out, ret_out, len_out, ws, grid, st);
  if (err) return err;
  reduce_stats<<<1, 32, 0, st>>>(ws, (int)grid, stats);
  return (int)cudaGetLastError();
}

extern "C" int policy_rollout_params_size(void) { return (int)sizeof(PolicyRolloutParams); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
