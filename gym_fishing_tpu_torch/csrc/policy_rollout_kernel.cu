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
// What bounds it on this card: operations and the latency of T dependent
// steps, not bytes (36 bytes per env and step against 2 x 2H x H = 16,384
// FLOP in the product through W2c at hidden 64 and 4H = 256 tanh). W2c and
// Whc are block diagonal (policy tower, value tower): the TPU kernel
// multiplies the merged [2H, 2H] matrix because that is its matrix unit's
// shape, here each product runs per tower over H, half the work. The kernel
// traps on a non-zero cross-tower entry, which merge_weights never builds.
//
// What the design does about it. A warp owns 8 envs for the whole rollout:
// their state stays in the registers of lanes 0-7, which run sampling, decode
// and dynamics and store each packed row as one 32-byte run. A CTA is 8 warps
// (64 envs) and keeps the weights in shared memory; nothing is shared between
// warps, so a step has no block barrier, only __syncwarp. Two CTAs fit an SM
// (at most 128 registers a thread), so B = 16384 is 256 CTAs in one wave on
// 132 SMs, 16 warps an SM: a step of one warp is a chain of ~64 tanhf a lane,
// its product and ~250 dependent instructions of the tail, and each scheduler
// has four such warps to interleave. (With 4 envs a warp the tail ran twice
// as often for the same envs on half as many lanes, and B = 16384 took 1.94
// waves of 264 resident CTAs.) That plan holds hidden 32 and 64 with at most
// 16 logits; hidden 128 and 256, and categorical heads of up to 128 classes
// at any hidden size, take policy_rollout_wide (below), whose 16 warps step
// their 64 envs together and stream the weights from L2 every step.
// - compute = float32: float32 FMA. Lanes 0-15 take the policy tower, lanes
//   16-31 the value tower, each lane 8 envs x H/16 columns: per 4 rows of a
//   tower's block a lane makes 8 broadcast LDS.128 of h1 and 4 LDS.128 of
//   the block for 128 FMA (a 4 x 4 tile over the merged matrix needed 8 for
//   64, half of them against zeros). h2 stays in registers; the head is a
//   per-lane partial sum and one transposing butterfly over the tower's 16
//   lanes per output (8 shuffles for 8 envs).
// - compute = bfloat16: the two H-contractions per tower run on the tensor
//   cores, mma.sync m16n8k16 with bf16 inputs and float32 sums. The 8 envs
//   are rows 0-7 of the M = 16 tile (rows 8-15 are zero: the tensor cores
//   are not what bounds the step, the tanh are), the hidden units lie on N
//   and K. A layer's accumulator fragment, after bias, tanh and rounding, is
//   the next product's A fragment in the same registers of the same lane, so
//   no activation goes through shared memory; the B fragments are 32-bit
//   loads from W2c^T and Whc^T kept in shared memory as bf16 with a row
//   stride of H + 8, which no two lanes of a load share a bank under.
// The GAE pass reads rows 3, 6, 7 eight steps at a time before it needs them.
//
// RNG: one Philox4x32-10 block per env and step, key = 64-bit seed, counter =
// (env, offset + t) (fishing_dynamics.cuh). Gaussian head: (u0, u1) give the
// Box-Muller pair (action z, process z); with obs noise (u2, u3) give eta.
// Categorical head: u0 is the uniform of the inverse CDF, (u1, u2) give the
// pair (eta, process z). Optional pre-generated planes [za or u, zp, nf]
// (nf = exp(sigma_m eta)) replace Philox for parity tests.
//
// Numerics: float32 IEEE arithmetic (FMA contraction allowed, no
// --use_fast_math, IEEE tanhf in both modes). Under compute = bfloat16 the
// inputs of the two H-contractions (W2c and h1, Whc and h2) are rounded with
// round-to-nearest-even and summed in float32 by the tensor cores, as the TPU
// kernel's bf16 inputs with f32 accumulation; the input layer, the tanh,
// sampling and dynamics stay float32. compute = float32 uses no tensor core:
// TF32 keeps three digits, and its split form was measured on this card for
// the update kernels as slower and biased (see ppo_update_kernel.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fishing_dynamics.cuh"
#include "merged_mlp.cuh"
#include "wide_mlp.cuh"

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
#define FULL_MASK 0xffffffffu

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEnvsPerWarp = 8;
constexpr int kEnvs = kWarps * kEnvsPerWarp;  // envs per CTA
constexpr int kMaxA = 16;   // logits width of policy_rollout_kernel (the wide path: kWideMaxA)
constexpr int kMaxA1 = kMaxA + 1;
constexpr int kStats = 4;   // n_done, sum ep_ret at done, sum ep_len at done, sum reward
constexpr int kGaeRun = 8;  // steps of the GAE pass whose rows are read together
// bf16: rows of Whc^T as the head's B operand: 16 policy outputs, then the
// value row and 7 rows of zeros (two n-tiles and one)
constexpr int kHeadRows = kMaxA + 8;
static_assert(kMaxA == 16, "the bf16 head takes at most two n-tiles of policy outputs");

constexpr int align4(int x) { return (x + 3) / 4 * 4; }

// Shared-memory plan (offsets in floats; every region 16-byte aligned).
template <int H, bool BF>
struct RollSmem {
  static constexpr int H2 = 2 * H;
  static constexpr int LDT = H + 4;      // float32: a tower's stride inside an h1 row
  static constexpr int LDH = 2 * LDT;    // float32: row stride of h1
  static constexpr int LDB = H + 8;      // bf16: row stride of W2c^T and Whc^T, in bf16
  // float32: the towers' blocks of W2c [2][H][H]; bf16: their transposes as
  // bf16 [2][H][LDB], then Whc^T as bf16 [kHeadRows][LDB]
  static constexpr int W2 = 0;
  static constexpr int W2_FLOATS = BF ? (2 * H + kHeadRows) * LDB / 2 : 2 * H * H;
  static constexpr int H1 = W2 + W2_FLOATS;                   // float32 only: [kEnvs][LDH]
  static constexpr int WHT = H1 + (BF ? 0 : kEnvs * LDH);     // float32 only: [kMaxA1][H2]
  static constexpr int W1 = WHT + (BF ? 0 : kMaxA1 * H2);     // [H2] (folded when fold_obs)
  static constexpr int B1 = W1 + H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int BH = B2 + H2;                          // [kMaxA1]
  static constexpr int OUT = BH + align4(kMaxA1);             // [kEnvs][kMaxA1]
  static constexpr int STAT = OUT + align4(kEnvs * kMaxA1);   // [kEnvs][kStats]
  static constexpr int TOTAL = STAT + kEnvs * kStats;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
  static_assert((2 * H + kHeadRows) * LDB % 2 == 0 && W2_FLOATS % 4 == 0, "alignment");
};
// two CTAs per SM: 2 x (BYTES + 1 KiB reserved) within the SM's 228 KiB
static_assert(2 * (RollSmem<64, false>::BYTES + 1024) <= 233472 &&
                  2 * (RollSmem<64, true>::BYTES + 1024) <= 233472,
              "two CTAs must fit an SM");

template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&v)[N]) {
  static_assert(N == 2 || N == 4, "row width");
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Sums each v[e] over the 16 lanes of this lane's half-warp, halving the envs
// a lane keeps at every exchange; returns the sum of env (lane >> 1) & 7. The
// order of the additions is fixed.
__device__ __forceinline__ float tower_sums(const float (&v)[kEnvsPerWarp], int lane) {
  const bool b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float w[4], x[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b3 ? v[i + 4] : v[i], send = b3 ? v[i] : v[i + 4];
    w[i] = keep + __shfl_xor_sync(FULL_MASK, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? w[i + 2] : w[i], send = b2 ? w[i] : w[i + 2];
    x[i] = keep + __shfl_xor_sync(FULL_MASK, send, 4);
  }
  const float keep = b1 ? x[1] : x[0], send = b1 ? x[0] : x[1];
  const float y = keep + __shfl_xor_sync(FULL_MASK, send, 2);
  return y + __shfl_xor_sync(FULL_MASK, y, 1);
}

// One warp's float32 forward for its 8 envs (inputs in lanes 0-7 of `inp`):
// fills out[e][a] for a in [0, A] of the warp's rows. sm is the CTA's shared
// memory, h1 and out this warp's rows of it.
template <int H>
__device__ __forceinline__ void warp_forward_f32(const float* sm, float* h1, float* out, int lane,
                                                 float inp, int A) {
  using L_ = RollSmem<H, false>;
  constexpr int H2 = 2 * H, CPL = H / 16, LDT = L_::LDT, LDH = L_::LDH;
  const int tower = lane >> 4, c0 = (lane & 15) * CPL;
  const int col = tower * H + c0;  // this lane's first column of the merged layers
  {
    // rank-1 input layer, written as the twin computes it: w * m + b, then tanh
    float w1[CPL], b1[CPL];
    load_row<CPL>(sm + L_::W1 + col, w1);
    load_row<CPL>(sm + L_::B1 + col, b1);
#pragma unroll
    for (int e = 0; e < kEnvsPerWarp; ++e) {
      const float m = __shfl_sync(FULL_MASK, inp, e);
      float v[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) v[c] = tanhf(__fadd_rn(__fmul_rn(w1[c], m), b1[c]));
      store_row<CPL>(h1 + e * LDH + tower * LDT + c0, v);
    }
  }
  __syncwarp();
  float acc[kEnvsPerWarp][CPL];
#pragma unroll
  for (int e = 0; e < kEnvsPerWarp; ++e)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[e][c] = 0.0f;
  {
    const float* a0 = h1 + tower * LDT;
    const float* b0 = sm + L_::W2 + tower * H * H + c0;
#pragma unroll 2
    for (int j = 0; j < H; j += 4) {
      float a[kEnvsPerWarp][4];
#pragma unroll
      for (int e = 0; e < kEnvsPerWarp; ++e) load_row<4>(a0 + e * LDH + j, a[e]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[CPL];
        load_row<CPL>(b0 + (j + q) * H, b);
#pragma unroll
        for (int e = 0; e < kEnvsPerWarp; ++e)
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[e][c] = fmaf(a[e][q], b[c], acc[e][c]);
      }
    }
  }
  {
    float b2[CPL];
    load_row<CPL>(sm + L_::B2 + col, b2);
#pragma unroll
    for (int e = 0; e < kEnvsPerWarp; ++e)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[e][c] = tanhf(acc[e][c] + b2[c]);
  }
  // heads: the policy half sums output o of its tower, the value half the
  // value (again for every o > 0, stored once)
  for (int o = 0; o < A; ++o) {
    const int a = tower == 0 ? o : A;
    float wh[CPL], v[kEnvsPerWarp];
    load_row<CPL>(sm + L_::WHT + a * H2 + col, wh);
#pragma unroll
    for (int e = 0; e < kEnvsPerWarp; ++e) {
      v[e] = acc[e][0] * wh[0];
#pragma unroll
      for (int c = 1; c < CPL; ++c) v[e] = fmaf(acc[e][c], wh[c], v[e]);
    }
    const float z = tower_sums(v, lane);
    if ((lane & 1) == 0 && (tower == 0 || o == 0))
      out[((lane >> 1) & 7) * kMaxA1 + a] = z + sm[L_::BH + a];
  }
  __syncwarp();
}

// An env's carried state in the lane that owns it, and the lane's sums of
// the episode statistics.
struct EnvCarry {
  float x, h, cur_ret, inp;
  int tt, cur_len;
  float nd, sr, sl, srw;
};

// The step's draws: za (the action's normal under the Gaussian head, the
// inverse CDF's uniform under the categorical one), zp (process noise) and
// nf (the observation's noise factor), from the planes or from Philox.
__device__ __forceinline__ void step_draws(const PolicyRolloutParams& p, bool gauss,
                                           bool obs_noise, long long env, int t, long long col,
                                           long long TB, const float* __restrict__ noise,
                                           float& za, float& zp, float& nf) {
  nf = 1.0f;
  if (p.has_noise) {
    za = noise[col];
    zp = noise[TB + col];
    if (obs_noise) nf = noise[2 * TB + col];
    return;
  }
  const uint4 bits = philox_bits(p.seed, (unsigned long long)env, p.offset + (unsigned long long)t);
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

// The quota of class k under the proportional or relative decode.
__device__ __forceinline__ float categorical_quota(const PolicyRolloutParams& p, int k, float h,
                                                   float K) {
  if (p.scheme == PROPORTIONAL) return (float)k / (float)p.n_actions * K;
  // RELATIVE_MULTIPLIERS[a]: a pure lookup of the carried harvest
  const float mult = k == 0 ? 1.0f : (k == 1 ? 1.2f : (k == 2 ? 0.8f : 0.0f));
  return h * mult;
}

// The rest of the step once the action is drawn: harvest, growth, noise,
// reward, collapse and horizon, rows 0-3 and 6-7 of the packed matrix, the
// statistics, auto-reset and the next input.
__device__ __forceinline__ void env_step(const PolicyRolloutParams& p, int model, EnvCarry& c,
                                         float act, float logp, float quota, float value,
                                         float zp, float nf, long long col, long long TB,
                                         float* __restrict__ packed, bool fold, bool obs_noise,
                                         float K, float inv_K, float two_K) {
  const float hv = fminf(c.x, quota);
  const float x1 = c.x - hv;
  const float r_eff = p.r + p.r_drift * (float)c.tt;
  const float mu = growth(p, model, x1, r_eff);
  const float x2 = p.noise_form == ADDITIVE ? mu + p.sigma * x1 * zp : mu * expf(p.sigma * zp);
  float xn = x2 < 0.0f ? 0.0f : x2;  // keeps a NaN visible
  const bool collapsed = xn <= 0.0f;
  float rew = p.price * hv - p.cost * quota * quota;
  rew = rew - (collapsed ? p.collapse_penalty : 0.0f);
  int tn = c.tt + 1;
  const bool done = tn >= p.Tmax || collapsed;
  const float done_f = done ? 1.0f : 0.0f;
  const float ep_ret_now = c.cur_ret + rew;
  const int ep_len_now = c.cur_len + 1;

  packed[col] = fold ? c.inp * inv_K - 1.0f : c.inp;
  packed[TB + col] = act;
  packed[2 * TB + col] = logp;
  packed[3 * TB + col] = value;
  packed[6 * TB + col] = rew;
  packed[7 * TB + col] = done_f;

  c.nd += done_f;
  c.sr += ep_ret_now * done_f;
  c.sl += (float)ep_len_now * done_f;
  c.srw += rew;

  // auto-reset; the carried harvest is the pre-min quota under the relative
  // scheme and the realised harvest otherwise
  xn = done ? p.init_state : xn;
  tn = done ? 0 : tn;
  const float new_h = p.scheme == RELATIVE ? quota : hv;
  c.h = done ? p.init_harvest : new_h;
  c.cur_ret = done ? 0.0f : ep_ret_now;
  c.cur_len = done ? 0 : ep_len_now;
  c.x = xn;
  c.tt = tn;
  // the next input: measured with noise for live envs, noise-free after a reset
  const float meas = obs_noise && !done ? xn * nf : xn;
  c.inp = fold ? fminf(fmaxf(meas, 0.0f), two_K) : fminf(fmaxf(meas / K - 1.0f, -1.0f), 1.0f);
}

// The reverse GAE pass of one env, bootstrapped from next_value (the value
// of the final, post-reset input): rows 4-5, and rows 6-7 back to zero.
__device__ __forceinline__ void gae_pass(const PolicyRolloutParams& p, long long env,
                                         long long B, int T, long long TB, float next_value,
                                         float* __restrict__ packed) {
  float gae = 0.0f;
  for (int t_hi = T - 1; t_hi >= 0; t_hi -= kGaeRun) {
    float rew[kGaeRun], nonterm[kGaeRun], value[kGaeRun];
#pragma unroll
    for (int j = 0; j < kGaeRun; ++j) {
      if (t_hi - j >= 0) {
        const long long col = (long long)(t_hi - j) * B + env;
        rew[j] = packed[6 * TB + col];
        nonterm[j] = 1.0f - packed[7 * TB + col];
        value[j] = packed[3 * TB + col];
      }
    }
#pragma unroll
    for (int j = 0; j < kGaeRun; ++j) {
      if (t_hi - j >= 0) {
        const long long col = (long long)(t_hi - j) * B + env;
        const float delta = rew[j] + p.gamma * next_value * nonterm[j] - value[j];
        gae = delta + p.gamma_lambda * nonterm[j] * gae;
        packed[4 * TB + col] = gae;
        packed[5 * TB + col] = gae + value[j];
        packed[6 * TB + col] = 0.0f;
        packed[7 * TB + col] = 0.0f;
        next_value = value[j];
      }
    }
  }
}

// Two bf16 values rounded to nearest even from floats, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B on the tensor cores: A [16, 16] bf16 whose rows 8-15 are zero (a_lo:
// row lane / 4, columns 2 (lane % 4) + {0, 1}; a_hi: the same row, columns + 8),
// B [16, 8] bf16 (b_lo: rows 2 (lane % 4) + {0, 1} of column lane / 4; b_hi:
// rows + 8), d [16, 8] float32 (d[0], d[1]: row lane / 4, columns
// 2 (lane % 4) + {0, 1}; d[2], d[3]: row lane / 4 + 8).
__device__ __forceinline__ void mma_rows8(float (&d)[4], uint32_t a_lo, uint32_t a_hi,
                                          uint32_t b_lo, uint32_t b_hi) {
  const uint32_t zero = 0u;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a_lo), "r"(zero), "r"(a_hi), "r"(zero), "r"(b_lo), "r"(b_hi));
}

// d += A B over the KT k-tiles of one n-tile: a[kt] the A fragments, `row` this
// lane's first element of the B operand's row (stored transposed: row n, k
// contiguous).
template <int KT>
__device__ __forceinline__ void mma_ntile(float (&d)[4], const uint32_t (&a)[KT][2],
                                          const __nv_bfloat16* row) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const uint32_t b_lo = *reinterpret_cast<const uint32_t*>(row + 16 * kt);
    const uint32_t b_hi = *reinterpret_cast<const uint32_t*>(row + 16 * kt + 8);
    mma_rows8(d, a[kt][0], a[kt][1], b_lo, b_hi);
  }
}

// One warp's bf16 forward for its 8 envs (inputs in lanes 0-7 of `inp`): fills
// out[e][a] for a in [0, A] of the warp's rows. Lane l holds env l / 4 and, of
// every 8 hidden units, the two at 2 (l % 4).
template <int H>
__device__ __forceinline__ void warp_forward_bf16(const float* sm, float* out, int lane,
                                                  float inp, int A) {
  using L_ = RollSmem<H, true>;
  constexpr int KT = H / 16, NT = H / 8, LDB = L_::LDB;
  const int g = lane >> 2, q2 = 2 * (lane & 3);
  const __nv_bfloat16* w2t = reinterpret_cast<const __nv_bfloat16*>(sm + L_::W2);
  const __nv_bfloat16* wht = w2t + 2 * H * LDB;
  const float m = __shfl_sync(FULL_MASK, inp, g);
  // head sums: policy outputs 0-7, policy outputs 8-15, value
  float hd[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) hd[i][c] = 0.0f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    // rank-1 input layer, as the twin computes it, straight into A fragments
    uint32_t a[KT][2];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = t * H + 16 * kt + 8 * half + q2;
        const float2 w1 = *reinterpret_cast<const float2*>(sm + L_::W1 + j);
        const float2 b1 = *reinterpret_cast<const float2*>(sm + L_::B1 + j);
        a[kt][half] = pack_bf16(tanhf(__fadd_rn(__fmul_rn(w1.x, m), b1.x)),
                                tanhf(__fadd_rn(__fmul_rn(w1.y, m), b1.y)));
      }
    // h2 of n-tiles 2 kt and 2 kt + 1 is the head's A fragment of k-tile kt
    uint32_t h2[KT][2];
    const __nv_bfloat16* wt = w2t + (t * H + g) * LDB + q2;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_ntile<KT>(d, a, wt + 8 * nt * LDB);
      const float2 b2 = *reinterpret_cast<const float2*>(sm + L_::B2 + t * H + 8 * nt + q2);
      h2[nt >> 1][nt & 1] = pack_bf16(tanhf(d[0] + b2.x), tanhf(d[1] + b2.y));
    }
    if (t == 0) {
      mma_ntile<KT>(hd[0], h2, wht + g * LDB + q2);
      if (A > 8) mma_ntile<KT>(hd[1], h2, wht + (8 + g) * LDB + q2);
    } else {
      mma_ntile<KT>(hd[2], h2, wht + (kMaxA + g) * LDB + q2);
    }
  }
  float* mine = out + g * kMaxA1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int a_out = 8 * i + q2 + c;
      if (a_out < A) mine[a_out] = hd[i][c] + sm[L_::BH + a_out];
    }
  if (q2 == 0) mine[A] = hd[2][0] + sm[L_::BH + A];
  __syncwarp();
}

template <int H, bool BF>
__global__ void __launch_bounds__(kThreads, 2) policy_rollout_kernel(
    const PolicyRolloutParams p, const float* __restrict__ w,
    const float* __restrict__ stock_in, const int* __restrict__ t_in,
    const float* __restrict__ hv_in, const float* __restrict__ ret_in,
    const int* __restrict__ len_in, const float* __restrict__ noise, float* __restrict__ packed,
    float* __restrict__ stock_out, int* __restrict__ t_out, float* __restrict__ hv_out,
    float* __restrict__ ret_out, int* __restrict__ len_out, float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  using L_ = RollSmem<H, BF>;
  constexpr int H2 = 2 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool gauss = p.scheme == CONTINUOUS;
  const int A = p.act_dim, A1 = A + 1;
  const Layout L = make_layout(1, H2, A);
  const float K = p.K, inv_K = 1.0f / K, two_K = 2.0f * K;
  const bool fold = p.fold_obs != 0, obs_noise = p.obs_noise != 0;

  // The cross-tower blocks of W2c and Whc are zero by construction
  // (merge_weights) and stay so under the fused update's masked step; the
  // products rely on it.
  if constexpr (BF) {
    __nv_bfloat16* w2t = reinterpret_cast<__nv_bfloat16*>(sm + L_::W2);
    __nv_bfloat16* wht = w2t + 2 * H * L_::LDB;
    for (int i = tid; i < kHeadRows * L_::LDB; i += kThreads) wht[i] = __float2bfloat16_rn(0.0f);
    __syncthreads();
    for (int i = tid; i < H2 * H2; i += kThreads) {
      const float v = w[L.w2 + i];
      const int r = i / H2, c = i % H2;
      if ((r < H) != (c < H)) {
        if (v != 0.0f) __trap();
      } else {
        w2t[c * L_::LDB + r % H] = __float2bfloat16_rn(v);  // [tower][column][row in tower]
      }
    }
    for (int i = tid; i < H2 * A1; i += kThreads) {
      const float v = w[L.wh + i];
      const int r = i / A1, c = i % A1;
      if ((r < H) != (c < A)) {
        if (v != 0.0f) __trap();
      } else {
        wht[(c < A ? c : kMaxA) * L_::LDB + r % H] = __float2bfloat16_rn(v);
      }
    }
  } else {
    float* w2 = sm + L_::W2;
    float* wht = sm + L_::WHT;
    for (int i = tid; i < H2 * H2; i += kThreads) {
      const float v = w[L.w2 + i];
      const int r = i / H2, c = i % H2;
      if ((r < H) != (c < H)) {
        if (v != 0.0f) __trap();
      } else {
        w2[r * H + c % H] = v;  // [tower][row in tower][column in tower]
      }
    }
    for (int i = tid; i < H2 * A1; i += kThreads) {
      const float v = w[L.wh + i];
      const int r = i / A1, c = i % A1;
      if ((r < H) != (c < A) && v != 0.0f) __trap();
      wht[c * H2 + r] = v;
    }
  }
  for (int i = tid; i < H2; i += kThreads) {
    // fold: obs = clip(m, 0, 2K)/K - 1 enters the input layer as w/K and b - w
    const float w1 = w[L.w1 + i], b1 = w[L.b1 + i];
    sm[L_::W1 + i] = fold ? w1 * inv_K : w1;
    sm[L_::B1 + i] = fold ? b1 - w1 : b1;
    sm[L_::B2 + i] = w[L.b2 + i];
  }
  for (int i = tid; i < A1; i += kThreads) sm[L_::BH + i] = w[L.bh + i];
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
  float* outw = sm + L_::OUT + s0 * kMaxA1;  // this warp's head outputs [8][kMaxA1]
  const float* out = outw + (lane & (kEnvsPerWarp - 1)) * kMaxA1;

  auto forward = [&](float m) {
    if constexpr (BF) {
      warp_forward_bf16<H>(sm, outw, lane, m, A);
    } else {
      warp_forward_f32<H>(sm, sm + L_::H1 + s0 * L_::LDH, outw, lane, m, A);
    }
  };

  EnvCarry c = {};
  if (active) {
    c.x = stock_in[env];
    c.tt = t_in[env];
    c.h = hv_in[env];
    c.cur_ret = ret_in[env];
    c.cur_len = len_in[env];
  }
  // the first input is noise-free
  c.inp = fold ? fminf(fmaxf(c.x, 0.0f), two_K) : fminf(fmaxf(c.x / K - 1.0f, -1.0f), 1.0f);

  for (int t = 0; t < T; ++t) {
    forward(c.inp);
    if (active) {
      const float value = out[A];
      const long long col = (long long)t * B + env;
      float za, zp, nf;  // za: action normal (Gaussian) or uniform (categorical)
      step_draws(p, gauss, obs_noise, env, t, col, TB, noise, za, zp, nf);
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
        quota = categorical_quota(p, k, c.h, K);
      }
      env_step(p, model, c, act, logp, quota, value, zp, nf, col, TB, packed, fold, obs_noise, K,
               inv_K, two_K);
    }
    // the next forward overwrites the head outputs this step's tail read
    __syncwarp();
  }

  // GAE, bootstrapped from the value of the final (post-reset) input
  forward(c.inp);
  if (active) {
    gae_pass(p, env, B, T, TB, out[A], packed);
    stock_out[env] = c.x;
    t_out[env] = c.tt;
    hv_out[env] = c.h;
    ret_out[env] = c.cur_ret;
    len_out[env] = c.cur_len;
  }

  // episode statistics: this CTA's sums in env order -> ws row blockIdx.x
  if (lane < kEnvsPerWarp) {
    float* st = sm + L_::STAT + (s0 + lane) * kStats;
    st[0] = c.nd;
    st[1] = c.sr;
    st[2] = c.sl;
    st[3] = c.srw;
  }
  __syncthreads();
  if (tid < kStats) {
    float z = 0.0f;
    for (int s = 0; s < kEnvs; ++s) z += sm[L_::STAT + s * kStats + tid];
    ws[(long long)blockIdx.x * kStats + tid] = z;
  }
}

// ------------------------------------------------------------------ wide
// Hidden 128 and 256, and categorical heads of 17 to 128 classes at any
// hidden size (the kernel above keeps hidden 32 and 64 with at most 16
// logits). At hidden 256 a tower's W2 block is 256 KiB in float32, so the
// weights cannot stay in shared memory: a CTA of 16 warps steps 64 envs
// together, keeps only their activations ([64][2H], 132 KiB at hidden 256)
// and the head outputs in shared memory, and streams W2's blocks and the
// policy head from L2 through block_product's slabs (wide_mlp.cuh) every
// step: 640 KiB per CTA and step at hidden 256, which 64 envs share. The
// products are float32 FMA in both modes, with bf16-rounded inputs under
// bfloat16 (the weights rounded once by wide_prep). Sampling, decode and
// dynamics: warp w owns envs 4w..4w+3, lane i < 4 carries env 4w + i; the
// categorical sampler takes one env at a time on the whole warp, classes
// 4l..4l+3 on lane l: the max and the sum by warp reductions, each
// exp(out_k - mx) once, the CDF by a scan of the lanes' running sums.
constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideEnvsPerWarp = kEnvs / kWideWarps;  // 4
static_assert(kWideEnvsPerWarp * kWideWarps == kEnvs && 4 * 32 == kWideMaxA, "wide plan");

template <int H>
struct WideRollSmem {
  static constexpr int H2 = 2 * H;
  static constexpr int LDA = kActLD<H2>;
  static constexpr int ACT = 0;                         // [kEnvs][LDA]: h1, then h2
  static constexpr int SLAB = ACT + kEnvs * LDA;        // [2][kSlabFloats]
  static constexpr int OUT = SLAB + 2 * kSlabFloats;    // [kEnvs][kWideLDO]
  static constexpr int VAL = OUT + kEnvs * kWideLDO;    // [kEnvs]
  static constexpr int INP = VAL + kEnvs;               // [kEnvs]
  static constexpr int W1 = INP + kEnvs;                // [H2] (folded when fold_obs)
  static constexpr int B1 = W1 + H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int BH = B2 + H2;                    // [kWideMaxA + 4]
  static constexpr int STAT = BH + kWideMaxA + 4;       // [kEnvs][kStats]
  static constexpr int TOTAL = STAT + kEnvs * kStats;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};
static_assert(WideRollSmem<256>::BYTES <= 232448, "the wide rollout exceeds a CTA's shared memory");

// One env's categorical draw on the whole warp: the class a = min(#{k : cdf_k
// < u}, A - 1) and its log-probability, from the head outputs o[0, A).
__device__ __forceinline__ void warp_categorical(const float* o, int A, float u, int lane,
                                                 int& cls, float& logp) {
  float e[4], mx = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int a = 4 * lane + j;
    e[j] = a < A ? o[a] : -CUDART_INF_F;
    mx = fmaxf(mx, e[j]);
  }
  mx = warp_max(mx);
  float se = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = 4 * lane + j < A ? expf(e[j] - mx) : 0.0f;
    se += e[j];
  }
  se = warp_sum(se);
  // the lane's running sums of the softmax, then the lanes before it by a scan
  float run[4], r = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    r += e[j] / se;
    run[j] = r;
  }
  float incl = r;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(WIDE_FULL_MASK, incl, d);
    if (lane >= d) incl += y;
  }
  float before = __shfl_up_sync(WIDE_FULL_MASK, incl, 1);
  if (lane == 0) before = 0.0f;
  int below = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) below += 4 * lane + j < A && before + run[j] < u ? 1 : 0;
  below = __reduce_add_sync(WIDE_FULL_MASK, below);
  cls = below < A - 1 ? below : A - 1;
  logp = (o[cls] - mx) - logf(se);
}

template <int H, bool BF>
__global__ void __launch_bounds__(kWideThreads, 1) policy_rollout_wide(
    const PolicyRolloutParams p, const float* __restrict__ w, const float* __restrict__ prep,
    const float* __restrict__ stock_in, const int* __restrict__ t_in,
    const float* __restrict__ hv_in, const float* __restrict__ ret_in,
    const int* __restrict__ len_in, const float* __restrict__ noise, float* __restrict__ packed,
    float* __restrict__ stock_out, int* __restrict__ t_out, float* __restrict__ hv_out,
    float* __restrict__ ret_out, int* __restrict__ len_out, float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  using L_ = WideRollSmem<H>;
  constexpr int H2 = 2 * H, LDA = L_::LDA, LDO = kWideLDO;
  // thread tiles: the W2 product [kEnvs][H2], the policy head [kEnvs][AP]
  constexpr int TC = H2 >= 512 ? 8 : 4, TS = kEnvs * (H2 / TC) / kWideThreads;
  constexpr int TSF = 4, TCF = 4;
  static_assert(TS >= 1 && (kEnvs / TSF) * (kWideMaxA / TCF) <= kWideThreads, "tiling");
  float* act = sm + L_::ACT;
  float* slab = sm + L_::SLAB;
  float* outs = sm + L_::OUT;
  float* sval = sm + L_::VAL;
  float* sinp = sm + L_::INP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool gauss = p.scheme == CONTINUOUS;
  const int A = p.act_dim, AP = wide_ap(A);
  const Layout L = make_layout(1, H2, A);
  const WidePrep W = wide_prep_layout(H, AP);
  const float K = p.K, inv_K = 1.0f / K, two_K = 2.0f * K;
  const bool fold = p.fold_obs != 0, obs_noise = p.obs_noise != 0;

  for (int i = tid; i < H2; i += kWideThreads) {
    // fold: obs = clip(m, 0, 2K)/K - 1 enters the input layer as w/K and b - w
    const float w1 = w[L.w1 + i], b1 = w[L.b1 + i];
    sm[L_::W1 + i] = fold ? w1 * inv_K : w1;
    sm[L_::B1 + i] = fold ? b1 - w1 : b1;
    sm[L_::B2 + i] = w[L.b2 + i];
  }
  for (int i = tid; i <= A; i += kWideThreads) sm[L_::BH + i] = w[L.bh + i];
  const float log_std = gauss ? w[L.ls] : 0.0f;
  const float std_a = expf(log_std);

  const long long B = p.num_envs;
  const int T = p.num_steps;
  const long long TB = (long long)T * B;
  const int e0 = warp * kWideEnvsPerWarp;
  const long long env = (long long)blockIdx.x * kEnvs + e0 + lane;
  const bool active = lane < kWideEnvsPerWarp && env < B;
  const int model = p.growth == MIXTURE ? p.model_idx : p.growth;
  const int f_s0 = tid / (H2 / TC) * TS, f_c0 = tid % (H2 / TC) * TC;
  const int ncgf = AP / TCF;
  const bool h_mine = tid < (kEnvs / TSF) * ncgf;
  const int h_s0 = h_mine ? tid / ncgf * TSF : 0, h_c0 = h_mine ? tid % ncgf * TCF : 0;

  EnvCarry c = {};
  if (active) {
    c.x = stock_in[env];
    c.tt = t_in[env];
    c.h = hv_in[env];
    c.cur_ret = ret_in[env];
    c.cur_len = len_in[env];
  }
  // the first input is noise-free
  c.inp = fold ? fminf(fmaxf(c.x, 0.0f), two_K) : fminf(fmaxf(c.x / K - 1.0f, -1.0f), 1.0f);
  if (lane < kWideEnvsPerWarp) sinp[e0 + lane] = c.inp;
  __syncthreads();

  // head outputs and values of the CTA's envs from the inputs in sinp
  auto forward = [&]() {
    for (int e = tid; e < kEnvs * H2; e += kWideThreads) {
      const int s = e / H2, j = e % H2;
      act[s * LDA + j] = tanhf(__fadd_rn(__fmul_rn(sm[L_::W1 + j], sinp[s]), sm[L_::B1 + j]));
    }
    __syncthreads();
    {
      float acc[TS][TC];
      block_product<TS, TC, BF>(act, LDA, H, prep + W.fw, H, H2, slab, f_s0, f_c0, true, acc);
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int q = 0; q < TC; ++q)
          act[(f_s0 + i) * LDA + f_c0 + q] = tanhf(acc[i][q] + sm[L_::B2 + f_c0 + q]);
    }
    __syncthreads();
    float acc[TSF][TCF];
    block_product<TSF, TCF, BF>(act, LDA, AP, prep + W.mp, H, AP, slab, h_s0, h_c0, h_mine, acc);
    if (h_mine)
#pragma unroll
      for (int i = 0; i < TSF; ++i)
#pragma unroll
        for (int q = 0; q < TCF; ++q) {
          const int a = h_c0 + q;
          outs[(h_s0 + i) * LDO + a] = a < A ? acc[i][q] + sm[L_::BH + a] : 0.0f;
        }
    for (int q = 0; q < kWideEnvsPerWarp; ++q) {
      const int s = e0 + q;
      float z = 0.0f;
      for (int k = lane; k < H; k += 32) {
        float h2 = act[s * LDA + H + k];
        if constexpr (BF) h2 = bf16_round(h2);
        z = fmaf(h2, prep[W.wv + k], z);
      }
      z = warp_sum(z);
      if (lane == 0) sval[s] = z + sm[L_::BH + A];
    }
    __syncthreads();
  };

  for (int t = 0; t < T; ++t) {
    forward();
    const long long col = (long long)t * B + env;
    float za = 0.0f, zp = 0.0f, nf = 1.0f;
    if (active) step_draws(p, gauss, obs_noise, env, t, col, TB, noise, za, zp, nf);
    float act_v = 0.0f, logp = 0.0f, quota = 0.0f;
    if (gauss) {
      if (active) {
        act_v = outs[(e0 + lane) * LDO] + std_a * za;
        logp = -0.5f * (za * za) - log_std - 0.5f * LOG_2PI_F;
        quota = (fminf(fmaxf(act_v, -1.0f), 1.0f) + 1.0f) * K * p.action_scale;
      }
    } else {
      for (int q = 0; q < kWideEnvsPerWarp; ++q) {
        const float u = __shfl_sync(WIDE_FULL_MASK, za, q);
        int k;
        float lp;
        warp_categorical(outs + (e0 + q) * LDO, A, u, lane, k, lp);
        if (lane == q) {
          act_v = (float)k;
          logp = lp;
          quota = categorical_quota(p, k, c.h, K);
        }
      }
    }
    if (active)
      env_step(p, model, c, act_v, logp, quota, sval[e0 + lane], zp, nf, col, TB, packed, fold,
               obs_noise, K, inv_K, two_K);
    if (lane < kWideEnvsPerWarp) sinp[e0 + lane] = c.inp;
    // the next forward overwrites the head outputs and values this step read
    __syncthreads();
  }

  // GAE, bootstrapped from the value of the final (post-reset) input
  forward();
  if (active) {
    gae_pass(p, env, B, T, TB, sval[e0 + lane], packed);
    stock_out[env] = c.x;
    t_out[env] = c.tt;
    hv_out[env] = c.h;
    ret_out[env] = c.cur_ret;
    len_out[env] = c.cur_len;
  }

  // episode statistics: this CTA's sums in env order -> ws row blockIdx.x
  if (lane < kWideEnvsPerWarp) {
    float* st = sm + L_::STAT + (e0 + lane) * kStats;
    st[0] = c.nd;
    st[1] = c.sr;
    st[2] = c.sl;
    st[3] = c.srw;
  }
  __syncthreads();
  if (tid < kStats) {
    float z = 0.0f;
    for (int s = 0; s < kEnvs; ++s) z += sm[L_::STAT + s * kStats + tid];
    ws[(long long)blockIdx.x * kStats + tid] = z;
  }
}

// Second stage: stats[m] = sum over the G CTA rows of ws, in row order.
__global__ void __launch_bounds__(32) reduce_stats(const float* __restrict__ ws, int G,
                                                   float* __restrict__ stats) {
  const int m = threadIdx.x;
  if (m >= kStats) return;
  float z = 0.0f;
  // unrolled so that eight rows are in flight while the sum keeps its order
#pragma unroll 8
  for (int g = 0; g < G; ++g) z += ws[(long long)g * kStats + m];
  stats[m] = z;
}

static int check_params(const PolicyRolloutParams* p) {
  const bool gauss = p->scheme == CONTINUOUS;
  if ((p->hidden != 32 && p->hidden != 64 && p->hidden != 128 && p->hidden != 256) ||
      p->num_steps < 1 || p->num_envs < 1 || (p->num_envs + kEnvs - 1) / kEnvs > 0x7FFFFFFFLL ||
      (p->scheme != CONTINUOUS && p->scheme != PROPORTIONAL && p->scheme != RELATIVE) ||
      (gauss ? p->act_dim != 1 : (p->act_dim < 2 || p->act_dim > kWideMaxA)) ||
      p->growth < LOGISTIC || p->growth > MIXTURE ||
      (p->noise_form != ADDITIVE && p->noise_form != LOGNORMAL) ||
      (p->compute != FLOAT32 && p->compute != BFLOAT16))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Hidden 32 and 64 with at most kMaxA logits take policy_rollout_kernel;
// every other size policy_rollout_wide, whose weights wide_prep lays out first.
static bool wide_path(int hidden, int act_dim) { return hidden > 64 || act_dim > kMaxA; }

// The launchers' tensors.
struct RollArgs {
  const float *w, *stock_in;
  const int* t_in;
  const float *hv_in, *ret_in;
  const int* len_in;
  const float* noise;
  float *packed, *stock_out;
  int* t_out;
  float *hv_out, *ret_out;
  int* len_out;
  float *ws, *prep;
};

template <int H, bool BF>
static int launch(const PolicyRolloutParams* p, const RollArgs& a, unsigned grid,
                  cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(policy_rollout_kernel<H, BF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)RollSmem<H, BF>::BYTES);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(policy_rollout_kernel<H, BF>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  policy_rollout_kernel<H, BF><<<grid, kThreads, RollSmem<H, BF>::BYTES, st>>>(
      *p, a.w, a.stock_in, a.t_in, a.hv_in, a.ret_in, a.len_in, a.noise, a.packed, a.stock_out,
      a.t_out, a.hv_out, a.ret_out, a.len_out, a.ws);
  return (int)cudaGetLastError();
}

template <int H, bool BF>
static int launch_wide(const PolicyRolloutParams* p, const RollArgs& a, unsigned grid,
                       cudaStream_t st) {
  constexpr size_t bytes = WideRollSmem<H>::BYTES;
  cudaError_t e = launch_wide_prep(a.w, 1, H, p->act_dim, BF, BF, a.prep, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(policy_rollout_wide<H, BF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  policy_rollout_wide<H, BF><<<grid, kWideThreads, bytes, st>>>(
      *p, a.w, a.prep, a.stock_in, a.t_in, a.hv_in, a.ret_in, a.len_in, a.noise, a.packed,
      a.stock_out, a.t_out, a.hv_out, a.ret_out, a.len_out, a.ws);
  return (int)cudaGetLastError();
}

template <bool BF>
static int launch_mode(const PolicyRolloutParams* p, const RollArgs& a, unsigned grid,
                       cudaStream_t st) {
  if (!wide_path(p->hidden, p->act_dim))
    return p->hidden == 64 ? launch<64, BF>(p, a, grid, st) : launch<32, BF>(p, a, grid, st);
  if (a.prep == nullptr) return (int)cudaErrorInvalidValue;
  switch (p->hidden) {
    case 32: return launch_wide<32, BF>(p, a, grid, st);
    case 64: return launch_wide<64, BF>(p, a, grid, st);
    case 128: return launch_wide<128, BF>(p, a, grid, st);
    default: return launch_wide<256, BF>(p, a, grid, st);
  }
}

// ws: [ceil(B / policy_rollout_envs_per_cta())][4] scratch; stats: [4];
// prep: policy_rollout_prep_floats(hidden, act_dim) floats of scratch (none
// for the narrow path: it may be null there).
extern "C" int policy_rollout_launch(const PolicyRolloutParams* p, const float* w,
                                     const float* stock_in, const int* t_in, const float* hv_in,
                                     const float* ret_in, const int* len_in, const float* noise,
                                     float* packed, float* stock_out, int* t_out, float* hv_out,
                                     float* ret_out, int* len_out, float* ws, float* stats,
                                     float* prep, void* stream) {
  int err = check_params(p);
  if (err) return err;
  if (p->has_noise && noise == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((p->num_envs + kEnvs - 1) / kEnvs);
  const RollArgs a{w,         stock_in, t_in,  hv_in,  ret_in,  len_in, noise, packed,
                   stock_out, t_out,    hv_out, ret_out, len_out, ws,     prep};
  err = p->compute == BFLOAT16 ? launch_mode<true>(p, a, grid, st)
                               : launch_mode<false>(p, a, grid, st);
  if (err) return err;
  reduce_stats<<<1, 32, 0, st>>>(ws, (int)grid, stats);
  return (int)cudaGetLastError();
}

extern "C" int policy_rollout_prep_floats(int hidden, int act_dim) {
  return wide_path(hidden, act_dim) ? wide_prep_layout(hidden, wide_ap(act_dim)).total : 0;
}

extern "C" int policy_rollout_params_size(void) { return (int)sizeof(PolicyRolloutParams); }

extern "C" int policy_rollout_envs_per_cta(void) { return kEnvs; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
