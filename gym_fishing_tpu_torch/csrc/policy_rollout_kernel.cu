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
// their envs together (128 on the tensor cores under bfloat16, 64 under
// float32) and read the weights from L2 every step.
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
#include "mma_tiles.cuh"
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
// weights cannot stay in shared memory: a CTA of 16 warps steps its envs
// together, keeps only their activations and head outputs in shared memory,
// and reads the weights from L2 every step (wide_prep lays them out once per
// launch, wide_mlp.cuh). Two plans, by what the products run on:
// - compute = bfloat16 at hidden 64 and above (kWideMma): the W2c product
//   and the policy head on the tensor cores, mma.sync m16n8k16 with bf16
//   inputs and float32 sums. 128 envs a CTA, so B = 16384 is one wave of
//   128 CTAs. h1 and h2 are kept as bf16 ([128][2H + 8], 130 KiB at hidden
//   256): every consumer of them rounds them to bf16 under this mode (the
//   products, the value head), so the values do not change. The W2c product
//   is tower_mma (mma_tiles.cuh): a warp takes 2H / 16 columns of one tower
//   over the rows of 64 envs at a time (at hidden 256 two passes, which
//   keeps 64 accumulators a thread), its B fragments 8-byte loads from
//   wide_prep's FWB copy; after a pass's product a block barrier, then each
//   thread writes h2 = tanh(. + b2) over the h1 rows the pass read. The
//   policy head: a warp takes one m16 tile of envs and every other n8 tile
//   of the padded classes, B from wide_prep's MPB copy. The value head is a
//   warp dot of h2 with Wv.
// - otherwise (compute = float32, and bfloat16 at hidden 32): 64 envs a CTA
//   ([64][2H] float32 activations, 132 KiB at hidden 256); the W2 product
//   and the categorical head are float32 FMA through block_product's slabs,
//   with bf16-rounded inputs under bfloat16 (the weights rounded once by
//   wide_prep); the Gaussian head's mean is a warp dot like the value. The
//   slabs share their space with the head outputs, dead while the products
//   run. At hidden 256 (WideRollSmem::KM) the W2 product is FMA-bound only
//   if its shared loads are few: h1 is written k-major, so a thread's 8 envs
//   x 8 columns take one k as two broadcast LDS.128 of h1 (one warp, one
//   s0) and two LDS.128 of the slab, its columns two runs of 4 so that a
//   quarter-warp's pieces are consecutive: 10 wavefronts a warp for 64 FMA,
//   where 8 scalar loads of h1 and 8 contiguous columns a lane (two lanes a
//   bank) took 24. A slab there holds 16 rows of W2 (32 KiB), so a product
//   is 16 rounds of cp.async and block barrier, not 32; h2 goes back over
//   h1 row-major for the head and the value. Below hidden 256 that layout
//   measured slower, so h1 stays row-major there, read through slabs of
//   kSlabFloats (16 KiB). Each output sums its k in order in either
//   layout, so the bits are the 64-env FMA kernel's of before.
// Sampling, decode and dynamics: warp w owns the CTA's envs E/16 w.. (E/16
// = 8 or 4), lane i < E/16 carries env E/16 w + i; the categorical sampler
// draws the warp's envs four at a time on the whole warp (warp_categorical).
constexpr int kWideThreads = 512;
constexpr int kWideWarps = kWideThreads / 32;
static_assert(4 * 32 == kWideMaxA, "the sampler's lanes take 4 classes each");

// envs a CTA of the wide path takes
template <bool MMA>
inline constexpr int kWideEnvs = MMA ? 128 : kEnvs;

// The FMA plan's slab: 16 rows of the W2 operand at hidden 256
constexpr int kWideSlab = 2 * kSlabFloats;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The index, in uint2, of the B fragment word of lane (g, t) for k-step kb
// and n8 tile nt of the policy head in shared memory: k-step major, so that
// a warp's words of one k-step and tile are 256 consecutive bytes
// (wide_prep's MPB order puts a column's k-steps together, 512 bytes
// between the lanes g at hidden 256: eight lanes a bank).
__device__ __forceinline__ int head_b_index(int kb, int nt, int g, int t) {
  return ((kb * (kWideMaxA / 8) + nt) * 8 + g) * 4 + t;
}

template <int H, bool MMA>
struct WideRollSmem {
  static constexpr int H2 = 2 * H;
  static constexpr int E = kWideEnvs<MMA>;
  // row stride of the activations: bf16 elements under MMA (a half-warp's
  // 4-byte fragment reads of rows g and columns 2t fall on distinct banks),
  // floats otherwise
  static constexpr int LDA = MMA ? H2 + 8 : kActLD<H2>;
  // FMA at hidden 256: h1 k-major (row stride LDK) and deep slabs; below
  // it the FMA product keeps h1 row-major and slabs of kSlabFloats
  static constexpr bool KM = !MMA && H2 >= 512;
  static constexpr int LDK = E;
  static constexpr int SLABF = KM ? kWideSlab : kSlabFloats;
  // MMA: [E][LDA] bf16, h1 then h2; KM: h1 k-major [H2][LDK], then h2
  // [E][LDA]; otherwise [E][LDA] floats, h1 then h2
  static constexpr int ACT = 0;
  static constexpr int ACT_FLOATS = MMA ? cmax(E * LDA / 2, E * kWideLDO) : E * LDA;
  static constexpr int SLAB = ACT + ACT_FLOATS;  // FMA: [2][SLABF]
  // MMA: the policy head's bf16 B fragments, staged once (head_b_index)
  static constexpr int MPB = SLAB;
  // [E][kWideLDO]; each plan puts them where a step is done with what lay
  // there before they are written: under MMA over the activations, under
  // FMA in the slabs' space
  static constexpr int OUT = MMA ? ACT : SLAB;
  static constexpr int VAL = SLAB + (MMA ? H * kWideMaxA / 2 : cmax(E * kWideLDO, 2 * SLABF));
  static constexpr int INP = VAL + E;                     // [E]
  static constexpr int W1 = INP + E;                      // [H2] (folded when fold_obs)
  static constexpr int B1 = W1 + H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int BH = B2 + H2;                      // [kWideMaxA + 4]
  static constexpr int STAT = BH + kWideMaxA + 4;         // [E][kStats]
  static constexpr int TOTAL = STAT + E * kStats;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
  static_assert(SLAB % 4 == 0, "alignment");
};
static_assert(WideRollSmem<256, false>::BYTES <= 232448 &&
                  WideRollSmem<256, true>::BYTES <= 232448,
              "the wide rollout exceeds a CTA's shared memory");

// The categorical draws of a warp's EW envs (env q's head outputs at o + q
// ldo, its uniform u in lane q) on the whole warp, classes 4l..4l+3 on lane
// l: lane q < EW gets env q's class a = min(#{k : cdf_k < u}, A - 1) and
// its log-probability. The max and the sum by warp reductions, each
// exp(out_k - mx) once, the CDF by a scan of the lanes' running sums. Four
// envs at a time side by side, so that their reductions' shuffles overlap
// (one env at a time waited out each reduction's latency: at 100 classes
// and 8 envs a warp the tail took 10 times the Gaussian head's); each
// env's arithmetic is the same as if it were drawn alone, and the same in
// both plans.
template <int EW>
__device__ __forceinline__ void warp_categorical(const float* o, int ldo, int A, float u,
                                                 int lane, int& cls, float& logp) {
  constexpr int NE = EW < 4 ? EW : 4;
  static_assert(EW % NE == 0, "envs in groups of four");
#pragma unroll 1
  for (int q0 = 0; q0 < EW; q0 += NE) {
    float e[NE][4], mx[NE], se[NE], incl[NE];
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      mx[q] = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = 4 * lane + j;
        e[q][j] = a < A ? o[(q0 + q) * ldo + a] : -CUDART_INF_F;
        mx[q] = fmaxf(mx[q], e[q][j]);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
#pragma unroll
      for (int q = 0; q < NE; ++q)
        mx[q] = fmaxf(mx[q], __shfl_xor_sync(WIDE_FULL_MASK, mx[q], d));
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      se[q] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        e[q][j] = 4 * lane + j < A ? expf(e[q][j] - mx[q]) : 0.0f;
        se[q] += e[q][j];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
#pragma unroll
      for (int q = 0; q < NE; ++q) se[q] += __shfl_xor_sync(WIDE_FULL_MASK, se[q], d);
    // the lane's running sums of the softmax (over e), then the lanes
    // before it by a scan
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      float r = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r += e[q][j] / se[q];
        e[q][j] = r;
      }
      incl[q] = r;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const float y = __shfl_up_sync(WIDE_FULL_MASK, incl[q], d);
        if (lane >= d) incl[q] += y;
      }
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      float before = __shfl_up_sync(WIDE_FULL_MASK, incl[q], 1);
      if (lane == 0) before = 0.0f;
      const float uq = __shfl_sync(WIDE_FULL_MASK, u, q0 + q);
      int below = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) below += 4 * lane + j < A && before + e[q][j] < uq ? 1 : 0;
      below = __reduce_add_sync(WIDE_FULL_MASK, below);
      const int k = below < A - 1 ? below : A - 1;
      if (lane == q0 + q) {
        cls = k;
        logp = (o[(q0 + q) * ldo + k] - mx[q]) - logf(se[q]);
      }
    }
  }
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
  constexpr bool MMA = kWideMma<2 * H, BF>;
  using L_ = WideRollSmem<H, MMA>;
  constexpr int H2 = 2 * H, E = L_::E, EW = E / kWideWarps, LDA = L_::LDA, LDO = kWideLDO;
  // FMA thread tiles: the W2 product [E][H2], the policy head [E][AP]
  constexpr int TC = H2 >= 512 ? 8 : 4, TS = E * (H2 / TC) / kWideThreads;
  constexpr int TSF = 4, TCF = 4;
  static_assert(MMA || (TS >= 1 && (E / TSF) * (kWideMaxA / TCF) <= kWideThreads), "tiling");
  // MMA: m16 tiles of envs per pass of the W2 product (at most 64
  // accumulators a thread), and the head's n8 tiles a warp takes at most
  constexpr int MT = E / 16, NT = H2 >= 128 ? H2 / 128 : 1, MTP = MT < 16 / NT ? MT : 16 / NT;
  constexpr int KB = H / 16, HEAD_NT = kWideMaxA / 8 / (kWideWarps / MT);
  static_assert(!MMA || (MT % MTP == 0 && kWideWarps % MT == 0), "mma plan");
  float* act = sm + L_::ACT;
  __nv_bfloat16* actb = reinterpret_cast<__nv_bfloat16*>(sm + L_::ACT);
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
  const int e0 = warp * EW;
  const long long env = (long long)blockIdx.x * E + e0 + lane;
  const bool active = lane < EW && env < B;
  const int model = p.growth == MIXTURE ? p.model_idx : p.growth;
  // FMA: this thread's tile of the W2 product, TS envs from f_s0 and TC
  // columns; at TC = 8 two runs of 4, f_c0.. and f_c0 + CS.. in one tower
  // (block_product), so that a warp reads 16 consecutive bytes a lane
  constexpr int CS = TC == 8 ? H / 2 : 0;
  const int f_s0 = tid / (H2 / TC) * TS, f_cg = tid % (H2 / TC);
  const int f_c0 = CS ? f_cg / (H / TC) * H + f_cg % (H / TC) * (TC / 2) : f_cg * TC;
  const int ncgf = AP / TCF;
  const bool h_mine = tid < (E / TSF) * ncgf;
  const int h_s0 = h_mine ? tid / ncgf * TSF : 0, h_c0 = h_mine ? tid % ncgf * TCF : 0;
  // MMA head: this warp's m16 tile of envs and its first n8 tile of classes
  const int g = lane >> 2, t4 = lane & 3, hm = warp % MT, hn0 = warp / MT;

  if constexpr (MMA) {
    // the policy head's B fragments from wide_prep's MPB copy, once
    const uint2* src = reinterpret_cast<const uint2*>(prep + W.mpb);
    uint2* dst = reinterpret_cast<uint2*>(sm + L_::MPB);
    for (int i = tid; i < AP / 8 * KB * 32; i += kWideThreads) {
      const int col = i / (KB * 4);  // src index ((nt 8 + g) KB + kb) 4 + t
      dst[head_b_index(i / 4 % KB, col / 8, col % 8, i % 4)] = src[i];
    }
  }

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
  if (lane < EW) sinp[e0 + lane] = c.inp;
  __syncthreads();

  // head outputs and values of the CTA's envs from the inputs in sinp
  auto forward = [&]() {
    // the input layer, h1 = tanh(w1 m + b1), rank 1, as the twin computes it
    if constexpr (MMA) {
      for (int e = tid; e < E * H; e += kWideThreads) {
        const int s = e / H, j = 2 * (e % H);
        const float m = sinp[s];
        const float2 w1 = *reinterpret_cast<const float2*>(sm + L_::W1 + j);
        const float2 b1 = *reinterpret_cast<const float2*>(sm + L_::B1 + j);
        *reinterpret_cast<unsigned*>(actb + s * LDA + j) =
            pack_bf16x2(tanhf(__fadd_rn(__fmul_rn(w1.x, m), b1.x)),
                        tanhf(__fadd_rn(__fmul_rn(w1.y, m), b1.y)));
      }
    } else if constexpr (L_::KM) {
      for (int e = tid; e < E * H2; e += kWideThreads) {
        const int j = e / E, s = e % E;
        act[j * L_::LDK + s] =
            tanhf(__fadd_rn(__fmul_rn(sm[L_::W1 + j], sinp[s]), sm[L_::B1 + j]));
      }
    } else {
      for (int e = tid; e < E * H2; e += kWideThreads) {
        const int s = e / H2, j = e % H2;
        act[s * LDA + j] = tanhf(__fadd_rn(__fmul_rn(sm[L_::W1 + j], sinp[s]), sm[L_::B1 + j]));
      }
    }
    __syncthreads();
    // the W2 product, h2 = tanh(h1 W2 + b2) per tower, over h1 in place
    if constexpr (MMA) {
      const uint2* fwb = reinterpret_cast<const uint2*>(prep + W.fwb);
#pragma unroll 1
      for (int r0 = 0; r0 < E; r0 += 16 * MTP) {
        float acc[MTP][NT][4];
        tower_mma<H2>(actb + r0 * LDA, LDA, fwb, acc);
        __syncthreads();  // every warp has read these rows of h1
        tower_mma_out<H2>(acc, [&](int s, int col, float z) {
          actb[(r0 + s) * LDA + col] = __float2bfloat16_rn(tanhf(z + sm[L_::B2 + col]));
        });
      }
    } else {
      float acc[TS][TC];
      block_product<TS, TC, BF, false, L_::KM, L_::SLABF, CS>(
          act, L_::KM ? L_::LDK : LDA, H, prep + W.fw, H, H2, slab, f_s0, f_c0, true, acc);
      // h2 row-major over h1, four columns a store
#pragma unroll
      for (int i = 0; i < TS; ++i)
#pragma unroll
        for (int r = 0; r < TC / 4; ++r) {
          const int col = f_c0 + (CS && r >= TC / 8 ? CS - TC / 2 : 0) + 4 * r;
          float v[4];
          load_row<4>(sm + L_::B2 + col, v);
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = tanhf(acc[i][4 * r + q] + v[q]);
          store_row<4>(act + (f_s0 + i) * LDA + col, v);
        }
    }
    __syncthreads();
    // the heads: the policy outputs from h2's policy columns (zero past A),
    // the value a warp dot of its value columns with Wv, a warp E/16 envs
    float hacc[HEAD_NT][4];
    if constexpr (MMA) {
      // a warp's m16 tile of envs and every other n8 tile of classes, B from
      // the staged fragments
      const uint2* mpb = reinterpret_cast<const uint2*>(sm + L_::MPB);
      const int n_tiles = AP / 8;
#pragma unroll
      for (int j = 0; j < HEAD_NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) hacc[j][q] = 0.0f;
      const __nv_bfloat16* a = actb + (16 * hm + g) * LDA + 2 * t4;
#pragma unroll 2
      for (int kb = 0; kb < KB; ++kb) {
        const __nv_bfloat16* q = a + kb * 16;
        const unsigned af[4] = {bf16_pair(q), bf16_pair(q + 8 * LDA), bf16_pair(q + 8),
                                bf16_pair(q + 8 * LDA + 8)};
#pragma unroll
        for (int j = 0; j < HEAD_NT; ++j) {
          const int nt = hn0 + j * (kWideWarps / MT);
          if (nt < n_tiles) {
            const uint2 bf = mpb[head_b_index(kb, nt, g, t4)];
            mma_16816(hacc[j], af, bf.x, bf.y);
          }
        }
      }
    } else if (!gauss) {
      float acc[TSF][TCF];
      block_product<TSF, TCF, BF, false, false, L_::SLABF>(act, LDA, AP, prep + W.mp, H, AP,
                                                           slab, h_s0, h_c0, h_mine, acc);
      if (h_mine)
#pragma unroll
        for (int i = 0; i < TSF; ++i)
#pragma unroll
          for (int q = 0; q < TCF; ++q) {
            const int a = h_c0 + q;
            outs[(h_s0 + i) * LDO + a] = a < A ? acc[i][q] + sm[L_::BH + a] : 0.0f;
          }
    }
    {
      // the lane's terms k = lane + 32 i, one chain an env, then one
      // butterfly an env, the warp's envs side by side; under FMA the
      // Gaussian head's one mean likewise, from h2's policy columns and MT's
      // first row (a block product would leave all but 32 threads idle)
      constexpr int KL = H / 32;
      const bool dot_mean = !MMA && gauss;
      float wv[KL], z[EW], wm[KL], zm[EW];
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        wv[i] = prep[W.wv + lane + 32 * i];
        wm[i] = dot_mean ? prep[W.mt + lane + 32 * i] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < EW; ++q) {
        const int s = e0 + q;
        z[q] = 0.0f;
        zm[q] = 0.0f;
#pragma unroll
        for (int i = 0; i < KL; ++i) {
          const int k = lane + 32 * i;
          float h2;
          if constexpr (MMA) {
            h2 = __bfloat162float(actb[s * LDA + H + k]);
          } else {
            h2 = act[s * LDA + H + k];
            if constexpr (BF) h2 = bf16_round(h2);
            if (dot_mean) {
              float h2p = act[s * LDA + k];
              if constexpr (BF) h2p = bf16_round(h2p);
              zm[q] = fmaf(h2p, wm[i], zm[q]);
            }
          }
          z[q] = fmaf(h2, wv[i], z[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < EW; ++q) {
        const float v = warp_sum(z[q]);
        if (lane == 0) sval[e0 + q] = v + sm[L_::BH + A];
        if (dot_mean) {
          const float m = warp_sum(zm[q]);
          if (lane == 0) outs[(e0 + q) * LDO] = m + sm[L_::BH];
        }
      }
    }
    if constexpr (MMA) {
      __syncthreads();  // every warp has read h2, which the head outputs overwrite
      const int n_tiles = AP / 8;
#pragma unroll
      for (int j = 0; j < HEAD_NT; ++j) {
        const int nt = hn0 + j * (kWideWarps / MT);
        if (nt < n_tiles)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int a_out = 8 * nt + 2 * t4 + q % 2, s = 16 * hm + g + q / 2 * 8;
            outs[s * LDO + a_out] = a_out < A ? hacc[j][q] + sm[L_::BH + a_out] : 0.0f;
          }
      }
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
      int k = 0;
      warp_categorical<EW>(outs + e0 * LDO, LDO, A, za, lane, k, logp);
      if (active) {
        act_v = (float)k;
        quota = categorical_quota(p, k, c.h, K);
      }
    }
    if (active)
      env_step(p, model, c, act_v, logp, quota, sval[e0 + lane], zp, nf, col, TB, packed, fold,
               obs_noise, K, inv_K, two_K);
    if (lane < EW) sinp[e0 + lane] = c.inp;
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
  if (lane < EW) {
    float* st = sm + L_::STAT + (e0 + lane) * kStats;
    st[0] = c.nd;
    st[1] = c.sr;
    st[2] = c.sl;
    st[3] = c.srw;
  }
  __syncthreads();
  if (tid < kStats) {
    float z = 0.0f;
    for (int s = 0; s < E; ++s) z += sm[L_::STAT + s * kStats + tid];
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

// The envs a CTA takes: kEnvs, or kWideEnvs on the wide path's tensor cores.
static int envs_per_cta(int hidden, int act_dim, int compute) {
  return wide_path(hidden, act_dim) && compute == BFLOAT16 && hidden >= 64 ? kWideEnvs<true>
                                                                           : kEnvs;
}

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

// wide_prep for the wide path at hidden H: the fragment-ordered bf16 copies
// (FWB, MPB) where the products run on the tensor cores.
template <int H, bool BF>
static int launch_prep(const PolicyRolloutParams* p, const float* w, float* prep,
                       cudaStream_t st) {
  constexpr bool MMA = kWideMma<2 * H, BF>;
  return (int)launch_wide_prep(w, 1, H, p->act_dim, BF, BF, prep, st, MMA, MMA);
}

template <int H, bool BF>
static int launch_wide(const PolicyRolloutParams* p, const RollArgs& a, unsigned grid,
                       cudaStream_t st) {
  constexpr size_t bytes = WideRollSmem<H, kWideMma<2 * H, BF>>::BYTES;
  int err = launch_prep<H, BF>(p, a.w, a.prep, st);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(policy_rollout_wide<H, BF>,
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

// ws: [ceil(B / policy_rollout_envs_per_cta(hidden, act_dim, compute))][4]
// scratch; stats: [4]; prep: policy_rollout_prep_floats(hidden, act_dim)
// floats of scratch (none for the narrow path: it may be null there).
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
  const int E = envs_per_cta(p->hidden, p->act_dim, p->compute);
  const unsigned grid = (unsigned)((p->num_envs + E - 1) / E);
  const RollArgs a{w,         stock_in, t_in,  hv_in,  ret_in,  len_in, noise, packed,
                   stock_out, t_out,    hv_out, ret_out, len_out, ws,     prep};
  err = p->compute == BFLOAT16 ? launch_mode<true>(p, a, grid, st)
                               : launch_mode<false>(p, a, grid, st);
  if (err) return err;
  reduce_stats<<<1, 32, 0, st>>>(ws, (int)grid, stats);
  return (int)cudaGetLastError();
}

// wide_prep alone, as policy_rollout_launch runs it before the wide kernel,
// into prep (policy_rollout_prep_floats floats); for the card test of the
// layout. Only hidden, act_dim and compute of p are read.
extern "C" int policy_rollout_wide_prep(const PolicyRolloutParams* p, const float* w,
                                        float* prep, void* stream) {
  if (!wide_path(p->hidden, p->act_dim) || prep == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const bool bf = p->compute == BFLOAT16;
  switch (p->hidden) {
    case 32: return bf ? launch_prep<32, true>(p, w, prep, st) : launch_prep<32, false>(p, w, prep, st);
    case 64: return bf ? launch_prep<64, true>(p, w, prep, st) : launch_prep<64, false>(p, w, prep, st);
    case 128: return bf ? launch_prep<128, true>(p, w, prep, st) : launch_prep<128, false>(p, w, prep, st);
    default: return bf ? launch_prep<256, true>(p, w, prep, st) : launch_prep<256, false>(p, w, prep, st);
  }
}

extern "C" int policy_rollout_prep_floats(int hidden, int act_dim) {
  return wide_path(hidden, act_dim) ? wide_prep_layout(hidden, wide_ap(act_dim)).total : 0;
}

// wide_prep_layout's offsets at these sizes, fw .. mpb then total, into out[9]
// (the wrapper's views of wide_prep's regions).
extern "C" void policy_rollout_prep_layout(int hidden, int act_dim, int* out) {
  const WidePrep w = wide_prep_layout(hidden, wide_ap(act_dim));
  const int offs[9] = {w.fw, w.gw, w.mp, w.mt, w.wv, w.fwb, w.w2b, w.mpb, w.total};
  for (int i = 0; i < 9; ++i) out[i] = offs[i];
}

extern "C" int policy_rollout_params_size(void) { return (int)sizeof(PolicyRolloutParams); }

extern "C" int policy_rollout_envs_per_cta(int hidden, int act_dim, int compute) {
  return envs_per_cta(hidden, act_dim, compute);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
