// Fused T-step fishing rollout under a closed-form policy, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gym_fishing_tpu/kernels/rollout_kernel.py::
// _rollout_kernel. Per env and per step: optional lognormal observation noise
// on the policy input, the escapement / constant-mortality / constant-quota
// policy, the proportional or relative snap, harvest, growth (six models or the
// mixture, with r drift), additive or lognormal process noise, the
// price*h - cost*q^2 - collapse-penalty reward, auto-reset and episode
// accounting. The Python wrapper is gym_fishing_tpu_torch/kernels/
// rollout_kernel.py::rollout; its plain PyTorch twin there is rollout_reference.
//
// One library is built per configuration. What is uniform for a call is fixed
// when the source is compiled, by -D flags that the wrapper derives from its
// arguments (kernels/rollout_kernel.py::configuration): K1_GROWTH (the model;
// the wrapper resolves the mixture's index), K1_NOISE_FORM, K1_POLICY,
// K1_SCHEME, K1_OBS_NOISE, K1_PLANES (noise from planes, not Philox),
// and K1_DRIFT (r_drift != 0). The step holds no test of any of them; the
// launcher refuses parameters that disagree with its library's configuration,
// and there is no generic kernel. Unset flags give fishing-v1 under
// escapement, so the file also compiles alone.
//
// What bounds it on this card: the rate at which an SM's four schedulers start
// instructions, not memory and not occupancy. Per env and step
// the function needs a quarter of a Philox4x32-10 block (10 integer
// operations), half a Box-Muller pair (2 special-function results, a few
// float32 operations) and about 20 float32 and 4 integer operations of
// policy, growth, noise, reward and reset, while the kernel reads and writes
// only 11 x 4 bytes per env per *call* (4 inputs, 7 outputs): memory is
// nowhere near.
//
// What the design does about it: one thread per env with the whole T-step
// loop in registers; every switch a compile-time constant; the Philox round
// keys made once on the host and read as constant-bank operands; Box-Muller
// on the special-function units (one lg2, one sqrt, one sin, one cos per
// pair, with a two-term series where u is close to 1 and one subtraction as
// the whole range reduction: fishing_dynamics.cuh::box_muller_sfu); x / K as
// a multiply by 1 / K taken once; no conversion of t where r does not drift;
// whole Philox blocks in the loop and the odd steps after it, so the loop
// tests nothing but its counter. The other models' and noise forms' exp, pow
// and division by a varying value run as __expf, __powf and __fdividef, with
// which the parity bars were measured to hold in every configuration that
// reaches them (bench/rollout_instructions.py --models).
//
// All of that under the continuous scheme only. The proportional and relative
// snaps are discontinuous: a stock or a draw that differs from the plain
// twin's in its last bit can land an env on another action, and its
// trajectory then differs by whole actions. Under those schemes (K1_IEEE) the
// draws and every function stay the IEEE ones the twin computes, bit for bit.
// -DK1_IEEE=0 or 1 overrides that, for measuring one arithmetic beside the
// other (bench/rollout_instructions.py --models); no wrapper passes it.
//
// RNG: Philox4x32-10 with key = 64-bit seed and counter = (env index,
// offset + draw index), 64 bits each. Each uint32 becomes a uniform in (0, 1]
// exactly as the TPU kernel's _uniform_from_bits does, then Box-Muller. One
// pair (cos, sin) feeds two steps, so one block feeds four; with obs_noise one
// pair is (process z, measurement eta) for one step. Optional pre-generated
// noise planes replace Philox for parity tests.
//
// Built without --use_fast_math: every expression keeps IEEE rounding except
// the functions called by name above.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fishing_dynamics.cuh"

#ifndef K1_GROWTH
#define K1_GROWTH LOGISTIC
#endif
#ifndef K1_NOISE_FORM
#define K1_NOISE_FORM ADDITIVE
#endif
#ifndef K1_POLICY
#define K1_POLICY 0  // ESCAPEMENT
#endif
#ifndef K1_SCHEME
#define K1_SCHEME CONTINUOUS
#endif
#ifndef K1_OBS_NOISE
#define K1_OBS_NOISE 0
#endif
#ifndef K1_PLANES
#define K1_PLANES 0
#endif
#ifndef K1_DRIFT
#define K1_DRIFT 0
#endif
// 1: IEEE draws and functions throughout (see above).
#ifndef K1_IEEE
#define K1_IEEE (K1_SCHEME != CONTINUOUS)
#endif
// Threads a CTA and the CTAs an SM must hold (which caps the registers).
#define K1_THREADS 256
#define K1_MIN_BLOCKS 6

// Index into the Python tuple POLICIES.
enum { ESCAPEMENT = 0, CONSTANT_MORTALITY, CONSTANT };

static_assert(K1_GROWTH >= LOGISTIC && K1_GROWTH < MIXTURE, "K1_GROWTH: one of the six models");
static_assert(K1_NOISE_FORM == ADDITIVE || K1_NOISE_FORM == LOGNORMAL, "K1_NOISE_FORM");
static_assert(K1_POLICY >= ESCAPEMENT && K1_POLICY <= CONSTANT, "K1_POLICY");
static_assert(K1_SCHEME >= CONTINUOUS && K1_SCHEME <= RELATIVE, "K1_SCHEME");
static_assert((K1_OBS_NOISE | K1_PLANES | K1_DRIFT) >> 1 == 0, "0 or 1");

struct RolloutParams {
  float r, r_drift, K, sigma, sigma_m, price, cost, init_state, init_harvest;
  float A, B, C, theta, a, b, q, collapse_penalty, policy_param;
  int Tmax, model_idx, n_actions;
  int growth, noise_form, policy, scheme, obs_noise, num_steps, has_noise;
  long long num_envs;
  unsigned long long offset;
  PhiloxKeys keys;  // of the 64-bit seed
};
static_assert(sizeof(RolloutParams) == 208, "RolloutParams layout must match ctypes");

#define K1_EXP(x) ((K1_IEEE) ? expf(x) : __expf(x))
#define K1_POW(x, y) ((K1_IEEE) ? powf(x, y) : __powf(x, y))
#define K1_DIV(x, y) ((K1_IEEE) ? (x) / (y) : __fdividef(x, y))
#define K1_OVER_K(x) ((K1_IEEE) ? (x) / p.K : (x) * c.inv_K)

// The four normals of one Philox block, as the step loop draws them.
__device__ __forceinline__ float4 draw4(uint4 bits) {
  return (K1_IEEE) ? box_muller_ieee(bits) : box_muller_sfu(bits);
}
__device__ __forceinline__ float2 draw2(uint4 bits) {
  if (K1_IEEE) {
    const float4 n = box_muller_ieee(bits);
    return make_float2(n.x, n.y);
  }
  return box_muller_pair_sfu(bits.x, bits.y);
}

// What the loop needs of the parameters beyond the struct, taken once.
struct Hoisted {
  float inv_K;    // x / K as x * (1 / K), unless K1_IEEE
  float pow_b_q;  // May
  float n;        // proportional snap
};

// fishing_dynamics.cuh::growth for the one model this library was built for.
__device__ __forceinline__ float growth_fixed(const RolloutParams& p, const Hoisted& c, float x,
                                              float r) {
  const float xk = K1_OVER_K(x);
  if (K1_GROWTH == RICKER) return x * K1_EXP(r * (1.0f - xk));
  if (K1_GROWTH == BEVERTON_HOLT) return K1_DIV(p.A * x, 1.0f + p.B * x);
  if (K1_GROWTH == ALLEN) return x * K1_EXP(K1_OVER_K(r * (1.0f - xk) * (x - p.C)));
  if (K1_GROWTH == MYERS) {
    const float xt = K1_POW(x, p.theta);
    return K1_DIV(r * xt, 1.0f + K1_OVER_K(xt));
  }
  if (K1_GROWTH == MAY) {
    const float xq = K1_POW(x, p.q);
    return x + r * x * (1.0f - xk) - K1_DIV(p.a * xq, xq + c.pow_b_q);
  }
  return x + r * x * (1.0f - xk);
}

struct EnvCarry {
  float x;    // stock
  int t;      // years passed
  float h;    // carried harvest (relative scheme)
  float cur;  // running return of the in-flight episode
  float rew;  // reward accumulated this call
  float eps;  // sum of completed-episode returns this call
  int epc;    // episodes completed this call
};

__device__ __forceinline__ void env_step(const RolloutParams& p, const Hoisted& c, EnvCarry& s,
                                         float z, float eta) {
  // The policy reads the raw (optionally noisy) stock, not the clipped obs.
  const float x_obs = K1_OBS_NOISE ? s.x * K1_EXP(p.sigma_m * eta) : s.x;
  float quota;
  if (K1_POLICY == ESCAPEMENT) {
    quota = fmaxf(x_obs - p.policy_param, 0.0f);
  } else if (K1_POLICY == CONSTANT_MORTALITY) {
    quota = p.policy_param * x_obs;
  } else {
    quota = p.policy_param;
  }
  if (K1_SCHEME == PROPORTIONAL) {
    // encode∘decode of the n-action grid; rintf rounds half to even.
    // IEEE divisions: a quotient rounded otherwise could land on another action
    const float a = fminf(fmaxf(rintf(quota * c.n / p.K), 0.0f), c.n - 1.0f);
    quota = a / c.n * p.K;
  } else if (K1_SCHEME == RELATIVE) {
    // nearest of h * {1.0, 1.2, 0.8}; strict < keeps the first on ties.
    float best = s.h * 1.0f;
    float bestd = fabsf(best - quota);
    float cand = s.h * 1.2f;
    float d = fabsf(cand - quota);
    if (d < bestd) { best = cand; bestd = d; }
    cand = s.h * 0.8f;
    d = fabsf(cand - quota);
    if (d < bestd) { best = cand; bestd = d; }
    quota = best;
  }
  const float hv = fminf(s.x, quota);
  const float x1 = s.x - hv;
  const float r_eff = K1_DRIFT ? p.r + p.r_drift * (float)s.t : p.r;
  const float mu = growth_fixed(p, c, x1, r_eff);
  const float x2 = K1_NOISE_FORM == ADDITIVE ? mu + p.sigma * x1 * z : mu * K1_EXP(p.sigma * z);
  float x_next = x2 < 0.0f ? 0.0f : x2;  // keeps a NaN visible
  const bool collapsed = x_next <= 0.0f;
  float step_rew = p.price * hv - p.cost * quota * quota;
  step_rew = step_rew - (collapsed ? p.collapse_penalty : 0.0f);
  s.rew += step_rew;
  s.cur += step_rew;
  int t_next = s.t + 1;
  const bool done = (t_next >= p.Tmax) || collapsed;
  if (done) {
    s.eps += s.cur;
    s.epc += 1;
    s.cur = 0.0f;
    x_next = p.init_state;
    t_next = 0;
  }
  // The carried harvest becomes the pre-min quota under the relative scheme.
  if (K1_SCHEME == RELATIVE) s.h = done ? p.init_harvest : quota;
  s.x = x_next;
  s.t = t_next;
}

__global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS) rollout_kernel(
    const RolloutParams p, const float* __restrict__ stock_in, const int* __restrict__ t_in,
    const float* __restrict__ ep_in, const float* __restrict__ hv_in,
    const float* __restrict__ noise, float* __restrict__ stock_out, int* __restrict__ t_out,
    float* __restrict__ ep_out, float* __restrict__ rew_out, float* __restrict__ eps_out,
    int* __restrict__ epc_out, float* __restrict__ hv_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long B = p.num_envs;
  if (i >= B) return;
  const int T = p.num_steps;
  Hoisted c;
  c.inv_K = 1.0f / p.K;
  c.pow_b_q = K1_GROWTH == MAY ? powf(p.b, p.q) : 0.0f;
  c.n = (float)p.n_actions;
  EnvCarry s = {stock_in[i], t_in[i], hv_in[i], ep_in[i], 0.0f, 0.0f, 0};

#if K1_PLANES
  // pre-generated planes, (obs_noise ? 2 : 1) x T x B: z, then eta
  for (int k = 0; k < T; ++k) {
    const float z = noise[(long long)k * B + i];
    const float eta = K1_OBS_NOISE ? noise[((long long)T + k) * B + i] : 0.0f;
    env_step(p, c, s, z, eta);
  }
#elif K1_OBS_NOISE
  // one pair per step: (process z, measurement eta); a block feeds 2 steps
  unsigned long long ctr = p.offset;
  for (int d = 0; d < (T >> 1); ++d, ++ctr) {
    const float4 n = draw4(philox_bits_keyed(p.keys, (unsigned long long)i, ctr));
    env_step(p, c, s, n.x, n.y);
    env_step(p, c, s, n.z, n.w);
  }
  if (T & 1) {
    const float2 n = draw2(philox_bits_keyed(p.keys, (unsigned long long)i, ctr));
    env_step(p, c, s, n.x, n.y);
  }
#else
  // one pair feeds two steps, a block four (T is even)
  unsigned long long ctr = p.offset;
  for (int d = 0; d < (T >> 2); ++d, ++ctr) {
    const float4 n = draw4(philox_bits_keyed(p.keys, (unsigned long long)i, ctr));
    env_step(p, c, s, n.x, 0.0f);
    env_step(p, c, s, n.y, 0.0f);
    env_step(p, c, s, n.z, 0.0f);
    env_step(p, c, s, n.w, 0.0f);
  }
  if (T & 2) {
    const float2 n = draw2(philox_bits_keyed(p.keys, (unsigned long long)i, ctr));
    env_step(p, c, s, n.x, 0.0f);
    env_step(p, c, s, n.y, 0.0f);
  }
#endif
  stock_out[i] = s.x;
  t_out[i] = s.t;
  ep_out[i] = s.cur;
  rew_out[i] = s.rew;
  eps_out[i] = s.eps;
  epc_out[i] = s.epc;
  hv_out[i] = s.h;
}

// The four normals of Philox block (env i, offset) into out[j * n + i], j < 4:
// the rollout's own draw path, exposed for statistical checks of the stream.
__global__ void __launch_bounds__(256) philox_normal_fill_kernel(
    const PhiloxKeys keys, unsigned long long offset, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 z = draw4(philox_bits_keyed(keys, (unsigned long long)i, offset));
  out[i] = z.x;
  out[n + i] = z.y;
  out[2 * n + i] = z.z;
  out[3 * n + i] = z.w;
}

// Box-Muller alone, from given bits[j * n + i], j < 4, into out[j * n + i]:
// the rollout's draw path (SFU) or the IEEE one it is measured beside.
template <bool SFU>
__global__ void __launch_bounds__(256) box_muller_kernel(const uint32_t* __restrict__ bits,
                                                         long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 b = make_uint4(bits[i], bits[n + i], bits[2 * n + i], bits[3 * n + i]);
  const float4 z = SFU ? box_muller_sfu(b) : box_muller_ieee(b);
  out[i] = z.x;
  out[n + i] = z.y;
  out[2 * n + i] = z.z;
  out[3 * n + i] = z.w;
}

static int grid_for(long long n, int threads, unsigned* blocks) {
  const long long b = (n + threads - 1) / threads;
  if (n <= 0 || b > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

// The wrapper's switches must be the ones this library was compiled for.
static bool matches_configuration(const RolloutParams* p) {
  const int model = p->growth == MIXTURE
                        ? (p->model_idx > LOGISTIC && p->model_idx < MIXTURE ? p->model_idx : LOGISTIC)
                        : p->growth;
  return model == K1_GROWTH && p->noise_form == K1_NOISE_FORM && p->policy == K1_POLICY &&
         p->scheme == K1_SCHEME && p->obs_noise == K1_OBS_NOISE && p->has_noise == K1_PLANES &&
         (p->r_drift != 0.0f) == (K1_DRIFT != 0);
}

extern "C" int rollout_launch(const RolloutParams* p, const float* stock_in, const int* t_in,
                              const float* ep_in, const float* hv_in, const float* noise,
                              float* stock_out, int* t_out, float* ep_out, float* rew_out,
                              float* eps_out, int* epc_out, float* hv_out, void* stream) {
  unsigned blocks;
  if (!matches_configuration(p) || (K1_PLANES != 0) != (noise != nullptr))
    return (int)cudaErrorInvalidValue;
  const int err = grid_for(p->num_envs, K1_THREADS, &blocks);
  if (err) return err;
  rollout_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
      *p, stock_in, t_in, ep_in, hv_in, noise, stock_out, t_out, ep_out, rew_out, eps_out,
      epc_out, hv_out);
  return (int)cudaGetLastError();
}

extern "C" int philox_normal_fill(const PhiloxKeys* keys, unsigned long long offset, long long n,
                                  float* out, void* stream) {
  unsigned blocks;
  const int err = grid_for(n, 256, &blocks);
  if (err) return err;
  philox_normal_fill_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(*keys, offset, n, out);
  return (int)cudaGetLastError();
}

extern "C" int box_muller_fill(const uint32_t* bits, long long n, int sfu, float* out,
                               void* stream) {
  unsigned blocks;
  const int err = grid_for(n, 256, &blocks);
  if (err) return err;
  if (sfu)
    box_muller_kernel<true><<<blocks, 256, 0, (cudaStream_t)stream>>>(bits, n, out);
  else
    box_muller_kernel<false><<<blocks, 256, 0, (cudaStream_t)stream>>>(bits, n, out);
  return (int)cudaGetLastError();
}

// The configuration compiled in, in the order of rollout_kernel.py::CONFIG_FLAGS.
extern "C" void rollout_configuration(int* out) {
  const int cfg[7] = {K1_GROWTH, K1_NOISE_FORM, K1_POLICY, K1_SCHEME,
                      K1_OBS_NOISE, K1_PLANES, K1_DRIFT};
  for (int j = 0; j < 7; ++j) out[j] = cfg[j];
}

extern "C" int rollout_params_size(void) { return (int)sizeof(RolloutParams); }

extern "C" int rollout_threads(void) { return K1_THREADS; }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
