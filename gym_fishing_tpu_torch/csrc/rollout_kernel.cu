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
// What bounds it on this card: per env and step the kernel does about one exp
// or pow (growth, lognormal noise), half a log, half a sincos and half a sqrt
// (Box-Muller), and a quarter of a Philox4x32-10 block, while it reads and
// writes only 11 x 4 bytes per env per *call* (4 inputs, 7 outputs). At
// B = 2^21 and T = 512 that is ~92 MB of traffic against ~10^9 env-steps, so it
// is bound by special-function and integer throughput, not by memory.
//
// What the design does about it: one thread per env with the whole T-step loop
// in registers (no shared or device memory inside the loop), runtime-uniform
// switches on model, policy, scheme and noise form (no divergence), and one
// Box-Muller pair (cos and sin) feeding two steps, so one Philox block (four
// uint32) feeds four steps.
//
// RNG: Philox4x32-10 with key = 64-bit seed and counter = (env index,
// offset + draw index), 64 bits each. Each uint32 becomes a uniform in (0, 1]
// exactly as the TPU kernel's _uniform_from_bits does, then Box-Muller. With
// obs_noise one pair is (process z, measurement eta) for one step. Optional
// pre-generated noise planes replace Philox for parity tests.
//
// Built without --use_fast_math: the parity tolerances assume IEEE expf, logf,
// powf, sincosf and division.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fishing_dynamics.cuh"

struct RolloutParams {
  float r, r_drift, K, sigma, sigma_m, price, cost, init_state, init_harvest;
  float A, B, C, theta, a, b, q, collapse_penalty, policy_param;
  int Tmax, model_idx, n_actions;
  int growth, noise_form, policy, scheme, obs_noise, num_steps, has_noise;
  long long num_envs;
  unsigned long long seed, offset;
};
static_assert(sizeof(RolloutParams) == 136, "RolloutParams layout must match ctypes");

// Index into the Python tuple POLICIES.
enum { ESCAPEMENT = 0, CONSTANT_MORTALITY, CONSTANT };

struct EnvCarry {
  float x;    // stock
  int t;      // years passed
  float h;    // carried harvest (relative scheme)
  float cur;  // running return of the in-flight episode
  float rew;  // reward accumulated this call
  float eps;  // sum of completed-episode returns this call
  int epc;    // episodes completed this call
};

__device__ __forceinline__ void env_step(const RolloutParams& p, int model, EnvCarry& s,
                                         float z, float eta) {
  // The policy reads the raw (optionally noisy) stock, not the clipped obs.
  const float x_obs = p.obs_noise ? s.x * expf(p.sigma_m * eta) : s.x;
  float quota;
  switch (p.policy) {
    case ESCAPEMENT:
      quota = fmaxf(x_obs - p.policy_param, 0.0f);
      break;
    case CONSTANT_MORTALITY:
      quota = p.policy_param * x_obs;
      break;
    default:
      quota = p.policy_param;
      break;
  }
  if (p.scheme == PROPORTIONAL) {
    // encode∘decode of the n-action grid; rintf rounds half to even.
    const float n = (float)p.n_actions;
    const float a = fminf(fmaxf(rintf(quota * n / p.K), 0.0f), n - 1.0f);
    quota = a / n * p.K;
  } else if (p.scheme == RELATIVE) {
    // nearest of h * {1.0, 1.2, 0.8}; strict < keeps the first on ties.
    float best = s.h * 1.0f;
    float bestd = fabsf(best - quota);
    float c = s.h * 1.2f;
    float d = fabsf(c - quota);
    if (d < bestd) { best = c; bestd = d; }
    c = s.h * 0.8f;
    d = fabsf(c - quota);
    if (d < bestd) { best = c; bestd = d; }
    quota = best;
  }
  const float hv = fminf(s.x, quota);
  const float x1 = s.x - hv;
  const float r_eff = p.r + p.r_drift * (float)s.t;
  const float mu = growth(p, model, x1, r_eff);
  const float x2 = p.noise_form == ADDITIVE ? mu + p.sigma * x1 * z : mu * expf(p.sigma * z);
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
  if (p.scheme == RELATIVE) s.h = done ? p.init_harvest : quota;
  s.x = x_next;
  s.t = t_next;
}

__global__ void __launch_bounds__(256) rollout_kernel(
    const RolloutParams p, const float* __restrict__ stock_in, const int* __restrict__ t_in,
    const float* __restrict__ ep_in, const float* __restrict__ hv_in,
    const float* __restrict__ noise, float* __restrict__ stock_out, int* __restrict__ t_out,
    float* __restrict__ ep_out, float* __restrict__ rew_out, float* __restrict__ eps_out,
    int* __restrict__ epc_out, float* __restrict__ hv_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long B = p.num_envs;
  if (i >= B) return;
  const int T = p.num_steps;
  const int model = p.growth == MIXTURE ? p.model_idx : p.growth;
  EnvCarry s = {stock_in[i], t_in[i], hv_in[i], ep_in[i], 0.0f, 0.0f, 0};

  if (p.has_noise) {
    // pre-generated planes, (obs_noise ? 2 : 1) x T x B: z, then eta
    for (int k = 0; k < T; ++k) {
      const float z = noise[(long long)k * B + i];
      const float eta = p.obs_noise ? noise[((long long)T + k) * B + i] : 0.0f;
      env_step(p, model, s, z, eta);
    }
  } else if (p.obs_noise) {
    // one pair per step: (process z, measurement eta); block d feeds 2 steps
    for (int k = 0; k < T; k += 2) {
      const float4 n = philox_normals(p.seed, (unsigned long long)i, p.offset + (k >> 1));
      env_step(p, model, s, n.x, n.y);
      if (k + 1 < T) env_step(p, model, s, n.z, n.w);
    }
  } else {
    // one pair feeds two steps; block d feeds 4 steps (T is even)
    for (int k = 0; k < T; k += 4) {
      const float4 n = philox_normals(p.seed, (unsigned long long)i, p.offset + (k >> 2));
      env_step(p, model, s, n.x, 0.0f);
      env_step(p, model, s, n.y, 0.0f);
      if (k + 2 < T) {
        env_step(p, model, s, n.z, 0.0f);
        env_step(p, model, s, n.w, 0.0f);
      }
    }
  }
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
    unsigned long long seed, unsigned long long offset, long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4 z = philox_normals(seed, (unsigned long long)i, offset);
  out[i] = z.x;
  out[n + i] = z.y;
  out[2 * n + i] = z.z;
  out[3 * n + i] = z.w;
}

static const int kThreads = 256;

static int grid_for(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (n <= 0 || b > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

extern "C" int rollout_launch(const RolloutParams* p, const float* stock_in, const int* t_in,
                              const float* ep_in, const float* hv_in, const float* noise,
                              float* stock_out, int* t_out, float* ep_out, float* rew_out,
                              float* eps_out, int* epc_out, float* hv_out, void* stream) {
  unsigned blocks;
  const int err = grid_for(p->num_envs, &blocks);
  if (err) return err;
  rollout_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *p, stock_in, t_in, ep_in, hv_in, noise, stock_out, t_out, ep_out, rew_out, eps_out,
      epc_out, hv_out);
  return (int)cudaGetLastError();
}

extern "C" int philox_normal_fill(unsigned long long seed, unsigned long long offset,
                                  long long n, float* out, void* stream) {
  unsigned blocks;
  const int err = grid_for(n, &blocks);
  if (err) return err;
  philox_normal_fill_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(seed, offset, n, out);
  return (int)cudaGetLastError();
}

extern "C" int rollout_params_size(void) { return (int)sizeof(RolloutParams); }

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
