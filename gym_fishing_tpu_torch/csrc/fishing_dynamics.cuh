// Device code shared by the fishing kernels (rollout_kernel.cu and
// policy_rollout_kernel.cu): the enums of the Python tuples, the
// Philox4x32-10 generator with its uniform and Box-Muller helpers, and the
// deterministic growth update.
//
// RNG: Philox4x32-10 with key = 64-bit seed and counter = (env index, draw
// index), 64 bits each. Each uint32 becomes a uniform in (0, 1] exactly as
// the TPU kernels' _uniform_from_bits does. The Python twins
// (kernels/rollout_kernel.py::_philox4x32_10) compute the same stream.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Indices into the Python tuples GROWTH_MODELS (+ mixture), NOISE_FORMS and
// SCHEMES.
enum { LOGISTIC = 0, RICKER, BEVERTON_HOLT, ALLEN, MYERS, MAY, MIXTURE };
enum { ADDITIVE = 0, LOGNORMAL };
enum { CONTINUOUS = 0, PROPORTIONAL, RELATIVE };

#define TWO_PI_F 6.2831855f

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k.x += W0;
      k.y += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// The four uint32 of Philox block (env, counter) under key seed.
__device__ __forceinline__ uint4 philox_bits(unsigned long long seed, unsigned long long env,
                                             unsigned long long counter) {
  const uint4 ctr = make_uint4((uint32_t)env, (uint32_t)(env >> 32), (uint32_t)counter,
                               (uint32_t)(counter >> 32));
  return philox4x32_10(ctr, make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
}

// uint32 -> uniform in (0, 1]: 23 mantissa bits under the exponent of 1.0
// give [1, 2); subtracting from 2 keeps log() finite.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return 2.0f - __uint_as_float((bits >> 9) | 0x3F800000u);
}

// Four N(0,1) draws from one Philox block: (cos, sin) of two Box-Muller pairs.
__device__ __forceinline__ float4 philox_normals(unsigned long long seed,
                                                 unsigned long long env,
                                                 unsigned long long counter) {
  const uint4 bits = philox_bits(seed, env, counter);
  float s0, c0, s1, c1;
  const float rad0 = sqrtf(-2.0f * logf(uniform_from_bits(bits.x)));
  sincosf(TWO_PI_F * uniform_from_bits(bits.y), &s0, &c0);
  const float rad1 = sqrtf(-2.0f * logf(uniform_from_bits(bits.z)));
  sincosf(TWO_PI_F * uniform_from_bits(bits.w), &s1, &c1);
  return make_float4(rad0 * c0, rad0 * s0, rad1 * c1, rad1 * s1);
}

// Deterministic growth update of post-harvest stock x at growth rate r. P is
// any parameter struct with the fields K, A, B, C, theta, a, b and q. An
// out-of-range mixture index selects logistic, as the where-chain of the JAX
// mixture does.
template <class P>
__device__ __forceinline__ float growth(const P& p, int model, float x, float r) {
  const float K = p.K;
  switch (model) {
    case RICKER:
      return x * expf(r * (1.0f - x / K));
    case BEVERTON_HOLT:
      return p.A * x / (1.0f + p.B * x);
    case ALLEN:
      return x * expf(r * (1.0f - x / K) * (x - p.C) / K);
    case MYERS: {
      const float xt = powf(x, p.theta);
      return r * xt / (1.0f + xt / K);
    }
    case MAY: {
      const float xq = powf(x, p.q);
      return x + r * x * (1.0f - x / K) - p.a * xq / (xq + powf(p.b, p.q));
    }
    default:
      return x + r * x * (1.0f - x / K);
  }
}
