// Device code shared by the fishing kernels (rollout_kernel.cu and
// policy_rollout_kernel.cu): the enums of the Python tuples, the
// Philox4x32-10 generator with its uniform and Box-Muller helpers, and the
// deterministic growth update. The second half (PhiloxKeys, philox_bits_keyed,
// box_muller_sfu) is the stepping kernel's draw path: the same stream from
// round keys made once on the host, and Box-Muller on the special-function
// units.
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

// Four N(0,1) draws from the four uint32 of one Philox block: (cos, sin) of
// two Box-Muller pairs, with IEEE logf, sqrtf and sincosf.
__device__ __forceinline__ float4 box_muller_ieee(uint4 bits) {
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

// ------------------------------------------------ the stepping kernel's draws

// The ten round keys of Philox4x32-10 depend only on the seed: the host makes
// them once per call (key + round * Weyl constant, mod 2^32), and as kernel
// parameters they are constant-bank operands that cost no register.
struct PhiloxKeys {
  uint32_t k[10][2];
};

// philox_bits from ready round keys. Per round two 32 x 32 -> 64-bit
// multiplies (mul.wide.u32) and two three-input xors: 40 operations a block.
__device__ __forceinline__ uint4 philox_bits_keyed(const PhiloxKeys& keys, unsigned long long env,
                                                   unsigned long long counter) {
  uint32_t c0 = (uint32_t)env, c1 = (uint32_t)(env >> 32);
  uint32_t c2 = (uint32_t)counter, c3 = (uint32_t)(counter >> 32);
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint64_t p0 = (uint64_t)0xD2511F53u * c0;
    const uint64_t p1 = (uint64_t)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ keys.k[round][0];
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ keys.k[round][1];
    c1 = (uint32_t)p1;
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// One result of a special-function unit each (MUFU.LG2, .SQRT, .SIN, .COS).
// The .ftz forms are a single instruction; the plain forms and the __logf
// family add a denormal rescue around it that these arguments never need.
__device__ __forceinline__ float sfu_lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sfu_sqrt(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sfu_sin(float x) {
  float y;
  asm("sin.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sfu_cos(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A uniform u = 1 - w is taken for "close to 1" below this w (a multiple of
// 2^-23, as every w is).
#define SFU_NEAR_ONE 0.00390625f  // 2^-8

// -2 ln(u) for u = 2 - f, f in [1, 2) with 23 mantissa bits: never negative,
// never NaN. lg2's error is absolute (about 2^-22) for u in [0.5, 1], which
// is nothing beside -2 ln(u) unless u is close to 1; there w = 1 - u = f - 1
// is exact and -2 ln(1 - w) = 2w + w^2 + 2/3 w^3 + ..., cut after w^2 (the
// next term is w^2 / 3 of the sum, below 5.1e-6 of it for w < 2^-8, and half
// that of the radius). Both are computed and one is selected, so no lane
// diverges.
__device__ __forceinline__ float neg2_log_uniform(float f) {
  const float w = f - 1.0f;
  const float far = sfu_lg2(2.0f - f) * -1.3862944f;  // -2 ln 2
  const float near = fmaf(w, w, w + w);
  return w < SFU_NEAR_ONE ? near : far;
}

// Box-Muller of one pair: (rad cos(theta), rad sin(theta)) with theta =
// 2 pi u in (0, 2 pi]. The units' sine and cosine are accurate on [-pi, pi]
// only, and cos(theta) = -cos(theta - pi), sin(theta) = -sin(theta - pi)
// exactly: one subtraction reduces the argument, and the sign goes to the
// radius. No general range reduction and no slow path.
__device__ __forceinline__ float2 box_muller_pair_sfu(uint32_t bits_rad, uint32_t bits_ang) {
  const float f0 = __uint_as_float((bits_rad >> 9) | 0x3F800000u);
  const float f1 = __uint_as_float((bits_ang >> 9) | 0x3F800000u);
  const float nrad = -sfu_sqrt(neg2_log_uniform(f0));
  const float a = fmaf(TWO_PI_F, 2.0f - f1, -3.1415927f);
  return make_float2(nrad * sfu_cos(a), nrad * sfu_sin(a));
}

// box_muller_ieee's four draws, on the special-function units.
__device__ __forceinline__ float4 box_muller_sfu(uint4 bits) {
  const float2 a = box_muller_pair_sfu(bits.x, bits.y);
  const float2 b = box_muller_pair_sfu(bits.z, bits.w);
  return make_float4(a.x, a.y, b.x, b.y);
}
