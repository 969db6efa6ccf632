// Device code shared by the kernels that run the merged block-diagonal
// actor-critic (ppo_update_kernel.cu and policy_rollout_kernel.cu): the
// layout of the flat merged weight buffer, bf16 input rounding, vector loads
// from shared memory, a warp sum, and the register-tiled product of a chunk
// of activations with a [2H, 2H] matrix in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Offsets into the flat merged buffer: W1c [D][2H], b1c [2H], W2c [2H][2H],
// b2c [2H], Whc [2H][A+1], bhc [A+1], log_std [A]
// (kernels/ppo_update_kernel.py::merge_weights, flatten_merged).
struct Layout {
  int w1, b1, w2, b2, wh, bh, ls, P;
};

__host__ __device__ inline Layout make_layout(int D, int H2, int A) {
  Layout L;
  L.w1 = 0;
  L.b1 = D * H2;
  L.w2 = L.b1 + H2;
  L.b2 = L.w2 + H2 * H2;
  L.wh = L.b2 + H2;
  L.bh = L.wh + H2 * (A + 1);
  L.ls = L.bh + A + 1;
  L.P = L.ls + A;
  return L;
}

// Row stride, in floats, of an activation buffer [samples][H2] in shared
// memory: padded so rows stay 16-byte aligned and shift banks.
template <int H2>
inline constexpr int kActLD = H2 + 4;

template <bool BF>
__device__ __forceinline__ float in_round(float x) {
  if constexpr (BF) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&v)[N]) {
  static_assert(N == 2 || N == 4 || N == 8, "row width");
  if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[s][c] = sum_j in_round(A[s][j]) * Bm[j][c] for the 4 samples s0.. and the
// H2/32 columns c0.. of this thread; A is [samples][kActLD<H2>], Bm is
// [H2][H2] (already rounded under bf16).
template <int H2, bool BF>
__device__ __forceinline__ void chunk_product(const float* __restrict__ A,
                                              const float* __restrict__ Bm, int s0, int c0,
                                              float (&acc)[4][H2 / 32]) {
  constexpr int LD = kActLD<H2>;
  constexpr int CPT = H2 / 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < H2; j += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      load_row<4>(A + (s0 + i) * LD + j, a[i]);
#pragma unroll
      for (int q = 0; q < 4; ++q) a[i][q] = in_round<BF>(a[i][q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[CPT];
      load_row<CPT>(Bm + (j + q) * H2 + c0, b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i][q], b[c], acc[i][c]);
    }
  }
}
