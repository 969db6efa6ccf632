// Device code shared by the kernels that run the merged block-diagonal
// actor-critic (ppo_update_kernel.cu and policy_rollout_kernel.cu): the
// layout of the flat merged weight buffer, the row stride of an activation
// buffer and vector loads from shared memory.

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
