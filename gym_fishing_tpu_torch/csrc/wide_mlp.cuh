// Device code shared by the wide paths of the update kernels
// (ppo_update_kernel.cu) and the policy rollout (policy_rollout_kernel.cu):
// hidden 128 and 256, and categorical heads of more than 16 classes at any
// hidden size, whose weights do not fit a CTA's shared memory.
//
// At hidden 256 one tower's W2 block is 256 KiB in float32, and the
// categorical head's Wm at 128 classes another 128 KiB. So the wide kernels
// keep only activations in shared memory and stream every weight matrix
// from L2 in k-slabs: wide_prep lays the merged weights out once per launch
// as plain row-major operands (both towers' W2 blocks side by side, their
// transposes, the policy head padded to a multiple of 8 classes and its
// transpose, the value head), and block_product runs one block-wide product
// over a double-buffered ring of two slabs filled by cp.async, as float32
// FMA; under bfloat16 the inputs that the mode rounds are rounded where they
// are read (the weights by wide_prep), which is the function the mode
// defines. Under bfloat16 at hidden 64 and above the W2c products run on the
// tensor cores instead: K4's (mma_tiles.cuh::tower_mma) from a bf16 copy of
// FW in the order of an mma.sync B fragment (bf_copy), its policy head from
// one of MP (bf_head); K2/K3's (ppo_grad_tower) from a bf16 copy of W2c's two
// tower blocks, row-major (bf_rows), which each CTA keeps in shared memory.
// dW2c of the update kernels is not a block product at all: see
// ppo_update_kernel.cu::dw2c_split.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "merged_mlp.cuh"

#define WIDE_FULL_MASK 0xffffffffu

constexpr int kWideMaxA = 128;             // categorical classes of the wide paths
constexpr int kWideLDO = kWideMaxA + 4;    // row stride of a block of head outputs
constexpr int kSlabFloats = 4096;          // one slab of a streamed operand (16 KiB)

// One float (or four) from global to shared memory without passing through a
// register; complete after cp_async_wait_all in the issuing thread.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Groups of cp.async copies: close the group of this thread's copies issued
// since the last commit; wait until at most N of its groups are in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Sums and maxima over the warp by a butterfly: every lane gets the result,
// added in the same order on every call.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(WIDE_FULL_MASK, v, d);
  return v;
}

// The same over each half-warp (lanes 0-15 and 16-31 apart).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int d = 8; d > 0; d >>= 1) v += __shfl_xor_sync(WIDE_FULL_MASK, v, d);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(WIDE_FULL_MASK, v, d));
  return v;
}

// The policy head's width padded to the product's column tiles.
__host__ __device__ inline int wide_ap(int A) { return (A + 7) / 8 * 8; }

// Offsets (floats) into wide_prep's output, for tower width H and padded
// head width AP: FW [H][2H], GW [H][2H], MP [H][AP], MT [AP][H], WV [H],
// then FWB, a bf16 copy of FW in the order of an mma.sync B fragment
// (frag_index), 2H x H bf16, then W2B, W2c's tower blocks as bf16 [2][H][H]
// (W2B[t][k][n] = W2c[t H + k][t H + n], row-major), then MPB, MP's, AP x H
// bf16. K4's wide path writes FWB and MPB, K2/K3's W2B; each sizes its
// scratch by the same total and carries the others' space unused.
struct WidePrep {
  int fw, gw, mp, mt, wv, fwb, w2b, mpb, total;
};

__host__ __device__ inline WidePrep wide_prep_layout(int H, int AP) {
  WidePrep w;
  w.fw = 0;
  w.gw = w.fw + 2 * H * H;
  w.mp = w.gw + 2 * H * H;
  w.mt = w.mp + H * AP;
  w.wv = w.mt + AP * H;
  w.fwb = w.wv + H;      // a multiple of 4 floats: 8-byte loads
  w.w2b = w.fwb + H * H;   // a multiple of 4 floats: 16-byte copies
  w.mpb = w.w2b + H * H;
  w.total = w.mpb + H * AP / 2;
  return w;
}

// Where entry (k, n) of a [H][N] operand B (k < H, n < N: 2H for FW and GW,
// AP for MP) lies in its bf16 copy: column n's H values in blocks of 16 k,
// each block ordered as
// the lanes t = 0..3 of an m16n8k16 B fragment take them, (2t, 2t + 1,
// 2t + 8, 2t + 9), so that lane (g, t) reads its two registers b0, b1 of
// column n = n0 + g as one 8-byte word at 4 (n (H / 16) + k / 16) + t.
__host__ __device__ inline int frag_index(int k, int n, int H) {
  const int r = k % 16;
  return ((n * (H / 16) + k / 16) * 4 + r % 8 / 2) * 4 + r / 8 * 2 + r % 2;
}

// The merged weights w (make_layout(D, 2H, A)) as the wide products read them:
//   FW[k][t H + n] = W2c[t H + k][t H + n]   (B of the forward product, both towers)
//   GW[k][t H + n] = W2c[t H + n][t H + k]   (B of the backward product)
//   MP[k][a] = Whc[k][a], MT[a][k] = Whc[k][a] for a < A, zero for A <= a < AP
//   WV[k] = Whc[H + k][A]
// rounded to bf16 where round_w2 (FW, GW) and round_head (MP, MT, WV) say;
// with bf_copy also FWB, FW as bf16 (for round_w2 weights, the same values),
// with bf_head MPB, MP as bf16 (likewise for round_head), and with bf_rows
// W2B in place of FW and GW, which nothing on that path reads.
// The cross-tower blocks of W2c and Whc are zero by construction
// (merge_weights) and stay so under K3's masked update; the products rely on
// it, and a non-zero entry traps.
__global__ void __launch_bounds__(256) wide_prep(const float* __restrict__ w, int D, int H, int A,
                                                 bool round_w2, bool round_head, bool bf_copy,
                                                 bool bf_head, bool bf_rows,
                                                 float* __restrict__ out) {
  const int H2 = 2 * H, A1 = A + 1, AP = wide_ap(A);
  const Layout L = make_layout(D, H2, A);
  const WidePrep P = wide_prep_layout(H, AP);
  const int n_w2 = H2 * H2, n_wh = H2 * A1, n_pad = (AP - A) * H;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_w2 + n_wh + n_pad; i += stride) {
    if (i < n_w2) {
      const int r = i / H2, c = i % H2;
      const float v = w[L.w2 + i];
      if ((r < H) != (c < H)) {
        if (v != 0.0f) __trap();
        continue;
      }
      const float x = round_w2 ? bf16_round(v) : v;
      const int t = r / H, k = r % H, n = c % H;  // W2c[t H + k][t H + n]
      if (bf_rows) {
        reinterpret_cast<__nv_bfloat16*>(out + P.w2b)[(t * H + k) * H + n] =
            __float2bfloat16_rn(x);
        continue;
      }
      out[P.fw + k * H2 + t * H + n] = x;
      out[P.gw + n * H2 + t * H + k] = x;
      if (bf_copy)
        reinterpret_cast<__nv_bfloat16*>(out + P.fwb)[frag_index(k, t * H + n, H)] =
            __float2bfloat16_rn(x);
    } else if (i < n_w2 + n_wh) {
      const int q = i - n_w2, r = q / A1, c = q % A1;
      const float v = w[L.wh + q];
      if ((r < H) != (c < A)) {
        if (v != 0.0f) __trap();
        continue;
      }
      const float x = round_head ? bf16_round(v) : v;
      if (c < A) {
        out[P.mp + r * AP + c] = x;
        out[P.mt + c * H + r] = x;
        if (bf_head)
          reinterpret_cast<__nv_bfloat16*>(out + P.mpb)[frag_index(r, c, H)] =
              __float2bfloat16_rn(x);
      } else {
        out[P.wv + r - H] = x;
      }
    } else {
      const int q = i - n_w2 - n_wh, a = A + q / H, k = q % H;
      out[P.mp + k * AP + a] = 0.0f;
      out[P.mt + a * H + k] = 0.0f;
      if (bf_head)
        reinterpret_cast<__nv_bfloat16*>(out + P.mpb)[frag_index(k, a, H)] =
            __float2bfloat16_rn(0.0f);
    }
  }
}

// One block-wide product C[s][c] = sum over k < K of A[s][off(c) + k] B[k][c],
// for the rows s of A in shared memory (row stride lda) and B [K][NB]
// row-major in global memory, whose rows stream through `slab` ([2][SLAB]
// floats of shared memory) in slabs of ks rows, one in flight while the other
// is read. off(c) = c / tw * tw: with tw = H the columns of tower t read A's
// columns t H.., the block-diagonal product. This thread sums rows s0.. (TS) x
// columns c0.. (TC) into acc if `mine`; every thread of the block must call
// it, and it ends with a block barrier, after which A and the slabs may be
// overwritten. RA rounds A's values to bf16 as they are read. With
// SLAB_SUMS each slab's products are summed apart and then added to acc, so
// a sum of K terms rounds like one of ks + K / ks: the update kernels need
// it to keep the float32 twin's accuracy at hidden 256 (a sum of 256 terms
// in one chain rounds twice as far as the hidden-64 kernel's 64). With AKM
// A is k-major instead, A[off(c) + k][s] at row stride lda: a thread reads
// its TS rows of one k as TS / 4 LDS.128, which the threads of a warp that
// share s0 take as one broadcast; and with CS > 0 (AKM only) the thread's
// TC columns are two runs of TC / 2, c0.. and c0 + CS.., so that lanes whose
// c0 are TC / 2 apart read the slab as consecutive 16-byte pieces (eight
// contiguous columns a lane put two lanes of each quarter-warp on the same
// banks). K and NB are multiples of 4, B's rows 16-byte aligned.
template <int TS, int TC, bool RA, bool SLAB_SUMS = false, bool AKM = false,
          int SLAB = kSlabFloats, int CS = 0>
__device__ __forceinline__ void block_product(const float* A, int lda, int tw,
                                              const float* __restrict__ B, int K, int NB,
                                              float* slab, int s0, int c0, bool mine,
                                              float (&acc)[TS][TC]) {
  static_assert(CS == 0 || (AKM && TC % 8 == 0), "split column runs: k-major A, 4-wide runs");
  int ks = 32;
  while (ks > 4 && (K % ks || ks * NB > SLAB)) ks >>= 1;
  const int n_slabs = K / ks, pieces = ks * NB / 4;
  auto fetch = [&](int sl, float* dst) {
    const float* src = B + (size_t)sl * ks * NB;
    for (int e = threadIdx.x; e < pieces; e += blockDim.x) cp_async16(dst + 4 * e, src + 4 * e);
  };
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.0f;
  const float* a0 = AKM ? A + (c0 / tw * tw) * lda + s0 : A + s0 * lda + c0 / tw * tw;
  fetch(0, slab);
  cp_async_wait_all();
  __syncthreads();
  for (int sl = 0; sl < n_slabs; ++sl) {
    const float* cur = slab + (sl & 1) * SLAB;
    if (sl + 1 < n_slabs) fetch(sl + 1, slab + ((sl + 1) & 1) * SLAB);
    if (mine) {
      const float* ak = a0 + sl * ks * (AKM ? lda : 1);
      const float* bk = cur + c0;
      float part[TS][TC];
      float (&sum)[TS][TC] = SLAB_SUMS ? part : acc;
      if constexpr (SLAB_SUMS) {
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) part[i][c] = 0.0f;
      }
      if constexpr (AKM) {
#pragma unroll 2
        for (int k = 0; k < ks; ++k) {
          float a[TS], b[TC];
          load_row<TS>(ak + k * lda, a);
          if constexpr (CS > 0) {
            float b0[TC / 2], b1[TC / 2];
            load_row<TC / 2>(bk + k * NB, b0);
            load_row<TC / 2>(bk + k * NB + CS, b1);
#pragma unroll
            for (int c = 0; c < TC / 2; ++c) {
              b[c] = b0[c];
              b[TC / 2 + c] = b1[c];
            }
          } else {
            load_row<TC>(bk + k * NB, b);
          }
#pragma unroll
          for (int i = 0; i < TS; ++i) {
            if constexpr (RA) a[i] = bf16_round(a[i]);
#pragma unroll
            for (int c = 0; c < TC; ++c) sum[i][c] = fmaf(a[i], b[c], sum[i][c]);
          }
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < ks; k += 4) {
          if constexpr (TS <= 4) {
            float a[TS][4];
#pragma unroll
            for (int i = 0; i < TS; ++i) {
              load_row<4>(ak + i * lda + k, a[i]);
              if constexpr (RA) {
#pragma unroll
                for (int q = 0; q < 4; ++q) a[i][q] = bf16_round(a[i][q]);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float b[TC];
              load_row<TC>(bk + (k + q) * NB, b);
#pragma unroll
              for (int i = 0; i < TS; ++i)
#pragma unroll
                for (int c = 0; c < TC; ++c) sum[i][c] = fmaf(a[i][q], b[c], sum[i][c]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              float b[TC];
              load_row<TC>(bk + (k + q) * NB, b);
#pragma unroll
              for (int i = 0; i < TS; ++i) {
                float a = ak[i * lda + k + q];
                if constexpr (RA) a = bf16_round(a);
#pragma unroll
                for (int c = 0; c < TC; ++c) sum[i][c] = fmaf(a, b[c], sum[i][c]);
              }
            }
          }
        }
      }
      if constexpr (SLAB_SUMS) {
#pragma unroll
        for (int i = 0; i < TS; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[i][c] += part[i][c];
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// acc[i][j] = sum over the rows s < n of a[s lda + i] g[s ldg + j]: one TK x TN
// tile of an outer-product sum A^T G, both operands in shared memory, 16-byte
// aligned (8-byte where a width is 2). R rounds both to bf16 as they are read.
template <int TK, int TN, bool R>
__device__ __forceinline__ void outer_tile(const float* a, int lda, const float* g, int ldg, int n,
                                           float (&acc)[TK][TN]) {
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int s = 0; s < n; ++s) {
    float x[TK], y[TN];
    load_row<TK>(a + s * lda, x);
    load_row<TN>(g + s * ldg, y);
    if constexpr (R) {
#pragma unroll
      for (int i = 0; i < TK; ++i) x[i] = bf16_round(x[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) y[j] = bf16_round(y[j]);
    }
#pragma unroll
    for (int i = 0; i < TK; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// Launch wide_prep over the merged weights w into out (wide_prep_layout(H,
// wide_ap(A)).total floats).
inline cudaError_t launch_wide_prep(const float* w, int D, int H, int A, bool round_w2,
                                    bool round_head, float* out, cudaStream_t st,
                                    bool bf_copy = false, bool bf_head = false,
                                    bool bf_rows = false) {
  const int n = 4 * H * H + 2 * H * (A + 1) + (wide_ap(A) - A) * H;
  wide_prep<<<(n + 255) / 256, 256, 0, st>>>(w, D, H, A, round_w2, round_head, bf_copy, bf_head,
                                             bf_rows, out);
  return cudaGetLastError();
}
