// Tensor-core products of bf16 tiles held in shared memory, through the
// warp-level wmma fragments of <mma.h> (mma.sync class instructions: no wgmma,
// no TMA): m16n16k16 products of bf16 inputs with float32 sums. With inputs
// rounded to nearest even this is the function the bf16 compute mode defines,
// up to the order of the sums.
//
// A fragment's element order is unspecified, so only uniform elementwise
// operations touch `frag.x[i]`; everything else goes through shared memory
// after store_matrix_sync.
//
// The tensor core adds into its accumulator rounding towards zero, which
// shrinks a sum by a few 2^-24 of its size, every element the same way.
// Under bf16 inputs (2^-9) that is far below the mode's own rounding. It is
// why the float32 mode does not run as split TF32 products here: see the note
// on numerics in ppo_update_kernel.cu.
//
// Below them, mma.sync m16n8k16 by hand in the instruction's fixed register
// layout (mma_16816), and tower_mma: the W2c product of the wide paths under
// bfloat16, shared by the update kernels (ppo_grad_wide) and the policy
// rollout (policy_rollout_wide).

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

constexpr int kMmaK = 16;  // depth of one k-step

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, kMmaK, float>;

template <int NF>
__device__ __forceinline__ void zero_frags(AccFrag (&acc)[NF]) {
#pragma unroll
  for (int f = 0; f < NF; ++f) nvcuda::wmma::fill_fragment(acc[f], 0.0f);
}

// acc[f] += A * B_f for the NF fragments f of one warp, over KSTEPS k-steps of
// depth kMmaK. A is a [16, KSTEPS * kMmaK] tile read with layout LayA and
// leading dimension lda, its k-th slice at A + k * a_kstep; B_f is a
// [KSTEPS * kMmaK, 16] tile read with layout LayB and leading dimension ldb,
// its k-th slice at B + k * b_kstep + f * b_fstep. All pointers are 32-byte
// aligned shared-memory addresses, the leading dimensions multiples of 8.
template <typename LayA, typename LayB, int NF, int KSTEPS>
__device__ __forceinline__ void mma_tiles(const __nv_bfloat16* __restrict__ A, int lda,
                                          int a_kstep, const __nv_bfloat16* __restrict__ B,
                                          int ldb, int b_kstep, int b_fstep,
                                          AccFrag (&acc)[NF]) {
  namespace wmma = nvcuda::wmma;
  wmma::fragment<wmma::matrix_a, 16, 16, kMmaK, __nv_bfloat16, LayA> a;
  wmma::fragment<wmma::matrix_b, 16, 16, kMmaK, __nv_bfloat16, LayB> b;
#pragma unroll 2
  for (int k = 0; k < KSTEPS; ++k) {
    wmma::load_matrix_sync(a, A + k * a_kstep, lda);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      wmma::load_matrix_sync(b, B + k * b_kstep + f * b_fstep, ldb);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
}

// One mma.sync m16n8k16 with bf16 inputs and float32 sums, c += A B, in the
// instruction's own register layout (lane = 4 g + t): a[0..3] hold A's
// (row g, columns 2t, 2t + 1), (g + 8, 2t..), (g, 2t + 8..), (g + 8,
// 2t + 8..), two bf16 a register, the lower column in the low half; b0, b1
// hold B's (rows 2t, 2t + 1; column g) and (2t + 8, 2t + 9; g); c[0..3] are
// C's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Unlike a wmma
// fragment this layout is fixed, so a fragment can be built in registers
// from float32 values (pack_bf16x2) and a result used where it lands.
__device__ __forceinline__ void mma_16816(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to nearest bf16 and packed, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// acc[i][f] += A_i * B_f over one k-step of depth kMmaK for a warp's MF x NF
// grid of tiles: A_i is the [16, kMmaK] tile at A + i * a_fstep (layout
// LayA, leading dimension lda), B_f the [kMmaK, 16] tile at B + f * b_fstep
// (LayB, ldb). Each operand tile is loaded once for the whole grid. Alignment
// as mma_tiles.
template <typename LayA, typename LayB, int MF, int NF>
__device__ __forceinline__ void mma_grid(const __nv_bfloat16* __restrict__ A, int lda,
                                         int a_fstep, const __nv_bfloat16* __restrict__ B,
                                         int ldb, int b_fstep, AccFrag (&acc)[MF][NF]) {
  namespace wmma = nvcuda::wmma;
  wmma::fragment<wmma::matrix_a, 16, 16, kMmaK, __nv_bfloat16, LayA> a[MF];
  wmma::fragment<wmma::matrix_b, 16, 16, kMmaK, __nv_bfloat16, LayB> b[NF];
#pragma unroll
  for (int i = 0; i < MF; ++i) wmma::load_matrix_sync(a[i], A + i * a_fstep, lda);
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::load_matrix_sync(b[f], B + f * b_fstep, ldb);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::mma_sync(acc[i][f], a[i], b[f], acc[i][f]);
}

// A pair of adjacent entries of an A operand as one bf16x2 register: float32
// activations rounded to nearest even as they are read, or bf16 ones as they
// lie. p is 8-byte (float) or 4-byte (bf16) aligned.
__device__ __forceinline__ unsigned bf16_pair(const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  return pack_bf16x2(x.x, x.y);
}

__device__ __forceinline__ unsigned bf16_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Under bfloat16 at hidden 64 and above the wide paths' W2c products run on
// the tensor cores (tower_mma); at hidden 32 a warp's share of the columns
// would be half an mma tile, and they stay FMA.
template <int H2, bool BF>
inline constexpr bool kWideMma = BF && H2 >= 128;

// A W2c product of a wide path on the tensor cores, for a CTA of 16 warps:
// acc = A x B per tower for MT m16 tiles of rows (16 MT samples or envs) and
// this warp's H2 / 16 columns n0.. (H2 / 128 n8 tiles; warps 0-7 take the
// policy tower), summed over its tower's H rows in k-steps of 16 by mma.sync
// m16n8k16 (bf16 inputs, float32 sums). A is [16 MT][lda] in shared memory,
// float32 activations rounded to bf16 in registers as they are read (which
// is what the mode's rounding of the products' inputs defines) or bf16 ones;
// lda = H2 + 8 elements, so that a half-warp's reads of rows g and columns 2t
// fall on distinct banks. B is wide_prep's fragment-ordered bf16 copy (FWB,
// GWB; frag_index), one 8-byte load a lane and n8 tile, from L2. No barrier:
// a warp reads only its own columns of B, and nothing writes A meanwhile.
// acc[m][f] holds the entries in mma_16816's C layout: rows 16 m + g
// (+ 8), columns n0 + 8 f + 2t (+ 1).
template <int H2, int MT, typename TA>
__device__ __forceinline__ void tower_mma(const TA* A, int lda, const uint2* __restrict__ B,
                                          float (&acc)[MT][H2 / 128][4]) {
  constexpr int H = H2 / 2, NT = H2 / 128, KB = H / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = warp * (H2 / 16), k0 = n0 / H * H;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int f = 0; f < NT; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][f][e] = 0.0f;
  const uint2* b = B + (n0 + g) * KB * 4 + t;
  const TA* a = A + g * lda + k0 + 2 * t;
#pragma unroll
  for (int kb = 0; kb < KB; ++kb) {
    uint2 bf[NT];
#pragma unroll
    for (int f = 0; f < NT; ++f) bf[f] = __ldg(b + (f * 8 * KB + kb) * 4);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const TA* q = a + m * 16 * lda + kb * 16;
      const unsigned af[4] = {bf16_pair(q), bf16_pair(q + 8 * lda), bf16_pair(q + 8),
                              bf16_pair(q + 8 * lda + 8)};
#pragma unroll
      for (int f = 0; f < NT; ++f) mma_16816(acc[m][f], af, bf[f].x, bf[f].y);
    }
  }
}

// Calls fn(row, column, value) for each entry of tower_mma's result held by
// this thread.
template <int H2, int MT, typename Fn>
__device__ __forceinline__ void tower_mma_out(const float (&acc)[MT][H2 / 128][4], Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = warp * (H2 / 16);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int f = 0; f < H2 / 128; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fn(16 * m + g + e / 2 * 8, n0 + 8 * f + 2 * t + e % 2, acc[m][f][e]);
}
