// Tensor-core products of bf16 tiles held in shared memory, through the
// warp-level wmma fragments of <mma.h> (mma.sync class instructions, no
// wgmma): m16n16k16 products of bf16 inputs with float32 sums. With inputs
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
// layout (mma_16816); warpgroup products on wgmma from swizzled shared memory
// (wgmma_bf16_mn, for dw2c_split under bfloat16); tower_mma: the W2c product
// of the policy rollout's wide path under bfloat16 (policy_rollout_wide),
// its B operand from L2; and tower_mma_smem: the update kernels' two W2c
// products under bfloat16 (ppo_grad_tower), from one tower's block resident
// in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

// Warpgroup products (wgmma, sm_90a) of bf16 operands held in shared memory
// MN-major (A's M index and B's N index contiguous, as a [samples][columns]
// tile of activations lies: both operands transposed in wgmma's terms) in
// boxes of 64 elements x 128-byte rows under the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte aligned box): 8-row groups
// 1024 bytes apart along K, 64-element blocks `lbo` bytes apart along M or
// N. wgmma_bf16_mn<N>: the warpgroup's m64 x N float32 tile d (N / 2
// registers a thread) += A^T B over one k-step of 16 samples, or = A^T B
// with accumulate = 0; warp w of the warpgroup holds rows 16 w + g (+ 8) and
// columns 8 j + 2 t (+ 1) at d[4 j + 2 h + e], lane 4 g + t (mma_16816's C
// layout, n8 tile by n8 tile). Between wgmma_fence and wgmma_wait_all the
// accumulators belong to the tensor cores.
__device__ __forceinline__ uint64_t wgmma_desc_mn128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;   // layout type 1: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16_mn<64>(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16_mn<128>(float (&d)[64], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
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
// the tensor cores (tower_mma in K4, tower_mma_smem in K2/K3); at hidden 32 a
// warp's share of the columns would be half an mma tile, and they stay FMA.
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
// fall on distinct banks. B is wide_prep's fragment-ordered bf16 copy (FWB;
// frag_index), one 8-byte load a lane and n8 tile, from L2. No barrier:
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

// ldmatrix: two or four 8 x 8 bf16 matrices from shared memory, lane l giving
// the address of row l % 8 of matrix l / 8 (lanes 0-15 for two). Lane 4 g + t
// receives row g, columns 2t and 2t + 1 of each matrix (the lower column in
// the low half), or with .trans column g, rows 2t and 2t + 1: an mma.sync B
// fragment from a matrix stored n-major, or from one stored k-major.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// Where entry (k, n) of one tower's [H][H] block lies in its resident bf16
// copy: row k at k H, its 16-byte pieces of 8 columns swizzled, piece c at
// c ^ (k % 8), so that the 8 rows of an ldmatrix matrix, 8 consecutive k at
// one piece, fall on the 8 distinct 16-byte bank groups.
template <int H>
__device__ __forceinline__ int tower_swz(int k, int n) {
  return k * H + (((n >> 3) ^ (k & 7)) << 3) + (n & 7);
}

// A W2c product of the update kernels on the tensor cores, for a CTA of 16
// warps that holds one tower: acc = A x B for this warp's m16 tile of rows
// (16 (warp / 8).., samples) and its H / 8 columns n0 = (warp % 8) H / 8..
// (H / 64 n8 tiles), summed over the tower's H rows of B in k-steps of 16
// by mma.sync m16n8k16 (bf16 inputs, float32 sums), the k-steps in order,
// as tower_mma sums them. A is [32][lda] bf16 in shared memory (the
// activations as the mode rounds them), read through ldmatrix; lda = H + 8,
// so that the 8 rows of a matrix fall on distinct 16-byte bank groups. B is
// the tower's W2c block W[k][n] = W2c[tH + k][tH + n] as bf16 in shared
// memory (tower_swz), read through ldmatrix: the forward product h1 W (B =
// W, through .trans) and, with BACKWARD, g_p2 W^T (B[k][n] = W[n][k], the
// same copy read straight). No barrier: nothing writes A or B meanwhile.
// acc[f] holds the entries in mma_16816's C layout: rows 16 (warp / 8) + g
// (+ 8), columns n0 + 8 f + 2t (+ 1).
template <int H, bool BACKWARD>
__device__ __forceinline__ void tower_mma_smem(const __nv_bfloat16* A, int lda,
                                               const __nv_bfloat16* B, float (&acc)[H / 64][4]) {
  constexpr int NT = H / 64, KB = H / 16;
  static_assert(NT == 1 || NT % 2 == 0, "n8 tiles in pairs");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = (warp & 7) * (H / 8);
  // this lane's ldmatrix row: of A, matrix mi = lane / 8 (rows + 8 (mi % 2),
  // columns + 8 (mi / 2): a0..a3), row r = lane % 8; of B, matrix mi (its k
  // half mi % 2 and n8 tile mi / 2 of a pair), row r
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int f = 0; f < NT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.0f;
  const __nv_bfloat16* a = A + ((warp >> 3) * 16 + (mi & 1) * 8 + r) * lda + (mi >> 1) * 8;
#pragma unroll 4
  for (int kb = 0; kb < KB; ++kb) {
    unsigned af[4];
    ldsm_x4<false>(af, a + kb * 16);
#pragma unroll
    for (int f = 0; f < NT; f += 2) {
      // forward: row k of W, piece of column n; backward: row n (an output
      // column) of W, piece of k
      const int k = kb * 16 + (mi & 1) * 8, n = n0 + 8 * (f + (mi >> 1));
      const __nv_bfloat16* src = BACKWARD ? B + tower_swz<H>(n + r, k) : B + tower_swz<H>(k + r, n);
      if constexpr (NT == 1) {
        unsigned b[2];
        ldsm_x2<!BACKWARD>(b, src);
        mma_16816(acc[f], af, b[0], b[1]);
      } else {
        unsigned b[4];
        ldsm_x4<!BACKWARD>(b, src);
        mma_16816(acc[f], af, b[0], b[1]);
        mma_16816(acc[f + 1], af, b[2], b[3]);
      }
    }
  }
}

// Calls fn(row, column, value) for each entry of tower_mma_smem's result
// held by this thread.
template <int H, typename Fn>
__device__ __forceinline__ void tower_mma_smem_out(const float (&acc)[H / 64][4], Fn fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 3) * 16, n0 = (warp & 7) * (H / 8);
#pragma unroll
  for (int f = 0; f < H / 64; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) fn(m0 + g + e / 2 * 8, n0 + 8 * f + 2 * t + e % 2, acc[f][e]);
}
