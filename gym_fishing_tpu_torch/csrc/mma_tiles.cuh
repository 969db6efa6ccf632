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
