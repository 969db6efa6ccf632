// Fused PPO minibatch gradient (K2) and gradient + clip + Adam (K3), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels gym_fishing_tpu/kernels/ppo_update_kernel.py::
// _ppo_grad_kernel (body _grad_tile) and ::_ppo_grad_adam_kernel. The Python
// wrappers are gym_fishing_tpu_torch/kernels/ppo_update_kernel.py::
// fused_minibatch_grad and ::fused_minibatch_grad_adam; their plain PyTorch
// twins there are fused_minibatch_grad_reference and
// fused_minibatch_grad_adam_reference.
//
// What it computes, per visited tile of the feature-major sample matrix
// data[R, N] (rows: obs[D], action[na], old logp, old value, advantage,
// return, zero padding; R = 8, 16 or 24, the fields' count rounded up to a
// multiple of 8): the merged block-diagonal actor-critic forward
//   h1 = tanh(W1c^T x + b1c), h2 = tanh(W2c^T h1 + b2c), out = Whc^T h2 + bhc
// (W1c [D, 2H], W2c [2H, 2H], Whc [2H, A+1]; rows of out: policy mean or
// logits, then the value), the Gaussian or categorical log-prob, the clipped
// surrogate and clipped value loss, and the hand-derived backward, summed into
// the 7 merged gradient buffers and 4 metric sums.
//
// What bounds it on this card: operations, not bytes. The three
// 2H-contractions (forward through W2c, dW2c, and the gradient into h1) are
// nearly all of the work against 32 bytes of input a sample. The TPU kernel
// runs them on the merged [2H, 2H] matrix because that is its matrix unit's
// shape; W2c's cross-tower blocks are zero and no parameter, so here each
// product runs per tower over H: 3 x 2 x 128 x 64 = 49,152 FLOP a sample at
// hidden = 64, 1.3e10 FLOP for a minibatch of 2^18 samples against 8 MB. What
// stays beside the products is float32 work of the same order: 2 x 2H tanhf
// per sample, the (A+1)-wide head and its backward, and the loss.
//
// What the design does about it:
// - Stage 1: kSplit CTAs of 512 threads (16 warps) per visited tile
//   (tile_order picks the tile, so shuffling stays zero-copy); each CTA takes
//   a contiguous share of the tile's chunks of 64 samples, whose float32
//   activations stay in shared memory (the tanh derivatives use the
//   unrounded values). A chunk takes 5 block barriers under bf16 and 6 under
//   float32; the next chunk's R rows of samples are copied into the other
//   half of a double buffer with cp.async while this one computes, so the
//   row count costs no registers.
//   * compute = bfloat16: the three products run on the tensor cores through
//     the wmma fragments of mma_tiles.cuh, bf16 inputs with float32 sums. One
//     copy of W2c sits in shared memory as bf16: the forward product reads
//     it row-major and the backward product g_p1 = g_p2 W2c^T reads the same
//     buffer column-major. The thread that produces h1 or g_p2 also writes
//     the rounded copy the products read. A warp owns a [16, 2H/4] tile of
//     each activation product and applies the bias, tanh or tanh derivative
//     to its own tile after store_matrix_sync; dW2c stays in accumulator
//     fragments over all chunks.
//   * compute = float32: the products are float32 FMA, register-tiled
//     (4 samples x 4 outputs a thread for the activation products, 4 x 4 of a
//     dW2c block a thread, kept over all chunks), reading the towers' blocks
//     of W2c and of its transpose (together the size of one merged copy).
//     The note on numerics says why not the tensor cores.
//   * both: the head, its backward and the loss are float32 FMA: a warp
//     takes 4 samples of the chunk for the head, 8 lanes a sample, and 4 of
//     its lanes their loss, whose sums stay in shared memory. Column sums
//     (db1c, db2c, dW1c) accumulate in registers of threads that keep one
//     column for the whole tile. 128 registers a thread is all that 512
//     threads leave, so the loss recomputes the class probabilities instead
//     of keeping them.
//   Above kMaxD observation fields (the BIGD instantiations, for windows of
//   stacked observations) the threads own dW1c's D x 2H entries instead, and
//   after one more barrier each adds its entries' share of the chunk from
//   g_p1 and x in shared memory; W1c is then read from L2.
//   Each CTA writes its partial gradients and metric sums to a workspace row
//   [G * kSplit, P + 4].
//   That plan holds hidden 32 and 64 with at most 16 logits. Hidden 128 and
//   256, and categorical heads of up to 128 classes at any hidden size, take
//   the wide path: the same grid and workspace rows, chunks of 32 samples,
//   and h1 and g_p2 written out once, for dW2c as a split-K product over the
//   whole minibatch (dw2c_split) into the dW2c blocks of the rows.
//   * float32, and bfloat16 at hidden 32: ppo_grad_wide (below). Only the
//     activations stay in shared memory; every weight matrix streams from
//     L2 (FMA products through block_product's slabs), and dWhc is added
//     chunk by chunk into the CTA's own workspace row.
//   * bfloat16 at hidden 64 and above: ppo_grad_tower (below). What bounded
//     ppo_grad_wide there was W2c: both towers' blocks do not fit a CTA
//     beside the activations, so every chunk read them from L2 for its two
//     tensor-core products (512 KiB a chunk at hidden 256, ~30k of the
//     chunk's 72k cycles). The towers are independent in stage 1, so a
//     tile's two CTAs become its two towers: each keeps its tower's W2c
//     block (128 KiB bf16 at hidden 256) resident in shared memory for all
//     the tile's chunks, and both products read it through ldmatrix. The
//     tower split costs the per-chunk work that does not shrink with the
//     tower's width (the loss, the head's dots, the chunk's barriers), now
//     run once a tower, and the two CTAs of a tile do unequal work (the
//     policy tower carries the head), so the policy CTAs are launched
//     first. A categorical head's Wm does not fit beside the block either:
//     its two products stream Wm and Wm^T through two slabs in the
//     activation buffer that the head leaves free, each element read from
//     L2 once a chunk, and dWhc is summed over the tile in an aligned
//     float32 copy, each entry read, added and written by one thread in
//     16-byte pieces.
// - Stage 2: one thread per gradient entry sums the rows in index order, in
//   blocks of 16 rows and then the blocks. No float atomics anywhere, so two
//   identical steps give identical bits. The column sums of stage 1 (db1c,
//   db2c, dW1c) likewise add each chunk's share to their running sums once.
// - Stage 3 (K3 only): the masked global norm, the clip and Adam over the
//   merged parameters as a grid-wide pass of two launches (clip_norm_parts,
//   clip_adam_apply): per-CTA partial sums of squares, then every CTA sums
//   them in one fixed order and updates its run.
//
// Numerics: float32 IEEE arithmetic (FMA contraction allowed, no
// --use_fast_math). compute = bfloat16: product inputs rounded with
// __float2bfloat16_rn (W2c once, h1 and g_p2 per chunk), as the TPU kernel's
// bf16 inputs with f32 accumulation. compute = float32 uses no TF32: a single
// TF32 pass keeps three digits, and the split product
// lo_a hi_b + hi_a lo_b + hi_a hi_b (hi = tf32(a), lo = tf32(a - hi)) was
// built and measured on the H100 and not kept. The tensor core adds into its
// accumulator rounding towards zero, so every h2 comes out a few 2^-24
// small, the value head inherits the shrink, and the value tower's gradients,
// sums of (value - return) terms that cancel over the samples, collect it:
// their error against float64 was 2-5 times the float32 twin's, and it went
// back to the twin's own when the forward product alone ran as FMA. With
// W2c's zero blocks skipped the FMA products were also the faster ones.
// The cross-tower blocks of W2c must be zero, as merge_weights builds them
// and K3's masked update keeps them: stage 1 traps on any other input.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "merged_mlp.cuh"
#include "mma_tiles.cuh"
#include "tma_ring.cuh"
#include "wide_mlp.cuh"

struct GradParams {
  float clip_eps, vf_coef, inv_n, ent_coef;
  int obs_dim, act_dim, head, compute, hidden, tile, num_tiles, rows;
  long long n_cols;
};
static_assert(sizeof(GradParams) == 56, "GradParams layout must match ctypes");

struct AdamParams {
  float lr, bc1, bc2, max_grad_norm, beta1, beta2, one_minus_b1, one_minus_b2, adam_eps, pad0;
};
static_assert(sizeof(AdamParams) == 40, "AdamParams layout must match ctypes");

// Indices into the Python tuples HEADS and COMPUTES.
enum { GAUSSIAN = 0, CATEGORICAL = 1 };
enum { FLOAT32 = 0, BFLOAT16 = 1 };

#define LOG_2PI_F 1.8378770664093453f

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // samples per chunk
constexpr int kSplit = 2;   // CTAs (workspace rows) per visited tile
constexpr int kMaxRows = 24;  // rows of the packed matrix: 8, 16 or 24
// obs_dim: at most kMaxObsD (one action column and the 4 fixed rows in
// kMaxRows). Up to kMaxD each thread keeps its column's dW1c sums in
// registers; above it (the BIGD instantiations) threads own entries of the
// [D][2H] block instead, and W1c is read from L2 rather than shared memory.
constexpr int kMaxD = 4;
constexpr int kMaxObsD = kMaxRows - 5;
constexpr int kMaxA = 16;   // logits width of ppo_grad_tiles (the wide path: kWideMaxA)
constexpr int kMaxA1 = kMaxA + 1;
constexpr int kMaxGaussA = kMaxA;  // Gaussian action columns: D + A + 4 <= kMaxRows
constexpr int kSPW = kChunk / kWarps;  // samples per warp in the head and the loss
constexpr int kMet = 4 + kMaxGaussA;  // floats per loss thread: 4 metric sums, then dlog_std
static_assert(kChunk == 64 && kWarps == 16, "the tiling of the products assumes 4 x 4 warps");
static_assert(4 + kMaxGaussA <= 32 && kSPW * 8 == 32, "loss threads");

constexpr size_t align_up(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory plan of stage 1: byte offsets of the aligned regions, then
// float offsets inside the last one.
template <int H2, bool BF>
struct Smem {
  static constexpr int H = H2 / 2;
  static constexpr int LD = kActLD<H2>;  // row stride of a float32 activation buffer
  static constexpr int LDB = H2 + 8;     // bf16: row stride of W2c and of the rounded copies
  static constexpr int LDT = H + 4;      // float32: row stride of a tower's block
  // bf16: W2c as bf16 [H2][LDB]. float32: the towers' blocks of W2c, float
  // [2][H][LDT], then of its transpose, the same shape.
  static constexpr size_t W2 = 0;
  static constexpr size_t W2_BYTES = BF ? 2 * H2 * LDB : sizeof(float) * 4 * H * LDT;
  static constexpr size_t ACT = align_up(W2 + W2_BYTES);  // float [3][kChunk][LD]
  // bf16 only: bf16 [2][kChunk][LDB], the rounded h1 and g_p2
  static constexpr size_t RND = align_up(ACT + sizeof(float) * 3 * kChunk * LD);
  static constexpr size_t REST = align_up(RND + (BF ? 2 * 2 * kChunk * LDB : 0));
  static constexpr int WH = 0;                       // [A1][H2], Whc transposed
  static constexpr int DWH = WH + kMaxA1 * H2;       // [2][A1][H2] accumulators, by chunk half
  static constexpr int BH = DWH + 2 * kMaxA1 * H2;
  static constexpr int DBH = BH + 32;                // dbhc accumulators
  static constexpr int LS = DBH + 32;
  static constexpr int IV = LS + 32;                 // exp(-2 log_std)
  static constexpr int W1 = IV + 32;                 // [kMaxD][H2]
  static constexpr int B1 = W1 + kMaxD * H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int MET = B2 + H2;                // [kChunk][kMet]: the loss threads' sums
  static constexpr int X = MET + kChunk * kMet;      // [2][kMaxRows][kChunk], double-buffered
  static constexpr int OUT = X + 2 * kMaxRows * kChunk; // [kChunk][kMaxA1]
  static constexpr int GTOP = OUT + kChunk * kMaxA1; // [kChunk][kMaxA1]
  static constexpr int N_REST = GTOP + kChunk * kMaxA1;
  static constexpr size_t BYTES = REST + sizeof(float) * N_REST;
  // after the last chunk the activation buffers hold dW2c [H2][LD], then the
  // per-thread partial column sums
  static constexpr int SCR_B2 = H2 * LD, SCR_B1 = SCR_B2 + kThreads, SCR_W1 = SCR_B1 + kThreads;
  static_assert(SCR_W1 + kMaxD * kThreads <= 3 * kChunk * LD, "scratch exceeds the activations");
  static_assert(kMaxA1 <= 32 && kMaxA <= 32, "bhc and log_std slots");
};
static_assert(Smem<128, false>::BYTES <= 232448 && Smem<128, true>::BYTES <= 232448,
              "stage 1 exceeds the shared memory of a CTA");

// Float32 FMA product of a chunk's activations with one tower's block:
// acc[i][c] = sum over the tower's H2 / 2 rows j of A[s0 + i][k0 + j] *
// Bt[tower][j][c0 - k0 + c], for 4 samples and H2 / 32 columns of this
// thread, k0 the first column of c0's tower. A is [samples][kActLD<H2>], Bt
// the towers' blocks [2][H2 / 2][ldt].
template <int H2>
__device__ __forceinline__ void tower_product(const float* __restrict__ A,
                                              const float* __restrict__ Bt, int ldt, int s0,
                                              int c0, float (&acc)[4][H2 / 32]) {
  constexpr int LD = kActLD<H2>, CPT = H2 / 32, H = H2 / 2;
  const int k0 = c0 < H ? 0 : H;
  const float* a0 = A + s0 * LD + k0;
  const float* b0 = Bt + k0 * ldt + (c0 - k0);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.0f;
#pragma unroll 2
  for (int j = 0; j < H; j += 4) {
    float a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load_row<4>(a0 + i * LD + j, a[i]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float b[CPT];
      load_row<CPT>(b0 + (j + q) * ldt, b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i][q], b[c], acc[i][c]);
    }
  }
}

// BIGD: obs_dim above kMaxD (see kMaxObsD). The shared-memory plan is the
// same; W1c's region there stays unused.
template <int H2, bool BF, bool BIGD>
__global__ void __launch_bounds__(kThreads, 1)
    ppo_grad_tiles(const GradParams p, const float* __restrict__ data,
                   const int* __restrict__ order, const float* __restrict__ w,
                   const float* __restrict__ adv_stats, float* __restrict__ ws) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ __align__(128) unsigned char smem[];
  using S = Smem<H2, BF>;
  // W2c is block diagonal (policy tower, value tower), so every product runs
  // per tower over H = H2 / 2: half the work of the merged matrix.
  constexpr int H = H2 / 2, LD = S::LD, LDB = S::LDB, LDT = S::LDT;
  constexpr int SSTEP = kThreads / H2;  // sample stride of a thread in the elementwise passes
  constexpr int EPT = kChunk / SSTEP;   // its samples per chunk
  // bf16: the warps tile an activation product 4 x 4
  constexpr int CW = H2 / 4;     // columns of a warp's tile
  constexpr int NF = CW / 16;    // its 16-wide fragments
  constexpr int RG = 32 / CW;    // lanes that share a column of that tile
  constexpr int RPL = 16 / RG;   // rows per lane there
  constexpr int NW2 = H / 32;    // a warp's tile of a dW2c block is 1 x NW2 fragments
  constexpr int WPT = (H / 16) * (H / 16) / NW2;  // warps that share one tower's block
  // float32: a thread's tile of an activation product is 4 samples x CPT
  // columns, and of a dW2c block 4 x 4 (at hidden = 32 a quarter of the threads)
  constexpr int CPT = H2 / 32;
  constexpr int T = H / 4, T2 = T * T;
  static_assert(CW % 16 == 0 && 32 % CW == 0 && 4 * RG == SSTEP && H % CW == 0 &&
                    2 * WPT <= kWarps && 2 * T2 <= kThreads,
                "tiling");

  float* sH1 = reinterpret_cast<float*>(smem + S::ACT);
  float* sB = sH1 + kChunk * LD;   // h2, then the backward product before its derivative
  float* sG = sB + kChunk * LD;    // g_p2
  __nv_bfloat16* bW2 = reinterpret_cast<__nv_bfloat16*>(smem + S::W2);   // bf16 only
  __nv_bfloat16* bH1 = reinterpret_cast<__nv_bfloat16*>(smem + S::RND);  // bf16 only
  __nv_bfloat16* bG = bH1 + kChunk * LDB;                                // bf16 only
  float* fW2 = reinterpret_cast<float*>(smem + S::W2);  // float32 only
  float* fW2T = fW2 + 2 * H * LDT;                      // float32 only
  float* rest = reinterpret_cast<float*>(smem + S::REST);
  float* sWhT = rest + S::WH;
  float* sdWh = rest + S::DWH;
  float* sbh = rest + S::BH;
  float* sdbh = rest + S::DBH;
  float* sls = rest + S::LS;
  float* siv = rest + S::IV;
  float* sW1 = rest + S::W1;
  float* sb1 = rest + S::B1;
  float* sb2 = rest + S::B2;
  float* sMet = rest + S::MET;
  float* sX = rest + S::X;
  float* sOut = rest + S::OUT;
  float* sGtop = rest + S::GTOP;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.obs_dim, A = p.act_dim, A1 = A + 1;
  const bool gauss = p.head == GAUSSIAN;
  const int na = gauss ? A : 1;
  const Layout L = make_layout(D, H2, A);
  const long long N = p.n_cols;
  const int tile_idx = order[blockIdx.x / kSplit];
  if (tile_idx < 0 || (long long)(tile_idx + 1) * p.tile > N) __trap();
  // this CTA's share of the tile's chunks
  const int part = blockIdx.x % kSplit, n_chunks = p.tile / kChunk;
  const int c_begin = part * n_chunks / kSplit, c_end = (part + 1) * n_chunks / kSplit;
  const long long base = (long long)tile_idx * p.tile;

  for (int i = tid; i < H2 * H2; i += kThreads) {
    const float v = w[L.w2 + i];
    const int r = i / H2, c = i % H2;
    if ((r < H) != (c < H)) {
      // the cross-tower blocks are zero by construction (merge_weights) and
      // stay so under K3's masked update; the products rely on it
      if (v != 0.0f) __trap();
      if constexpr (BF) bW2[r * LDB + c] = __float2bfloat16_rn(0.0f);
    } else if constexpr (BF) {
      bW2[r * LDB + c] = __float2bfloat16_rn(v);
    } else {
      // block [tower][row in tower][column in tower]; r is tower * H + row
      fW2[r * LDT + c % H] = v;
      fW2T[(r / H * H + c % H) * LDT + r % H] = v;
    }
  }
  for (int i = tid; i < H2 * A1; i += kThreads) sWhT[(i % A1) * H2 + i / A1] = w[L.wh + i];
  for (int i = tid; i < 2 * kMaxA1 * H2; i += kThreads) sdWh[i] = 0.0f;
  if constexpr (!BIGD)
    for (int i = tid; i < D * H2; i += kThreads) sW1[i] = w[L.w1 + i];
  const float* w1 = BIGD ? w + L.w1 : sW1;
  for (int i = tid; i < H2; i += kThreads) {
    sb1[i] = w[L.b1 + i];
    sb2[i] = w[L.b2 + i];
  }
  for (int i = tid; i < kChunk * kMet; i += kThreads) sMet[i] = 0.0f;
  for (int i = tid; i < A1; i += kThreads) {
    sbh[i] = w[L.bh + i];
    sdbh[i] = 0.0f;
  }
  for (int i = tid; i < A; i += kThreads) {
    sls[i] = w[L.ls + i];
    siv[i] = expf(-2.0f * w[L.ls + i]);
  }
  const float adv_mu = adv_stats[0], adv_inv_std = adv_stats[1];
  const float eps = p.clip_eps, inv_n = p.inv_n;
  const float g_value_scale = p.vf_coef * inv_n, ent_scale = p.ent_coef * inv_n;

  // The elementwise passes: this thread keeps column ecol and the samples
  // es0, es0 + SSTEP, ... of every chunk.
  const int ecol = tid % H2, es0 = tid / H2;
  // bf16, the activation products: this warp's tile is rows trow.. (16
  // samples) by columns tcol.. (CW), of the tower whose first row of W2c is
  // tk0; afterwards lane keeps column pcol, rows prow.. (RPL).
  const int trow = (warp / 4) * 16, tcol = (warp % 4) * CW, tk0 = tcol < H ? 0 : H;
  const int pcol = tcol + lane % CW, prow = trow + (lane / CW) * RPL;
  // bf16, dW2c: this warp's NW2 fragments of its tower's block start at row
  // wrow, column wcol (at hidden = 32 the blocks are 8 fragments for 16 warps)
  const bool w2_warp = warp < 2 * WPT;
  const int wrow = warp / WPT * H + (warp % WPT / 2) * 16;
  const int wcol = warp / WPT * H + (warp % WPT % 2) * NW2 * 16;
  // float32, the activation products: samples fs0.. (4) by columns fc0.. (CPT)
  const int fs0 = warp * 4, fc0 = lane * CPT;
  // float32, dW2c: rows fj0.. (4) by columns fk0.. (4) of this thread's tower
  const bool w2_thread = tid < 2 * T2;
  const int fj0 = tid / T2 * H + (tid % T2 / T) * 4, fk0 = tid / T2 * H + (tid % T) * 4;

  // accumulators that persist over the chunks (the loss threads' sums and
  // dWhc, dbhc are in shared memory); of the two for dW2c a mode uses one
  AccFrag acc_w2[NW2];
  float facc_w2[4][4];
  if constexpr (BF) {
    zero_frags(acc_w2);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) facc_w2[i][c] = 0.0f;
  }
  float acc_b1 = 0.0f, acc_b2 = 0.0f;
  // dW1c: this thread's column's D sums, or under BIGD the entries tid,
  // tid + kThreads, ... of the [D][H2] block
  constexpr int NW1 = BIGD ? (kMaxObsD * H2 + kThreads - 1) / kThreads : kMaxD;
  float acc_w1[NW1];
#pragma unroll
  for (int k = 0; k < NW1; ++k) acc_w1[k] = 0.0f;

  // a chunk's packed samples [R][kChunk] into dst: element e is row
  // e / kChunk, sample e % kChunk, and this thread copies e = tid, tid +
  // kThreads, ...
  const int n_elems = p.rows * kChunk;
  auto fetch = [&](int chunk, float* dst) {
    const float* src = data + base + (long long)chunk * kChunk;
    for (int e = tid; e < n_elems; e += kThreads)
      cp_async4(dst + e, src + (long long)(e / kChunk) * N + e % kChunk);
  };
  if (c_begin < c_end) fetch(c_begin, sX);
  cp_async_wait_all();
  __syncthreads();

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const float* x = sX + ((chunk - c_begin) & 1) * (kMaxRows * kChunk);
    float* x_next = sX + ((chunk - c_begin + 1) & 1) * (kMaxRows * kChunk);
    // the next chunk's samples, in flight until the chunk's last barrier
    if (chunk + 1 < c_end) fetch(chunk + 1, x_next);

    // h1 = tanh(W1c^T x + b1c)
#pragma unroll 2
    for (int e = 0; e < EPT; ++e) {
      const int s = es0 + e * SSTEP;
      float z = 0.0f;
      for (int d = 0; d < D; ++d) z = fmaf(w1[d * H2 + ecol], x[d * kChunk + s], z);
      const float h = tanhf(z + sb1[ecol]);
      sH1[s * LD + ecol] = h;
      if constexpr (BF) bH1[s * LDB + ecol] = __float2bfloat16_rn(h);
    }
    __syncthreads();

    // h2 = tanh(W2c^T h1 + b2c)
    if constexpr (BF) {
      AccFrag acc[NF];
      zero_frags(acc);
      mma_tiles<wmma::row_major, wmma::row_major, NF, H / kMmaK>(
          bH1 + trow * LDB + tk0, LDB, kMmaK, bW2 + tk0 * LDB + tcol, LDB, kMmaK * LDB, 16, acc);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        wmma::store_matrix_sync(sB + trow * LD + tcol + f * 16, acc[f], LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll 2
      for (int r = 0; r < RPL; ++r) {
        float* h = sB + (prow + r) * LD + pcol;
        *h = tanhf(*h + sb2[pcol]);
      }
    } else {
      float acc[4][CPT];
      tower_product<H2>(sH1, fW2, LDT, fs0, fc0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          sB[(fs0 + i) * LD + fc0 + c] = tanhf(acc[i][c] + sb2[fc0 + c]);
    }
    __syncthreads();

    // heads: out[s][a] = Whc[:, a] . h2[s] + bhc[a] for the warp's kSPW
    // samples, 8 lanes a sample
    {
      const int s = warp * kSPW + lane / 8, kk = lane % 8;
      for (int a = 0; a < A1; ++a) {
        float z = 0.0f;
#pragma unroll 4
        for (int k = kk; k < H2; k += 8) z = fmaf(sWhT[a * H2 + k], sB[s * LD + k], z);
        z += __shfl_xor_sync(0xffffffffu, z, 4);
        z += __shfl_xor_sync(0xffffffffu, z, 2);
        z += __shfl_xor_sync(0xffffffffu, z, 1);
        if (kk == 0) sOut[s * kMaxA1 + a] = z + sbh[a];
      }
    }
    __syncwarp();

    // per-sample loss and the gradient at the head's outputs (kSPW lanes a warp)
    if (lane < kSPW) {
      const int s = warp * kSPW + lane;
      const float* xs = x + s;
      const float old_logp = xs[(D + na) * kChunk], old_v = xs[(D + na + 1) * kChunk];
      const float adv = xs[(D + na + 2) * kChunk], ret = xs[(D + na + 3) * kChunk];
      const float* out = sOut + s * kMaxA1;
      const float value = out[A];
      float* gtop = sGtop + s * kMaxA1;
      float* m = sMet + s * kMet;  // this thread's sums: 4 metrics, then dlog_std
      float logp = 0.0f, ent = 0.0f, mx = 0.0f, lse = 0.0f;
      if (gauss) {
        for (int a = 0; a < A; ++a) {
          const float diff = xs[(D + a) * kChunk] - out[a];
          logp += -0.5f * (diff * diff * siv[a] + 2.0f * sls[a] + LOG_2PI_F);
        }
      } else {
        mx = out[0];
        for (int a = 1; a < A; ++a) mx = fmaxf(mx, out[a]);
        float se = 0.0f;
        for (int a = 0; a < A; ++a) se += expf(out[a] - mx);
        lse = logf(se);
        const float act = xs[D * kChunk];
        for (int a = 0; a < A; ++a) {
          const float logp_a = (out[a] - mx) - lse;
          if ((float)a == act) logp += logp_a;
          ent -= expf(logp_a) * logp_a;
        }
      }
      const float logr = logp - old_logp;
      const float ratio = expf(logr);
      const float adv_n = (adv - adv_mu) * adv_inv_std;
      const float rc = fminf(fmaxf(ratio, 1.0f - eps), 1.0f + eps);
      const float u1 = ratio * adv_n, u2 = rc * adv_n;
      const bool inside = ratio > 1.0f - eps && ratio < 1.0f + eps;
      const float g_logp = ((u1 <= u2) || inside ? ratio * adv_n : 0.0f) * (-inv_n);
      const float dv = value - old_v;
      const float e1 = value - ret;
      const float e2 = old_v + fminf(fmaxf(dv, -eps), eps) - ret;
      const bool inside_v = dv > -eps && dv < eps;
      const float g_value =
          (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.0f)) * g_value_scale;
      m[0] -= fminf(u1, u2);
      m[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
      m[2] += ratio - 1.0f - logr;
      m[3] += gauss ? value : ent;
      if (gauss) {
        for (int a = 0; a < A; ++a) {
          const float diff = xs[(D + a) * kChunk] - out[a];
          gtop[a] = g_logp * diff * siv[a];
          m[4 + a] += g_logp * (diff * diff * siv[a] - 1.0f);
        }
      } else {
        const float act = xs[D * kChunk];
        for (int a = 0; a < A; ++a) {
          const float logp_a = (out[a] - mx) - lse;
          const float prob = expf(logp_a);
          const float onehot = (float)a == act ? 1.0f : 0.0f;
          gtop[a] = g_logp * (onehot - prob) + ent_scale * prob * (logp_a + ent);
        }
      }
      gtop[A] = g_value;
    }
    __syncthreads();

    // head backward: dWhc, dbhc and g_p2 = (Whc g_top) * (1 - h2^2), db2c
    for (int it = tid; it < 2 * H2 * A1; it += kThreads) {
      // entry (a, k) over one half of the chunk's samples, two sums in flight
      const int half = it / (H2 * A1), q = it % (H2 * A1);
      const int a = q / H2, k = q % H2;
      const float* h2 = sB + half * (kChunk / 2) * LD + k;
      const float* gt = sGtop + half * (kChunk / 2) * kMaxA1 + a;
      float z0 = 0.0f, z1 = 0.0f;
#pragma unroll 4
      for (int s = 0; s < kChunk / 2; s += 2) {
        z0 = fmaf(h2[s * LD], gt[s * kMaxA1], z0);
        z1 = fmaf(h2[(s + 1) * LD], gt[(s + 1) * kMaxA1], z1);
      }
      sdWh[half * (kMaxA1 * H2) + q] += z0 + z1;
    }
    if (tid >= kThreads - A1) {
      const int a = kThreads - 1 - tid;
      float z = 0.0f;
      for (int s = 0; s < kChunk; ++s) z += sGtop[s * kMaxA1 + a];
      sdbh[a] += z;
    }
    float g2[EPT];
#pragma unroll
    for (int e = 0; e < EPT; ++e) g2[e] = 0.0f;
    for (int a = 0; a < A1; ++a) {
      const float wh = sWhT[a * H2 + ecol];
#pragma unroll
      for (int e = 0; e < EPT; ++e)
        g2[e] = fmaf(wh, sGtop[(es0 + e * SSTEP) * kMaxA1 + a], g2[e]);
    }
    float cb2 = 0.0f;  // the chunk's share of db2c, added to the running sum once
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      const int s = es0 + e * SSTEP;
      const float h2 = sB[s * LD + ecol];
      const float g = g2[e] * (1.0f - h2 * h2);
      sG[s * LD + ecol] = g;
      if constexpr (BF) bG[s * LDB + ecol] = __float2bfloat16_rn(g);
      cb2 += g;
    }
    acc_b2 += cb2;
    __syncthreads();

    // dW2c += h1^T g_p2, and g_p1 = (g_p2 W2c^T) * (1 - h1^2), which is
    // consumed where it is made: db1c, dW1c
    if constexpr (BF) {
      if (w2_warp)
        mma_tiles<wmma::col_major, wmma::row_major, NW2, kChunk / kMmaK>(
            bH1 + wrow, LDB, kMmaK * LDB, bG + wcol, LDB, kMmaK * LDB, 16, acc_w2);
      AccFrag acc[NF];
      zero_frags(acc);
      mma_tiles<wmma::row_major, wmma::col_major, NF, H / kMmaK>(
          bG + trow * LDB + tk0, LDB, kMmaK, bW2 + tcol * LDB + tk0, LDB, kMmaK, 16 * LDB, acc);
#pragma unroll
      for (int f = 0; f < NF; ++f)
        wmma::store_matrix_sync(sB + trow * LD + tcol + f * 16, acc[f], LD, wmma::mem_row_major);
      __syncwarp();
      float cb1 = 0.0f, cw1[kMaxD] = {0.0f, 0.0f, 0.0f, 0.0f};  // the chunk's shares
#pragma unroll
      for (int r = 0; r < RPL; ++r) {
        const int s = prow + r;
        const float h1 = sH1[s * LD + pcol];
        const float g = sB[s * LD + pcol] * (1.0f - h1 * h1);
        cb1 += g;
        if constexpr (BIGD) {
          sB[s * LD + pcol] = g;  // g_p1, for the dW1c pass below
        } else {
#pragma unroll
          for (int d = 0; d < kMaxD; ++d)
            if (d < D) cw1[d] = fmaf(x[d * kChunk + s], g, cw1[d]);
        }
      }
      acc_b1 += cb1;
      if constexpr (!BIGD)
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) acc_w1[d] += cw1[d];
    } else {
      if (w2_thread) {
#pragma unroll 4
        for (int s = 0; s < kChunk; ++s) {
          float a[4], b[4];
          load_row<4>(sH1 + s * LD + fj0, a);
          load_row<4>(sG + s * LD + fk0, b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) facc_w2[i][c] = fmaf(a[i], b[c], facc_w2[i][c]);
        }
      }
      float acc[4][CPT];
      tower_product<H2>(sG, fW2T, LDT, fs0, fc0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) sB[(fs0 + i) * LD + fc0 + c] = acc[i][c];
      __syncthreads();
      float cb1 = 0.0f, cw1[kMaxD] = {0.0f, 0.0f, 0.0f, 0.0f};  // the chunk's shares
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        const int s = es0 + e * SSTEP;
        const float h1 = sH1[s * LD + ecol];
        const float g = sB[s * LD + ecol] * (1.0f - h1 * h1);
        cb1 += g;
        if constexpr (BIGD) {
          sB[s * LD + ecol] = g;  // g_p1, for the dW1c pass below
        } else {
#pragma unroll
          for (int d = 0; d < kMaxD; ++d)
            if (d < D) cw1[d] = fmaf(x[d * kChunk + s], g, cw1[d]);
        }
      }
      acc_b1 += cb1;
      if constexpr (!BIGD)
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) acc_w1[d] += cw1[d];
    }
    if constexpr (BIGD) {
      // dW1c's share of the chunk, entry (d, c) = sum over its samples of
      // x[d][s] g_p1[s][c], both read from shared memory (d is the same
      // across a warp, so x is a broadcast); added to the running sum once
      __syncthreads();  // g_p1 is complete
#pragma unroll
      for (int k = 0; k < NW1; ++k) {
        const int o = tid + k * kThreads;
        if (o < D * H2) {
          const float* xd = x + (o / H2) * kChunk;
          const float* g = sB + o % H2;
          float z = 0.0f;
#pragma unroll 8
          for (int s = 0; s < kChunk; ++s) z = fmaf(xd[s], g[s * LD], z);
          acc_w1[k] += z;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // This CTA's partial sums -> workspace row blockIdx.x. The activation
  // buffers are free now: dW2c goes through them, and the per-thread column
  // sums are added there in a fixed order.
  float* stage = sH1;
  if constexpr (BF) {
    if (w2_warp) {
#pragma unroll
      for (int f = 0; f < NW2; ++f)
        wmma::store_matrix_sync(stage + wrow * LD + wcol + f * 16, acc_w2[f], LD,
                                wmma::mem_row_major);
    }
  } else if (w2_thread) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) stage[(fj0 + i) * LD + fk0 + c] = facc_w2[i][c];
  }
  stage[S::SCR_B2 + tid] = acc_b2;
  {
    // SSTEP threads shared each column of g_p1, as they did of g_p2
    const int slot = BF ? ((warp / 4) * RG + lane / CW) * H2 + pcol : tid;
    stage[S::SCR_B1 + slot] = acc_b1;
    if constexpr (!BIGD)
#pragma unroll
      for (int d = 0; d < kMaxD; ++d) stage[S::SCR_W1 + d * kThreads + slot] = acc_w1[d];
  }
  __syncthreads();

  float* out = ws + (long long)blockIdx.x * (L.P + 4);
  for (int i = tid; i < H2 * H2; i += kThreads)  // the cross-tower blocks are no parameters
    out[L.w2 + i] = (i / H2 < H) == (i % H2 < H) ? stage[(i / H2) * LD + i % H2] : 0.0f;
  if constexpr (BIGD) {
#pragma unroll
    for (int k = 0; k < NW1; ++k)
      if (tid + k * kThreads < D * H2) out[L.w1 + tid + k * kThreads] = acc_w1[k];
  }
  if (tid < H2) {
    float zb1 = 0.0f, zb2 = 0.0f, zw[kMaxD] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < SSTEP; ++c) {
      zb1 += stage[S::SCR_B1 + c * H2 + tid];
      zb2 += stage[S::SCR_B2 + c * H2 + tid];
      if constexpr (!BIGD)
#pragma unroll
        for (int d = 0; d < kMaxD; ++d) zw[d] += stage[S::SCR_W1 + d * kThreads + c * H2 + tid];
    }
    out[L.b1 + tid] = zb1;
    out[L.b2 + tid] = zb2;
    if constexpr (!BIGD)
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) out[L.w1 + d * H2 + tid] = zw[d];
  }
  for (int q = tid; q < H2 * A1; q += kThreads) {
    const int e = (q % A1) * H2 + q / A1;
    out[L.wh + q] = sdWh[e] + sdWh[kMaxA1 * H2 + e];
  }
  if (tid >= kThreads - A1) out[L.bh + kThreads - 1 - tid] = sdbh[kThreads - 1 - tid];
  if (warp == 1 && lane < 4 + A) {
    // metric sums, then dlog_std (zero for the categorical head: no such parameter)
    float z = 0.0f;
    if (lane < 4 || gauss)
      for (int s = 0; s < kChunk; ++s) z += sMet[s * kMet + lane];
    if (lane < 4) {
      out[L.P + lane] = z;
    } else {
      out[L.ls + lane - 4] = z;
    }
  }
}

// ------------------------------------------------------------------ wide
// Stage 1 at the widths whose weights do not fit a CTA: hidden 128 and 256,
// and categorical heads of 17 to 128 classes at any hidden size (the kernel
// above keeps hidden 32 and 64 with at most 16), under float32, and under
// bfloat16 at hidden 32 (at hidden 64 and above bfloat16 takes
// ppo_grad_tower, below). Its shared memory holds the activations of a chunk
// of kWideChunk samples ([S][2H] twice) and every weight matrix streams
// from L2.
// - The two W2c products of a chunk (the forward product and g_p1's):
//   float32 FMA through block_product's slabs (wide_mlp.cuh), the towers' W2
//   blocks side by side and their transposes.
// - The head's products (Wm padded to whole tiles, its transpose for g_p2)
//   are float32 FMA through the slabs in both modes.
// - dW2c (512 KiB at hidden 256) is not summed here: each chunk writes its
//   h1 and g_p2 [S][2H] once to the activation scratch (as bf16 under
//   bfloat16, the values the mode's product reads), and dw2c_split (below)
//   takes the product over the whole minibatch afterwards.
// - dWhc (128 KiB at 128 classes) is added chunk by chunk into the CTA's
//   own workspace row, which only this CTA writes: no atomics, the same
//   thread adds the same entries in the same order every chunk, so the bits
//   stay fixed.
// Shared memory at hidden 256 (WideSmem<512, false>): the two activation
// arrays 130 KiB (row stride 2H + 4 floats), two 16 KiB slabs, the head
// outputs 16.5 KiB, the double-buffered sample rows 6 KiB and 12.5 KiB of
// biases, W1c and sums: 197.6 KiB of the 227 KiB a CTA may have. Per chunk:
//   h1 (elementwise) | h2 = tanh(h1 W2 + b2) | out = h2 Wm + bh, value by warp
//   | loss, a warp a sample, the classes over the lanes | dbhc, dWhc, then
//   g_p2 = (g_top Wm^T) (1 - h2^2) | db2c, h1 and g_p2 out, g_p1 =
//   (g_p2 W2^T) (1 - h1^2) | db1c, dW1c.
constexpr int kWideChunk = 32;

// The activation scratch of the wide path: h1 [n][H2], then g_p2 [n][H2],
// rows in minibatch order (visited tile g, then sample: g * tile + i),
// float32, or bf16 under bfloat16. Copies a chunk's [kWideChunk][H2] rows
// from shared memory (row stride lda) to rows row0.. of one of them; every
// thread of the block calls it.
template <int H2, bool BF>
__device__ __forceinline__ void rows_out(const float* src, int lda, void* act, long long row0) {
  constexpr int Q = H2 / 4;
  for (int e = threadIdx.x; e < kWideChunk * Q; e += blockDim.x) {
    const int s = e / Q, c = e % Q * 4;
    const float4 v = *reinterpret_cast<const float4*>(src + s * lda + c);
    const long long o = (row0 + s) * H2 + c;
    if constexpr (BF) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(act) + o) = u;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(act) + o) = v;
    }
  }
}
static_assert(kWarps * 2 == kWideChunk, "a warp takes two samples of a chunk in the loss");

template <int H2, bool BF>
struct WideSmem {
  static constexpr int S = kWideChunk;
  static constexpr int LDA = kActLD<H2>;
  static constexpr int ACT0 = 0;                        // [S][LDA]: h1, then g_p1
  static constexpr int ACT1 = ACT0 + S * LDA;           // [S][LDA]: h2, then g_p2
  static constexpr int SLAB = ACT1 + S * LDA;           // [2][kSlabFloats]
  static constexpr int OUT = SLAB + 2 * kSlabFloats;    // [S][kWideLDO]: head outputs, then g_top
  static constexpr int X = OUT + S * kWideLDO;          // [2][kMaxRows][S], double-buffered
  static constexpr int W1 = X + 2 * kMaxRows * S;       // [kMaxD][H2]
  static constexpr int B1 = W1 + kMaxD * H2;
  static constexpr int B2 = B1 + H2;
  static constexpr int BH = B2 + H2;                    // [kWideMaxA + 4]
  static constexpr int VAL = BH + kWideMaxA + 4;        // [S] value
  static constexpr int GV = VAL + S;                    // [S] gradient at the value
  static constexpr int LS = GV + S;                     // [kMaxGaussA]
  static constexpr int IV = LS + kMaxGaussA;            // [kMaxGaussA] exp(-2 log_std)
  static constexpr int RED = IV + kMaxGaussA;           // [kWarps][kMet] per-warp sums
  static constexpr int TOTAL = RED + kWarps * kMet;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};
static_assert(WideSmem<512, false>::BYTES <= 232448 && WideSmem<512, true>::BYTES <= 232448,
              "wide stage 1 exceeds the shared memory of a CTA");

// BIGD: obs_dim above kMaxD, as in ppo_grad_tiles: W1c is read from L2, and
// dW1c's chunk shares are added into the workspace row.
template <int H2, bool BF, bool BIGD>
__global__ void __launch_bounds__(kThreads, 1)
    ppo_grad_wide(const GradParams p, const float* __restrict__ data,
                  const int* __restrict__ order, const float* __restrict__ w,
                  const float* __restrict__ prep, const float* __restrict__ adv_stats,
                  void* __restrict__ act, float* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);
  using S_ = WideSmem<H2, BF>;
  constexpr int H = H2 / 2, S = kWideChunk, LDA = S_::LDA, LDO = kWideLDO;
  static_assert(!kWideMma<H2, BF>, "bfloat16 at hidden 64 and above takes ppo_grad_tower");
  // thread tiles: the W2 products [S][H2], g_p2's product [S][H], the head [S][AP]
  constexpr int TC2 = H2 >= 512 ? 8 : 4, TS2 = S * (H2 / TC2) / kThreads;
  constexpr int TCB = H >= 64 ? 4 : 2, TSB = S * (H / TCB) / kThreads;
  constexpr int TSF = 2, TCF = 4;
  static_assert(TS2 >= 1 && TSB >= 1 && (S / TSF) * (kWideMaxA / TCF) <= kThreads &&
                    H2 <= kThreads,
                "tiling");

  float* act0 = sm + S_::ACT0;
  float* act1 = sm + S_::ACT1;
  float* slab = sm + S_::SLAB;
  float* out = sm + S_::OUT;
  __nv_bfloat16* abf = reinterpret_cast<__nv_bfloat16*>(out);   // a product's A as bf16
  __nv_bfloat16* h_out = static_cast<__nv_bfloat16*>(act);      // the activation scratch
  float* sX = sm + S_::X;
  float* sW1 = sm + S_::W1;
  float* sb1 = sm + S_::B1;
  float* sb2 = sm + S_::B2;
  float* sbh = sm + S_::BH;
  float* sval = sm + S_::VAL;
  float* sgv = sm + S_::GV;
  float* sls = sm + S_::LS;
  float* siv = sm + S_::IV;
  float* sred = sm + S_::RED;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.obs_dim, A = p.act_dim, A1 = A + 1, AP = wide_ap(A);
  const bool gauss = p.head == GAUSSIAN;
  const int na = gauss ? A : 1;
  const Layout L = make_layout(D, H2, A);
  const WidePrep W = wide_prep_layout(H, AP);
  const long long N = p.n_cols, n_mb = (long long)p.num_tiles * p.tile;
  const int tile_idx = order[blockIdx.x / kSplit];
  if (tile_idx < 0 || (long long)(tile_idx + 1) * p.tile > N) __trap();
  const int part = blockIdx.x % kSplit, n_chunks = p.tile / S;
  const int c_begin = part * n_chunks / kSplit, c_end = (part + 1) * n_chunks / kSplit;
  const long long base = (long long)tile_idx * p.tile;

  // this CTA's workspace row: zero, then the chunks add into it
  float* row = ws + (long long)blockIdx.x * (L.P + 4);
  for (int i = tid; i < L.P + 4; i += kThreads) row[i] = 0.0f;
  if constexpr (!BIGD)
    for (int i = tid; i < D * H2; i += kThreads) sW1[i] = w[L.w1 + i];
  const float* w1 = BIGD ? w + L.w1 : sW1;
  for (int i = tid; i < H2; i += kThreads) {
    sb1[i] = w[L.b1 + i];
    sb2[i] = w[L.b2 + i];
  }
  for (int i = tid; i < A1; i += kThreads) sbh[i] = w[L.bh + i];
  if (gauss)
    for (int i = tid; i < A; i += kThreads) {
      sls[i] = w[L.ls + i];
      siv[i] = expf(-2.0f * w[L.ls + i]);
    }
  const float adv_mu = adv_stats[0], adv_inv_std = adv_stats[1];
  const float eps = p.clip_eps, inv_n = p.inv_n;
  const float g_value_scale = p.vf_coef * inv_n, ent_scale = p.ent_coef * inv_n;

  // this thread's tiles of the products
  const int f_s0 = tid / (H2 / TC2) * TS2, f_c0 = tid % (H2 / TC2) * TC2;
  const int b_s0 = tid / (H / TCB) * TSB, b_c0 = tid % (H / TCB) * TCB;
  const int ncgf = AP / TCF;
  const bool h_mine = tid < (S / TSF) * ncgf;
  const int h_s0 = h_mine ? tid / ncgf * TSF : 0, h_c0 = h_mine ? tid % ncgf * TCF : 0;

  // running sums kept over the chunks: column tid of db1c, db2c, dW1c; entry
  // tid of dbhc; the warp's metric sums (lane 0) and dlog_std (lane a). They
  // are float64, a handful of additions a thread and chunk: the bias
  // gradients and dlog_std are sums over every sample whose terms cancel,
  // and the float64 bar holds each buffer to 4 times the twin's error
  double acc_b1 = 0.0, acc_b2 = 0.0, acc_bh = 0.0;
  double acc_w1[kMaxD] = {0.0, 0.0, 0.0, 0.0};
  double met[4] = {0.0, 0.0, 0.0, 0.0};
  double acc_ls = 0.0;

  const int n_elems = p.rows * S;
  auto fetch = [&](int chunk, float* dst) {
    const float* src = data + base + (long long)chunk * S;
    for (int e = tid; e < n_elems; e += kThreads)
      cp_async4(dst + e, src + (long long)(e / S) * N + e % S);
  };
  if (c_begin < c_end) fetch(c_begin, sX);
  cp_async_wait_all();
  __syncthreads();

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const float* x = sX + ((chunk - c_begin) & 1) * (kMaxRows * S);
    if (chunk + 1 < c_end) fetch(chunk + 1, sX + ((chunk - c_begin + 1) & 1) * (kMaxRows * S));

    // h1 = tanh(W1c^T x + b1c)
    for (int e = tid; e < S * H2; e += kThreads) {
      const int s = e / H2, c = e % H2;
      float z = 0.0f;
      for (int d = 0; d < D; ++d) z = fmaf(w1[d * H2 + c], x[d * S + s], z);
      act0[s * LDA + c] = tanhf(z + sb1[c]);
    }
    __syncthreads();

    // h2 = tanh(W2c^T h1 + b2c), per tower
    {
      float acc[TS2][TC2];
      block_product<TS2, TC2, BF, true>(act0, LDA, H, prep + W.fw, H, H2, slab, f_s0, f_c0, true, acc);
#pragma unroll
      for (int i = 0; i < TS2; ++i)
#pragma unroll
        for (int c = 0; c < TC2; ++c)
          act1[(f_s0 + i) * LDA + f_c0 + c] = tanhf(acc[i][c] + sb2[f_c0 + c]);
    }
    __syncthreads();

    // head: the policy outputs from the policy tower (zero past A), the
    // value from the value tower. The categorical head's logits are one
    // block product; the value and the Gaussian head's few means (whose
    // rounding dlog_std and dbhc sum over every sample) are warp dots, a
    // warp two samples, each lane H / 32 terms and then a butterfly
    if (!gauss) {
      float acc[TSF][TCF];
      block_product<TSF, TCF, false, true>(act1, LDA, AP, prep + W.mp, H, AP, slab, h_s0, h_c0,
                                           h_mine, acc);
      if (h_mine)
#pragma unroll
        for (int i = 0; i < TSF; ++i)
#pragma unroll
          for (int c = 0; c < TCF; ++c) {
            const int a = h_c0 + c;
            out[(h_s0 + i) * LDO + a] = a < A ? acc[i][c] + sbh[a] : 0.0f;
          }
    }
    for (int q = 0; q < 2; ++q) {
      const int s = warp * 2 + q;
      for (int a = gauss ? 0 : A; a <= A; ++a) {
        const float* wcol = a < A ? prep + W.mp + a : prep + W.wv;
        const int stride = a < A ? AP : 1, k0 = a < A ? 0 : H;
        float z = 0.0f;
        for (int k = lane; k < H; k += 32) z = fmaf(act1[s * LDA + k0 + k], wcol[k * stride], z);
        z = warp_sum(z) + sbh[a];
        if (lane == 0) {
          if (a < A) {
            out[s * LDO + a] = z;
          } else {
            sval[s] = z;
          }
        }
      }
      if (gauss)
        for (int a = A + lane; a < AP; a += 32) out[s * LDO + a] = 0.0f;
    }
    __syncthreads();

    // per-sample loss and g_top (in place of the head outputs): a warp takes
    // two samples, lane l the classes (or action columns) l, l + 32, ...
    for (int q = 0; q < 2; ++q) {
      const int s = warp * 2 + q;
      const float* xs = x + s;
      const float old_logp = xs[(D + na) * S], old_v = xs[(D + na + 1) * S];
      const float adv = xs[(D + na + 2) * S], ret = xs[(D + na + 3) * S];
      const float value = sval[s];
      float* o = out + s * LDO;
      float lp[kWideMaxA / 32];
      float logp, ent = 0.0f;
      if (gauss) {
        float part_lp = 0.0f;
        if (lane < A) {
          const float diff = xs[(D + lane) * S] - o[lane];
          part_lp = -0.5f * (diff * diff * siv[lane] + 2.0f * sls[lane] + LOG_2PI_F);
        }
        logp = warp_sum(part_lp);
      } else {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          lp[j] = a < A ? o[a] : -CUDART_INF_F;
          mx = fmaxf(mx, lp[j]);
        }
        mx = warp_max(mx);
        float se = 0.0f;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j)
          if (lane + 32 * j < A) se += expf(lp[j] - mx);
        const float lse = logf(warp_sum(se));
        const float act = xs[D * S];
        float pl = 0.0f, pe = 0.0f;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          if (a < A) {
            lp[j] = (lp[j] - mx) - lse;
            if ((float)a == act) pl += lp[j];
            pe -= expf(lp[j]) * lp[j];
          }
        }
        logp = warp_sum(pl);
        ent = warp_sum(pe);
      }
      const float logr = logp - old_logp;
      const float ratio = expf(logr);
      const float adv_n = (adv - adv_mu) * adv_inv_std;
      const float rc = fminf(fmaxf(ratio, 1.0f - eps), 1.0f + eps);
      const float u1 = ratio * adv_n, u2 = rc * adv_n;
      const bool inside = ratio > 1.0f - eps && ratio < 1.0f + eps;
      const float g_logp = ((u1 <= u2) || inside ? ratio * adv_n : 0.0f) * (-inv_n);
      const float dv = value - old_v;
      const float e1 = value - ret;
      const float e2 = old_v + fminf(fmaxf(dv, -eps), eps) - ret;
      const bool inside_v = dv > -eps && dv < eps;
      const float g_value =
          (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.0f)) * g_value_scale;
      if (lane == 0) {
        met[0] -= fminf(u1, u2);
        met[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
        met[2] += ratio - 1.0f - logr;
        met[3] += gauss ? value : ent;
        sgv[s] = g_value;
      }
      if (gauss) {
        if (lane < A) {
          const float diff = xs[(D + lane) * S] - o[lane];
          o[lane] = g_logp * diff * siv[lane];
          acc_ls += g_logp * (diff * diff * siv[lane] - 1.0f);
        }
      } else {
        const float act = xs[D * S];
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          if (a < A) {
            const float prob = expf(lp[j]);
            const float onehot = (float)a == act ? 1.0f : 0.0f;
            o[a] = g_logp * (onehot - prob) + ent_scale * prob * (lp[j] + ent);
          }
        }
      }
    }
    __syncthreads();

    // head backward: dbhc, dWhc (policy block and value column), then g_p2
    if (tid <= A)
      for (int s = 0; s < S; ++s) acc_bh += tid < A ? out[s * LDO + tid] : sgv[s];
    {
      constexpr int TK = 8, TN = 4;
      const int n_nt = AP / TN;
      for (int t = tid; t < (H / TK) * n_nt; t += kThreads) {
        const int k0 = t / n_nt * TK, a0 = t % n_nt * TN;
        float acc[TK][TN];
        outer_tile<TK, TN, false>(act1 + k0, LDA, out + a0, LDO, S, acc);
#pragma unroll
        for (int i = 0; i < TK; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (a0 + j < A) row[L.wh + (k0 + i) * A1 + a0 + j] += acc[i][j];
      }
      for (int k = tid; k < H; k += kThreads) {
        float z = 0.0f;
        for (int s = 0; s < S; ++s) z = fmaf(act1[s * LDA + H + k], sgv[s], z);
        row[L.wh + (H + k) * A1 + A] += z;
      }
    }
    {
      float acc[TSB][TCB];
      block_product<TSB, TCB, false, true>(out, LDO, H, prep + W.mt, AP, H, slab, b_s0, b_c0, true,
                                           acc);
#pragma unroll
      for (int i = 0; i < TSB; ++i)
#pragma unroll
        for (int c = 0; c < TCB; ++c) {
          float* hp = act1 + (b_s0 + i) * LDA + b_c0 + c;
          const float h = *hp;
          *hp = acc[i][c] * (1.0f - h * h);
        }
      for (int e = tid; e < S * H; e += kThreads) {
        const int s = e / H, k = e % H;
        float* hp = act1 + s * LDA + H + k;
        const float h = *hp;
        *hp = sgv[s] * prep[W.wv + k] * (1.0f - h * h);
      }
    }
    __syncthreads();

    // db2c; h1 and g_p2 out to the activation scratch (dW2c is dw2c_split's);
    // g_p1 = (g_p2 W2c^T) (1 - h1^2)
    if (tid < H2)
      for (int s = 0; s < S; ++s) acc_b2 += act1[s * LDA + tid];
    {
      const long long m0 = (long long)(blockIdx.x / kSplit) * p.tile + (long long)chunk * S;
      rows_out<H2, BF>(act0, LDA, act, m0);
      rows_out<H2, BF>(act1, LDA, act, n_mb + m0);
    }
    {
      float acc[TS2][TC2];
      block_product<TS2, TC2, BF, true>(act1, LDA, H, prep + W.gw, H, H2, slab, f_s0, f_c0, true, acc);
#pragma unroll
      for (int i = 0; i < TS2; ++i)
#pragma unroll
        for (int c = 0; c < TC2; ++c) {
          float* hp = act0 + (f_s0 + i) * LDA + f_c0 + c;
          const float h = *hp;
          *hp = acc[i][c] * (1.0f - h * h);
        }
    }
    __syncthreads();

    // db1c, dW1c
    if (tid < H2)
      for (int s = 0; s < S; ++s) {
        const double g = act0[s * LDA + tid];
        acc_b1 += g;
        if constexpr (!BIGD)
#pragma unroll
          for (int d = 0; d < kMaxD; ++d)
            if (d < D) acc_w1[d] = fma((double)x[d * S + s], g, acc_w1[d]);
      }
    if constexpr (BIGD)
      // entry (d, c) of the chunk's share in float64, added into the row
      // (which only this thread writes there) with one rounding
      for (int o = tid; o < D * H2; o += kThreads) {
        const float* xd = x + (o / H2) * S;
        const float* g = act0 + o % H2;
        double z = 0.0;
        for (int s = 0; s < S; ++s) z = fma((double)xd[s], (double)g[s * LDA], z);
        row[L.w1 + o] = (float)((double)row[L.w1 + o] + z);
      }
    cp_async_wait_all();
    __syncthreads();
  }

  // the register sums into the row; the warps' metric sums and dlog_std in
  // warp order
  if (tid < H2) {
    row[L.b1 + tid] = (float)acc_b1;
    row[L.b2 + tid] = (float)acc_b2;
    if constexpr (!BIGD)
#pragma unroll
      for (int d = 0; d < kMaxD; ++d)
        if (d < D) row[L.w1 + d * H2 + tid] = (float)acc_w1[d];
  }
  if (tid <= A) row[L.bh + tid] = (float)acc_bh;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) sred[warp * kMet + i] = (float)met[i];
  if (gauss && lane < A) sred[warp * kMet + 4 + lane] = (float)acc_ls;
  __syncthreads();
  if (tid < 4 + (gauss ? A : 0)) {
    float z = 0.0f;
    for (int v = 0; v < kWarps; ++v) z += sred[v * kMet + tid];
    if (tid < 4) {
      row[L.P + tid] = z;
    } else {
      row[L.ls + tid - 4] = z;
    }
  }
}

// ----------------------------------------------------------------- tower
// Stage 1 of the wide path under bfloat16 at hidden 64 and above
// (kWideMma<H2, true>): one CTA a tower of a visited tile. Under bfloat16 the
// W2c products are on the tensor cores, and what bounded ppo_grad_wide there
// was their B operand: both towers' blocks (256 KiB of bf16 at hidden 256)
// do not fit a CTA beside the activations, so each chunk of 32 samples read
// them from L2 twice, 512 KiB a chunk, 4.3 GB a call, its latency inside
// every k-step of both products. The towers do not depend on each other in
// stage 1 (the policy tower needs only the log-prob, the surrogate and the
// entropy; the value tower the value loss; their gradient entries, W1c
// columns, biases and metric sums are disjoint), so here CTA (tile, tower)
// holds its tower's block (128 KiB at hidden 256) in shared memory for all
// the tile's chunks, copied once by cp.async from wide_prep's W2B, and
// walks every chunk of the tile: the weights cross L2 once a CTA.
// - The grid is ppo_grad_wide's, num_tiles x kSplit CTAs, one workspace row
//   each: CTA g < num_tiles takes the policy tower of visited tile g, CTA
//   num_tiles + g its value tower. A row is zero outside its tower's
//   entries: W1c's, b1c's and b2c's columns of the tower; the policy block
//   of Whc, dbhc[0..A-1], dlog_std, and the surrogate, KL and entropy sums;
//   or the value column of Whc, dbhc[A], the value loss and the value sum.
//   Its h1 and g_p2 columns go to the activation scratch as ppo_grad_wide's
//   do, so dw2c_split, reduce_rows and the wrappers are unchanged.
// - Both W2c products read the one resident copy through ldmatrix
//   (mma_tiles.cuh::tower_mma_smem): the forward product h1 W2 through
//   ldmatrix.trans, g_p1 = g_p2 W2^T straight; the copy's 16-byte pieces
//   are swizzled so that neither conflicts on the banks. Their A operand
//   (h1, g_p2) is written as bf16 beside its float32 values by the phase
//   that produces it, into the head outputs' space, which neither product
//   overlaps; the scratch takes the same bf16 rows. mma.sync m16n8k16, the
//   k-steps in tower_mma's order, so h2 and g_p1 carry ppo_grad_wide's bits;
//   a warp takes one m16 tile of samples and H / 8 columns. Not wgmma: with
//   W2c as its A (M = the tower's columns, N = 32 samples) its accumulators
//   land transposed to the epilogues' rows, and once resident the products
//   take ~5k of a tower's ~21k cycles a chunk.
// - What is left of a chunk is the float32 work around the products: the
//   tanh of h1 and h2, the head, the loss and the column sums. The value
//   column and the Gaussian head's few columns are warp dots read from L2
//   through L1, and the Gaussian head's dWhc block and the value column stay
//   in registers over the tile. A column's sums over a chunk's samples are
//   split over the threads that share the column.
// - The categorical head is three float32 products of S x H x AP FMA (the
//   logits, dWhc's share, g_p2), 852k each at hidden 256 and 100 classes,
//   ~6.7k cycles of the SM's FMA pipe. Wm [H][AP] (104 KiB there) fits
//   neither beside the resident block nor in the 28 KiB of L1 that the
//   shared memory leaves. Read through L1, every warp whose tile spanned it
//   fetched it from L2 (13 + 8 times a chunk), and dWhc's share went into
//   the row in 4-byte pieces at a stride of A1 floats: ~106k of the policy
//   CTA's ~128k cycles a chunk. Now
//   * the head reads neither h1 nor its buffer act0, so the categorical
//     policy CTA keeps no float32 h1 there (g_p1's epilogue recomputes it
//     from x and W1c, the same bits, ~3k cycles) and its products read B
//     from act0: the logits Wm and g_p2 Wm^T, in slabs of rows that pass
//     through two slots there (ring_product; each thread loads its 16-byte
//     pieces of the next slab into registers while the block reads this
//     one, the first slab by cp.async while the phases before run), so each
//     element crosses from L2 once a chunk; their sums keep
//     block_product's runs of rows, and so the head's bits (a logit's last
//     bit decides the clip branch of a sample on the clip's edge: one such
//     sample flipped is over K2's bar on a 2^18-sample minibatch);
//   * dWhc is summed over the tile in a float32 copy [H][AP] with 16-byte
//     aligned rows in the row's dW2c block (head_rows_add): a thread owns a
//     tile of 4 rows x 4 classes and reads, adds and writes it in 16-byte
//     pieces, loads issued before its sums (each entry gets the sums it got
//     in the row, in the same order); at the end the copy goes into the
//     dWhc block and its space back to zero.
//   * at hidden 256 the logits take two runs of 32 rows of Wm at once (two
//     fit act0's two slots at every class count: logit_pairs), the two
//     half-warps of a warp one run each, their partials added in run order
//     into running sums kept in the head outputs (pair_logits): twice the
//     warps of one run at a time, the same bits.
//   What bounds the three products then is shared memory's 32 operands a
//   clock (a thread tile of 4 x 4 loads 8 operands for 16 FMA) and latency:
//   ~19-22k cycles for dWhc and g_p2 at hidden 256 and 100 classes, against
//   6.7k of FMA. Larger tiles, which the registers left allow only with
//   operands loaded one by one, were measured slower.
// What the tower split costs: the per-chunk phases that do not scale with the
// tower's width (the loss and the head's dots, a warp two samples; the bias
// sums) and the chunk's 9 block barriers now run once per tower, and the
// policy CTA carries the head alone: ~21k cycles a chunk against the value
// CTA's ~20k at hidden 256 under the Gaussian head, ~96k at 100 classes.
// The grid's second wave of value CTAs fills in behind the first wave of
// policy CTAs.
// Shared memory at hidden 256 (TowerSmem<512>), 231,056 of the 232,448 bytes
// a CTA may have: the W2c block 131,072 (bf16 [256][256]); the activations
// 67,584 (float [2][32][264]: h1 then g_p1, h2 then g_p2); the head outputs
// 16,896 (float [32][132]; during each product its A, bf16 [32][264]: a row
// stride of 528 bytes puts an ldmatrix's 8 rows on distinct bank groups);
// the sample rows 6,144 (double-buffered); W1c's columns 4,096; b1c and b2c
// 2,048; bhc, the value, its gradient, log_std and the warps' sums 2,192;
// the chunk's observations in float64 1,024. The categorical head's slabs
// take the first activation buffer. Per chunk (the barriers between):
//   h1, its bf16 copy | h2 = tanh(h1 W2 + b2), h1 out | policy: out = h2 Wm
//   + bh; value: v = h2 wv + bh | loss | policy: dbhc, dWhc; value: dbhc,
//   dWhc, g_p2 | policy: g_p2 = (g_top Wm^T) (1 - h2^2) | db2c, g_p2 out and
//   its bf16 copy | g_p1 = (g_p2 W2^T) (1 - h1^2) | db1c, dW1c.
template <int H2>
struct TowerSmem {
  static constexpr int H = H2 / 2, S = kWideChunk;
  static constexpr int LDA = H + 8;                     // row stride of an activation buffer
  static constexpr size_t W2_BYTES = 2 * H * H;         // bf16 [H][H], tower_swz
  // float offsets after the W2c block
  static constexpr int ACT0 = 0;                        // [S][LDA]: h1, then g_p1
  static constexpr int ACT1 = ACT0 + S * LDA;           // [S][LDA]: h2, then g_p2
  // [S][kWideLDO]: head outputs, then g_top; during the products the
  // product's A as bf16 [S][LDB]
  static constexpr int OUT = ACT1 + S * LDA;
  static constexpr int LDB = H + 8;
  static constexpr int X = OUT + S * kWideLDO;          // [2][kMaxRows][S], double-buffered
  static constexpr int W1 = X + 2 * kMaxRows * S;       // [kMaxD][H], the tower's columns
  static constexpr int B1 = W1 + kMaxD * H;
  static constexpr int B2 = B1 + H;
  static constexpr int BH = B2 + H;                     // [kWideMaxA + 4]
  static constexpr int VAL = BH + kWideMaxA + 4;        // [S] value
  static constexpr int GV = VAL + S;                    // [S] gradient at the value
  static constexpr int LS = GV + S;                     // [kMaxGaussA]
  static constexpr int IV = LS + kMaxGaussA;            // [kMaxGaussA] exp(-2 log_std)
  static constexpr int RED = IV + kMaxGaussA;           // [kWarps][kMet] per-warp sums
  static constexpr int XD = RED + kWarps * kMet;        // double [kMaxD][S]: x's observations
  static constexpr int TOTAL = XD + 2 * kMaxD * S;
  static constexpr size_t BYTES = W2_BYTES + sizeof(float) * TOTAL;
  static_assert((W2_BYTES + sizeof(float) * XD) % 8 == 0, "aligned doubles");
  static_assert(LDB % 64 == 8 && W2_BYTES % 16 == 0 && S * LDB * 2 <= S * kWideLDO * 4,
                "conflict-free ldmatrix rows, aligned rows, A's copy inside OUT");
};
static_assert(TowerSmem<512>::BYTES == 231056 && TowerSmem<512>::BYTES <= 232448,
              "the tower kernel's plan at hidden 256: see the note above");
static_assert(kSplit == 2, "a tile's CTAs are its two towers");

// The clipped surrogate of one sample from its log-prob: the gradient at the
// log-prob, and its metric terms, -min(u1, u2) and the KL estimate
// ratio - 1 - log ratio.
struct Surrogate {
  float g_logp, neg_min, kl;
};

__device__ __forceinline__ Surrogate clipped_surrogate(float logp, float old_logp, float adv_n,
                                                       float eps, float inv_n) {
  const float logr = logp - old_logp;
  const float ratio = expf(logr);
  const float rc = fminf(fmaxf(ratio, 1.0f - eps), 1.0f + eps);
  const float u1 = ratio * adv_n, u2 = rc * adv_n;
  const bool inside = ratio > 1.0f - eps && ratio < 1.0f + eps;
  return {((u1 <= u2) || inside ? ratio * adv_n : 0.0f) * (-inv_n), -fminf(u1, u2),
          ratio - 1.0f - logr};
}

// The categorical head's operands in the tower kernel pass through the
// activation buffer that the head leaves free (act0: the policy CTA
// recomputes h1 where g_p1 needs it), in two slots: each thread loads its
// 16-byte pieces of the next slab into registers while the block computes
// on this one, and stores them after. (cp.async of every slab into a ring
// of 3 to 5 slots was measured slower: issuing the copies alone took ~5k of
// the logits' cycles a chunk.) kPieces pieces a thread at most.
constexpr int kPieces = 2;

// Slab 0 of ring_product's B (the first min(ks, K) rows of [K][NB]) into the
// ring's first slot by cp.async, while the phases before the product run.
__device__ __forceinline__ void ring_prefetch(float* ring, const float* __restrict__ B, int K,
                                              int NB, int ks) {
  for (int e = threadIdx.x; e < min(ks, K) * NB / 4; e += blockDim.x)
    cp_async16(ring + 4 * e, B + 4 * e);
}

// C[i][c] = sum over k < K of A[s0 + i ss][k] B[k][c0 + c], this thread's TS
// samples (ss apart) and 4 columns if `mine`, A in shared memory (row stride
// lda, 16-byte aligned rows), B [K][NB] row-major in global memory, read
// once: slabs of ks rows (the last may be shorter, a multiple of 4) pass
// through the two slots of `ring` (2 ks NB floats), slab sl + 1 loaded into
// registers while slab sl is read; slab 0 by ring_prefetch before. The sums
// are block_product's SLAB_SUMS, whatever the slabs: runs of `run` rows (its
// slab rows for this K and NB) summed apart, then added, so C has the bits
// of block_product's sums. Every thread of the block calls it; `ring` may be
// overwritten after the next block barrier.
template <int TS>
__device__ __forceinline__ void ring_product(const float* A, int lda, int ss,
                                             const float* __restrict__ B, int K, int NB, int ks,
                                             float* ring, int s0, int c0, bool mine,
                                             float (&acc)[TS][4]) {
  const int n_slabs = (K + ks - 1) / ks, tid = threadIdx.x;
  int run = 32;
  while (run > 4 && (K % run || run * NB > kSlabFloats)) run >>= 1;
  const float4* B4 = reinterpret_cast<const float4*>(B);
  float4 v[kPieces];
  auto load = [&](int sl) {
    const int n4 = min(ks, K - sl * ks) * NB / 4;
#pragma unroll
    for (int j = 0; j < kPieces; ++j)
      if (tid + j * kThreads < n4) v[j] = __ldcg(B4 + sl * (ks * NB / 4) + tid + j * kThreads);
  };
  auto store = [&](int sl) {
    const int n4 = min(ks, K - sl * ks) * NB / 4;
    float4* dst = reinterpret_cast<float4*>(ring + (sl & 1) * (ks * NB));
#pragma unroll
    for (int j = 0; j < kPieces; ++j)
      if (tid + j * kThreads < n4) dst[tid + j * kThreads] = v[j];
  };
  float part[TS][4];
#pragma unroll
  for (int i = 0; i < TS; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = part[i][c] = 0.0f;
  if (n_slabs > 1) load(1);
  cp_async_wait_all();
  for (int sl = 0; sl < n_slabs; ++sl) {
    __syncthreads();
    if (mine) {
      const float* ak = A + s0 * lda + sl * ks;
      const float* bk = ring + (sl & 1) * (ks * NB) + c0;
      const int rows = min(ks, K - sl * ks);
#pragma unroll 2
      for (int k = 0; k < rows; k += 4) {
        float a[TS][4];
#pragma unroll
        for (int i = 0; i < TS; ++i) load_row<4>(ak + i * ss * lda + k, a[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float b[4];
          load_row<4>(bk + (k + q) * NB, b);
#pragma unroll
          for (int i = 0; i < TS; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[i][c] = fmaf(a[i][q], b[c], part[i][c]);
        }
        if ((sl * ks + k + 4) % run == 0)
#pragma unroll
          for (int i = 0; i < TS; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] += part[i][c];
              part[i][c] = 0.0f;
            }
      }
    }
    if (sl + 1 < n_slabs) {
      store(sl + 1);
      if (sl + 2 < n_slabs) load(sl + 2);
    }
  }
}

// Whether the logits at hidden H take pair_logits: two whole runs of 32 rows
// of Wm [H][AP] fit act0's two slots (S x LDA floats of TowerSmem) at every
// AP, and the runs pair up. Hidden 256 only. (At 128 and 64 the smaller heads
// fit too, but a choice between the two schedules by AP at run time took
// registers from the whole kernel: hidden 128 with 100 classes, which keeps
// the one-run schedule, lost 5% of stage 1 to the spills.)
__host__ __device__ constexpr bool logit_pairs(int H) {
  return H % 64 == 0 && 2 * 32 * kWideMaxA <= kWideChunk * (H + 8);
}

// 16-byte pieces a thread of one pair of runs, at most
constexpr int kPairPieces = 4;
static_assert(32 * kWideMaxA <= kSlabFloats && 16 * kWideMaxA <= kPairPieces * kThreads &&
                  kWideMaxA / 8 <= kWarps,
              "a run of Wm is block_product's, a pair fits the pieces, AP / 8 warps");

// The logits where logit_pairs(H): out[s][a] = h2 Wm + bh (zero for A
// <= a < AP) with Wm's runs of 32 rows two at a time. Runs 2r and 2r + 1 sit
// in ring's two slots (the first pair by ring_prefetch of 64 rows); in a
// thread tile of 4 samples (8 apart) x 4 classes, warp w the classes 8 w..,
// lane l samples (l % 16) / 2 + 8 i and classes 4 (l % 2).. (each
// quarter-warp reads 4 rows of h2 and 2 pieces of a row of Wm: one
// wavefront), the lower half-warp sums run 2r and the upper run 2r + 1 for
// the same tile, each an FMA chain from zero in k order as block_product
// sums a run: AP / 8 warps (13 at 100 classes) on both runs at once. The
// partials cross by a shuffle, and the lower lane adds samples i = 0, 1 of
// the tile, the upper i = 2, 3: out = (out + even) + odd, from zero at the
// first pair (the running sums stay in out, which leaves the registers to
// the products), then + bh at the last. The runs are added left to right as
// ring_product adds them one at a time, so every logit keeps its bits.
// Every thread of the block loads its pieces of the next pair into
// registers once it has read this pair (issued before the sums, they held 16
// registers through them and were no faster), and stores them after a
// barrier; H / 64 rounds. Every thread of the block calls it.
__device__ __forceinline__ void pair_logits(const float* h2, int lda, const float* __restrict__ mp,
                                            const float* sbh, int H, int A, int AP, float* ring,
                                            float* out, int ldo) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, half = lane >> 4;
  const int s0 = (lane & 15) / 2, c0 = warp * 8 + (lane & 1) * 4;
  const bool mine = c0 < AP;   // the same over the warp: AP is a multiple of 8
  const int n_pairs = H / 64, n4 = 16 * AP;
  const float4* B4 = reinterpret_cast<const float4*>(mp);
  float4 v[kPairPieces];
  auto load = [&](int r) {
#pragma unroll
    for (int j = 0; j < kPairPieces; ++j)
      if (tid + j * kThreads < n4) v[j] = __ldcg(B4 + r * n4 + tid + j * kThreads);
  };
  cp_async_wait_all();
  for (int r = 0; r < n_pairs; ++r) {
    __syncthreads();
    if (mine) {
      const float* ak = h2 + s0 * lda + (2 * r + half) * 32;
      const float* bk = ring + half * (32 * AP) + c0;
      float part[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[i][c] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < 32; k += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) load_row<4>(ak + i * 8 * lda + k, a[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float b[4];
          load_row<4>(bk + (k + q) * AP, b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) part[i][c] = fmaf(a[i][q], b[c], part[i][c]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float4* o = reinterpret_cast<float4*>(out + (s0 + 8 * (2 * half + j)) * ldo + c0);
        const float4 cur = r ? *o : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float base[4] = {cur.x, cur.y, cur.z, cur.w};
        float z[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // this lane's partial of sample 2 half + j, and its partner's
          const float own = half ? part[2 + j][c] : part[j][c];
          const float other =
              __shfl_xor_sync(WIDE_FULL_MASK, half ? part[j][c] : part[2 + j][c], 16);
          z[c] = (base[c] + (half ? other : own)) + (half ? own : other);
          if (r + 1 == n_pairs) z[c] = c0 + c < A ? z[c] + sbh[c0 + c] : 0.0f;
        }
        *o = make_float4(z[0], z[1], z[2], z[3]);
      }
    }
    if (r + 1 < n_pairs) {
      load(r + 1);
      __syncthreads();
      float4* dst = reinterpret_cast<float4*>(ring);
#pragma unroll
      for (int j = 0; j < kPairPieces; ++j)
        if (tid + j * kThreads < n4) dst[tid + j * kThreads] = v[j];
    }
  }
}

// The categorical head's logits out[s][a] = h2 Wm + bh (zero for A <= a <
// AP), Wm [H][AP] through act0: by pair_logits where logit_pairs(H);
// elsewhere through ring_product, one run at a time, in thread tiles of 4
// samples (8 apart) x 4 classes: warp w the classes 16 w.., lane l samples
// l / 4 + 8 i and classes 4 (l % 4).. of them (each quarter-warp reads 2 rows
// of h2 and 4 pieces of a row of Wm: one wavefront). That is AP / 16 warps
// (7 at 100 classes); tiles of 2 x 4 on all 16, which cut the runs, were
// measured slower. Every thread of the block calls it.
template <int H>
__device__ __forceinline__ void head_logits(const float* h2, int lda, const float* __restrict__ mp,
                                            const float* sbh, int A, int AP, int ks, float* ring,
                                            float* out, int ldo) {
  if constexpr (logit_pairs(H)) {
    pair_logits(h2, lda, mp, sbh, H, A, AP, ring, out, ldo);
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s0 = lane / 4, c0 = warp * 16 + lane % 4 * 4;
    const bool mine = c0 < AP;
    float acc[4][4];
    ring_product<4>(h2, lda, 8, mp, H, AP, ks, ring, s0, c0, mine, acc);
    if (mine)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[(s0 + 8 * i) * ldo + c0 + c] = c0 + c < A ? acc[i][c] + sbh[c0 + c] : 0.0f;
  }
}

// dWhc's policy block += this chunk's share h2^T g_top, summed over the
// tile's chunks in dwh, a float32 copy [H][AP] with 16-byte aligned rows in
// global memory (L2): thread tiles of 4 rows x 4 classes, a warp 8 row
// groups x 4 class groups (each quarter-warp reads 2 pieces of h2 and 4 of
// g_top: one wavefront), a tile's sums over the samples in order
// (outer_tile) added to its entries, which it loads before the sums and
// stores after, in 16-byte pieces: an entry has one owner and gets the sums
// it got in the row, in the same order. No barrier.
__device__ __forceinline__ void head_rows_add(float* __restrict__ dwh, const float* h2, int lda,
                                              const float* gt, int ldg, int H, int AP) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, kb = H / 32;
  for (int b = warp; b < kb * ((AP + 15) / 16); b += kWarps) {
    const int k0 = b % kb * 32 + lane / 4 * 4, a0 = b / kb * 16 + lane % 4 * 4;
    if (a0 >= AP) continue;
    float4* d = reinterpret_cast<float4*>(dwh + k0 * AP + a0);
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = d[i * (AP / 4)];
    float acc[4][4];
    outer_tile<4, 4, false>(h2 + k0, lda, gt + a0, ldg, kWideChunk, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      d[i * (AP / 4)] = make_float4(v[i].x + acc[i][0], v[i].y + acc[i][1], v[i].z + acc[i][2],
                                    v[i].w + acc[i][3]);
  }
}

// BIGD: obs_dim above kMaxD, as in ppo_grad_tiles: W1c is read from L2, and
// dW1c's chunk shares are added into the workspace row. CAT: the categorical
// head (p.head), whose policy CTA runs the head through act0.
template <int H2, bool BIGD, bool CAT>
__global__ void __launch_bounds__(kThreads, 1)
    ppo_grad_tower(const GradParams p, const float* __restrict__ data,
                   const int* __restrict__ order, const float* __restrict__ w,
                   const float* __restrict__ prep, const float* __restrict__ adv_stats,
                   void* __restrict__ act, float* __restrict__ ws) {
  extern __shared__ __align__(128) unsigned char smem[];
  using S_ = TowerSmem<H2>;
  constexpr int H = H2 / 2, S = kWideChunk, LDA = S_::LDA, LDB = S_::LDB, LDO = kWideLDO;
  // the categorical head's slabs in act0: g_p2's of 16 rows of Wm^T
  // fit twice, its thread tiles cover [S][H] once, the logits' warps of 16
  // classes cover AP, and dWhc's copy fits the row's dW2c block
  constexpr int RING = S * LDA;
  static_assert(S == 32 && (H / 32) * (S / (4 * (H / 64))) == kWarps && kWideMaxA / 16 <= kWarps &&
                    2 * 16 * H <= RING &&
                    16 * H <= 4 * kPieces * kThreads && 4 * H * H >= H * kWideMaxA + 3 &&
                    H <= kThreads && RING == S * (H + 8),
                "tiling; logit_pairs reads act0's size as S (H + 8)");
  __nv_bfloat16* sW2 = reinterpret_cast<__nv_bfloat16*>(smem);
  float* sm = reinterpret_cast<float*>(smem + S_::W2_BYTES);
  float* act0 = sm + S_::ACT0;
  float* act1 = sm + S_::ACT1;
  float* out = sm + S_::OUT;
  __nv_bfloat16* abf = reinterpret_cast<__nv_bfloat16*>(out);   // a product's A as bf16
  __nv_bfloat16* h_out = static_cast<__nv_bfloat16*>(act);      // the activation scratch
  float* sX = sm + S_::X;
  float* sW1 = sm + S_::W1;
  float* sb1 = sm + S_::B1;
  float* sb2 = sm + S_::B2;
  float* sbh = sm + S_::BH;
  float* sval = sm + S_::VAL;
  float* sgv = sm + S_::GV;
  float* sls = sm + S_::LS;
  float* siv = sm + S_::IV;
  float* sred = sm + S_::RED;
  double* sxd = reinterpret_cast<double*>(sm + S_::XD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.obs_dim, A = p.act_dim, A1 = A + 1, AP = wide_ap(A);
  const bool gauss = !CAT;
  const int na = gauss ? A : 1;
  const Layout L = make_layout(D, H2, A);
  const WidePrep W = wide_prep_layout(H, AP);
  const long long N = p.n_cols, n_mb = (long long)p.num_tiles * p.tile;
  // CTAs 0..G-1 take the policy tower of visited tile blockIdx.x, the rest
  // the value tower of tile blockIdx.x - G: the heavier policy CTAs fill the
  // first wave
  const bool policy = blockIdx.x < p.num_tiles;
  // the categorical policy CTA: its head runs through act0, so h1 is not
  // kept there
  const bool cat_policy = CAT && policy;
  const int g = policy ? blockIdx.x : blockIdx.x - p.num_tiles;
  const int tile_idx = order[g];
  if (tile_idx < 0 || (long long)(tile_idx + 1) * p.tile > N) __trap();
  const int c0 = policy ? 0 : H;   // the tower's first merged column
  const int n_chunks = p.tile / S;
  const long long base = (long long)tile_idx * p.tile;
  const long long m0 = (long long)g * p.tile;   // the tile's scratch rows

  // the tower's W2c block into shared memory, once (complete at the first
  // wait below)
  {
    constexpr int PIECES = H / 8;   // 16-byte pieces a row
    const __nv_bfloat16* src =
        reinterpret_cast<const __nv_bfloat16*>(prep + W.w2b) + (policy ? 0 : H * H);
    for (int q = tid; q < H * PIECES; q += kThreads) {
      const int k = q / PIECES, c = q % PIECES;
      cp_async16(reinterpret_cast<float*>(sW2 + tower_swz<H>(k, 8 * c)),
                 reinterpret_cast<const float*>(src + k * H + 8 * c));
    }
  }
  // this CTA's workspace row: zero (16-byte stores between the ends), then
  // its tower's entries
  float* row = ws + (long long)blockIdx.x * (L.P + 4);
  {
    const int n_row = L.P + 4;
    const unsigned to16 = (0u - (unsigned)(reinterpret_cast<uintptr_t>(row) >> 2)) & 3u;
    const int lead = min(n_row, (int)to16);
    const int n4 = (n_row - lead) / 4;
    for (int i = tid; i < lead; i += kThreads) row[i] = 0.0f;
    float4* row4 = reinterpret_cast<float4*>(row + lead);
    for (int i = tid; i < n4; i += kThreads) row4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = lead + 4 * n4 + tid; i < n_row; i += kThreads) row[i] = 0.0f;
  }
  if constexpr (!BIGD)
    for (int i = tid; i < D * H; i += kThreads) sW1[i] = w[L.w1 + i / H * H2 + c0 + i % H];
  const float* w1 = BIGD ? w + L.w1 + c0 : sW1;
  const int w1_ld = BIGD ? H2 : H;
  for (int i = tid; i < H; i += kThreads) {
    sb1[i] = w[L.b1 + c0 + i];
    sb2[i] = w[L.b2 + c0 + i];
  }
  for (int i = tid; i < A1; i += kThreads) sbh[i] = w[L.bh + i];
  if (gauss)
    for (int i = tid; i < A; i += kThreads) {
      sls[i] = w[L.ls + i];
      siv[i] = expf(-2.0f * w[L.ls + i]);
    }
  const float adv_mu = adv_stats[0], adv_inv_std = adv_stats[1];
  const float eps = p.clip_eps, inv_n = p.inv_n;
  const float g_value_scale = p.vf_coef * inv_n, ent_scale = p.ent_coef * inv_n;
  // the value head's entry of column tid (value tower); this lane's terms
  // k = lane + 32 i of the head's first dot: the value's, or the first
  // Gaussian mean's
  const float wv = !policy && tid < H ? prep[W.wv + tid] : 0.0f;
  float w_dot[H / 32];
#pragma unroll
  for (int i = 0; i < H / 32; ++i)
    w_dot[i] = policy ? prep[W.mp + (lane + 32 * i) * AP] : prep[W.wv + lane + 32 * i];
  // the column sums over a chunk's samples: column col of the tower, samples
  // part, part + kParts, ...
  constexpr int kParts = kThreads / H;
  const int col = tid % H, part = tid / H;

  // Wm's rows a slab of the logits through act0: two slabs, at most
  // kPieces 16-byte pieces a thread each
  int f_ks = 32;
  while (2 * f_ks * AP > RING || f_ks * AP > 4 * kPieces * kThreads) f_ks >>= 1;
  // the categorical policy CTA sums dWhc over the tile in a float32 copy
  // [H][AP] (16-byte aligned rows) in its row's dW2c block, which stage 1
  // zeroed and whose entries dw2c_split writes (or finds zero) after it; the
  // copy goes into the dWhc block, and its space back to zero, at the end
  float* dwh = row + L.w2;
  dwh += (0u - (unsigned)(reinterpret_cast<uintptr_t>(dwh) >> 2)) & 3u;

  // running sums kept over the chunks, float64 as in ppo_grad_wide: this
  // thread's part of column col of the tower's db1c, db2c, dW1c; dbhc entry
  // a on thread kThreads - 1 - a (policy) or A on thread kThreads - 1
  // (value), threads that own no column; the metric sums of the half-warp's
  // sample (lanes 0 and 16) and dlog_std (lanes a and 16 + a). Float32,
  // added chunk by chunk as ppo_grad_wide adds them into the row: the value
  // tower's entry tid of Whc's value column, and under the Gaussian head the
  // policy tower's entries tid + j kThreads of Whc's policy block [H][A]
  // (categorical: in dwh)
  constexpr int kWhPT = H * kMaxGaussA / kThreads;
  double acc_b1 = 0.0, acc_b2 = 0.0, acc_bh = 0.0;
  double acc_w1[kMaxD] = {0.0, 0.0, 0.0, 0.0};
  double met[4] = {0.0, 0.0, 0.0, 0.0};
  double acc_ls = 0.0;
  float acc_wv = 0.0f;
  float acc_wh[kWhPT];
#pragma unroll
  for (int j = 0; j < kWhPT; ++j) acc_wh[j] = 0.0f;

  const int n_elems = p.rows * S;
  auto fetch = [&](int chunk, float* dst) {
    const float* src = data + base + (long long)chunk * S;
    for (int e = tid; e < n_elems; e += kThreads)
      cp_async4(dst + e, src + (long long)(e / S) * N + e % S);
  };
  fetch(0, sX);
  cp_async_wait_all();
  __syncthreads();

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const float* x = sX + (chunk & 1) * (kMaxRows * S);
    if (chunk + 1 < n_chunks) fetch(chunk + 1, sX + ((chunk + 1) & 1) * (kMaxRows * S));
    // the logits' first slab, or first pair of runs
    if (cat_policy) ring_prefetch(act0, prep + W.mp, H, AP, logit_pairs(H) ? 64 : f_ks);

    // h1 = tanh(W1c^T x + b1c), the tower's columns, two a thread, and as
    // bf16 beside it (the categorical policy CTA keeps only the bf16 copy,
    // and g_p1 recomputes the same bits); the observations in float64 for
    // dW1c
    auto h1_at = [&](int s, int c) {
      float u = 0.0f;
      for (int d = 0; d < D; ++d) u = fmaf(w1[d * w1_ld + c], x[d * S + s], u);
      return tanhf(u + sb1[c]);
    };
    if (!BIGD && tid < D * S) sxd[tid] = (double)x[tid];
    for (int e = tid; e < S * H / 2; e += kThreads) {
      const int s = e / (H / 2), c = e % (H / 2) * 2;
      const float z0 = h1_at(s, c), z1 = h1_at(s, c + 1);
      if (!cat_policy) *reinterpret_cast<float2*>(act0 + s * LDA + c) = make_float2(z0, z1);
      *reinterpret_cast<unsigned*>(abf + s * LDB + c) = pack_bf16x2(z0, z1);
    }
    __syncthreads();

    // h2 = tanh(h1 W2 + b2c), from the resident block; h1 out to the
    // activation scratch from its bf16 copy
    {
      float acc[H / 64][4];
      tower_mma_smem<H, false>(abf, LDB, sW2, acc);
      __nv_bfloat16* dst = h_out + (m0 + (long long)chunk * S) * H2 + c0;
      for (int e = tid; e < S * H / 8; e += kThreads) {
        const int s = e / (H / 8), c = e % (H / 8) * 8;
        *reinterpret_cast<uint4*>(dst + (long long)s * H2 + c) =
            *reinterpret_cast<const uint4*>(abf + s * LDB + c);
      }
      tower_mma_smem_out<H>(acc, [&](int s, int c, float z) {
        act1[s * LDA + c] = tanhf(z + sb2[c]);
      });
    }
    __syncthreads();

    // head: the policy outputs (zero past A) or the value. The categorical
    // head's logits are one product, Wm through act0; the value and the
    // Gaussian head's few means are warp dots, a warp two samples, each lane
    // H / 32 terms and then a butterfly
    if (cat_policy) {
      head_logits<H>(act1, LDA, prep + W.mp, sbh, A, AP, f_ks, act0, out, LDO);
    } else {
      // the warp's two samples s0, s0 + 1 at once, from one load of the column
      const int s0 = warp * 2;
      for (int a = policy ? 0 : A; a < (policy ? A : A1); ++a) {
        float wk[H / 32];
#pragma unroll
        for (int i = 0; i < H / 32; ++i)
          wk[i] = a == (policy ? 0 : A) ? w_dot[i] : prep[W.mp + (lane + 32 * i) * AP + a];
        float z0 = 0.0f, z1 = 0.0f;
#pragma unroll
        for (int i = 0; i < H / 32; ++i) {
          z0 = fmaf(act1[s0 * LDA + lane + 32 * i], wk[i], z0);
          z1 = fmaf(act1[(s0 + 1) * LDA + lane + 32 * i], wk[i], z1);
        }
        z0 = warp_sum(z0) + sbh[a];
        z1 = warp_sum(z1) + sbh[a];
        if (lane == 0) {
          if (a < A) {
            out[s0 * LDO + a] = z0;
            out[(s0 + 1) * LDO + a] = z1;
          } else {
            sval[s0] = z0;
            sval[s0 + 1] = z1;
          }
        }
      }
      if (policy)
        for (int a = A + lane; a < AP; a += 32) {
          out[s0 * LDO + a] = 0.0f;
          out[(s0 + 1) * LDO + a] = 0.0f;
        }
    }
    __syncthreads();

    // per-sample loss: the policy tower's surrogate, KL and entropy, and
    // g_top in place of the head outputs; the value tower's value loss and
    // the gradient at the value. The value, and the Gaussian head: half-warp
    // h takes sample s0 + h of the warp's two (lane a of it action column
    // a). The categorical head: a warp takes its two samples in turn, lane l
    // the classes l, l + 32, ...
    const int s0 = warp * 2, hs = s0 + (lane >> 4), la = lane & 15;
    if (cat_policy) ring_prefetch(act0, prep + W.mt, AP, H, 16);   // g_p2's first slab
    if (!policy) {
      if (la == 0) {
        const float* xs = x + hs;
        const float old_v = xs[(D + na + 1) * S], ret = xs[(D + na + 3) * S];
        const float value = sval[hs];
        const float dv = value - old_v;
        const float e1 = value - ret;
        const float e2 = old_v + fminf(fmaxf(dv, -eps), eps) - ret;
        const bool inside_v = dv > -eps && dv < eps;
        met[1] += 0.5f * fmaxf(e1 * e1, e2 * e2);
        if (gauss) met[3] += value;
        sgv[hs] = (e1 * e1 >= e2 * e2 ? e1 : (inside_v ? e2 : 0.0f)) * g_value_scale;
      }
    } else if (gauss) {
      const float* xs = x + hs;
      float* o = out + hs * LDO;
      const float diff = la < A ? xs[(D + la) * S] - o[la] : 0.0f;
      const float logp = half_warp_sum(
          la < A ? -0.5f * (diff * diff * siv[la] + 2.0f * sls[la] + LOG_2PI_F) : 0.0f);
      const Surrogate u = clipped_surrogate(logp, xs[(D + na) * S],
                                            (xs[(D + na + 2) * S] - adv_mu) * adv_inv_std, eps,
                                            inv_n);
      if (la == 0) {
        met[0] += u.neg_min;
        met[2] += u.kl;
      }
      if (la < A) {
        o[la] = u.g_logp * diff * siv[la];
        acc_ls += u.g_logp * (diff * diff * siv[la] - 1.0f);
      }
    } else {
      for (int q = 0; q < 2; ++q) {
        const int s = s0 + q;
        const float* xs = x + s;
        float* o = out + s * LDO;
        float lp[kWideMaxA / 32];
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          lp[j] = a < A ? o[a] : -CUDART_INF_F;
          mx = fmaxf(mx, lp[j]);
        }
        mx = warp_max(mx);
        float se = 0.0f;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j)
          if (lane + 32 * j < A) se += expf(lp[j] - mx);
        const float lse = logf(warp_sum(se));
        const float act = xs[D * S];
        float pl = 0.0f, pe = 0.0f;
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          if (a < A) {
            lp[j] = (lp[j] - mx) - lse;
            if ((float)a == act) pl += lp[j];
            pe -= expf(lp[j]) * lp[j];
          }
        }
        const float logp = warp_sum(pl), ent = warp_sum(pe);
        const Surrogate u = clipped_surrogate(logp, xs[(D + na) * S],
                                              (xs[(D + na + 2) * S] - adv_mu) * adv_inv_std, eps,
                                              inv_n);
        if (lane == 0) {
          met[0] += u.neg_min;
          met[2] += u.kl;
          met[3] += ent;
        }
#pragma unroll
        for (int j = 0; j < kWideMaxA / 32; ++j) {
          const int a = lane + 32 * j;
          if (a < A) {
            const float prob = expf(lp[j]);
            const float onehot = (float)a == act ? 1.0f : 0.0f;
            o[a] = u.g_logp * (onehot - prob) + ent_scale * prob * (lp[j] + ent);
          }
        }
      }
    }
    __syncthreads();

    // head backward. Policy: dbhc, dWhc's policy block (Gaussian: entry
    // (k, a) = e = tid + j kThreads as e / A, e % A, in registers;
    // categorical: into dwh, head_rows_add). Value: dbhc[A], dWhc's
    // value column and g_p2 = g_v wv (1 - h2^2), thread k column k (it reads
    // h2's column k, then overwrites it)
    if (policy) {
      if (tid >= kThreads - A)
        for (int s = 0; s < S; ++s) acc_bh += out[s * LDO + kThreads - 1 - tid];
      if (gauss) {
#pragma unroll
        for (int j = 0; j < kWhPT; ++j) {
          const int e = tid + j * kThreads;
          if (e < H * A) {
            const float* h = act1 + e / A;
            const float* gt = out + e % A;
            float z = 0.0f;
#pragma unroll 8
            for (int s = 0; s < S; ++s) z = fmaf(h[s * LDA], gt[s * LDO], z);
            acc_wh[j] += z;
          }
        }
      }
      if (cat_policy) head_rows_add(dwh, act1, LDA, out, LDO, H, AP);
    } else {
      if (tid == kThreads - 1)
        for (int s = 0; s < S; ++s) acc_bh += sgv[s];
      if (tid < H) {
        float z = 0.0f;
        for (int s = 0; s < S; ++s) z = fmaf(act1[s * LDA + tid], sgv[s], z);
        acc_wv += z;
        for (int s = 0; s < S; ++s) {
          float* hp = act1 + s * LDA + tid;
          const float h = *hp;
          *hp = sgv[s] * wv * (1.0f - h * h);
        }
      }
    }
    __syncthreads();

    // policy: g_p2 = (g_top Wm^T) (1 - h2^2). The Gaussian head's few
    // classes by thread (col, part), its samples' sums over the classes a
    // < A in turn (the padding classes add zeros); the categorical head's
    // as one product, Wm^T through act0
    if (policy && gauss) {
      constexpr int SP = S / kParts;
      float z[SP];
#pragma unroll
      for (int i = 0; i < SP; ++i) z[i] = 0.0f;
      for (int a = 0; a < A; ++a) {
        const float mt = prep[W.mt + a * H + col];
#pragma unroll
        for (int i = 0; i < SP; ++i) z[i] = fmaf(out[(part + i * kParts) * LDO + a], mt, z[i]);
      }
#pragma unroll
      for (int i = 0; i < SP; ++i) {
        float* hp = act1 + (part + i * kParts) * LDA + col;
        const float h = *hp;
        *hp = z[i] * (1.0f - h * h);
      }
    } else if (policy) {
      // thread tiles of TSB samples (4 apart) x 4 columns, a warp 4 TSB
      // samples x 32 columns: lane l samples l / 8 + 4 i of its warp's and
      // columns 4 (l % 8).. of its warp's 32 (a quarter-warp reads one row of
      // g_top and 8 pieces of a row of Wm^T: one wavefront)
      constexpr int TSB = H / 64;
      const int b_s0 = warp / (H / 32) * 4 * TSB + lane / 8;
      const int b_c0 = warp % (H / 32) * 32 + lane % 8 * 4;
      float acc[TSB][4];
      ring_product<TSB>(out, LDO, 4, prep + W.mt, AP, H, 16, act0, b_s0, b_c0, true, acc);
#pragma unroll
      for (int i = 0; i < TSB; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* hp = act1 + (b_s0 + 4 * i) * LDA + b_c0 + c;
          const float h = *hp;
          *hp = acc[i][c] * (1.0f - h * h);
        }
    }
    __syncthreads();

    // db2c; g_p2 as bf16, out to the activation scratch (dW2c is
    // dw2c_split's) and beside it for the backward product
    for (int s = part; s < S; s += kParts) acc_b2 += act1[s * LDA + col];
    {
      __nv_bfloat16* dst = h_out + (n_mb + m0 + (long long)chunk * S) * H2 + c0;
      for (int e = tid; e < S * H / 4; e += kThreads) {
        const int s = e / (H / 4), c = e % (H / 4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(act1 + s * LDA + c);
        const uint2 u = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
        *reinterpret_cast<uint2*>(abf + s * LDB + c) = u;
        *reinterpret_cast<uint2*>(dst + (long long)s * H2 + c) = u;
      }
    }
    __syncthreads();

    // g_p1 = (g_p2 W2^T) (1 - h1^2), from the resident block
    {
      float acc[H / 64][4];
      tower_mma_smem<H, true>(abf, LDB, sW2, acc);
      tower_mma_smem_out<H>(acc, [&](int s, int c, float z) {
        float* hp = act0 + s * LDA + c;
        const float h = cat_policy ? h1_at(s, c) : *hp;
        *hp = z * (1.0f - h * h);
      });
    }
    __syncthreads();

    // db1c, dW1c
    for (int s = part; s < S; s += kParts) {
      const double gp = act0[s * LDA + col];
      acc_b1 += gp;
      if constexpr (!BIGD)
#pragma unroll
        for (int d = 0; d < kMaxD; ++d)
          if (d < D) acc_w1[d] = fma(sxd[d * S + s], gp, acc_w1[d]);
    }
    if constexpr (BIGD)
      // entry (d, c) of the chunk's share in float64, added into the row
      // (which only this thread writes there) with one rounding
      for (int o = tid; o < D * H; o += kThreads) {
        const float* xd = x + (o / H) * S;
        const float* gc = act0 + o % H;
        double z = 0.0;
        for (int s = 0; s < S; ++s) z = fma((double)xd[s], (double)gc[s * LDA], z);
        float* r = row + L.w1 + (o / H) * H2 + c0 + o % H;
        *r = (float)((double)*r + z);
      }
    cp_async_wait_all();
    __syncthreads();
  }

  // the categorical policy CTA's dWhc copy into its block, and its space
  // back to zero (the loop's last barrier made every thread's sums visible)
  if (cat_policy)
    for (int e = tid; e < H * AP; e += kThreads) {
      if (e % AP < A) row[L.wh + e / AP * A1 + e % AP] = dwh[e];
      dwh[e] = 0.0f;
    }
  // the register sums into the row: the column sums' parts added in part
  // order through the activations' space; the warps' metric sums and
  // dlog_std in warp order
  double* red = reinterpret_cast<double*>(act0);
  auto column_sums = [&](double v, float* dst) {
    __syncthreads();
    red[tid] = v;
    __syncthreads();
    if (tid < H) {
      double z = red[tid];
      for (int q = 1; q < kParts; ++q) z += red[q * H + tid];
      dst[tid] = (float)z;
    }
  };
  column_sums(acc_b1, row + L.b1 + c0);
  column_sums(acc_b2, row + L.b2 + c0);
  if constexpr (!BIGD)
#pragma unroll
    for (int d = 0; d < kMaxD; ++d)
      if (d < D) column_sums(acc_w1[d], row + L.w1 + d * H2 + c0);
  if (!policy && tid < H) row[L.wh + (H + tid) * A1 + A] = acc_wv;
  if (policy && gauss)
#pragma unroll
    for (int j = 0; j < kWhPT; ++j) {
      const int e = tid + j * kThreads;
      if (e < H * A) row[L.wh + e / A * A1 + e % A] = acc_wh[j];
    }
  if (policy ? tid >= kThreads - A : tid == kThreads - 1)
    row[L.bh + (policy ? kThreads - 1 - tid : A)] = (float)acc_bh;
  // the half-warps' sums into lanes 0..15
#pragma unroll
  for (int i = 0; i < 4; ++i) met[i] += __shfl_xor_sync(WIDE_FULL_MASK, met[i], 16);
  acc_ls += __shfl_xor_sync(WIDE_FULL_MASK, acc_ls, 16);
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) sred[warp * kMet + i] = (float)met[i];
  if (policy && gauss && lane < A) sred[warp * kMet + 4 + lane] = (float)acc_ls;
  __syncthreads();
  if (tid < 4 + (policy && gauss ? A : 0)) {
    float z = 0.0f;
    for (int v = 0; v < kWarps; ++v) z += sred[v * kMet + tid];
    if (tid < 4) {
      row[L.P + tid] = z;
    } else {
      row[L.ls + tid - 4] = z;
    }
  }
}

// ------------------------------------------------------- dW2c, split-K
// dW2c = h1^T g_p2 per tower over the n samples of the minibatch, after
// ppo_grad_wide has written h1 and g_p2 to the activation scratch. The
// samples are cut into ksplit_count(n, rows) ranges of whole blocks of
// kKBlock samples (at most kKSplitSamples each, at most one range per
// workspace row); each tower's [H, H] block into tiles of BM x BM. CTA
// (range j, tile t) sums its tile over its range and writes it into the dW2c
// block of workspace row j, which stage 1 zeroed; rows past the ranges and
// the cross-tower blocks stay zero, and stage 2 adds the rows in its fixed
// order. No atomics, and each CTA adds its samples in one order, so the bits
// stay fixed. Within a range the products of a block of kKBlock samples are
// summed apart and then added to the running sum, so a partial rounds like a
// sum of kKBlock + kKSplitSamples / kKBlock terms.
// It computes dW2c of _grad_tile (gym_fishing_tpu/kernels/ppo_update_kernel.py
// :296) out of the chunk loop.
// * float32: what bounds it is operations (2 x H^2 multiply-adds a sample:
//   6.9e10 FLOP for 2^18 samples at hidden 256, against 1.1 GB of float32
//   operands). FMA, a thread 4G x 4G entries of the tile in registers (groups
//   of 4 rows and columns BM / G apart, so a warp's shared-memory reads are
//   contiguous), operands through a ring of kDwStages cp.async stages of 16
//   samples.
// * bfloat16 (dw2c_split_bf16 below): what bounds it is bytes (0.54 GB of bf16
//   operands at hidden 256, 0.16 ms at 3.35 TB/s, against 0.07 ms of tensor
//   core work).
constexpr int kKBlock = 64;            // samples per block sum
constexpr int kKSplitSamples = 2048;   // samples per range, at most
constexpr int kDwStages = 3;
// bfloat16: stages of kKBlock samples in the TMA ring
constexpr int kDwRing = 6;

__host__ __device__ inline int ksplit_count(long long n, int rows) {
  const long long s = (n + kKSplitSamples - 1) / kKSplitSamples;
  return (int)(s < rows ? s : rows);
}

// First sample of range j of n_split over n samples (n a multiple of kKBlock).
__host__ __device__ inline long long ksplit_begin(long long n, int n_split, int j) {
  return (n / kKBlock) * j / n_split * kKBlock;
}

// The tile edge of dw2c_split at tower width H: the tower, up to 128.
__host__ __device__ constexpr int dw_tile(int H) { return H < 128 ? H : 128; }

template <int BM>
struct DwF32 {
  static constexpr int G = BM >= 128 ? 2 : 1;    // groups of 4 rows (columns) a thread
  static constexpr int TD = BM / (4 * G);        // threads along each edge
  static constexpr int NT = TD * TD;
  static constexpr int BK = 16;                  // samples a stage
  static constexpr size_t BYTES = sizeof(float) * 2 * kDwStages * BK * BM;
};

// bfloat16: a CTA's tile is BM x BM, BM = 64 at hidden 32 (both towers in
// one tile, whose cross-tower quarters are not written) and 64, else 128; the
// operands arrive by TMA in boxes of kKBlock samples x 64 columns (128-byte
// rows, 128-byte swizzle), BM / 64 boxes of h1 and of g_p2 a stage. BM / 64
// consumer warpgroups (one a 64-row slab of the tile) and one producer warp.
__host__ __device__ constexpr int dw_bf_tile(int H) { return H <= 64 ? 64 : 128; }

template <int BM>
struct DwBF {
  static constexpr int BOXES = BM / 64;           // boxes of each operand a stage
  static constexpr int CONSUMERS = 128 * BOXES;   // a warpgroup a 64-row slab of the tile
  static constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
  static constexpr int BOX_BYTES = kKBlock * 64 * 2;
  static constexpr int STAGE_BYTES = 2 * BOXES * BOX_BYTES;
  static constexpr size_t BYTES = (size_t)kDwRing * STAGE_BYTES + 1024;   // + the alignment
  static_assert(kKBlock == 64, "a stage is one block of 64 samples");
};

// The CTA's place: (tower, first row, first column of its tile, range j,
// its samples [k0, k1)).
struct DwPlace {
  int tw, r0, c0, j;
  long long k0, k1;
};

__device__ inline DwPlace dw_place(const GradParams& p, int BM, int n_split) {
  const int nt = p.hidden / BM, tiles = 2 * nt * nt;
  const long long n = (long long)p.num_tiles * p.tile;
  DwPlace d;
  const int t = blockIdx.x % tiles;
  d.j = blockIdx.x / tiles;
  d.tw = t / (nt * nt);
  d.r0 = t % (nt * nt) / nt * BM;
  d.c0 = t % nt * BM;
  d.k0 = ksplit_begin(n, n_split, d.j);
  d.k1 = ksplit_begin(n, n_split, d.j + 1);
  return d;
}

template <int BM>
__global__ void __launch_bounds__(DwF32<BM>::NT, 1)
    dw2c_split_f32(const GradParams p, int n_split, const float* __restrict__ act,
                   float* __restrict__ ws) {
  using C = DwF32<BM>;
  constexpr int G = C::G, TD = C::TD, NT = C::NT, BK = C::BK, TR = 4 * G, GS = BM / G;
  constexpr int STAGE = BK * BM;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);   // [kDwStages][BK][BM]
  float* sB = sA + kDwStages * STAGE;
  const int H = p.hidden, H2 = 2 * H, tid = threadIdx.x, ty = tid / TD, tx = tid % TD;
  const long long n = (long long)p.num_tiles * p.tile;
  const DwPlace d = dw_place(p, BM, n_split);
  const float* A = act + d.k0 * H2 + d.tw * H + d.r0;
  const float* B = act + (n + d.k0) * H2 + d.tw * H + d.c0;
  const int steps = (int)((d.k1 - d.k0) / BK);
  auto load = [&](int i) {
    float* a = sA + i % kDwStages * STAGE;
    float* b = sB + i % kDwStages * STAGE;
    const long long off = (long long)i * BK * H2;
    for (int e = tid; e < STAGE / 4; e += NT) {
      const int kk = e / (BM / 4), mm = e % (BM / 4) * 4;
      cp_async16(a + kk * BM + mm, A + off + (long long)kk * H2 + mm);
      cp_async16(b + kk * BM + mm, B + off + (long long)kk * H2 + mm);
    }
  };
  float acc[TR][TR], part[TR][TR];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int c = 0; c < TR; ++c) acc[i][c] = part[i][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();
    // the stage read in step i - 1, which every thread has finished
    if (i + kDwStages - 1 < steps) load(i + kDwStages - 1);
    cp_async_commit();
    const float* a = sA + i % kDwStages * STAGE + ty * 4;
    const float* b = sB + i % kDwStages * STAGE + tx * 4;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float x[TR], y[TR];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 u = *reinterpret_cast<const float4*>(a + kk * BM + g * GS);
        float4 v = *reinterpret_cast<const float4*>(b + kk * BM + g * GS);
        x[4 * g] = u.x; x[4 * g + 1] = u.y; x[4 * g + 2] = u.z; x[4 * g + 3] = u.w;
        y[4 * g] = v.x; y[4 * g + 1] = v.y; y[4 * g + 2] = v.z; y[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TR; ++c) part[r][c] = fmaf(x[r], y[c], part[r][c]);
    }
    if ((i + 1) % (kKBlock / BK) == 0) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TR; ++c) {
          acc[r][c] += part[r][c];
          part[r][c] = 0.0f;
        }
    }
  }
  cp_async_wait_all();
  const Layout L = make_layout(p.obs_dim, H2, p.act_dim);
  float* out = ws + (long long)d.j * (L.P + 4) + L.w2 + (d.tw * H) * (H2 + 1);
#pragma unroll
  for (int r = 0; r < TR; ++r) {
    const int row = d.r0 + r / 4 * GS + ty * 4 + r % 4;
#pragma unroll
    for (int c = 0; c < TR; ++c) out[row * H2 + d.c0 + c / 4 * GS + tx * 4 + c % 4] = acc[r][c];
  }
}

// dW2c under bfloat16. Each range's per-tower block is a product of two
// [2048, H] bf16 operands into an [H, H] float32 block: 2^18 samples at
// hidden 256 read 0.54 GB and do 6.9e10 FLOP, so the bound is bytes, and
// what the kernel needs is enough operand bytes in flight on every SM.
// * A CTA takes one BM x BM tile of a tower's block and one range: at hidden
//   256 the tower's 2 x 2 tiles of 128 are four CTAs, each fetching its own
//   h1 and g_p2 columns, so each operand byte is read from DRAM once and
//   from L2 twice (a 2 x 2 cluster that multicast each box to the two CTAs
//   sharing it was measured slower on the H100, 0.277 against 0.267 ms: the
//   ring moves ~2.1 TB/s of DRAM reads whatever it requests, and the second
//   read from L2 costs nothing). Below hidden 256 a tile is a whole tower
//   block (or at hidden 32 both).
// * The producer warp keeps a ring of kDwRing stages of one block of 64
//   samples (32 KB at BM = 128) requested by TMA into 128-byte swizzled
//   shared memory; the consumers wait on one mbarrier a stage and release
//   it on an `empty` barrier that counts the consumer warps (a stage is
//   refilled only when all its readers are done).
// * Each consumer warpgroup runs its 64-row slab of the tile on wgmma
//   (m64 x BM x k16, bf16 from the swizzled boxes as they lie, transposed:
//   h1 and g_p2 are sample-major; float32 sums in registers): a stage's 64
//   samples are summed apart into `blk`, then added to the range's sum
//   `acc` (the float32 accumulation of 64 + 32 terms that the bar of 2e-5 of
//   a range's largest entry is set for), 2 x 64 registers a thread at BM =
//   128. mma.sync with ldmatrix (a warp a [64, 32] sub-tile) took 0.29 ms at
//   hidden 256 with the same ring, and its products alone 0.26 ms: with
//   wgmma the products hide under the loads.
// * The epilogue stores each thread's pairs of columns into the range's
//   workspace row, as float2 where the row's offset allows (P + 4 is odd).
template <int BM>
__global__ void __launch_bounds__(DwBF<BM>::THREADS, 1)
    dw2c_split_bf16(const GradParams p, int n_split, const __grid_constant__ CUtensorMap act_map,
                    float* __restrict__ ws) {
  using C = DwBF<BM>;
  constexpr int BOXES = C::BOXES, BOX = C::BOX_BYTES;
  extern __shared__ __align__(128) unsigned char dsmem[];
  __shared__ __align__(8) uint64_t full[kDwRing], empty[kDwRing];
  const uint32_t ring = (smem_u32(dsmem) + 1023u) & ~1023u;   // the swizzle's alignment
  const int H = p.hidden, H2 = 2 * H, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long n = (long long)p.num_tiles * p.tile;
  // the CTA's place: range j, tower tw, tile (tr, tc) of the tower's block;
  // r0 and c0 are its first row and column in the merged [2H, 2H] block,
  // which are also its first h1 and g_p2 columns in the scratch
  const int per_range = BM > H ? 1 : 2 * (H / BM) * (H / BM), per_tower = per_range / 2;
  const int j = blockIdx.x / per_range, tw = BM > H ? 0 : blockIdx.x % per_range / per_tower;
  const int tile = BM > H ? 0 : blockIdx.x % per_tower, tr = tile >> 1, tc = tile & 1;
  const int r0 = tw * H + tr * BM, c0 = tw * H + tc * BM;
  const long long k0 = ksplit_begin(n, n_split, j);
  const int steps = (int)((ksplit_begin(n, n_split, j + 1) - k0) / kKBlock);
  if (tid == 0) {
    for (int s = 0; s < kDwRing; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == C::CONSUMERS / 32) {
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kDwRing;
        if (i >= kDwRing) mbar_wait(&empty[s], (i / kDwRing - 1) & 1);
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        const uint32_t a = ring + s * C::STAGE_BYTES, b = a + BOXES * BOX;
        const int ka = (int)(k0 + (long long)i * kKBlock), kb = (int)(n + ka);
#pragma unroll
        for (int x = 0; x < BOXES; ++x) {
          tma_load_2d(a + x * BOX, &act_map, r0 + 64 * x, ka, &full[s]);
          tma_load_2d(b + x * BOX, &act_map, c0 + 64 * x, kb, &full[s]);
        }
      }
    }
  } else {
    const int wgi = warp / 4, wq = warp % 4;   // warpgroup (64-row slab), its warp
    float acc[BM / 2], blk[BM / 2];
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[e] = 0.0f;
    for (int i = 0; i < steps; ++i) {
      const int s = i % kDwRing;
      mbar_wait(&full[s], (i / kDwRing) & 1);
      // A: the slab's h1 box; B: the tile's BM g_p2 columns, BOXES boxes; a
      // k-step is 16 rows of 128 bytes further
      const uint32_t a = ring + s * C::STAGE_BYTES + wgi * BOX, b = a - wgi * BOX + BOXES * BOX;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKBlock / kMmaK; ++ks)
        wgmma_bf16_mn<BM>(blk, wgmma_desc_mn128(a + ks * 2048, BOX),
                          wgmma_desc_mn128(b + ks * 2048, BOX), ks);
      wgmma_commit();
      wgmma_wait_all();
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int e = 0; e < BM / 2; ++e) acc[e] += blk[e];
    }
    const Layout L = make_layout(p.obs_dim, H2, p.act_dim);
    float* out = ws + (long long)j * (L.P + 4) + L.w2;
    // a row of P + 4 floats: P is odd, so every other row's entries pair up
    // at 8-byte boundaries only one float further on
    const bool pairs = (((long long)j * (L.P + 4) + L.w2) & 1) == 0;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int jn = 0; jn < BM / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + wgi * 64 + wq * 16 + g + 8 * h, col = c0 + 8 * jn + 2 * t;
        if ((row < H) != (col < H)) continue;   // at hidden 32 the tile holds both towers
        float* o = out + (long long)row * H2 + col;
        const float x = acc[4 * jn + 2 * h], y = acc[4 * jn + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(o) = make_float2(x, y);
        } else {
          o[0] = x;
          o[1] = y;
        }
      }
  }
}

// Stage 2: out[i] = sum over the G workspace rows (kSplit per visited tile):
// blocks of kRowBlock rows in row order, then the blocks' sums in order, so
// the float32 error grows with G / kRowBlock + kRowBlock rather than with G.
constexpr int kRowBlock = 16;

__global__ void __launch_bounds__(256) reduce_rows(const float* __restrict__ ws, int G, int PW,
                                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= PW) return;
  float z = 0.0f;
  for (int g0 = 0; g0 < G; g0 += kRowBlock) {
    float b = 0.0f;
    for (int g = g0; g < min(G, g0 + kRowBlock); ++g) b += ws[(long long)g * PW + i];
    z += b;
  }
  out[i] = z;
}

// Stage 3 (K3 only): the masked global-norm clip and Adam over the merged
// buffer [P], as a grid-wide pass in two launches. Replaces the optimizer
// step of _ppo_grad_adam_kernel (gym_fishing_tpu/kernels/ppo_update_kernel.py::
// _optimizer_step, :500-560): the cross-tower blocks of dW2c and dWhc masked,
// the Gaussian head's entropy term -ent_coef joined to log_std's gradient
// before the clip, the categorical log_std and its moments carried through,
// then optax's Adam with the host's bias corrections.
// What bounds it: bytes, 28 a parameter (g, w, m, v read, w, m, v written):
// 7.4 MB at hidden 256, 2.2 us at 3.35 TB/s. One CTA took 0.33-0.54 ms there,
// latency-bound on one SM while the other 131 idled.
// What the design does about it: the buffer is cut into CTA runs (adam_plan)
// that fill the card: runs of kAdamRun floats over W1c, b1c, W2c and b2c,
// read and written 16 bytes a thread, W2c's mask taken per float4 from
// shifts (2H is a power of two, and a float4 never straddles a tower); then
// blocks of kAdamHeadRows rows of Whc, walked row by row (a warp a row, its
// lanes along the A + 1 columns in fixed chunks of 32), so no entry needs a
// / or %; then one CTA for bhc and log_std. clip_norm_parts writes each CTA's sum of squares of
// the masked gradient to a slot of its own; clip_adam_apply's CTAs each sum
// all slots in one fixed order, so every CTA holds the same norm bits, and
// apply the clip and Adam to their run. A thread's entries of a run are a
// fixed count, so their loads go out together, and clip_adam_apply is a
// programmatic dependent launch: its body and head CTAs load their run while
// clip_norm_parts still runs, so the second launch's latency overlaps the
// first. No atomics: two
// identical launches give identical bits. The masked cross-tower entries get a zero gradient, so
// zero weights and moments there stay exactly zero.
constexpr int kAdamThreads = 256;
constexpr int kAdamRun = 2048;      // floats of a body CTA's run: 2 float4 a thread
constexpr int kAdamHeadRows = 16;   // rows of Whc a head CTA walks: 2 a warp
constexpr int kAdamBody4 = kAdamRun / (4 * kAdamThreads);   // float4 a thread of a body run
constexpr int kAdamHeadChunks = (kWideMaxA + 1 + 31) / 32;   // 32-column chunks of a Whc row
static_assert(kAdamRun == 8 * kAdamThreads && kAdamHeadRows == 2 * kAdamThreads / 32, "runs");

// CTAs over [0, L.wh) (W1c, b1c, W2c, b2c), over Whc's 2H rows, and in all
// (one more for bhc and log_std).
struct AdamPlan {
  int body, head, ctas;
};

__host__ __device__ inline AdamPlan adam_plan(const Layout& L, int H2) {
  AdamPlan a;
  a.body = (L.wh + kAdamRun - 1) / kAdamRun;
  a.head = H2 / kAdamHeadRows;
  a.ctas = a.body + a.head + 1;
  return a;
}

// A thread's entries in its CTA's run, each a fixed number a thread, so that
// their loads go out together: the k-th float4 of a body run (its index, a
// multiple of 4; -1 past the body) and its masked gradient; in a head run
// the entry of chunk k of row rr of this warp (-1 past the row) and its
// masked gradient.
__device__ __forceinline__ int body_entry(const GradParams& p, const Layout& L, int k,
                                          const float* __restrict__ grad, float4& g) {
  const int H = p.hidden, H2 = 2 * H;
  const int i = blockIdx.x * kAdamRun + 4 * (k * kAdamThreads + threadIdx.x);
  if (i >= L.wh) return -1;
  g = *reinterpret_cast<const float4*>(grad + i);
  if (i >= L.w2 && i < L.b2) {
    const int e = i - L.w2, lg = __ffs(H2) - 1;   // 2H is a power of two
    if (((e >> lg) < H) != ((e & (H2 - 1)) < H)) g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  return i;
}

__device__ __forceinline__ int head_entry(const GradParams& p, const Layout& L, const AdamPlan& a,
                                          int rr, int k, const float* __restrict__ grad,
                                          float& g) {
  const int A = p.act_dim, A1 = A + 1, c = (threadIdx.x & 31) + 32 * k;
  const int r = (blockIdx.x - a.body) * kAdamHeadRows + 2 * (threadIdx.x >> 5) + rr;
  if (c >= A1) return -1;
  const int i = L.wh + r * A1 + c;
  g = (r < p.hidden ? c < A : c == A) ? grad[i] : 0.0f;
  return i;
}

// The tail run (bhc, then log_std): the gradient of entry i, and whether it
// is a parameter (the categorical head has no log_std).
__device__ __forceinline__ float tail_grad(const GradParams& p, const Layout& L, int i,
                                           const float* __restrict__ grad, bool& param) {
  const bool gauss = p.head == GAUSSIAN;
  param = i < L.ls || gauss;
  return i < L.ls ? grad[i] : gauss ? grad[i] - p.ent_coef : 0.0f;
}

// Sum of x over the CTA in a fixed order (a butterfly in each warp, then the
// warps' sums in warp order), the same bits in every thread.
__device__ __forceinline__ float cta_sum(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float z = 0.0f;
#pragma unroll
  for (int v = 0; v < kAdamThreads / 32; ++v) z += red[v];
  return z;
}

// Programmatic dependent launch: clip_adam_apply is launched to start while
// clip_norm_parts runs, loads what does not depend on it, and waits for it
// (and its writes) only before it reads the partial sums.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(kAdamThreads) clip_norm_parts(const GradParams p,
                                                              const float* __restrict__ grad,
                                                              float* __restrict__ parts) {
  __shared__ float red[kAdamThreads / 32];
  launch_dependents();
  const Layout L = make_layout(p.obs_dim, 2 * p.hidden, p.act_dim);
  const AdamPlan a = adam_plan(L, 2 * p.hidden);
  float ss = 0.0f;
  if (blockIdx.x < a.body) {
#pragma unroll
    for (int k = 0; k < kAdamBody4; ++k) {
      float4 g;
      if (body_entry(p, L, k, grad, g) < 0) continue;
      ss = fmaf(g.x, g.x, ss);
      ss = fmaf(g.y, g.y, ss);
      ss = fmaf(g.z, g.z, ss);
      ss = fmaf(g.w, g.w, ss);
    }
  } else if (blockIdx.x < a.body + a.head) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < kAdamHeadChunks; ++k) {
        float g;
        if (head_entry(p, L, a, rr, k, grad, g) >= 0) ss = fmaf(g, g, ss);
      }
  } else {
    for (int i = L.bh + threadIdx.x; i < L.P; i += kAdamThreads) {
      bool param;
      const float g = tail_grad(p, L, i, grad, param);
      ss = fmaf(g, g, ss);
    }
  }
  ss = cta_sum(ss, red);
  if (threadIdx.x == 0) parts[blockIdx.x] = ss;
}

__device__ __forceinline__ void adam_entry(const AdamParams& q, float g, float w, float m,
                                           float v, float& w_out, float& m_out, float& v_out) {
  const float mn = q.beta1 * m + q.one_minus_b1 * g;
  const float vn = q.beta2 * v + q.one_minus_b2 * (g * g);
  const float mhat = mn / q.bc1, vhat = vn / q.bc2;
  w_out = w - q.lr * mhat / (sqrtf(vhat) + q.adam_eps);
  m_out = mn;
  v_out = vn;
}

__global__ void __launch_bounds__(kAdamThreads) clip_adam_apply(
    const GradParams p, const AdamParams q, const float* __restrict__ grad,
    const float* __restrict__ w, const float* __restrict__ m, const float* __restrict__ v,
    float* __restrict__ w_out, float* __restrict__ m_out, float* __restrict__ v_out,
    const float* __restrict__ parts) {
  __shared__ float red[kAdamThreads / 32];
  const Layout L = make_layout(p.obs_dim, 2 * p.hidden, p.act_dim);
  const AdamPlan a = adam_plan(L, 2 * p.hidden);
  // a body or head CTA's run into registers before the wait: stage 2's
  // gradients and the weights and moments are there before clip_norm_parts
  // starts
  const bool body = blockIdx.x < a.body, head = !body && blockIdx.x < a.body + a.head;
  int bi[kAdamBody4], hi[2][kAdamHeadChunks];
  float4 bg[kAdamBody4], bw[kAdamBody4], bm[kAdamBody4], bv[kAdamBody4];
  float hg[2][kAdamHeadChunks], hw[2][kAdamHeadChunks], hm[2][kAdamHeadChunks],
      hv[2][kAdamHeadChunks];
  if (body) {
#pragma unroll
    for (int k = 0; k < kAdamBody4; ++k) {
      bi[k] = body_entry(p, L, k, grad, bg[k]);
      if (bi[k] < 0) continue;
      bw[k] = *reinterpret_cast<const float4*>(w + bi[k]);
      bm[k] = *reinterpret_cast<const float4*>(m + bi[k]);
      bv[k] = *reinterpret_cast<const float4*>(v + bi[k]);
    }
  } else if (head) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < kAdamHeadChunks; ++k) {
        hi[rr][k] = head_entry(p, L, a, rr, k, grad, hg[rr][k]);
        if (hi[rr][k] < 0) continue;
        hw[rr][k] = w[hi[rr][k]];
        hm[rr][k] = m[hi[rr][k]];
        hv[rr][k] = v[hi[rr][k]];
      }
  }
  wait_prerequisites();
  float ss = 0.0f;
  for (int k = threadIdx.x; k < a.ctas; k += kAdamThreads) ss += parts[k];
  const float norm = sqrtf(cta_sum(ss, red));
  const float scale = norm < q.max_grad_norm ? 1.0f : q.max_grad_norm / norm;
  if (body) {
#pragma unroll
    for (int k = 0; k < kAdamBody4; ++k) {
      if (bi[k] < 0) continue;
      float4 wo, mo, vo;
      adam_entry(q, bg[k].x * scale, bw[k].x, bm[k].x, bv[k].x, wo.x, mo.x, vo.x);
      adam_entry(q, bg[k].y * scale, bw[k].y, bm[k].y, bv[k].y, wo.y, mo.y, vo.y);
      adam_entry(q, bg[k].z * scale, bw[k].z, bm[k].z, bv[k].z, wo.z, mo.z, vo.z);
      adam_entry(q, bg[k].w * scale, bw[k].w, bm[k].w, bv[k].w, wo.w, mo.w, vo.w);
      *reinterpret_cast<float4*>(w_out + bi[k]) = wo;
      *reinterpret_cast<float4*>(m_out + bi[k]) = mo;
      *reinterpret_cast<float4*>(v_out + bi[k]) = vo;
    }
  } else if (head) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int k = 0; k < kAdamHeadChunks; ++k) {
        const int i = hi[rr][k];
        if (i >= 0)
          adam_entry(q, hg[rr][k] * scale, hw[rr][k], hm[rr][k], hv[rr][k], w_out[i], m_out[i],
                     v_out[i]);
      }
  } else {
    for (int i = L.bh + threadIdx.x; i < L.P; i += kAdamThreads) {
      bool param;
      const float g = tail_grad(p, L, i, grad, param);
      if (param) {
        adam_entry(q, g * scale, w[i], m[i], v[i], w_out[i], m_out[i], v_out[i]);
      } else {
        w_out[i] = w[i];
        m_out[i] = m[i];
        v_out[i] = v[i];
      }
    }
  }
}

// The network's sizes, which every stage reads.
static bool sizes_ok(const GradParams* p) {
  const bool gauss = p->head == GAUSSIAN;
  return (p->hidden == 32 || p->hidden == 64 || p->hidden == 128 || p->hidden == 256) &&
         p->obs_dim >= 1 && p->obs_dim <= kMaxObsD && p->act_dim >= 1 &&
         p->act_dim <= (gauss ? kMaxGaussA : kWideMaxA) &&
         (p->head == GAUSSIAN || p->head == CATEGORICAL);
}

static int check_params(const GradParams* p) {
  const int na = p->head == GAUSSIAN ? p->act_dim : 1;
  if (!sizes_ok(p) || (p->compute != FLOAT32 && p->compute != BFLOAT16) ||
      (p->rows != 8 && p->rows != 16 && p->rows != kMaxRows) || p->obs_dim + na + 4 > p->rows ||
      p->tile < kChunk || p->tile % kChunk || p->num_tiles < 1 || p->n_cols < p->tile ||
      p->n_cols % p->tile)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Hidden 32 and 64 with at most kMaxA logits take ppo_grad_tiles; every
// other size the wide path, whose weights wide_prep lays out first.
static bool wide_path(int hidden, int act_dim) { return hidden > 64 || act_dim > kMaxA; }

template <int H2, bool BF, bool BIGD>
static int launch_tiles(const GradParams* p, const float* data, const int* order,
                        const float* w, const float* adv, float* ws, cudaStream_t st) {
  constexpr size_t bytes = Smem<H2, BF>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(
      ppo_grad_tiles<H2, BF, BIGD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  ppo_grad_tiles<H2, BF, BIGD><<<p->num_tiles * kSplit, kThreads, bytes, st>>>(
      *p, data, order, w, adv, ws);
  return (int)cudaGetLastError();
}

// The wide path's stage 1: wide_prep, then ppo_grad_tower under bfloat16 at
// hidden 64 and above (from W2B) and ppo_grad_wide otherwise (from FW, GW).
template <int H2, bool BF, bool BIGD>
static int launch_wide(const GradParams* p, const float* data, const int* order, const float* w,
                       float* prep, const float* adv, void* act, float* ws, cudaStream_t st) {
  constexpr bool TOWER = kWideMma<H2, BF>;
  cudaError_t e = launch_wide_prep(w, p->obs_dim, H2 / 2, p->act_dim, BF, false, prep, st, false,
                                   false, TOWER);
  if (e != cudaSuccess) return (int)e;
  if constexpr (TOWER) {
    constexpr size_t bytes = TowerSmem<H2>::BYTES;
    const auto kernel = p->head == CATEGORICAL ? ppo_grad_tower<H2, BIGD, true>
                                               : ppo_grad_tower<H2, BIGD, false>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<p->num_tiles * kSplit, kThreads, bytes, st>>>(*p, data, order, w, prep, adv, act,
                                                            ws);
  } else {
    constexpr size_t bytes = WideSmem<H2, BF>::BYTES;
    e = cudaFuncSetAttribute(ppo_grad_wide<H2, BF, BIGD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ppo_grad_wide<H2, BF, BIGD><<<p->num_tiles * kSplit, kThreads, bytes, st>>>(
        *p, data, order, w, prep, adv, act, ws);
  }
  return (int)cudaGetLastError();
}

template <int H2, bool BF>
static int launch_dw2c(const GradParams* p, const void* act, float* ws, cudaStream_t st) {
  constexpr int H = H2 / 2, BM = dw_tile(H), tiles = 2 * (H / BM) * (H / BM);
  const long long n = (long long)p->num_tiles * p->tile;
  const int n_split = ksplit_count(n, p->num_tiles * kSplit);
  if constexpr (BF) {
    constexpr int BB = dw_bf_tile(H);
    constexpr int per_range = BB > H ? 1 : 2 * (H / BB) * (H / BB);
    constexpr size_t bytes = DwBF<BB>::BYTES;
    // h1 then g_p2: one bf16 matrix [2n][2H]
    CUtensorMap map;
    const int err = encode_bf16_map(&map, act, 2 * n, H2, kKBlock, 64);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        dw2c_split_bf16<BB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    dw2c_split_bf16<BB><<<per_range * n_split, DwBF<BB>::THREADS, bytes, st>>>(*p, n_split, map,
                                                                             ws);
  } else {
    constexpr size_t bytes = DwF32<BM>::BYTES;
    const cudaError_t e = cudaFuncSetAttribute(
        dw2c_split_f32<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    dw2c_split_f32<BM><<<tiles * n_split, DwF32<BM>::NT, bytes, st>>>(
        *p, n_split, static_cast<const float*>(act), ws);
  }
  return (int)cudaGetLastError();
}

template <bool BF>
static int launch_dw2c_h(const GradParams* p, const void* act, float* ws, cudaStream_t st) {
  switch (p->hidden) {
    case 32: return launch_dw2c<64, BF>(p, act, ws, st);
    case 64: return launch_dw2c<128, BF>(p, act, ws, st);
    case 128: return launch_dw2c<256, BF>(p, act, ws, st);
    default: return launch_dw2c<512, BF>(p, act, ws, st);
  }
}

template <bool BF, bool BIGD>
static int launch_path(const GradParams* p, const float* data, const int* order,
                         const float* w, float* prep, const float* adv, void* act, float* ws,
                         cudaStream_t st) {
  if (!wide_path(p->hidden, p->act_dim))
    return p->hidden == 64 ? launch_tiles<128, BF, BIGD>(p, data, order, w, adv, ws, st)
                           : launch_tiles<64, BF, BIGD>(p, data, order, w, adv, ws, st);
  if (prep == nullptr || act == nullptr) return (int)cudaErrorInvalidValue;
  switch (p->hidden) {
    case 32: return launch_wide<64, BF, BIGD>(p, data, order, w, prep, adv, act, ws, st);
    case 64: return launch_wide<128, BF, BIGD>(p, data, order, w, prep, adv, act, ws, st);
    case 128: return launch_wide<256, BF, BIGD>(p, data, order, w, prep, adv, act, ws, st);
    default: return launch_wide<512, BF, BIGD>(p, data, order, w, prep, adv, act, ws, st);
  }
}

template <bool BF>
static int launch_stage1(const GradParams* p, const float* data, const int* order,
                         const float* w, float* prep, const float* adv, void* act, float* ws,
                         cudaStream_t st) {
  return p->obs_dim > kMaxD ? launch_path<BF, true>(p, data, order, w, prep, adv, act, ws, st)
                            : launch_path<BF, false>(p, data, order, w, prep, adv, act, ws, st);
}

static int stage1(const GradParams* p, const float* data, const int* order, const float* w,
                  float* prep, const float* adv, void* act, float* ws, cudaStream_t st) {
  return p->compute == BFLOAT16
             ? launch_stage1<true>(p, data, order, w, prep, adv, act, ws, st)
             : launch_stage1<false>(p, data, order, w, prep, adv, act, ws, st);
}

// dW2c of the wide path from the activation scratch into the workspace rows.
static int dw2c_stage(const GradParams* p, const void* act, float* ws, cudaStream_t st) {
  if (act == nullptr) return (int)cudaErrorInvalidValue;
  return p->compute == BFLOAT16 ? launch_dw2c_h<true>(p, act, ws, st)
                                : launch_dw2c_h<false>(p, act, ws, st);
}

// Stages 1 (with dw2c_split on the wide path) and 2: gout[P + 4] = (merged
// gradients, metric sums).
static int grad_stages(const GradParams* p, const float* data, const int* order, const float* w,
                       float* prep, const float* adv, void* act, float* ws, float* gout,
                       cudaStream_t st) {
  int err = check_params(p);
  if (err) return err;
  err = stage1(p, data, order, w, prep, adv, act, ws, st);
  if (err) return err;
  if (wide_path(p->hidden, p->act_dim)) {
    err = dw2c_stage(p, act, ws, st);
    if (err) return err;
  }
  const int PW = make_layout(p->obs_dim, 2 * p->hidden, p->act_dim).P + 4;
  reduce_rows<<<(PW + 255) / 256, 256, 0, st>>>(ws, p->num_tiles * kSplit, PW, gout);
  return (int)cudaGetLastError();
}

// prep: prep_floats(hidden, act_dim) floats of scratch, act:
// ppo_grad_act_bytes(hidden, act_dim, compute, G * tile) bytes (none for
// the narrow path: both may be null there).
extern "C" int ppo_grad_launch(const GradParams* p, const float* data, const int* order,
                               const float* w, float* prep, void* act, const float* adv,
                               float* ws, float* gout, void* stream) {
  return grad_stages(p, data, order, w, prep, adv, act, ws, gout, (cudaStream_t)stream);
}

// Stage 3 in its two launches; parts: adam_plan(...).ctas floats of scratch.
static int clip_adam_stage(const GradParams* p, const AdamParams* q, const float* gout,
                           const float* w, const float* m, const float* v, float* w_out,
                           float* m_out, float* v_out, float* parts, cudaStream_t st) {
  const AdamPlan a = adam_plan(make_layout(p->obs_dim, 2 * p->hidden, p->act_dim), 2 * p->hidden);
  clip_norm_parts<<<a.ctas, kAdamThreads, 0, st>>>(*p, gout, parts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ctas);
  cfg.blockDim = dim3(kAdamThreads);
  cfg.stream = st;
  cudaLaunchAttribute early[1];
  early[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = early;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, clip_adam_apply, *p, *q, gout, w, m, v, w_out, m_out, v_out,
                         static_cast<const float*>(parts));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int ppo_grad_adam_launch(const GradParams* p, const AdamParams* q, const float* data,
                                    const int* order, const float* w, const float* m,
                                    const float* v, float* prep, void* act, const float* adv,
                                    float* ws, float* gout, float* w_out, float* m_out,
                                    float* v_out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = grad_stages(p, data, order, w, prep, adv, act, ws, gout, st);
  if (err) return err;
  // stage 2 has read the workspace: its first entries hold stage 3's partial sums
  return clip_adam_stage(p, q, gout, w, m, v, w_out, m_out, v_out, ws, st);
}

// Stage 3 alone, from a merged gradient buffer gout [P + 4] as stage 2 writes
// it; parts: ppo_clip_adam_ctas(...) floats of scratch.
extern "C" int ppo_clip_adam_launch(const GradParams* p, const AdamParams* q, const float* gout,
                                    const float* w, const float* m, const float* v,
                                    float* w_out, float* m_out, float* v_out, float* parts,
                                    void* stream) {
  if (!sizes_ok(p)) return (int)cudaErrorInvalidValue;
  return clip_adam_stage(p, q, gout, w, m, v, w_out, m_out, v_out, parts, (cudaStream_t)stream);
}

// The CTAs of stage 3, each with a partial sum of its own in the scratch.
extern "C" int ppo_clip_adam_ctas(int obs_dim, int hidden, int act_dim) {
  return adam_plan(make_layout(obs_dim, 2 * hidden, act_dim), 2 * hidden).ctas;
}

// The two launches of the wide path's stage 1 apart, for timing them and
// holding dw2c_split against its plain version: wide_prep and ppo_grad_wide
// or ppo_grad_tower (the workspace rows without dW2c, and the activation
// scratch), then
// dw2c_split alone (the rows' dW2c blocks from the scratch).
extern "C" int ppo_grad_stage1_launch(const GradParams* p, const float* data, const int* order,
                                      const float* w, float* prep, void* act, const float* adv,
                                      float* ws, void* stream) {
  const int err = check_params(p);
  if (err) return err;
  if (!wide_path(p->hidden, p->act_dim)) return (int)cudaErrorInvalidValue;
  return stage1(p, data, order, w, prep, adv, act, ws, (cudaStream_t)stream);
}

extern "C" int ppo_grad_dw2c_launch(const GradParams* p, const void* act, float* ws,
                                    void* stream) {
  const int err = check_params(p);
  if (err) return err;
  if (!wide_path(p->hidden, p->act_dim)) return (int)cudaErrorInvalidValue;
  return dw2c_stage(p, act, ws, (cudaStream_t)stream);
}

extern "C" int ppo_grad_params_size(void) { return (int)sizeof(GradParams); }

// Whether stage 1 at these sizes runs ppo_grad_tower (the wrapper counts its
// launches): the wide path under bfloat16 at hidden 64 and above.
extern "C" int ppo_grad_tower_path(int hidden, int act_dim, int compute) {
  return wide_path(hidden, act_dim) && compute == BFLOAT16 && hidden >= 64;
}

// Whether stage 1 at these sizes runs the categorical logits two runs of Wm
// at a time (the wrapper counts such launches): ppo_grad_tower with the
// categorical head where logit_pairs(hidden).
extern "C" int ppo_grad_logit_pair_path(int hidden, int act_dim, int compute, int head) {
  return ppo_grad_tower_path(hidden, act_dim, compute) && head == CATEGORICAL &&
         logit_pairs(hidden);
}

extern "C" int ppo_grad_prep_floats(int hidden, int act_dim) {
  return wide_path(hidden, act_dim) ? wide_prep_layout(hidden, wide_ap(act_dim)).total : 0;
}

// Bytes of the activation scratch for n samples: h1 and g_p2 [n][2H], 4
// bytes an entry under float32 and 2 under bfloat16 (none on the narrow path).
extern "C" long long ppo_grad_act_bytes(int hidden, int act_dim, int compute, long long n) {
  if (!wide_path(hidden, act_dim)) return 0;
  return 2 * n * 2 * hidden * (compute == BFLOAT16 ? 2 : 4);
}

extern "C" int ppo_adam_params_size(void) { return (int)sizeof(AdamParams); }

// The grid plan the wrapper sizes the workspace by: samples per chunk, and
// workspace rows per visited tile; dw2c_split's block and range of samples
// and its range count for n samples over `rows` workspace rows.
extern "C" int ppo_grad_chunk(void) { return kChunk; }

extern "C" int ppo_grad_split(void) { return kSplit; }

extern "C" int ppo_grad_kblock(void) { return kKBlock; }

extern "C" int ppo_grad_ksplit_samples(void) { return kKSplitSamples; }

extern "C" int ppo_grad_ksplit_count(long long n, int rows) { return ksplit_count(n, rows); }

extern "C" const char* cuda_error_string(int err) {
  static char msg[96];
  if (err == kTensorMapError) return "cuTensorMapEncodeTiled not found by the runtime";
  if (err > kTensorMapError) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed with CUresult %d",
             err - kTensorMapError);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
