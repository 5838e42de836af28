// Fused spatial self-attention (K6a and K6b) for Hopper (sm_90a).
//
// Replaces dvdgan_tpu/kernels/attention_spatial.py:_spatial_attn_pallas
// (K6a, one frame per program, the whole frame's logits in VMEM) and
// :_spatial_attn_tiled_pallas (K6b, query rows tiled, kv resident). Per frame
// of x (N, H, W, C), with kv = 2x2 max-pool(x) (HW/4 tokens):
//
//   q = x Wq (C -> c8)   k = kv Wk (C -> c8)   v = kv Wv (C -> c2)
//   out = x + gamma * softmax(q k^T) v Wo        (no 1/sqrt(d), residual in)
//
// with the TPU bodies' rounding points: the weights arrive in the activation
// type; q, k and the logits are f32 sums and are never rounded; the softmax
// is f32 over the full row (max, exp, sum, times 1/sum); attn, v and o are
// rounded once to the activation type before the product that reads them;
// y = o Wo is f32; out = f32(x) + gamma * y is rounded once.
//
// A frame's (HW x HW/4) f32 logits are 1 MB at 32x32: no SM's 227 KB of
// shared memory holds them, so on this card K6a is query-tiled like K6b, and
// both entries run the same two launches:
//
//   attn_kv_kernel   grid (HW/4 / KT, N): pools KT kv tokens of a frame into
//                    shared memory and writes k (f32) and v^T (N, c2, HW/4)
//                    in the activation type to scratch, once per frame. In
//                    f32 k goes out as k^T (N, c8, HW/4); in bf16 already
//                    split for the 3xTF32 logits (below), the projections on
//                    mma.sync with the weights' fragments read from L2.
//   attn_fwd_kernel  the query rows, by one of two bodies.
//
// bf16: persistent CTAs, warp-owned query rows. The grid is the SMs times the
// CTAs an SM holds; each CTA walks a contiguous range of work items (frame,
// TQ-query tile), so consecutive items share a frame. Wq^T and Wo^T are
// staged into shared memory once per CTA, the frame's split k and v^T once
// per frame the CTA enters (cp.async; the next frame's are fetched into L2
// meanwhile) where they fit beside the weights; where they do not (64x64 at
// C >= 128, larger maps), the warps read v^T, and k where it does not fit
// alone, from L2 (mode 2). A warp owns 16 query rows from x to out, with no
// block barrier between its phases and no logits tile in shared memory:
//
//   q      = x Wq on mma.sync (bf16, f32 sums); the A fragments come straight
//            from global memory as 16-byte loads (the contraction's order is
//            permuted to match, and Wq^T's fragments are 16-byte shared
//            loads), so x is never staged; the next item's rows are
//            prefetched into L2 under the current item.
//   logits = q k^T as 3xTF32 on the tensor cores: each f32 operand v is
//            split into hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and
//            lo_q hi_k + hi_q lo_k + hi_q hi_k run on mma.m16n8k8.tf32 with
//            f32 accumulators (lo lo is dropped): about 2^-21 relative per
//            product, near f32; one TF32 product alone (2^-11) would break
//            the contract. q's accumulator fragment is its A fragment (the
//            contraction permuted again), k arrives split in the first
//            launch, a lane's two keys' hi and lo in one 16-byte load; the
//            mmas of four key tiles interleave.
//   softmax over the full row, f32, exp(l - m) as ex2.approx of
//            l log2(e) - m log2(e) (exp_shifted). 32x32 maps (RES_KEYS =
//            256 keys) keep a row's logits in registers (16 rows x 256 keys
//            = 128 f32 a lane): max, exp, sum, times 1/sum, rounded to bf16
//            and packed from the accumulator fragments into attn v's A
//            fragments (as FlashAttention-2 does). Other maps (64x64: 1024
//            keys) walk the keys in blocks of SWEEP_KEYS three times,
//            recomputing the logits (c8 deep: a few mmas a fragment, the
//            same bits each time): the row max; the sum of exp(l - m); then
//            attn into attn v. Every rounding point stays where it is (an
//            online, rescaled softmax would move them).
//   o      = attn v on mma.sync, v^T's fragments by ldmatrix (mode 2: 4-byte
//            loads from L2); rounded to bf16 into o Wo's A fragments in
//            registers.
//   out    = f32(x) + gamma (o Wo), Wo^T staged with its rows permuted so a
//            lane's accumulators are 8 neighbouring channels: x read and out
//            written as 16-byte vectors.
//
// The wide bodies (modes 3 and 4: widths past what a warp's registers hold
// in one pass, C 384 and up): neither Wq^T and Wo^T (Wo^T alone is 264 KB at
// C 512) nor, on larger maps, the frame's split k and v^T (~390 KB each at
// 64x64 x 384) fit shared memory, so a warp would read them from L2 for its
// 16 rows alone: per 16 rows 0.58 MB at 32x32 x 384 (k three times, v^T,
// both weights), 1.75 MB at 64x64 x 384, 2.95 MB of weights at 8x8 x 1536.
// What bounds these bodies on this card is so the bytes each row reads from
// L2 and, once those are shared, the latency of the warps' mma.sync chains
// (the weights' products, and mode 4's three 3xTF32 logit sweeps) at one or
// two warps an SM sub-partition. The design: a work item is TQ queries of
// one frame on all of a CTA's warps (16 rows each) at once, and what they
// read in common streams through a ring of tiles in shared memory
// (Wide::tile: Wq^T 32 q channels x 128 channels of C, split k 4 k-steps x
// 32 keys, v^T 64 channels x 64 keys, Wo^T 32 output channels x 128 o
// channels), each tile copied once for the item's TQ rows by one warp in
// turn with cp.async, handed over by full and empty mbarriers (no block
// barrier, no warp copies for another's rows). A warp's arithmetic is what
// its 16 rows need and in the order below whatever tile or grid it runs
// under; the widths go in passes:
//
// Mode 3 (maps of at most WIDE_KEYS keys: the 4x4, 8x8 and 16x16
// attention): q and the logits in passes of 32 q channels (block sums over
// 128 channels of C promoted), each k-step's logits summed from zero and
// added into the row's f32 logits (in registers) in k order; attn v in
// passes of 64 o channels rounded into a per-warp o buffer in shared
// memory; o Wo from that buffer by ldmatrix, two groups of 32 output
// channels at a time, each pass of 128 o channels summed apart and added
// into f32 totals (rows_wide, out_wide).
//
// Mode 4 (larger maps: the 32x32 attention at C 384-1024, 64x64 at C
// 384-512): q as in mode 3, its split A fragments in a per-warp q buffer;
// on maps of RES_KEYS keys (32x32) each logit formed once and a row's 256
// kept in registers, on others mode 1's three sweeps over the k tiles (the
// same bits each time) with attn's bf16 A fragments in a per-warp buffer;
// attn v in passes of 64 o channels, each a sum over blocks of 64 keys
// promoted into f32 totals; o into the o buffer (over the q buffer) and
// out_wide (rows_wide_resident, rows_wide_sweep). The products stay on
// mma.sync, not wgmma, so a wide body remains bound by the latency of its
// warps' chains at 8 warps an SM or fewer (tools/torch_k6_phases.py).

// Keys that are not a multiple of 16 (the 4x4 map's 4): the first launch
// writes the frame's k and v^T padded with zero tokens to the next multiple
// of 16 (keys_padded), and the second sets the padded keys' logits to -inf
// before the row's max (mask_keys; f32: its softmax skips them and writes 0),
// so they add exactly 0 to the softmax's sum and to o. Widths the bodies do
// not take in place (c8 % 8, c2 % 16, modes 3 and 4 c2 % 32, C % 16, bf16
// C % 32) arrive zero-padded from the wrapper (`attention_spatial.plan`).
//
// A query's output does not depend on which CTA, tile size or grid took it:
// every row runs the same instructions in the same order. Bodies by the map
// (resident, sweep, sweep from L2) and by the widths the registers hold
// (OT): the
// table BODY_TABLE, which `attention_spatial.py` BODIES copies. The mmas are
// volatile asm issued in the order written: left free, the compiler hoisted
// loads across them and spilled.
//
// f32 (the parity mode, not the fast one): the CUDA-core body of the first
// version, unchanged. Grid (HW / TQ, N); a CTA owns TQ queries of one frame
// and walks its phases with block barriers between them: stage the x tile;
// q = x Wq into shared memory; the f32 logits of the TQ x HW/4 tile into
// shared memory as f32 FMAs (a thread keeps k for four keys in registers and
// takes four rows at a time, 16 FMAs per 16-byte broadcast read of q); a warp
// per row takes the softmax; o = attn v; y = o Wo; the residual and the one
// rounding into the x tile in place, which leaves in whole rows.
//
// What bounds it on the H100: in bf16 the tensor cores and the exps' MUFU
// (two exps a logit at 64x64) more than the bytes (x read twice, out written
// once); this version is still bound by latency at one CTA of 8 or 16 warps
// an SM (the wide bodies: above). Per-phase cycles of the bf16 body: build
// with -DK6_PROFILE (tools/torch_k6_phases.py).

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using tc::copy_rows_async;
using tc::cp_async_wait;
using tc::ldmatrix_x4;
using tc::mma_16816;

using bf16 = __nv_bfloat16;

constexpr int NT = 256;                // threads per CTA: f32 and attn_kv_kernel
constexpr int NWARPS = NT / 32;
constexpr int SMEM_MAX = 232448;       // 227 KB: a block's most on sm_90

// The bf16 bodies of attn_fwd_kernel, by the index the C interface takes:
// {mode, OT, most warps a CTA}. Mode 0 keeps a row's logits in registers
// (maps of exactly RES_KEYS keys: 32x32), 1 sweeps the keys in blocks of
// SWEEP_KEYS three times (any other map).
// A warp holds OT o n-tiles and OT / 4 q n-tiles (c2 <= 8 OT, c8 <= 2 OT).
// The most warps a CTA is also what an SM holds by registers (255 or 128 a
// thread), so the persistent grid takes one CTA of that size an SM.
// Mode 2 is mode 1 with the frame's v^T read from L2 instead of staged, and
// its split k too where k does not fit beside the weights: for maps whose k
// and v^T do not fit shared memory together (64x64 at C >= 128, larger
// maps). Mode 3 takes maps of at most WIDE_KEYS keys at widths past the
// others' (the 4x4, 8x8 and 16x16 attention at C 384 and up), the weights
// read from L2 (rows_wide); mode 4 the same widths on larger maps
// (rows_wide_sweep). Modes 3 and 4 take any width in passes (c2 % 32 == 0):
// their OT is no limit, and their CTAs may run fewer warps than the most,
// as their per-warp buffers fit shared memory.
constexpr int N_BODIES = 10;
constexpr int BODY_TABLE[N_BODIES][3] = {
    {0, 4, 8}, {0, 16, 8}, {1, 4, 16}, {1, 8, 8},  {1, 16, 8},
    {2, 4, 16}, {2, 8, 8}, {2, 16, 8}, {3, 32, 8}, {4, 32, 8}};
template <int B>
struct BodyOf {
  static constexpr int kMode = BODY_TABLE[B][0];
  static constexpr int kOT = BODY_TABLE[B][1];
  static constexpr int kWarps = BODY_TABLE[B][2];
};
constexpr int RES_KEYS = 256;
constexpr int SWEEP_KEYS = 64;
constexpr int WIDE_KEYS = 64;

// The keys k and v^T hold for a frame of `keys` pooled tokens: the next
// multiple of 16 (one attn v k-step), the padding zero tokens.
__host__ __device__ inline int keys_padded(int keys) {
  return (keys + 15) / 16 * 16;
}

// With -DK6_PROFILE the bf16 body adds the cycles lane 0 of every warp spends
// in each phase of a work item to k6_cycles (read and zeroed through
// spatial_attn_profile): 0 frame staging (modes 3 and 4: the next item's x
// prefetch), 1 q, 2 logits (sweep: the max sweep; mode 3: with q), 3
// softmax (sweep: the sum sweep), 4 attn v (sweep: the third sweep), 5 o Wo
// and the store; 6 counts warp items, 7 frames staged. Modes 3 and 4 also:
// 8 the cycles a warp waits for a tile of the ring, 9 counts the tiles, 10
// the cycles a warp waits, at its turn to copy a tile, for its stage to be
// released, 11 the cycles it then spends issuing the copies (8, 10 and 11
// lie inside the phases' cycles). Without it the marks compile to nothing.
#ifdef K6_PROFILE
__device__ unsigned long long k6_cycles[12];
#define K6_START() long long k6_t = clock64()
#define K6_LAP(i)                                                          \
  do {                                                                     \
    const long long k6_now = clock64();                                    \
    if ((threadIdx.x & 31) == 0)                                           \
      atomicAdd(&k6_cycles[i], (unsigned long long)(k6_now - k6_t));       \
    k6_t = k6_now;                                                         \
  } while (0)
#define K6_COUNT(i) atomicAdd(&k6_cycles[i], 1ull)
#else
#define K6_START()
#define K6_LAP(i)
#define K6_COUNT(i)
#endif

template <typename T>
struct Traits {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  static constexpr int kPad = kVec;            // row padding of a tile
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Elementwise max of two 16-byte vectors of T.
template <typename T>
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  constexpr int V = Traits<T>::kVec;
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (to_f32(pb[i]) > to_f32(pa[i])) pa[i] = pb[i];
  return a;
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) a[i][j] = 0.f;
}

// tf32(v), round to nearest with ties away from zero, as the f32 bit pattern
// with the 13 low bits clear.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// ---- f32 products (the f32 body and attn_kv_kernel's f32 path) -------------
//
// block_gemm(A, lda, Bt, ldb, M, N, K, epi): the CTA computes
// D (M x N) = A (M x K, row-major, row stride lda) * B, with B given n-major
// (Bt[n][k], row stride ldb), f32 sums, and hands every pair of neighbouring
// columns to epi(row, col, d[row][col], d[row][col + 1]) (col even), once.
// M is a multiple of 8, N of 2, K of 4. No synchronisation inside. FMAs on
// the CUDA cores, k ascending: a thread takes 8 rows x 2 neighbouring
// columns; A and Bt are read as 16-byte vectors along k.
template <class Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda,
                                           const float* Bt, int ldb, int M,
                                           int N, int K, Epi epi) {
  constexpr int RB = 8;
  const int n_pairs = N / 2;
  for (int u = threadIdx.x; u < (M / RB) * n_pairs; u += NT) {
    const int n = (u % n_pairs) * 2, r0 = (u / n_pairs) * RB;
    float acc[RB][2];
#pragma unroll
    for (int j = 0; j < RB; ++j) acc[j][0] = acc[j][1] = 0.f;
    const float* b0p = Bt + (size_t)n * ldb;
    const float* b1p = b0p + ldb;
    const float* ap = A + (size_t)r0 * lda;
    for (int k = 0; k < K; k += 4) {
      const float4 b0 = *reinterpret_cast<const float4*>(b0p + k);
      const float4 b1 = *reinterpret_cast<const float4*>(b1p + k);
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const float4 a =
            *reinterpret_cast<const float4*>(ap + (size_t)j * lda + k);
        acc[j][0] = fmaf(a.x, b0.x, acc[j][0]);
        acc[j][0] = fmaf(a.y, b0.y, acc[j][0]);
        acc[j][0] = fmaf(a.z, b0.z, acc[j][0]);
        acc[j][0] = fmaf(a.w, b0.w, acc[j][0]);
        acc[j][1] = fmaf(a.x, b1.x, acc[j][1]);
        acc[j][1] = fmaf(a.y, b1.y, acc[j][1]);
        acc[j][1] = fmaf(a.z, b1.z, acc[j][1]);
        acc[j][1] = fmaf(a.w, b1.w, acc[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < RB; ++j) epi(r0 + j, n, acc[j][0], acc[j][1]);
  }
}

// ---- first launch: k and v^T of a frame -------------------------------------

// The pooled tokens' row stride: f32 padded by a 16-byte vector; bf16 two
// rows 64 bytes apart modulo 128 (the 16-byte fragment loads below).
template <typename T>
__host__ __device__ inline int kv_ld(int C) {
  return Traits<T>::kBf16 ? (C % 64 == 0 ? C + 32 : C) : C + Traits<T>::kPad;
}
template <typename T>
__host__ __device__ inline size_t kv_smem_bytes(int kt, int C) {
  return (size_t)kt * kv_ld<T>(C) * sizeof(T);
}

// bf16: k and v^T of the CTA's KT pooled tokens (kv, row stride ld) on
// mma.sync, the weights' fragments read straight from global memory (every
// CTA reads the same 16-byte pieces: L2), nothing staged but the tokens.
// The contraction is permuted as q's is (q_frags): lane (g, t) takes
// channels 32j + 8t .. + 7 of a row, k-step 0 the first four, k-step 1 the
// last four, for A and B alike. k: units of 16 tokens x 8 channels (two
// chains, one a k-step, added in f32), written split for the logits. v^T:
// units of 16 channels x 16 tokens, rounded once. Each block of KV_BLOCK
// chunks sums from zero and is added into f32 totals: with one chain of 128
// mmas at C 2048 (the tensor cores' accumulation truncates) v's rounding
// moved, and 1.9% of the 4x4 map's outputs differed from the plain
// version by an ulp (0.2% with the blocks).
constexpr int KV_BLOCK = 4;
__device__ __forceinline__ void kv_project(const bf16* kv, int ld,
                                           const bf16* __restrict__ wk_t,
                                           const bf16* __restrict__ wv_t,
                                           float* __restrict__ kSn,
                                           bf16* __restrict__ vTn, int KT,
                                           int kvn, int tok0, int C, int c8,
                                           int c2) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, chunks = C / 32;
  const int mt = KT / 16;
  for (int u = warp; u < mt * (c8 / 8); u += NWARPS) {
    const int m0 = (u % mt) * 16, n0 = (u / mt) * 8;
    const bf16* a0p = kv + (size_t)(m0 + g) * ld + 8 * t;
    const bf16* a1p = a0p + (size_t)8 * ld;
    const bf16* bp = wk_t + (size_t)(n0 + g) * C + 8 * t;
    float acc[2][4];
    zero(acc);
    for (int j0 = 0; j0 < chunks; j0 += KV_BLOCK) {
      float blk[2][4];
      zero(blk);
      for (int j = j0; j < j0 + KV_BLOCK && j < chunks; ++j) {
        const uint4 a0 = *reinterpret_cast<const uint4*>(a0p + 32 * j);
        const uint4 a1 = *reinterpret_cast<const uint4*>(a1p + 32 * j);
        const uint4 b = __ldg(reinterpret_cast<const uint4*>(bp + 32 * j));
        const uint32_t k0[4] = {a0.x, a1.x, a0.y, a1.y};
        const uint32_t k1[4] = {a0.z, a1.z, a0.w, a1.w};
        mma_16816(blk[0], k0, b.x, b.y);
        mma_16816(blk[1], k1, b.z, b.w);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += blk[i][e];
    }
    // rows m0 + g (+ 8) at channels n0 + 2t, + 1: hi, hi, lo, lo
    const int c = n0 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v0 = acc[0][2 * h] + acc[1][2 * h];
      const float v1 = acc[0][2 * h + 1] + acc[1][2 * h + 1];
      const uint32_t h0 = tf32_rna(v0), h1 = tf32_rna(v1);
      *reinterpret_cast<uint4*>(
          kSn + ((size_t)(c / 8) * kvn + tok0 + m0 + g + 8 * h) * 16 +
          (c % 8) * 2) =
          make_uint4(h0, h1, tf32_rna(v0 - __uint_as_float(h0)),
                     tf32_rna(v1 - __uint_as_float(h1)));
    }
  }
  const int vm = c2 / 16;
  for (int u = warp; u < vm * mt; u += NWARPS) {
    const int m0 = (u % vm) * 16, t0 = (u / vm) * 16;
    const bf16* a0p = wv_t + (size_t)(m0 + g) * C + 8 * t;
    const bf16* a1p = a0p + (size_t)8 * C;
    const bf16* bp = kv + (size_t)(t0 + g) * ld + 8 * t;
    float acc[2][4];
    zero(acc);
    for (int j0 = 0; j0 < chunks; j0 += KV_BLOCK) {
      float blk[2][4];
      zero(blk);
      for (int j = j0; j < j0 + KV_BLOCK && j < chunks; ++j) {
        const uint4 a0 = __ldg(reinterpret_cast<const uint4*>(a0p + 32 * j));
        const uint4 a1 = __ldg(reinterpret_cast<const uint4*>(a1p + 32 * j));
        const uint32_t k0[4] = {a0.x, a1.x, a0.y, a1.y};
        const uint32_t k1[4] = {a0.z, a1.z, a0.w, a1.w};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 b = *reinterpret_cast<const uint4*>(
              bp + (size_t)8 * i * ld + 32 * j);
          mma_16816(blk[i], k0, b.x, b.y);
          mma_16816(blk[i], k1, b.z, b.w);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] += blk[i][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* p = vTn + (size_t)(m0 + g) * kvn + tok0 + t0 + 8 * i + 2 * t;
      store2(p, acc[i][0], acc[i][1]);
      store2(p + (size_t)8 * kvn, acc[i][2], acc[i][3]);
    }
  }
}

// x (N, H, W, C); wk_t (c8, C), wv_t (c2, C): the transposed projections;
// vT (N, c2, kvn) out, and k: in f32 kT (N, c8, kvn); in bf16 split for the
// 3xTF32 logits, kS (N, c8 / 8, kvn, 16) f32, kvn the frame's tokens padded
// (keys_padded; a padded token pools to zero, so its k and v are zero).
// The 16 floats of key m
// and k-step s are, for t = 0..3, {hi(k[m][8s + 2t]), hi(k[m][8s + 2t + 1]),
// lo(..), lo(..)} (hi = tf32(k), lo = tf32(k - hi)): a lane's B fragments of
// one key in one 16-byte load. A CTA takes KT kv tokens: it pools them into
// shared memory, then projects them (f32: block_gemm on the CUDA cores with
// the weights from global memory; bf16: kv_project).
template <typename T>
__global__ void __launch_bounds__(NT)
attn_kv_kernel(const T* __restrict__ x, const T* __restrict__ wk_t,
               const T* __restrict__ wv_t, float* __restrict__ kT,
               T* __restrict__ vT, int H, int W, int C, int c8, int c2, int KT) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Traits<T>::kVec;
  const int ld = kv_ld<T>(C);
  T* kv = reinterpret_cast<T*>(smem);               // [KT][ld] pooled tokens
  const int n = blockIdx.y, tok0 = blockIdx.x * KT;
  const int W2 = W / 2, keys = (H / 2) * W2, kvn = keys_padded(keys);
  const T* xn = x + (size_t)n * H * W * C;

  const int cv = C / V;
#pragma unroll 4
  for (int u = threadIdx.x; u < KT * cv; u += NT) {
    const int tk = u / cv, c0 = (u % cv) * V;
    const int m = tok0 + tk, i = m / W2, j = m % W2;
    uint4 best = make_uint4(0u, 0u, 0u, 0u);
    if (m < keys) {
      const T* p = xn + ((size_t)(2 * i) * W + 2 * j) * C + c0;
      const size_t row = (size_t)W * C;
      best = *reinterpret_cast<const uint4*>(p);
      best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + C));
      best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + row));
      best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + row + C));
    }
    *reinterpret_cast<uint4*>(kv + (size_t)tk * ld + c0) = best;
  }
  __syncthreads();

  if constexpr (Traits<T>::kBf16) {
    kv_project(kv, ld, wk_t, wv_t, kT + (size_t)n * c8 * kvn * 2,
               vT + (size_t)n * c2 * kvn, KT, kvn, tok0, C, c8, c2);
  } else {
    // k (tokens x c8) = kv Wk, kept f32, stored transposed
    float* kTn = kT + (size_t)n * c8 * kvn + tok0;
    block_gemm(kv, ld, wk_t, C, KT, c8, C,
               [&](int r, int c, float v0, float v1) {
                 kTn[(size_t)c * kvn + r] = v0;
                 kTn[(size_t)(c + 1) * kvn + r] = v1;
               });
    // v^T (c2 x tokens) = Wv^T kv^T, rounded once
    T* vTn = vT + (size_t)n * c2 * kvn + tok0;
    block_gemm(wv_t, C, kv, ld, c2, KT, C,
               [&](int r, int c, float v0, float v1) {
                 store2(vTn + (size_t)r * kvn + c, v0, v1);
               });
  }
}

// ---- second launch, f32: a tile of queries on the CUDA cores ----------------

// Shared-memory layout of the f32 body (bytes from the start): the x tile
// (kept for the residual); the logits/attn tile S; q; o.
struct Layout {
  int ldx, lds, ldo;              // row strides, in floats
  size_t u, q, o, total;          // offsets; x starts at 0
};

__host__ __device__ inline Layout make_layout(int tq, int kvn, int C, int c8,
                                              int c2) {
  Layout L;
  L.ldx = C + 4;
  L.lds = kvn + 4;
  L.ldo = c2 + 4;
  L.u = (size_t)tq * L.ldx * 4;
  L.q = L.u + (size_t)tq * L.lds * 4;
  L.o = L.q + (size_t)tq * c8 * 4;
  L.total = L.o + (size_t)tq * L.ldo * 4;
  return L;
}

// logits = q k^T with f32 operands, as f32 FMAs, d ascending. A thread owns
// four key columns (kg, kg + kvn/4, ...: neighbouring lanes, neighbouring
// keys) and a share of the rows; it keeps DC channels of its keys in
// registers (read from kT, coalesced) and takes four rows at a time, whose
// q values are broadcast reads: 16 FMAs per 16-byte read. Sums of a later
// chunk of channels start from what S holds.
template <int DC>
__device__ __forceinline__ void logits_tile(const float* __restrict__ kTn,
                                            const float* qs, float* S, int kvn,
                                            int c8, int lds, int TQ) {
  const int n_kg = kvn / 4;
  int rgc = 1;                    // row groups: threads beyond the key groups
  while (rgc * 2 * n_kg <= NT && TQ % (rgc * 8) == 0) rgc *= 2;
  const int rows = TQ / rgc;
  for (int u = threadIdx.x; u < rgc * n_kg; u += NT) {
    const int kg = u % n_kg, r_lo = (u / n_kg) * rows;
    for (int d0 = 0; d0 < c8; d0 += DC) {
      float kr[4][DC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int d = 0; d < DC; ++d)
          kr[j][d] = __ldg(kTn + (size_t)(d0 + d) * kvn + kg + j * n_kg);
      for (int r0 = r_lo; r0 < r_lo + rows; r0 += 4) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[i][j] = d0 ? S[(size_t)(r0 + i) * lds + kg + j * n_kg] : 0.f;
#pragma unroll
        for (int d = 0; d < DC; d += 4)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 q4 = *reinterpret_cast<const float4*>(
                qs + (r0 + i) * c8 + d0 + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(q4.x, kr[j][d], s[i][j]);
              s[i][j] = fmaf(q4.y, kr[j][d + 1], s[i][j]);
              s[i][j] = fmaf(q4.z, kr[j][d + 2], s[i][j]);
              s[i][j] = fmaf(q4.w, kr[j][d + 3], s[i][j]);
            }
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            S[(size_t)(r0 + i) * lds + kg + j * n_kg] = s[i][j];
      }
    }
  }
}

// The softmax of rows r0 .. r0 + R - 1 of S over their first `keys`
// columns, f32, by one warp: the R rows' chains (max, exp and sum, scale)
// run side by side. attn = e * (1 / sum): one division per row. Columns
// keys .. kvn - 1 (padded keys) get attn 0.
template <int R>
__device__ __forceinline__ void softmax_rows(float* S, int lds, int keys,
                                             int kvn, int r0) {
  const int lane = threadIdx.x & 31;
  float* row[R];
  float mx[R], sum[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    row[j] = S + (size_t)(r0 + j) * lds;
    mx[j] = -INFINITY;
    sum[j] = 0.f;
  }
  for (int m = lane; m < keys; m += 32)
#pragma unroll
    for (int j = 0; j < R; ++j) mx[j] = fmaxf(mx[j], row[j][m]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
  for (int m = lane; m < keys; m += 32)
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float e = expf(row[j][m] - mx[j]);
      row[j][m] = e;
      sum[j] += e;
    }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
#pragma unroll
  for (int j = 0; j < R; ++j) sum[j] = 1.f / sum[j];
  for (int m = lane; m < kvn; m += 32)
#pragma unroll
    for (int j = 0; j < R; ++j) row[j][m] = m < keys ? row[j][m] * sum[j] : 0.f;
}

// The same for rows of exactly 32 * EPL columns, each lane's EPL values of
// a row kept in registers from the one read to the one write.
template <int EPL, int R>
__device__ __forceinline__ void softmax_rows_reg(float* S, int lds, int r0) {
  const int lane = threadIdx.x & 31;
  float v[R][EPL], mx[R], sum[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float* row = S + (size_t)(r0 + j) * lds + lane;
#pragma unroll
    for (int i = 0; i < EPL; ++i) v[j][i] = row[32 * i];
    mx[j] = v[j][0];
#pragma unroll
    for (int i = 1; i < EPL; ++i) mx[j] = fmaxf(mx[j], v[j][i]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
#pragma unroll
  for (int j = 0; j < R; ++j) {
    sum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      v[j][i] = expf(v[j][i] - mx[j]);
      sum[j] += v[j][i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], o);
  __syncwarp();                 // every lane has read its rows: write attn
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float inv = 1.f / sum[j];
    float* row = S + (size_t)(r0 + j) * lds;
#pragma unroll
    for (int i = 0; i < EPL; ++i) row[32 * i + lane] = v[j][i] * inv;
  }
}

// x, out (N, HW, C); wq_t (c8, C), wo_t (C, c2); kT (N, c8, kvn) and
// vT (N, c2, kvn) from attn_kv_kernel (kvn = keys_padded(keys), keys the
// frame's pooled tokens); gamma: one f32 on the device. DC:
// the channels of k a thread keeps in registers for the logits (8, or 16
// where c8 is a multiple of 16: a kernel of its own).
template <int DC>
__device__ __forceinline__ void fwd_f32(
    const float* __restrict__ x, const float* __restrict__ wq_t,
    const float* __restrict__ wo_t, const float* __restrict__ kT,
    const float* __restrict__ vT, const float* __restrict__ gamma,
    float* __restrict__ out, int HW, int keys, int C, int c8, int c2, int TQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvn = keys_padded(keys);
  const Layout L = make_layout(TQ, kvn, C, c8, c2);
  float* xs = reinterpret_cast<float*>(smem);          // [TQ][ldx]
  float* S = reinterpret_cast<float*>(smem + L.u);     // [TQ][lds]
  float* qs = reinterpret_cast<float*>(smem + L.q);    // [TQ][c8]
  float* os = reinterpret_cast<float*>(smem + L.o);    // [TQ][ldo]
  const int n = blockIdx.y, q0 = blockIdx.x * TQ;
  const float* xq = x + ((size_t)n * HW + q0) * C;
  float* outq = out + ((size_t)n * HW + q0) * C;
  const float* vTn = vT + (size_t)n * c2 * kvn;

  const float gm = __ldg(gamma);
  copy_rows_async<NT>(xs, L.ldx, xq, C, TQ, C);
  cp_async_wait();
  __syncthreads();

  // q = x Wq, f32, not rounded
  block_gemm(xs, L.ldx, wq_t, C, TQ, c8, C,
             [&](int r, int c, float v0, float v1) {
               store2(qs + (size_t)r * c8 + c, v0, v1);
             });
  __syncthreads();

  // logits = q k^T with f32 operands
  const float* kTn = kT + (size_t)n * c8 * kvn;
  logits_tile<DC>(kTn, qs, S, kvn, c8, L.lds, TQ);
  __syncthreads();

  // softmax over the full rows: a warp takes TQ / 8 neighbouring rows
  {
    const int rpw = TQ / NWARPS, r_lo = (threadIdx.x >> 5) * rpw;
    if (keys == 256 && rpw % 4 == 0)        // 32 x 32 maps
      for (int r = r_lo; r < r_lo + rpw; r += 4)
        softmax_rows_reg<8, 4>(S, L.lds, r);
    else if (keys == 1024)                  // 64 x 64 maps
      for (int r = r_lo; r < r_lo + rpw; ++r)
        softmax_rows_reg<32, 1>(S, L.lds, r);
    else                                    // any other map
      for (int r = r_lo; r < r_lo + rpw; r += 2)
        softmax_rows<2>(S, L.lds, keys, kvn, r);
  }
  __syncthreads();

  // o = attn v, f32 sums
  block_gemm(S, L.lds, vTn, kvn, TQ, c2, kvn,
             [&](int r, int c, float v0, float v1) {
               store2(os + (size_t)r * L.ldo + c, v0, v1);
             });
  __syncthreads();

  // y = o Wo (f32); out = x + gamma * y into the x tile in place, then to
  // global memory in whole rows. The product and the sum are rounded apart,
  // as the plain version's are.
  block_gemm(os, L.ldo, wo_t, c2, TQ, C, c2,
             [&](int r, int c, float v0, float v1) {
               float* p = xs + (size_t)r * L.ldx + c;
               store2(p, __fadd_rn(p[0], __fmul_rn(gm, v0)),
                      __fadd_rn(p[1], __fmul_rn(gm, v1)));
             });
  __syncthreads();
  {
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TQ; r += NWARPS)
      for (int c = lane * 4; c < C; c += 128)
        *reinterpret_cast<uint4*>(outq + (size_t)r * C + c) =
            *reinterpret_cast<const uint4*>(xs + (size_t)r * L.ldx + c);
  }
}

// ---- second launch, bf16: persistent CTAs, warp-owned query rows ------------

// Shared memory of the bf16 body (bytes from the start): Wq^T [c8][ldq]; Wo^T
// [C][ldo], rows permuted (out_rows); the frame's v^T [c2][ldv]; its split k
// [c8 / 8][kvn][16] f32. Mode 2 (v^T not staged): the weights, then the split
// k where it fits beside them (k_staged), else nothing more. ldq keeps two rows 64 bytes apart modulo 128 (a
// quarter warp's 16-byte loads of two rows hit all 32 banks), ldo and ldv
// are odd multiples of 16 bytes (conflict-free ldmatrix).
struct TcLayout {
  int ldq, ldo, ldv;
  size_t wo, v, k, total;         // offsets; Wq^T starts at 0
  bool k_staged;
};

__host__ __device__ inline TcLayout tc_layout(int kvn, int C, int c8, int c2,
                                              bool v_staged) {
  TcLayout L;
  L.ldq = C % 64 == 0 ? C + 32 : C;
  L.ldo = c2 + 8;
  L.ldv = kvn + 8;
  L.wo = (size_t)c8 * L.ldq * 2;
  L.v = L.wo + (size_t)C * L.ldo * 2;
  L.k = v_staged ? L.v + (size_t)c2 * L.ldv * 2 : L.v;
  const size_t k_end = L.k + (size_t)c8 * kvn * 8;
  L.k_staged = v_staged || k_end <= SMEM_MAX;
  L.total = L.k_staged ? k_end : L.k;
  return L;
}

// Modes 3 and 4 (the wide bodies) run the CTA's warps on one work item at a
// time and stream what they read in common through a ring of tiles of at
// most TILE_BYTES (Wide::tile): Wq^T as 32 q channels x 128
// channels of C, the frame's split k as K_STEPS k-steps x K_KEYS keys, its
// v^T as 64 channels x 64 keys, Wo^T as 32 output channels x 128 o
// channels. Weight tiles keep two rows 64 bytes apart modulo 128 (W_LD: the
// 16-byte fragment loads of eight rows hit all banks), v^T tiles an odd
// multiple of 16 bytes (V_LD: ldmatrix).
constexpr int MIN_STAGES = 3, MAX_STAGES = 8;
constexpr int SM_SMEM = 233472, CTA_RESERVED = 1024;  // an SM's, a CTA's own
constexpr int WIDE_WARPS = 8;   // the wide bodies' most warps (BODY_TABLE)
constexpr int TILE_BYTES = 10240;
constexpr int BAR_BYTES = 16 * MAX_STAGES;   // a full and an empty mbarrier a stage
constexpr int W_LD = 160;
constexpr int V_LD = 72;
constexpr int K_STEPS = 4;
constexpr int K_KEYS = 32;

// Their shared memory: the ring's barriers at 0, its stages (as many as fit
// beside the warps' regions, MIN_STAGES to MAX_STAGES, in the CTA's share
// of an SM where that holds the least ring), then a region a warp. Mode 3: the warp's o buffer [16][ldb]. Mode 4: its
// q buffer (c8 / 8 k-steps x hi, lo x 32 lanes x 16 bytes: a lane's tf32 A
// fragments), which its o buffer [16][ldb] reuses once the logits are done,
// then, where the map has other than RES_KEYS keys, its attn buffer (kvn /
// 16 k-steps x 32 lanes x 16 bytes: a lane's bf16 A fragments). ldb is an
// odd multiple of 16 bytes (conflict-free ldmatrix).
struct WideLayout {
  int ldb, stages;
  size_t table_bytes, qo_bytes, warp_bytes, total;
};

// The tiles of a work item (Wide::tile): q passes x C blocks, the k tiles
// (mode 3: each q pass's; mode 4: every sweep's, one sweep on maps of
// RES_KEYS keys), the v^T tiles, Wo^T's.
__host__ __device__ inline int wide_tiles(int mode, int kvn, int C, int c8,
                                          int c2) {
  const int qp = (c8 / 8 + K_STEPS - 1) / K_STEPS, cb = (C + 127) / 128;
  const int kb = (kvn + K_KEYS - 1) / K_KEYS, vp = (c2 + 63) / 64;
  const int wo = (C / 32) * ((c2 + 127) / 128);
  if (mode == 3) return qp * (cb + kb) + vp + wo;
  return qp * cb + (kvn == RES_KEYS ? 1 : 3) * kb * qp +
         vp * ((kvn + 63) / 64) + wo;
}

// ... and the table of an item's tiles (TileEntry, 16 bytes each) after the
// barriers.
__host__ __device__ inline WideLayout wide_layout(int mode, int kvn, int C,
                                                  int c8, int c2, int warps) {
  WideLayout L;
  L.ldb = c2 + 8;
  L.table_bytes = (size_t)16 * wide_tiles(mode, kvn, C, c8, c2);
  const size_t ob = (size_t)32 * L.ldb, qb = (size_t)128 * c8;
  L.qo_bytes = mode == 4 && qb > ob ? qb : ob;
  L.warp_bytes =
      L.qo_bytes + (mode == 4 && kvn != RES_KEYS ? (size_t)32 * kvn : 0);
  const size_t fixed = (size_t)warps * L.warp_bytes + BAR_BYTES +
                       L.table_bytes;
  // the CTA's share of an SM that holds as many of its size as registers
  // allow (WIDE_WARPS / warps), where the least ring fits in it; else
  // SMEM_MAX
  const int per_sm = warps < WIDE_WARPS ? WIDE_WARPS / warps : 1;
  const size_t share = (size_t)SM_SMEM / per_sm - CTA_RESERVED;
  const size_t budget =
      share < SMEM_MAX && fixed + (size_t)MIN_STAGES * TILE_BYTES <= share
          ? share
          : SMEM_MAX;
  const size_t room = fixed < budget ? (budget - fixed) / TILE_BYTES : 0;
  L.stages = room < MIN_STAGES   ? MIN_STAGES
             : room > MAX_STAGES ? MAX_STAGES
                                 : (int)room;
  L.total = (size_t)L.stages * TILE_BYTES + fixed;
  return L;
}

// What a warp reads of its CTA: the staged operands and the shape.
struct TcCtx {
  const bf16* wq_s;
  const bf16* wo_s;
  const bf16* v_s;
  const float* k_s;
  int ldq, ldo, ldv, kvn, C, c8, c2;
  float gm;
  int keys;                       // the frame's tokens; kvn, padded, at most 15 more
};

// The warp body's mmas, D += A B with f32 accumulators: tf32 m16n8k8 (A rows
// g, g + 8 at k t, t + 4; B k t, t + 4 of column g) and bf16 m16n8k16
// (mma_bf16.cuh's layout). Volatile: they issue in the order written, which
// interleaves independent chains (left to itself the compiler hoists loads
// across them until the registers spill).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// exp(l - m) as 2^(l log2(e) - m log2(e)): one FFMA (mb = -m log2(e), once a
// row) and one MUFU.EX2 (ex2.approx, about 2^-22 relative; libdevice's expf
// spends eight more FP32 instructions, and at 64x64 the sweeps evaluate two
// exps an element).
constexpr float LOG2E = 1.4426950408889634f;
__device__ __forceinline__ float exp_shifted(float l, float mb) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(fmaf(l, LOG2E, mb)));
  return r;
}

// Two floats rounded to bf16, the first in the low half (the lower column
// of an mma fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32(x) + gamma * y for the two bf16 of `x`, rounded once.
__device__ __forceinline__ uint32_t residual(uint32_t x, float gm, float y0,
                                             float y1) {
  const float2 xf =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  return pack_bf16(__fadd_rn(xf.x, __fmul_rn(gm, y0)),
                   __fadd_rn(xf.y, __fmul_rn(gm, y1)));
}

// Copies `rows` rows of `cols` elements (a multiple of 16 bytes) into dst
// (row stride ld) with cp.async, row r from src(r), all the block's threads;
// one commit group.
template <typename T, class Src>
__device__ __forceinline__ void stage_async(T* dst, int ld, int rows, int cols,
                                            Src src) {
  constexpr int V = 16 / sizeof(T);
  const int cv = cols / V;
  for (int u = threadIdx.x; u < rows * cv; u += blockDim.x) {
    const int r = u / cv, e = (u - r * cv) * V;
    tc::cp_async_16(dst + (size_t)r * ld + e, src(r) + e, true);
  }
  tc::cp_async_commit();
}

// dst[row_of(n)][k] (row stride ld) = src[k][n] for k < K, n < NN: src
// row-major (K x NN, NN a multiple of 8) read in 16-byte pieces, all the
// block's threads. Once per CTA: the stores' bank conflicts do not matter.
template <class Row>
__device__ __forceinline__ void stage_transposed(bf16* dst, int ld,
                                                 const bf16* __restrict__ src,
                                                 int K, int NN, Row row_of) {
  const int nv = NN / 8;
  for (int u = threadIdx.x; u < K * nv; u += blockDim.x) {
    const int k = u / nv, n0 = (u - k * nv) * 8;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)k * NN + n0));
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(size_t)row_of(n0 + i) * ld + k] = e[i];
  }
}

// Asks L2 for `bytes` from p: lines part, part + parts, ... of 128 bytes.
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            int part, int parts) {
  const char* b = static_cast<const char*>(p);
  for (size_t o = (size_t)part * 128; o < bytes; o += (size_t)parts * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(b + o));
}

// Materialises a fragment here: the compiler may not sink the instructions
// that form it past this point (it would keep their wider inputs live, the
// f32 logits behind attn's bf16 fragments, and spill).
__device__ __forceinline__ void fence(uint32_t (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}

// The accumulators of q (two chains an n-tile: the k-steps of a chunk)
// added in f32 and split into the hi and lo tf32 A fragments of the logits:
// the accumulator holds q[g][8nt + 2t, + 1] and q[g + 8][..], the tf32 A
// fragment's k = t and t + 4, with channel 8nt + 2t as k = t.
template <int QT>
__device__ __forceinline__ void q_split(const float (&qa)[QT][4],
                                        const float (&qb)[QT][4],
                                        uint32_t (&qh)[QT][4],
                                        uint32_t (&ql)[QT][4]) {
#pragma unroll
  for (int nt = 0; nt < QT; ++nt) {
    const float a[4] = {qa[nt][0] + qb[nt][0], qa[nt][2] + qb[nt][2],
                        qa[nt][1] + qb[nt][1], qa[nt][3] + qb[nt][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qh[nt][e] = tf32_rna(a[e]);
      ql[nt][e] = tf32_rna(a[e] - __uint_as_float(qh[nt][e]));
    }
    fence(qh[nt]);
    fence(ql[nt]);
  }
}

// q of the warp's 16 rows xr[0 .. 15] (row stride C), f32 sums of bf16
// products on mma.sync, split into the hi and lo tf32 A fragments of the
// logits. Lane (g, t) loads 16 bytes of rows g and g + 8 at channels
// 32j + 8t .. + 7: its A fragments of chunk j's two k-steps, the contraction
// permuted (k-step 0 takes channels 8t .. 8t + 3, k-step 1 8t + 4 .. 8t + 7)
// and Wq^T read in the same order, also 16 bytes a lane. Four chunks' loads
// are in flight at once; the two k-steps sum into two accumulators (two
// chains an n-tile), added in f32 at the end.
template <int QT>
__device__ __forceinline__ void q_frags(const bf16* __restrict__ xr,
                                        const TcCtx& c, uint32_t (&qh)[QT][4],
                                        uint32_t (&ql)[QT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = c.c8 / 8, chunks = c.C / 32;
  const bf16* x0 = xr + (size_t)g * c.C + 8 * t;
  const bf16* x1 = x0 + (size_t)8 * c.C;
  const bf16* w0 = c.wq_s + (size_t)g * c.ldq + 8 * t;
  float qa[QT][4], qb[QT][4];
  zero(qa);
  zero(qb);
  for (int j0 = 0; j0 < chunks; j0 += 4) {
    uint4 a0[4], a1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < chunks) {
        a0[u] = __ldg(reinterpret_cast<const uint4*>(x0 + 32 * (j0 + u)));
        a1[u] = __ldg(reinterpret_cast<const uint4*>(x1 + 32 * (j0 + u)));
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < chunks) {
        uint4 w[QT];
#pragma unroll
        for (int nt = 0; nt < QT; ++nt)
          if (nt < nq)
            w[nt] = *reinterpret_cast<const uint4*>(
                w0 + (size_t)nt * 8 * c.ldq + 32 * (j0 + u));
        const uint32_t k0[4] = {a0[u].x, a1[u].x, a0[u].y, a1[u].y};
        const uint32_t k1[4] = {a0[u].z, a1[u].z, a0[u].w, a1[u].w};
#pragma unroll
        for (int nt = 0; nt < QT; ++nt)
          if (nt < nq) mma_bf16(qa[nt], k0, w[nt].x, w[nt].y);
#pragma unroll
        for (int nt = 0; nt < QT; ++nt)
          if (nt < nq) mma_bf16(qb[nt], k1, w[nt].z, w[nt].w);
      }
  }
  q_split(qa, qb, qh, ql);
}

// Adds the logits of the warp's 16 rows at NB n-tiles of 8 keys (the first
// `valid` of them) into s, 3xTF32: per k-step lo_q hi_k, hi_q lo_k, then
// hi_q hi_k into each tile's f32 accumulator, the tiles' mmas interleaved. kp: this
// lane's 16 bytes of its key (g) in the first tile at k-step 0; kstride:
// floats from one k-step to the next. Every caller forms a logit with the
// same instructions, so a recomputed logit has the same bits.
// logit_step_promoted (the wide bodies): each k-step's three mmas sum from
// zero and are added into s in f32 (the tensor cores' accumulation
// truncates; a logit at c8 64-256 is a chain of 24-96 mmas).
template <int NB>
__device__ __forceinline__ void logit_step(float (&s)[NB][4], const float* kp,
                                           int valid, int kstride, int kk,
                                           const uint32_t (&qh)[4],
                                           const uint32_t (&ql)[4]) {
  uint4 b[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid)
      b[j] = *reinterpret_cast<const uint4*>(kp + (size_t)j * 128 +
                                             (size_t)kk * kstride);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) mma_tf32(s[j], ql, b[j].x, b[j].y);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) mma_tf32(s[j], qh, b[j].z, b[j].w);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) mma_tf32(s[j], qh, b[j].x, b[j].y);
}
template <int NB>
__device__ __forceinline__ void logit_step_promoted(
    float (&s)[NB][4], const float* kp, int valid, int kstride, int kk,
    const uint32_t (&qh)[4], const uint32_t (&ql)[4]) {
  float t[NB][4];
  zero(t);
  logit_step<NB>(t, kp, valid, kstride, kk, qh, ql);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += t[j][e];
}
template <int QT, int NB>
__device__ __forceinline__ void logit_acc(float (&s)[NB][4], const float* kp,
                                          int valid, int kstride, int nq,
                                          const uint32_t (&qh)[QT][4],
                                          const uint32_t (&ql)[QT][4]) {
#pragma unroll
  for (int kk = 0; kk < QT; ++kk)
    if (kk < nq) logit_step<NB>(s, kp, valid, kstride, kk, qh[kk], ql[kk]);
}
// The same from zero.
template <int QT, int NB>
__device__ __forceinline__ void logit_block(float (&s)[NB][4], const float* kp,
                                            int valid, int kstride, int nq,
                                            const uint32_t (&qh)[QT][4],
                                            const uint32_t (&ql)[QT][4]) {
  zero(s);
  logit_acc<QT, NB>(s, kp, valid, kstride, nq, qh, ql);
}

// Row max and sum over the four lanes of a row (t = 0..3).
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The max of rows g (m[0]) and g + 8 (m[1]) over the first `valid` tiles.
template <int NB>
__device__ __forceinline__ void block_max(const float (&s)[NB][4], int valid,
                                          float (&m)[2]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) {
      m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
      m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
    }
}

// The logits of padded keys (key0 + 8j + 2t (+ 1) >= keys) to -inf, so that
// they add exp(-inf) = 0 to the row's sum and attn 0 to o.
template <int NB>
__device__ __forceinline__ void mask_keys(float (&s)[NB][4], int key0,
                                          int keys) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + 2 * t + (e & 1) >= keys) s[j][e] = -INFINITY;
}

// This lane's ldmatrix row address in a pair of n-tiles of an n-major B
// (rows 0-7 at k 0-7, at k 8-15, then rows 8-15 likewise).
__device__ __forceinline__ const bf16* b_pair_row(const bf16* B, int ld) {
  const int lane = threadIdx.x & 31;
  return B + (size_t)((lane & 7) + ((lane >> 4) << 3)) * ld +
         ((lane >> 3) & 1) * 8;
}

// attn = e (1 / sum) of two neighbouring n-tiles, rounded once into the A
// fragment of one attn v k-step (FlashAttention-2's register reuse).
__device__ __forceinline__ void attn_frag(uint32_t (&a)[4], const float (&e0)[4],
                                          const float (&e1)[4], float i0,
                                          float i1) {
  a[0] = pack_bf16(e0[0] * i0, e0[1] * i0);
  a[1] = pack_bf16(e0[2] * i1, e0[3] * i1);
  a[2] = pack_bf16(e1[0] * i0, e1[1] * i0);
  a[3] = pack_bf16(e1[2] * i1, e1[3] * i1);
}

// o rounded to bf16: accumulator n-tiles 2i, 2i + 1 are o Wo's k-step i.
__device__ __forceinline__ void o_frag(uint32_t (&a)[4], const float (&o0)[4],
                                       const float (&o1)[4]) {
  a[0] = pack_bf16(o0[0], o0[1]);
  a[1] = pack_bf16(o0[2], o0[3]);
  a[2] = pack_bf16(o1[0], o1[1]);
  a[3] = pack_bf16(o1[2], o1[3]);
}

// One attn v k-step (16 keys, A fragment a) into n-tiles 2p0 .. of acc (the
// first `np` pairs of it) at key column `key`: v^T's fragments by ldmatrix
// from shared memory, vp this lane's row address of the pair p0
// (b_pair_row); with L2, the same four registers as 4-byte loads from
// global memory, vp = v^T + g ldv + 2t.
template <int NP, bool L2>
__device__ __forceinline__ void attn_v_step(float (&acc)[2 * NP][4],
                                            const uint32_t (&a)[4],
                                            const bf16* vp, int key, int np,
                                            int ldv) {
  uint32_t b[NP][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (p < np) {
      const bf16* r = vp + (size_t)p * 16 * ldv + key;
      if constexpr (L2) {
        const bf16* r8 = r + (size_t)8 * ldv;
        b[p][0] = __ldg(reinterpret_cast<const unsigned int*>(r));
        b[p][1] = __ldg(reinterpret_cast<const unsigned int*>(r + 8));
        b[p][2] = __ldg(reinterpret_cast<const unsigned int*>(r8));
        b[p][3] = __ldg(reinterpret_cast<const unsigned int*>(r8 + 8));
      } else {
        ldmatrix_x4(b[p], r);
      }
    }
#pragma unroll
  for (int p = 0; p < NP; ++p)
    if (p < np) {
      mma_bf16(acc[2 * p], a, b[p][0], b[p][1]);
      mma_bf16(acc[2 * p + 1], a, b[p][2], b[p][3]);
    }
}

// The first two groups of 32 channels of x's rows g and g + 8 for the
// residual, loaded ahead of o Wo.
__device__ __forceinline__ void x_ahead(const bf16* __restrict__ xr,
                                        const TcCtx& c, uint4 (&xg)[2][2]) {
  const int lane = threadIdx.x & 31;
  const bf16* p = xr + (size_t)(lane >> 2) * c.C + 8 * (lane & 3);
#pragma unroll
  for (int G = 0; G < 2; ++G)
    if (32 * G < c.C) {
      xg[G][0] = __ldg(reinterpret_cast<const uint4*>(p + 32 * G));
      xg[G][1] = __ldg(reinterpret_cast<const uint4*>(p + 8 * c.C + 32 * G));
    }
}

// out = f32(x) + gamma (o Wo), rounded once, for the warp's 16 rows, from
// o's bf16 A fragments oa. Wo^T's shared rows are permuted: in each group of
// 32 output channels, row 8j + i holds channel 8 (i / 2) + 2j + i % 2, so
// n-tile j's accumulator columns 2t, 2t + 1 are channels 8t + 2j, + 1, and
// a lane holds 8 neighbouring channels of rows g and g + 8 over the four
// n-tiles. x of group G + 2 is loaded while group G computes (xg: groups 0
// and 1, loaded ahead); with YS = 2 the k-steps alternate between two
// accumulators, added in f32.
template <int OK>
__device__ __forceinline__ void out_rows(const uint32_t (&oa)[OK][4],
                                         const uint4 (&xg)[2][2],
                                         const bf16* __restrict__ xr,
                                         bf16* __restrict__ outr,
                                         const TcCtx& c) {
  constexpr int YS = OK >= 4 ? 2 : 1;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nk = c.c2 / 16, groups = c.C / 32;
  const bf16* wp = b_pair_row(c.wo_s, c.ldo);
  const size_t r0 = (size_t)g * c.C + 8 * t, r1 = r0 + (size_t)8 * c.C;
  const float gm = c.gm;
  uint4 x0 = xg[0][0], x1 = xg[0][1], n0 = xg[1][0], n1 = xg[1][1];
#pragma unroll 1
  for (int G = 0; G < groups; ++G) {
    uint4 f0 = n0, f1 = n1;
    if (G + 2 < groups) {
      f0 = __ldg(reinterpret_cast<const uint4*>(xr + r0 + 32 * (G + 2)));
      f1 = __ldg(reinterpret_cast<const uint4*>(xr + r1 + 32 * (G + 2)));
    }
    float y[YS][4][4];
    zero(y[0]);
    if constexpr (YS == 2) zero(y[1]);
#pragma unroll
    for (int kk = 0; kk < OK; ++kk)
      if (kk < nk) {
        uint32_t b[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          ldmatrix_x4(b[jp], wp + (size_t)(32 * G + 16 * jp) * c.ldo + 16 * kk);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          mma_bf16(y[kk % YS][2 * jp], oa[kk], b[jp][0], b[jp][1]);
          mma_bf16(y[kk % YS][2 * jp + 1], oa[kk], b[jp][2], b[jp][3]);
        }
      }
    if constexpr (YS == 2)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) y[0][j][e] += y[1][j][e];
    const float (&v)[4][4] = y[0];
    *reinterpret_cast<uint4*>(outr + r0 + 32 * G) =
        make_uint4(residual(x0.x, gm, v[0][0], v[0][1]),
                   residual(x0.y, gm, v[1][0], v[1][1]),
                   residual(x0.z, gm, v[2][0], v[2][1]),
                   residual(x0.w, gm, v[3][0], v[3][1]));
    *reinterpret_cast<uint4*>(outr + r1 + 32 * G) =
        make_uint4(residual(x1.x, gm, v[0][2], v[0][3]),
                   residual(x1.y, gm, v[1][2], v[1][3]),
                   residual(x1.z, gm, v[2][2], v[2][3]),
                   residual(x1.w, gm, v[3][2], v[3][3]));
    x0 = n0;
    x1 = n1;
    n0 = f0;
    n1 = f1;
  }
}

// Mode 0: the warp's 16 rows with all RES_KEYS of their logits in
// registers: lane (g, t) holds keys 8j + 2t, + 1 of rows g and g + 8, in
// blocks of NB n-tiles. attn v runs in groups of OG o n-tiles (each group's
// o rounded into oa at once, so registers hold one group: C 256 spilled
// with groups of eight), the k-steps alternating between KS accumulators.
// The fences keep each phase's fragments from holding the last phase's f32
// values live.
template <int OT>
__device__ __forceinline__ void rows_resident(const bf16* __restrict__ xr,
                                              bf16* __restrict__ outr,
                                              const TcCtx& c) {
  constexpr int QT = OT / 4, NJ = RES_KEYS / 8, NB = QT == 1 ? 8 : 4;
  constexpr int OG = 4, KS = 2;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = c.c8 / 8, np = c.c2 / 16;
  K6_START();
  uint32_t qh[QT][4], ql[QT][4];
  q_frags<QT>(xr, c, qh, ql);
  K6_LAP(1);

  const float* kp = c.k_s + (size_t)g * 16 + 4 * t;
  float s[NJ / NB][NB][4];
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b)
    logit_block<QT, NB>(s[b], kp + (size_t)b * NB * 128, NB, RES_KEYS * 16,
                        nq, qh, ql);
  K6_LAP(2);

  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b) block_max<NB>(s[b], NB, m);
  const float mb[2] = {-quad_max(m[0]) * LOG2E, -quad_max(m[1]) * LOG2E};
  float z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b) {
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float (&e)[4] = s[b][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = exp_shifted(e[i], mb[i >> 1]);
      y0 += e[0];
      y0 += e[1];
      y1 += e[2];
      y1 += e[3];
    }
    z0 += y0;
    z1 += y1;
  }
  const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);
  uint32_t pa[NJ / 2][4];
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    attn_frag(pa[kk], s[2 * kk / NB][2 * kk % NB],
              s[(2 * kk + 1) / NB][(2 * kk + 1) % NB], i0, i1);
    fence(pa[kk]);
  }
  K6_LAP(3);

  uint32_t oa[OT / 2][4];
  const bf16* vp = b_pair_row(c.v_s, c.ldv);
#pragma unroll
  for (int gi = 0; gi < OT / OG; ++gi)
    if (gi * OG / 2 < np) {
      float o[KS][OG][4];
#pragma unroll
      for (int k = 0; k < KS; ++k) zero(o[k]);
      const bf16* vg = vp + (size_t)gi * OG * 8 * c.ldv;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk)
        attn_v_step<OG / 2, false>(o[kk % KS], pa[kk], vg, 16 * kk,
                            np - gi * OG / 2, c.ldv);
      if constexpr (KS == 2)
#pragma unroll
        for (int i = 0; i < OG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[0][i][e] += o[1][i][e];
#pragma unroll
      for (int i = 0; i < OG / 2; ++i) {
        o_frag(oa[gi * OG / 2 + i], o[0][2 * i], o[0][2 * i + 1]);
        fence(oa[gi * OG / 2 + i]);
      }
    }
  K6_LAP(4);
  uint4 xg[2][2];
  x_ahead(xr, c, xg);
  out_rows<OT / 2>(oa, xg, xr, outr, c);
  K6_LAP(5);
}

// Modes 1 and 2: the warp's 16 rows over keys in blocks of SWEEP_KEYS (two
// halves of NB n-tiles), three sweeps that recompute the same logits: the
// row max; the sum of exp(l - m); attn = exp(l - m) (1 / sum) into attn v.
// The third sweep takes PG o n-tiles at a time (two passes at OT 16, each
// recomputing its logits): a block's attn v sums start from zero and are
// added into f32 totals (one tensor-core chain over all 64 k-steps of a
// 64x64 map made 0.65-1.3% of the bf16 outputs differ at C 128-256). L2
// (mode 2): c.k_s and
// c.v_s are the frame's k and v^T in global memory, read the same way but
// for v^T's fragments (attn_v_step), and c.k_s is the staged k where it fits
// (fwd_tc): the same instructions on the same values, so the same bits as
// mode 1.
template <int OT, bool L2>
__device__ __forceinline__ void rows_sweep(const bf16* __restrict__ xr,
                                           bf16* __restrict__ outr,
                                           const TcCtx& c) {
  constexpr int QT = OT / 4, NB = 4, BJ = SWEEP_KEYS / 8;
  constexpr int PG = OT < 8 ? OT : 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nj = c.kvn / 8, nq = c.c8 / 8, ks = c.kvn * 16, np = c.c2 / 16;
  K6_START();
  uint32_t qh[QT][4], ql[QT][4];
  q_frags<QT>(xr, c, qh, ql);
  K6_LAP(1);

  const float* kp = c.k_s + (size_t)g * 16 + 4 * t;
  const bool masked = c.keys != c.kvn;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll 2
  for (int j0 = 0; j0 < nj; j0 += NB) {
    float s[NB][4];
    logit_block<QT, NB>(s, kp + (size_t)j0 * 128, nj - j0, ks, nq, qh, ql);
    if (masked) mask_keys<NB>(s, 8 * j0, c.keys);
    block_max<NB>(s, nj - j0, m);
  }
  const float mb[2] = {-quad_max(m[0]) * LOG2E, -quad_max(m[1]) * LOG2E};
  K6_LAP(2);

  float z0 = 0.f, z1 = 0.f;
#pragma unroll 2
  for (int j0 = 0; j0 < nj; j0 += NB) {
    float s[NB][4];
    logit_block<QT, NB>(s, kp + (size_t)j0 * 128, nj - j0, ks, nq, qh, ql);
    if (masked) mask_keys<NB>(s, 8 * j0, c.keys);
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j0 + j < nj) {
        y0 += exp_shifted(s[j][0], mb[0]);
        y0 += exp_shifted(s[j][1], mb[0]);
        y1 += exp_shifted(s[j][2], mb[1]);
        y1 += exp_shifted(s[j][3], mb[1]);
      }
    z0 += y0;
    z1 += y1;
  }
  const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);
  K6_LAP(3);

  uint32_t oa[OT / 2][4];
  const bf16* vp = L2 ? c.v_s + (size_t)g * c.ldv + 2 * t
                      : b_pair_row(c.v_s, c.ldv);
#pragma unroll
  for (int g0 = 0; g0 < OT; g0 += PG)
    if (g0 / 2 < np) {
      const bf16* vg = vp + (size_t)g0 * 8 * c.ldv;
      float o[PG][4];
      zero(o);
#pragma unroll 1
      for (int j0 = 0; j0 < nj; j0 += BJ) {
        float ob[PG][4];
        zero(ob);
#pragma unroll
        for (int h = 0; h < BJ; h += NB)
          if (j0 + h < nj) {
            float s[NB][4];
            logit_block<QT, NB>(s, kp + (size_t)(j0 + h) * 128, nj - j0 - h,
                                ks, nq, qh, ql);
            if (masked) mask_keys<NB>(s, 8 * (j0 + h), c.keys);
#pragma unroll
            for (int kk = 0; kk < NB / 2; ++kk)
              if (j0 + h + 2 * kk < nj) {
                float (&e0)[4] = s[2 * kk];
                float (&e1)[4] = s[2 * kk + 1];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  e0[e] = exp_shifted(e0[e], mb[e >> 1]);
                  e1[e] = exp_shifted(e1[e], mb[e >> 1]);
                }
                uint32_t a[4];
                attn_frag(a, e0, e1, i0, i1);
                attn_v_step<PG / 2, L2>(ob, a, vg, 8 * (j0 + h) + 16 * kk,
                                        np - g0 / 2, c.ldv);
              }
          }
#pragma unroll
        for (int i = 0; i < PG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][e] += ob[i][e];
      }
#pragma unroll
      for (int i = 0; i < PG / 2; ++i) {
        o_frag(oa[g0 / 2 + i], o[2 * i], o[2 * i + 1]);
        fence(oa[g0 / 2 + i]);
      }
    }
  K6_LAP(4);
  uint4 xg[2][2];
  x_ahead(xr, c, xg);
  out_rows<OT / 2>(oa, xg, xr, outr, c);
  K6_LAP(5);
}

// ---- modes 3 and 4: a CTA's warps on one item, operands through a ring ----
//
// A work item of the wide bodies is TQ consecutive queries of one frame; the
// CTA's warps take 16 rows each. What they read in common (Wq^T, the frame's
// split k and v^T, Wo^T) comes in the item's fixed order of tiles
// (Wide::tile) through a ring in shared memory. The warps take turns to copy
// the tiles, tile h by warp h % warps, `stages - 2` tiles ahead of use: the
// warp waits for the stage's empty mbarrier (every warp done with the tile
// that held it), its lanes copy the tile with cp.async and arrive on the
// stage's full mbarrier as their copies land. A warp takes a tile by waiting
// for its full barrier and gives it back on the empty one. A byte read from
// L2 so serves the item's TQ rows, not one warp's 16; no warp waits for
// another except through a stage two tiles back, and the tile's bookkeeping
// is one warp's. A tile changes where a warp's B fragments come from, not
// what they hold: every row runs the same instructions on the same values
// under any tile or grid.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(tc::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// An arrival on `bar` once this thread's earlier cp.async copies have
// landed (counted against the barrier's expected arrivals).
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tc::smem_addr(bar))
               : "memory");
}

// One tile of the ring, in the CTA's table of an item's tiles: `rows` rows
// of `row_bytes` (a multiple of 16) from `off` bytes past the base of its
// kind (0 Wq^T, 1 the frame's split k, 2 the frame's v^T, 3 Wo^T; row
// stride src_ld bytes) to a stage (row stride dst_ld bytes).
struct TileEntry {
  uint32_t off, src_ld;
  uint16_t dst_ld, row_bytes;
  uint8_t rows, kind, pad[2];
};
static_assert(sizeof(TileEntry) == 16, "wide_layout counts 16 bytes a tile");

template <int MODE>
struct Wide {
  const bf16* wq_t;               // (c8, C)
  const bf16* wo_t;               // (C, c2)
  const float* kS;                // (N, c8 / 8, kvn, 16)
  const bf16* vT;                 // (N, c2, kvn)
  int C, c8, c2, kvn, keys, ldb;
  float gm;
  // tiles of an item by kind: q passes (32 q channels, also the k tiles'
  // K_STEPS groups) x C blocks (128); k key blocks (K_KEYS) x q passes,
  // `sweeps` times; v^T passes (64 channels) x key blocks (64); o passes
  // (128 o channels) a group of 32 output channels; in all, per_item
  int qp, cb, kb, sweeps, vp, vb, op, per_item;
  // the ring: stages, their full and empty barriers, the table of an
  // item's tiles, the copies' lead, the CTA's first item and items a
  // frame, its warps and this one, the tiles taken and released by this
  // warp, the CTA's tiles in all
  unsigned char* ring;
  uint64_t* bars;
  const TileEntry* table;
  int stages, lead, first, frame_items, warps, warp, used, released, total;

  // Tile i of an item, in the order the warps take them. Mode 3: per q
  // pass its C blocks of Wq^T, then its k at every key block; v^T by passes
  // of 64 channels. Mode 4: every q pass's C blocks; each sweep's k by key
  // blocks x k-step groups; v^T by passes x key blocks. Then Wo^T by pairs
  // of groups of 32 output channels (per o pass, both groups' tiles; an odd
  // last group alone).
  __device__ TileEntry tile(int i) const {
    if (MODE == 3) {
      const int per_pass = cb + kb;
      if (i < qp * per_pass) {
        const int p = i / per_pass, r = i - p * per_pass;
        return r < cb ? wq_tile(p, r) : k_tile(p, r - cb);
      }
      i -= qp * per_pass;
      if (i < vp) return v_tile(i, 0);
      i -= vp;
    } else {
      if (i < qp * cb) return wq_tile(i / cb, i % cb);
      i -= qp * cb;
      if (i < sweeps * kb * qp) {
        const int r = i % (kb * qp);
        return k_tile(r % qp, r / qp);
      }
      i -= sweeps * kb * qp;
      if (i < vp * vb) return v_tile(i / vb, i % vb);
      i -= vp * vb;
    }
    const int pairs = C / 64, full = pairs * 2 * op;
    if (i >= full) return wo_tile(2 * pairs, i - full);
    const int p = i / (2 * op), r = i - p * 2 * op;
    return wo_tile(2 * p + (r & 1), r >> 1);
  }
  __device__ TileEntry entry(size_t off, size_t src_ld, int dst_ld, int rows,
                             int row_bytes, int kind) const {
    return {(uint32_t)off, (uint32_t)src_ld, (uint16_t)dst_ld,
            (uint16_t)row_bytes, (uint8_t)rows, (uint8_t)kind, {0, 0}};
  }
  __device__ TileEntry wq_tile(int p, int b) const {
    return entry(2 * ((size_t)32 * p * C + 128 * b), (size_t)2 * C, 2 * W_LD,
                 min(32, c8 - 32 * p), 2 * min(128, C - 128 * b), 0);
  }
  __device__ TileEntry k_tile(int s, int b) const {
    return entry(64 * ((size_t)K_STEPS * s * kvn + K_KEYS * b),
                 (size_t)64 * kvn, 64 * K_KEYS,
                 min(K_STEPS, c8 / 8 - K_STEPS * s),
                 64 * min(K_KEYS, kvn - K_KEYS * b), 1);
  }
  __device__ TileEntry v_tile(int v, int b) const {
    return entry(2 * ((size_t)64 * v * kvn + 64 * b), (size_t)2 * kvn,
                 2 * V_LD, min(64, c2 - 64 * v), 2 * min(64, kvn - 64 * b),
                 2);
  }
  __device__ TileEntry wo_tile(int G, int P) const {
    return entry(2 * ((size_t)32 * G * c2 + 128 * P), (size_t)2 * c2,
                 2 * W_LD, 32, 2 * min(128, c2 - 128 * P), 3);
  }
  // The table of an item's tiles, every thread of the CTA a share.
  __device__ void fill_table(TileEntry* out) const {
    for (int i = threadIdx.x; i < per_item; i += blockDim.x) out[i] = tile(i);
  }
  __device__ uint64_t* full(int s) const { return bars + s; }
  __device__ uint64_t* empty(int s) const { return bars + MAX_STAGES + s; }

  // This warp's turn: tile h into its stage once every warp has released
  // the tile that held it; each lane's copies arrive on the full barrier.
  __device__ void issue(int h) {
    const int lane = threadIdx.x & 31, s = h % stages;
#ifdef K6_PROFILE
    const long long t0 = clock64();
#endif
    if (h >= stages) mbar_wait(empty(s), (h / stages - 1) & 1);
#ifdef K6_PROFILE
    const long long t1 = clock64();
#endif
    const int item = first + h / per_item, n = item / frame_items;
    const TileEntry t = table[h % per_item];
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(
            t.kind == 0 ? (const void*)wq_t
            : t.kind == 1 ? (const void*)(kS + (size_t)n * c8 * kvn * 2)
            : t.kind == 2 ? (const void*)(vT + (size_t)n * c2 * kvn)
                          : (const void*)wo_t) + t.off;
    unsigned char* dst = ring + (size_t)s * TILE_BYTES;
    const int pieces = t.row_bytes / 16;
    if ((pieces & (pieces - 1)) == 0) {       // every full tile
      const int sh = __ffs(pieces) - 1;
#pragma unroll 1
      for (int u = lane; u < t.rows << sh; u += 32) {
        const int r = u >> sh, e = (u & (pieces - 1)) * 16;
        tc::cp_async_16(dst + (size_t)r * t.dst_ld + e,
                        src + (size_t)r * t.src_ld + e, true);
      }
    } else {
#pragma unroll 1
      for (int u = lane; u < t.rows * pieces; u += 32) {
        const int r = u / pieces, e = (u - r * pieces) * 16;
        tc::cp_async_16(dst + (size_t)r * t.dst_ld + e,
                        src + (size_t)r * t.src_ld + e, true);
      }
    }
    mbar_arrive_copies(full(s));
#ifdef K6_PROFILE
    if (lane == 0) {
      K6_COUNT(9);
      atomicAdd(&k6_cycles[10], (unsigned long long)(t1 - t0));
      atomicAdd(&k6_cycles[11], (unsigned long long)(clock64() - t1));
    }
#endif
  }
  // The copies ahead of the first tile (this warp's turns among them).
  __device__ void start() {
    for (int h = warp; h < lead && h < total; h += warps) issue(h);
  }
  // A warp's next tile, held until released (every warp takes every tile,
  // in order); first its turn to copy the tile `lead` ahead, if it is one.
  __device__ const unsigned char* acquire() {
    const int h = used + lead;
    if (h < total && h % warps == warp) issue(h);
    const int s = used % stages;
#ifdef K6_PROFILE
    const long long t0 = clock64();
#endif
    mbar_wait(full(s), (used / stages) & 1);
#ifdef K6_PROFILE
    if ((threadIdx.x & 31) == 0)
      atomicAdd(&k6_cycles[8], (unsigned long long)(clock64() - t0));
#endif
    ++used;
    return ring + (size_t)s * TILE_BYTES;
  }
  // This warp is done with its oldest held tile.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(released % stages));
    ++released;
  }
  // Releases every held tile and takes the next.
  __device__ const unsigned char* next() {
    while (released < used) release();
    return acquire();
  }
};

// One block of four chunks (128 channels of C) of a q pass for the warp's 16
// rows: a0, a1 this lane's A fragments of the block's chunks (rows g and
// g + 8, from x), the pass's first nq <= 4 n-tiles of 8 q channels, Wq^T's
// 32 rows of the pass from the ring tile wt: q_frags' arithmetic with the
// block summed from zero and added into the pass's f32 totals qa, qb (C
// 384-1024 make chains of 12-32 mmas).
__device__ __forceinline__ void q_block(const uint4 (&a0)[4],
                                        const uint4 (&a1)[4], const bf16* wt,
                                        int valid, int nq, float (&qa)[4][4],
                                        float (&qb)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* w0 = wt + g * W_LD + 8 * t;
  float pa[4][4], pb[4][4];
  zero(pa);
  zero(pb);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < valid) {
      uint4 w[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < nq)
          w[nt] = *reinterpret_cast<const uint4*>(w0 + nt * 8 * W_LD + 32 * u);
      const uint32_t k0[4] = {a0[u].x, a1[u].x, a0[u].y, a1[u].y};
      const uint32_t k1[4] = {a0[u].z, a1[u].z, a0[u].w, a1[u].w};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < nq) mma_bf16(pa[nt], k0, w[nt].x, w[nt].y);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (nt < nq) mma_bf16(pb[nt], k1, w[nt].z, w[nt].w);
    }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qa[nt][e] += pa[nt][e];
      qb[nt][e] += pb[nt][e];
    }
}

// This lane's A fragments of chunks 4b .. 4b + 3 of x (x0, x1: rows g and
// g + 8 at channel 8t), the first `valid` of them.
__device__ __forceinline__ void x_chunks(const bf16* __restrict__ x0,
                                         const bf16* __restrict__ x1, int b,
                                         int valid, uint4 (&a0)[4],
                                         uint4 (&a1)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < valid) {
      a0[u] = __ldg(reinterpret_cast<const uint4*>(x0 + 32 * (4 * b + u)));
      a1[u] = __ldg(reinterpret_cast<const uint4*>(x1 + 32 * (4 * b + u)));
    }
}

// q pass p's split A fragments for the warp's 16 rows xr: its C blocks from
// the ring, each block's x fragments loaded while the last block computes.
template <class W>
__device__ __forceinline__ void q_pass(const bf16* __restrict__ xr, W& w,
                                       int p, uint32_t (&qh)[4][4],
                                       uint32_t (&ql)[4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunks = w.C / 32, nq = w.c8 / 8 - 4 * p;
  const bf16* x0 = xr + (size_t)g * w.C + 8 * t;
  const bf16* x1 = x0 + (size_t)8 * w.C;
  float qa[4][4], qb[4][4];
  zero(qa);
  zero(qb);
  uint4 a0[4], a1[4], n0[4], n1[4];
  x_chunks(x0, x1, 0, min(4, chunks), a0, a1);
#pragma unroll 1
  for (int b = 0; b < w.cb; ++b) {
    const int valid = min(4, chunks - 4 * b);
    if (b + 1 < w.cb) x_chunks(x0, x1, b + 1, min(4, chunks - 4 * b - 4), n0, n1);
    q_block(a0, a1, reinterpret_cast<const bf16*>(w.next()), valid, nq, qa,
            qb);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a0[u] = n0[u];
      a1[u] = n1[u];
    }
  }
  q_split(qa, qb, qh, ql);
}

// Two k-steps of logit_step_promoted at once (kk and kk + 1, A fragments
// q0 and q1): each k-step's three mmas sum from zero in its own tile, the
// two chains interleaved, then added into s in k order: the same sums.
template <int NB>
__device__ __forceinline__ void logit_step2_promoted(
    float (&s)[NB][4], const float* kp, int valid, int kstride, int kk,
    const uint32_t (&qh0)[4], const uint32_t (&ql0)[4],
    const uint32_t (&qh1)[4], const uint32_t (&ql1)[4]) {
  float t0[NB][4], t1[NB][4];
  zero(t0);
  zero(t1);
  uint4 b0[NB], b1[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) {
      b0[j] = *reinterpret_cast<const uint4*>(kp + (size_t)j * 128 +
                                              (size_t)kk * kstride);
      b1[j] = *reinterpret_cast<const uint4*>(kp + (size_t)j * 128 +
                                              (size_t)(kk + 1) * kstride);
    }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) {
      mma_tf32(t0[j], ql0, b0[j].x, b0[j].y);
      mma_tf32(t1[j], ql1, b1[j].x, b1[j].y);
    }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) {
      mma_tf32(t0[j], qh0, b0[j].z, b0[j].w);
      mma_tf32(t1[j], qh1, b1[j].z, b1[j].w);
    }
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < valid) {
      mma_tf32(t0[j], qh0, b0[j].x, b0[j].y);
      mma_tf32(t1[j], qh1, b1[j].x, b1[j].y);
    }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += t0[j][e];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += t1[j][e];
}

// The logits of NB n-tiles of the warp's rows at the k-steps of one k tile
// (kp: this lane's key g at k-step 0 of the tile, `steps` <= K_STEPS of
// them), q's fragments by qf(k-step, qh, ql), added into s; PAIRS: two
// k-steps at a time (logit_step2_promoted: fewer stalls, more registers).
template <int NB, bool PAIRS = true, class QF>
__device__ __forceinline__ void logit_tile(float (&s)[NB][4], const float* kp,
                                           int valid, int steps, QF qf) {
#pragma unroll
  for (int kk = 0; kk < K_STEPS; kk += PAIRS ? 2 : 1)
    if (PAIRS && kk + 1 < steps) {
      uint32_t qh0[4], ql0[4], qh1[4], ql1[4];
      qf(kk, qh0, ql0);
      qf(kk + 1, qh1, ql1);
      logit_step2_promoted<NB>(s, kp, valid, K_KEYS * 16, kk, qh0, ql0, qh1,
                               ql1);
    } else if (kk < steps) {
      uint32_t qh0[4], ql0[4];
      qf(kk, qh0, ql0);
      logit_step_promoted<NB>(s, kp, valid, K_KEYS * 16, kk, qh0, ql0);
    }
}

// o rounded to bf16 into this warp's o buffer ob (16 rows, row stride ldb):
// channel 32J + 8t + 4s + 2h + e at column 32J + 16s + 8h + 2t + e, so that
// ldmatrix of columns 32J + 16s .. + 15 is the A fragment of o Wo's k-step
// 2J + s with the contraction permuted to match Wo^T's rows read as 16-byte
// pieces (out_wide). o: OP accumulator n-tiles from channel ch0, the first
// `valid` of them.
template <int OP>
__device__ __forceinline__ void o_to_buffer(const float (&o)[OP][4], bf16* ob,
                                            int ldb, int ch0, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < OP; ++i)
    if (i < valid) {
      const int col = ((ch0 + 8 * i) & ~31) + 16 * (t >> 1) + 8 * (t & 1) +
                      2 * (((ch0 >> 3) + i) & 3);
      *reinterpret_cast<uint32_t*>(ob + (size_t)g * ldb + col) =
          pack_bf16(o[i][0], o[i][1]);
      *reinterpret_cast<uint32_t*>(ob + (size_t)(g + 8) * ldb + col) =
          pack_bf16(o[i][2], o[i][3]);
    }
}

// out = f32(x) + gamma (o Wo), rounded once, for the warp's 16 rows, o from
// the warp's buffer (o_to_buffer's columns), Wo^T's tiles from the ring, two
// groups of 32 output channels at a time. Per group: n-tile j's B column g is
// channel 8 (g / 2) + 2j + g % 2 of the group (out_rows' permutation: a
// lane's accumulators are 8 neighbouring channels); a lane's 16 bytes of
// that row at o channels 32J + 8t .. + 7 are the B fragments of k-steps 2J
// and 2J + 1. Each pass of 128 o channels (a tile a group) sums from zero
// and is added into the group's f32 totals.
template <class W>
__device__ __forceinline__ void out_wide(const bf16* ob,
                                         const bf16* __restrict__ xr,
                                         bf16* __restrict__ outr, W& w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int groups = w.C / 32, nk = w.c2 / 32;
  const bf16* ap = ob + (size_t)(lane & 15) * w.ldb + (lane >> 4) * 8;
  const size_t r0 = (size_t)g * w.C + 8 * t, r1 = r0 + (size_t)8 * w.C;
  const int brow = (8 * (g >> 1) + (g & 1)) * W_LD + 8 * t;
  const float gm = w.gm;
#pragma unroll 1
  for (int G = 0; G < groups; G += 2) {
    const int ng = G + 1 < groups ? 2 : 1;
    uint4 xa[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < ng) {
        xa[h][0] = __ldg(reinterpret_cast<const uint4*>(xr + r0 + 32 * (G + h)));
        xa[h][1] = __ldg(reinterpret_cast<const uint4*>(xr + r1 + 32 * (G + h)));
      }
    float y[2][4][4];
    zero(y[0]);
    zero(y[1]);
#pragma unroll 1
    for (int P = 0; P < w.op; ++P) {
      while (w.released < w.used) w.release();
      const bf16* wp[2];
      wp[0] = reinterpret_cast<const bf16*>(w.acquire()) + brow;
      wp[1] = ng == 2 ? reinterpret_cast<const bf16*>(w.acquire()) + brow
                      : wp[0];
      float yp[2][4][4];
      zero(yp[0]);
      zero(yp[1]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * P + jj < nk) {
          const int J = 4 * P + jj;
          uint4 b[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              b[h][j] = *reinterpret_cast<const uint4*>(wp[h] + 2 * j * W_LD +
                                                        32 * jj);
          uint32_t a0[4], a1[4];
          ldmatrix_x4(a0, ap + 32 * J);
          ldmatrix_x4(a1, ap + 32 * J + 16);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(yp[h][j], a0, b[h][j].x, b[h][j].y);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(yp[h][j], a1, b[h][j].z, b[h][j].w);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[h][j][e] += yp[h][j][e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (h < ng) {
        const uint4 x0 = xa[h][0], x1 = xa[h][1];
        const float (&v)[4][4] = y[h];
        *reinterpret_cast<uint4*>(outr + r0 + 32 * (G + h)) =
            make_uint4(residual(x0.x, gm, v[0][0], v[0][1]),
                       residual(x0.y, gm, v[1][0], v[1][1]),
                       residual(x0.z, gm, v[2][0], v[2][1]),
                       residual(x0.w, gm, v[3][0], v[3][1]));
        *reinterpret_cast<uint4*>(outr + r1 + 32 * (G + h)) =
            make_uint4(residual(x1.x, gm, v[0][2], v[0][3]),
                       residual(x1.y, gm, v[1][2], v[1][3]),
                       residual(x1.z, gm, v[2][2], v[2][3]),
                       residual(x1.w, gm, v[3][2], v[3][3]));
      }
  }
}

// Mode 3: maps of at most WIDE_KEYS keys at widths one pass of the other
// bodies does not hold (any c8 and c2, c2 % 32 == 0: the 4x4, 8x8 and 16x16
// attention at C 384 and up). A row's logits stay in registers (at most
// eight n-tiles of 8 keys, as mode 0's), formed in passes of 32 q channels:
// each pass's q (its four n-tiles, block sums promoted), then its k-steps
// over the k tiles of 32 keys, each k-step summed from zero and added into
// the f32 logits in k order. attn v runs in passes of 64 o channels (a v^T
// tile each), each pass's o rounded to bf16 into the warp's o buffer ob for
// out_wide.
template <class W>
__device__ __forceinline__ void rows_wide(const bf16* __restrict__ xr,
                                          bf16* __restrict__ outr, W& w,
                                          bf16* ob) {
  constexpr int NJ = WIDE_KEYS / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = w.c8 / 8, nj = w.kvn / 8, nt = w.c2 / 8;
  K6_START();
  float s[NJ][4];
  zero(s);
#pragma unroll 1
  for (int p = 0; p < w.qp; ++p) {
    uint32_t qh[4][4], ql[4][4];
    q_pass(xr, w, p, qh, ql);
    auto qf = [&](int kk, uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = qh[kk][e];
        l[e] = ql[kk][e];
      }
    };
#pragma unroll
    for (int h = 0; h < NJ / 4; ++h)
      if (h < w.kb) {
        const float* kp = reinterpret_cast<const float*>(w.next()) + g * 16 +
                          4 * t;
        float (&sh)[4][4] = *reinterpret_cast<float (*)[4][4]>(s[4 * h]);
        logit_tile<4>(sh, kp, nj - 4 * h, min(K_STEPS, nq - 4 * p), qf);
      }
  }
  if (w.keys != w.kvn) mask_keys<NJ>(s, 0, w.keys);
  K6_LAP(2);

  float m[2] = {-INFINITY, -INFINITY};
  block_max<NJ>(s, nj, m);
  const float mb[2] = {-quad_max(m[0]) * LOG2E, -quad_max(m[1]) * LOG2E};
  float z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (j < nj) {
      float (&e)[4] = s[j];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = exp_shifted(e[i], mb[i >> 1]);
      z0 += e[0];
      z0 += e[1];
      z1 += e[2];
      z1 += e[3];
    }
  const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);
  uint32_t pa[NJ / 2][4];
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk)
    if (2 * kk < nj) {
      attn_frag(pa[kk], s[2 * kk], s[2 * kk + 1], i0, i1);
      fence(pa[kk]);
    }
  K6_LAP(3);

#pragma unroll 1
  for (int v = 0; v < w.vp; ++v) {
    const bf16* vp = b_pair_row(reinterpret_cast<const bf16*>(w.next()), V_LD);
    float o[8][4];
    zero(o);
#pragma unroll
    for (int kk = 0; kk < NJ / 2; ++kk)
      if (2 * kk < nj)
        attn_v_step<4, false>(o, pa[kk], vp, 16 * kk, (nt - 8 * v) / 2, V_LD);
    o_to_buffer<8>(o, ob, w.ldb, 64 * v, nt - 8 * v);
  }
  __syncwarp();                   // the o buffer, written by every lane
  K6_LAP(4);
  out_wide(ob, xr, outr, w);
  __syncwarp();                   // read by every lane before the next item
  K6_LAP(5);
}

// q's split A fragments of all passes into this lane's slots of the warp's
// q buffer qb ([c8 / 8][hi, lo][32 lanes] of 16 bytes), and a reader of
// them by k-step for logit_tile.
template <class W>
__device__ __forceinline__ void q_to_buffer(const bf16* __restrict__ xr, W& w,
                                            uint4* qb) {
  const int lane = threadIdx.x & 31, nq = w.c8 / 8;
#pragma unroll 1
  for (int p = 0; p < w.qp; ++p) {
    uint32_t qh[4][4], ql[4][4];
    q_pass(xr, w, p, qh, ql);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * p + i < nq) {
        qb[(size_t)64 * (4 * p + i) + lane] =
            make_uint4(qh[i][0], qh[i][1], qh[i][2], qh[i][3]);
        qb[(size_t)64 * (4 * p + i) + 32 + lane] =
            make_uint4(ql[i][0], ql[i][1], ql[i][2], ql[i][3]);
      }
  }
}
struct QBuffer {
  const uint4* qb;
  int k0;                         // the k tile's first k-step
  __device__ void operator()(int kk, uint32_t (&h)[4], uint32_t (&l)[4]) const {
    const int lane = threadIdx.x & 31;
    const uint4 a = qb[(size_t)64 * (k0 + kk) + lane];
    const uint4 b = qb[(size_t)64 * (k0 + kk) + 32 + lane];
    h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
    l[0] = b.x; l[1] = b.y; l[2] = b.z; l[3] = b.w;
  }
};

// The logits of key block j0 (NB n-tiles of 8 keys) of the warp's rows: its
// k tiles, q from the buffer; the padded keys masked.
template <int NB, bool PAIRS, class W>
__device__ __forceinline__ void logits_block(float (&s)[NB][4], W& w,
                                             const uint4* qb, int j0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = w.c8 / 8, nj = w.kvn / 8;
  zero(s);
#pragma unroll 1
  for (int sg = 0; sg < w.qp; ++sg) {
    const float* kp = reinterpret_cast<const float*>(w.next()) + g * 16 +
                      4 * t;
    logit_tile<NB, PAIRS>(s, kp, nj - j0, min(K_STEPS, nq - K_STEPS * sg),
                          QBuffer{qb, K_STEPS * sg});
  }
  if (w.keys != w.kvn) mask_keys<NB>(s, 8 * j0, w.keys);
}

// attn v of the warp's rows in passes of 64 o channels, each over the v^T
// tiles of 64 keys summed from zero and added into f32 totals, the attn A
// fragment of k-step kk (16 keys) by af(kk); each pass's o rounded into the
// o buffer ob. KB > 0: exactly KB key blocks, unrolled (af's k-steps known
// when compiled: attn in registers).
template <int KB, class W, class AF>
__device__ __forceinline__ void attn_v_wide(W& w, bf16* ob, AF af) {
  constexpr int BJ = 64 / 8;
  const int nj = KB > 0 ? KB * BJ : w.kvn / 8, nt = w.c2 / 8;
#pragma unroll 1
  for (int v = 0; v < w.vp; ++v) {
    const int n0 = 8 * v;
    float o[8][4];
    zero(o);
    auto block = [&](int j0) {
      const bf16* vp =
          b_pair_row(reinterpret_cast<const bf16*>(w.next()), V_LD);
      float ok[8][4];
      zero(ok);
#pragma unroll
      for (int kk = 0; kk < BJ / 2; ++kk)
        if (j0 + 2 * kk < nj) {
          uint32_t a[4];
          af(j0 / 2 + kk, a);
          attn_v_step<4, false>(ok, a, vp, 16 * kk, (nt - n0) / 2, V_LD);
        }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] += ok[i][e];
    };
    if constexpr (KB > 0) {
#pragma unroll
      for (int b = 0; b < KB; ++b) block(BJ * b);
    } else {
#pragma unroll 1
      for (int j0 = 0; j0 < nj; j0 += BJ) block(j0);
    }
    o_to_buffer<8>(o, ob, w.ldb, 8 * n0, nt - n0);
  }
}

// Mode 4: maps of more than WIDE_KEYS keys at widths past modes 0-2's (the
// 32x32 attention at C 384-1024, 64x64 at C 384-512). q is formed as in
// mode 3 and its split A fragments go to this lane's slots of the warp's q
// buffer qb. Maps of RES_KEYS keys (32x32: rows_wide_resident) then form
// each logit once and keep a row's RES_KEYS logits in registers, as mode 0;
// larger maps take mode 1's three sweeps over the k tiles (each k-step's
// three mmas from zero, added in f32, as mode 3's: the same bits each time),
// the third writing attn's bf16 A fragments to this lane's slots of the attn
// buffer ab. attn v (attn_v_wide) and out_wide follow, o rounded into the o
// buffer ob over qb (the logits are done). Only ob is read by other lanes
// than the one that wrote it.
template <class W>
__device__ __forceinline__ void rows_wide_sweep(const bf16* __restrict__ xr,
                                                bf16* __restrict__ outr, W& w,
                                                unsigned char* wb,
                                                size_t qo_bytes) {
  constexpr int NB = 4;
  const int lane = threadIdx.x & 31;
  const int nj = w.kvn / 8;
  uint4* qb = reinterpret_cast<uint4*>(wb);             // [nq][2][32]
  bf16* ob = reinterpret_cast<bf16*>(wb);               // [16][ldb], after
  uint4* ab = reinterpret_cast<uint4*>(wb + qo_bytes);  // [nj / 2][32]
  K6_START();
  q_to_buffer(xr, w, qb);
  K6_LAP(1);

  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll 1
  for (int j0 = 0; j0 < nj; j0 += NB) {
    float s[NB][4];
    logits_block<NB, true>(s, w, qb, j0);
    block_max<NB>(s, nj - j0, m);
  }
  const float mb[2] = {-quad_max(m[0]) * LOG2E, -quad_max(m[1]) * LOG2E};
  K6_LAP(2);

  float z0 = 0.f, z1 = 0.f;
#pragma unroll 1
  for (int j0 = 0; j0 < nj; j0 += NB) {
    float s[NB][4];
    logits_block<NB, true>(s, w, qb, j0);
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j0 + j < nj) {
        y0 += exp_shifted(s[j][0], mb[0]);
        y0 += exp_shifted(s[j][1], mb[0]);
        y1 += exp_shifted(s[j][2], mb[1]);
        y1 += exp_shifted(s[j][3], mb[1]);
      }
    z0 += y0;
    z1 += y1;
  }
  const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);
  K6_LAP(3);

#pragma unroll 1
  for (int j0 = 0; j0 < nj; j0 += NB) {
    float s[NB][4];
    logits_block<NB, true>(s, w, qb, j0);
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk)
      if (j0 + 2 * kk < nj) {
        float (&e0)[4] = s[2 * kk];
        float (&e1)[4] = s[2 * kk + 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          e0[e] = exp_shifted(e0[e], mb[e >> 1]);
          e1[e] = exp_shifted(e1[e], mb[e >> 1]);
        }
        uint32_t a[4];
        attn_frag(a, e0, e1, i0, i1);
        ab[(size_t)32 * (j0 / 2 + kk) + lane] = make_uint4(a[0], a[1], a[2],
                                                           a[3]);
      }
  }
  attn_v_wide<0>(w, ob, [&](int k, uint32_t (&a)[4]) {
    const uint4 a4 = ab[(size_t)32 * k + lane];
    a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
  });
  __syncwarp();                   // the o buffer, written by every lane
  K6_LAP(4);
  out_wide(ob, xr, outr, w);
  __syncwarp();                   // read by every lane before the next item
  K6_LAP(5);
}

// Mode 4 on maps of RES_KEYS keys: the logits formed once, block by block
// of 32 keys as the sweeps form them, and kept in registers (lane (g, t):
// keys 8j + 2t, + 1 of rows g and g + 8); the max, the sum of exp(l - m) by
// blocks of 32 keys added in block order, and attn's A fragments, each
// exp(l - m) evaluated once: what the three sweeps compute, on the same
// values in the same order.
template <class W>
__device__ __forceinline__ void rows_wide_resident(const bf16* __restrict__ xr,
                                                   bf16* __restrict__ outr,
                                                   W& w, unsigned char* wb,
                                                   size_t qo_bytes) {
  constexpr int NB = 4, NJ = RES_KEYS / 8;
  uint4* qb = reinterpret_cast<uint4*>(wb);
  bf16* ob = reinterpret_cast<bf16*>(wb);
  K6_START();
  q_to_buffer(xr, w, qb);
  K6_LAP(1);

  float s[NJ / NB][NB][4];
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b) logits_block<NB, false>(s[b], w, qb, NB * b);
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b) block_max<NB>(s[b], NB, m);
  const float mb[2] = {-quad_max(m[0]) * LOG2E, -quad_max(m[1]) * LOG2E};
  K6_LAP(2);

  float z0 = 0.f, z1 = 0.f;
#pragma unroll
  for (int b = 0; b < NJ / NB; ++b) {       // per block of 32 keys
    float y0 = 0.f, y1 = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float (&e)[4] = s[b][j];
#pragma unroll
      for (int i = 0; i < 4; ++i) e[i] = exp_shifted(e[i], mb[i >> 1]);
      y0 += e[0];
      y0 += e[1];
      y1 += e[2];
      y1 += e[3];
    }
    z0 += y0;
    z1 += y1;
  }
  const float i0 = 1.f / quad_sum(z0), i1 = 1.f / quad_sum(z1);
  uint32_t pa[NJ / 2][4];
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    attn_frag(pa[kk], s[2 * kk / NB][2 * kk % NB],
              s[(2 * kk + 1) / NB][(2 * kk + 1) % NB], i0, i1);
    fence(pa[kk]);
  }
  K6_LAP(3);
  attn_v_wide<RES_KEYS / 64>(w, ob, [&](int k, uint32_t (&a)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = pa[k][e];
  });
  __syncwarp();
  K6_LAP(4);
  out_wide(ob, xr, outr, w);
  __syncwarp();
  K6_LAP(5);
}

// The persistent loop of modes 3 and 4: this CTA's contiguous range of work
// items (frame n, TQ queries from q0), a warp per 16 rows, all on one item. x, out (N, HW, C); wq_t (c8, C), wo_t
// (C, c2): the transposed projections; kS and vT from attn_kv_kernel.
template <int MODE, bool RES>
__device__ __forceinline__ void fwd_wide(
    const bf16* __restrict__ x, const bf16* __restrict__ wq_t,
    const bf16* __restrict__ wo_t, const float* __restrict__ kS,
    const bf16* __restrict__ vT, const float* __restrict__ gamma,
    bf16* __restrict__ out, int N, int HW, int keys, int C, int c8, int c2,
    int TQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvn = keys_padded(keys), warps = blockDim.x / 32;
  const WideLayout L = wide_layout(MODE, kvn, C, c8, c2, warps);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = HW / TQ;
  const long long items = (long long)N * tiles;
  const int first = (int)(items * blockIdx.x / gridDim.x);
  const int last = (int)(items * (blockIdx.x + 1) / gridDim.x);
  constexpr bool resident = MODE == 4 && RES;   // kvn == RES_KEYS

  Wide<MODE> w;
  w.wq_t = wq_t;
  w.wo_t = wo_t;
  w.kS = kS;
  w.vT = vT;
  w.C = C;
  w.c8 = c8;
  w.c2 = c2;
  w.kvn = kvn;
  w.keys = keys;
  w.ldb = L.ldb;
  w.gm = __ldg(gamma);
  w.qp = (c8 / 8 + K_STEPS - 1) / K_STEPS;
  w.cb = (C + 127) / 128;
  w.kb = (kvn + K_KEYS - 1) / K_KEYS;
  w.sweeps = resident ? 1 : 3;
  w.vp = (c2 + 63) / 64;
  w.vb = (kvn + 63) / 64;
  w.op = (c2 + 127) / 128;
  w.per_item = wide_tiles(MODE, kvn, C, c8, c2);
  w.bars = reinterpret_cast<uint64_t*>(smem);
  TileEntry* table = reinterpret_cast<TileEntry*>(smem + BAR_BYTES);
  w.table = table;
  w.ring = smem + BAR_BYTES + L.table_bytes;
  w.stages = L.stages;
  w.lead = L.stages - 2;
  w.first = first;
  w.frame_items = tiles;
  w.warps = warps;
  w.warp = warp;
  w.used = w.released = 0;
  w.total = (last - first) * w.per_item;
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(w.full(s), 32);
      mbar_init(w.empty(s), warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  w.fill_table(table);
  __syncthreads();
  w.start();
  unsigned char* wb = w.ring + (size_t)L.stages * TILE_BYTES +
                      (size_t)warp * L.warp_bytes;
  for (int it = first; it < last; ++it) {
    const int n = it / tiles, q0 = (it - n * tiles) * TQ;
    K6_START();
    if (it + 1 < last) {          // this warp's rows of the next item, into L2
      const int n1 = (it + 1) / tiles, q1 = (it + 1 - n1 * tiles) * TQ;
      prefetch_l2(x + ((size_t)n1 * HW + q1 + 16 * warp) * C, (size_t)32 * C,
                  lane, 32);
    }
    K6_LAP(0);
    if (lane == 0) K6_COUNT(6);
    const size_t row0 = (size_t)n * HW + q0 + 16 * warp;
    if constexpr (MODE == 3)
      rows_wide(x + row0 * C, out + row0 * C, w, reinterpret_cast<bf16*>(wb));
    else if constexpr (resident)
      rows_wide_resident(x + row0 * C, out + row0 * C, w, wb, L.qo_bytes);
    else
      rows_wide_sweep(x + row0 * C, out + row0 * C, w, wb, L.qo_bytes);
  }
}

// The persistent loop: this CTA's contiguous range of work items (frame n,
// TQ queries from q0), a warp per 16 rows (modes 0-2). x, out (N, HW, C);
// wq (C, c8), wo (c2, C) as the module holds them; kS and vT from
// attn_kv_kernel (bf16 layout, keys_padded(keys) tokens a frame).
template <int MODE, int OT>
__device__ __forceinline__ void fwd_tc(
    const bf16* __restrict__ x, const bf16* __restrict__ wq,
    const bf16* __restrict__ wo, const float* __restrict__ kS,
    const bf16* __restrict__ vT, const float* __restrict__ gamma,
    bf16* __restrict__ out, int N, int HW, int keys, int C, int c8, int c2,
    int TQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kStaged = MODE != 2;    // v^T (and k) in smem
  const int kvn = keys_padded(keys);
  const TcLayout L = tc_layout(kvn, C, c8, c2, kStaged);
  bf16* wq_s = reinterpret_cast<bf16*>(smem);
  bf16* wo_s = reinterpret_cast<bf16*>(smem + L.wo);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L.v);
  float* k_s = reinterpret_cast<float*>(smem + L.k);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = HW / TQ;
  const long long items = (long long)N * tiles;
  const int first = (int)(items * blockIdx.x / gridDim.x);
  const int last = (int)(items * (blockIdx.x + 1) / gridDim.x);
  const size_t kv_floats = (size_t)c8 * kvn * 2, v_elems = (size_t)c2 * kvn;

  // Wq^T from wq (C, c8); Wo^T from wo (c2, C), channel n to the row that
  // holds it in out_rows' permutation (row 8j + i of a group of 32 holds
  // channel 8 (i / 2) + 2j + i % 2)
  stage_transposed(wq_s, L.ldq, wq, C, c8, [](int n) { return n; });
  stage_transposed(wo_s, L.ldo, wo, c2, C, [](int n) {
    const int w = n & 31;
    return (n & ~31) + 8 * ((w >> 1) & 3) + 2 * (w >> 3) + (w & 1);
  });
  __syncthreads();                // mode 2 without k staged has no other
  TcCtx c{wq_s, wo_s, v_s, k_s, L.ldq, L.ldo, kStaged ? L.ldv : kvn, kvn, C,
          c8, c2, __ldg(gamma), keys};

  int frame = -1;
  for (int it = first; it < last; ++it) {
    const int n = it / tiles, q0 = (it - n * tiles) * TQ;
    K6_START();
    if (n != frame) {
      const float* kSn = kS + (size_t)n * kv_floats;
      const bf16* vTn = vT + (size_t)n * v_elems;
      if (L.k_staged) {
        __syncthreads();          // every warp is done with the last frame
        stage_async(k_s, 0, 1, (int)kv_floats, [&](int) { return kSn; });
      } else {
        c.k_s = kSn;
      }
      if constexpr (kStaged)
        stage_async(v_s, L.ldv, c2, kvn,
                    [&](int r) { return vTn + (size_t)r * kvn; });
      else
        c.v_s = vTn;
      if ((long long)(n + 1) * tiles < last) {   // the next frame, into L2
        prefetch_l2(kSn + kv_floats, kv_floats * 4, threadIdx.x, blockDim.x);
        prefetch_l2(vTn + v_elems, v_elems * 2, threadIdx.x, blockDim.x);
      }
      if (L.k_staged) {
        cp_async_wait();
        __syncthreads();
      }
      frame = n;
      if (threadIdx.x == 0) K6_COUNT(7);
    }
    if (it + 1 < last) {          // this warp's rows of the next item, into L2
      const int n1 = (it + 1) / tiles, q1 = (it + 1 - n1 * tiles) * TQ;
      prefetch_l2(x + ((size_t)n1 * HW + q1 + 16 * warp) * C, (size_t)32 * C,
                  lane, 32);
    }
    K6_LAP(0);
    if (lane == 0) K6_COUNT(6);
    const size_t row0 = (size_t)n * HW + q0 + 16 * warp;
    if constexpr (MODE == 0)
      rows_resident<OT>(x + row0 * C, out + row0 * C, c);
    else
      rows_sweep<OT, !kStaged>(x + row0 * C, out + row0 * C, c);
  }
}

// The second launch. f32: V = DC, the CUDA-core body on grid (HW / TQ, N),
// NT threads, wq and wo transposed. bf16: V = the body (BODY_TABLE), the
// persistent grid, 2 TQ threads (a warp per 16 queries), wq and wo as the
// module holds them.
template <typename T, int V>
struct FwdThreads {
  static constexpr int value = NT;
};
template <int V>
struct FwdThreads<bf16, V> {
  static constexpr int value = 32 * BodyOf<V>::kWarps;
};

// RES: mode 4 on maps of RES_KEYS keys (rows_wide_resident), a kernel of
// its own: one body's code in each.
template <typename T, int V, bool RES = false>
__global__ void __launch_bounds__(FwdThreads<T, V>::value, 1)
attn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                const T* __restrict__ wo, const float* __restrict__ kT,
                const T* __restrict__ vT, const float* __restrict__ gamma,
                T* __restrict__ out, int N, int HW, int keys, int C, int c8,
                int c2, int TQ) {
  if constexpr (!Traits<T>::kBf16)
    fwd_f32<V>(x, wq, wo, kT, vT, gamma, out, HW, keys, C, c8, c2, TQ);
  else if constexpr (BodyOf<V>::kMode >= 3)
    fwd_wide<BodyOf<V>::kMode, RES>(x, wq, wo, kT, vT, gamma, out, N, HW,
                                    keys, C, c8, c2, TQ);
  else
    fwd_tc<BodyOf<V>::kMode, BodyOf<V>::kOT>(x, wq, wo, kT, vT, gamma,
                                             out, N, HW, keys, C, c8, c2, TQ);
}

// ---- plans and launches ----------------------------------------------------

bool bad_shape(int N, int H, int W, int C, int c8, int c2) {
  if (N < 1 || H < 2 || W < 2 || (H & 1) || (W & 1)) return true;
  return C < 16 || C % 16 || c8 < 8 || c8 % 8 || c2 < 16 || c2 % 16 ||
         N > 65535;
}

// kv tokens per CTA of the first launch: the most of 64, 32, 16 that divides
// the frame's padded tokens and fits (bf16: C % 32 == 0 for its fragment
// loads); 0 where none does. A token's k and v do not depend on the tile.
template <typename T>
int plan_kt(int H, int W, int C) {
  const int kvn = keys_padded((H / 2) * (W / 2));
  if (Traits<T>::kBf16 && C % 32) return 0;
  for (int kt = 64; kt >= 16; kt >>= 1)
    if (kvn % kt == 0 && kv_smem_bytes<T>(kt, C) <= SMEM_MAX) return kt;
  return 0;
}

// Shared memory of the second launch for this plan; 0 for a plan the kernel
// does not take: f32 (body -1) a multiple of 16 queries dividing HW; bf16 a
// body whose mode and widths take the shape, C % 32 == 0, TQ a multiple of
// 16 dividing HW of at most the body's warps (mode 0: maps of RES_KEYS keys;
// modes 1 and 2: any; mode 3: at most WIDE_KEYS keys padded, c2 % 32 == 0;
// mode 4: any, c2 % 32 == 0; modes 3 and 4 any width). Either must fit
// SMEM_MAX.
size_t fwd_smem(int dtype, int body, int tq, int H, int W, int C, int c8,
                int c2) {
  const int HW = H * W, keys = HW / 4, kvn = keys_padded(keys);
  if (tq < 16 || tq % 16 || HW % tq) return 0;
  size_t bytes = 0;
  if (dtype == 0 && body == -1) {
    bytes = make_layout(tq, kvn, C, c8, c2).total;
  } else if (dtype == 1 && body >= 0 && body < N_BODIES) {
    const int mode = BODY_TABLE[body][0], ot = BODY_TABLE[body][1];
    if (C % 32 || (mode < 3 && (c8 > 2 * ot || c2 > 8 * ot)) ||
        (mode == 0 && keys != RES_KEYS) ||
        (mode == 3 && kvn > WIDE_KEYS) || (mode >= 3 && c2 % 32) ||
        tq / 16 > BODY_TABLE[body][2])
      return 0;
    bytes = mode >= 3 ? wide_layout(mode, kvn, C, c8, c2, tq / 16).total
                      : tc_layout(kvn, C, c8, c2, mode != 2).total;
  }
  return bytes <= SMEM_MAX ? bytes : 0;
}

template <typename T>
int kv_launch(const void* x, const void* wk_t, const void* wv_t, float* kT,
              void* vT, int N, int H, int W, int C, int c8, int c2,
              cudaStream_t stream) {
  const int kt = plan_kt<T>(H, W, C);
  if (kt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = kv_smem_bytes<T>(kt, C);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_kv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(keys_padded((H / 2) * (W / 2)) / kt, N);
  attn_kv_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk_t),
      static_cast<const T*>(wv_t), kT, static_cast<T*>(vT), H, W, C, c8, c2,
      kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool RES = false>
int fwd_launch(const void* x, const void* wq, const void* wo,
               const float* kT, const void* vT, const float* gamma, void* out,
               int N, int HW, int C, int c8, int c2, int tq, dim3 grid,
               int threads, size_t bytes, cudaStream_t stream) {
  const auto kernel = attn_fwd_kernel<T, V, RES>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, threads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq),
      static_cast<const T*>(wo), kT, static_cast<const T*>(vT), gamma,
      static_cast<T*>(out), N, HW, HW / 4, C, c8, c2, tq);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 launch of body `body` (V and up).
template <int V = 0>
int fwd_bf16(int body, const void* x, const void* wq, const void* wo,
             const float* kT, const void* vT, const float* gamma, void* out,
             int N, int HW, int C, int c8, int c2, int tq, int ctas,
             size_t bytes, cudaStream_t stream) {
  if constexpr (V < N_BODIES) {
    if (body != V)
      return fwd_bf16<V + 1>(body, x, wq, wo, kT, vT, gamma, out, N, HW, C,
                             c8, c2, tq, ctas, bytes, stream);
    if constexpr (BodyOf<V>::kMode == 4)
      if (keys_padded(HW / 4) == RES_KEYS)
        return fwd_launch<bf16, V, true>(x, wq, wo, kT, vT, gamma, out, N, HW,
                                         C, c8, c2, tq, dim3(ctas), 2 * tq,
                                         bytes, stream);
    return fwd_launch<bf16, V>(x, wq, wo, kT, vT, gamma, out, N, HW, C, c8,
                               c2, tq, dim3(ctas), 2 * tq, bytes, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each launching function makes ONE launch on `stream` (a cudaStream_t) and
// returns cudaGetLastError() right after it (0 = launched). The plan (body,
// queries per work item, grid) comes from `attention_spatial.plan`.
extern "C" {

// Shared memory of the second launch for a plan (see fwd_smem); 0 where the
// kernel does not take it, -1 for a shape neither launch takes.
long long spatial_attn_smem_bytes(int dtype, int body, int tq, int H, int W,
                                  int C, int c8, int c2) {
  if (bad_shape(1, H, W, C, c8, c2)) return -1;
  return static_cast<long long>(fwd_smem(dtype, body, tq, H, W, C, c8, c2));
}

// kv tokens per CTA of the first launch (0: the projections do not fit).
int spatial_attn_kv_tokens(int dtype, int H, int W, int C) {
  return dtype == 0 ? plan_kt<float>(H, W, C) : plan_kt<bf16>(H, W, C);
}

// {mode, OT, most warps a CTA} of bf16 body `body` into out[0..2].
int spatial_attn_body(int body, int* out) {
  if (body < 0 || body >= N_BODIES) return -1;
  for (int i = 0; i < 3; ++i) out[i] = BODY_TABLE[body][i];
  return 0;
}

// First launch: vT (N, c2, kvn) and k (f32: kT (N, c8, kvn); bf16: kS
// (N, c8 / 8, kvn, 16)) from x (N, H, W, C) and the transposed projections
// wk_t (c8, C), wv_t (c2, C); kvn = HW/4 rounded up to a multiple of 16 (the
// padded tokens' k and v are zero).
int spatial_attn_kv(int dtype, int device, const void* x, const void* wk_t,
                    const void* wv_t, float* kT, void* vT, int N, int H, int W,
                    int C, int c8, int c2, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, C, c8, c2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return kv_launch<float>(x, wk_t, wv_t, kT, vT, N, H, W, C, c8, c2, s);
  if (dtype == 1)
    return kv_launch<bf16>(x, wk_t, wv_t, kT, vT, N, H, W, C, c8, c2, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Second launch: out (N, H, W, C) from x, the projections wq, wo (f32 and
// the bf16 modes 3 and 4 transposed: (c8, C), (C, c2); the other bf16 bodies as
// the module holds them: (C, c8), (c2, C)), the first launch's k and vT and
// gamma (one f32 on the device),
// by the plan:
// f32 body -1, `tq` queries a CTA, ctas = N HW / tq; bf16 `body`, `tq`
// queries a work item, `ctas` persistent CTAs (at most N HW / tq).
int spatial_attn_fwd(int dtype, int device, const void* x, const void* wq,
                     const void* wo, const float* kT, const void* vT,
                     const float* gamma, void* out, int N, int H, int W, int C,
                     int c8, int c2, int body, int tq, int ctas, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = bad_shape(N, H, W, C, c8, c2)
                           ? 0
                           : fwd_smem(dtype, body, tq, H, W, C, c8, c2);
  const int HW = H * W;
  const long long items = (long long)N * (HW / (tq > 0 ? tq : 1));
  if (bytes == 0 || ctas < 1 || ctas > items ||
      (dtype == 0 && ctas != items))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const dim3 grid(HW / tq, N);
    return c8 % 16 == 0
               ? fwd_launch<float, 16>(x, wq, wo, kT, vT, gamma, out, N,
                                       HW, C, c8, c2, tq, grid, NT, bytes, s)
               : fwd_launch<float, 8>(x, wq, wo, kT, vT, gamma, out, N,
                                      HW, C, c8, c2, tq, grid, NT, bytes, s);
  }
  return fwd_bf16(body, x, wq, wo, kT, vT, gamma, out, N, HW, C, c8, c2, tq,
                  ctas, bytes, s);
}

#ifdef K6_PROFILE
// Copies the twelve counters of the bf16 body (K6_PROFILE above) to `out`
// and zeroes them.
int spatial_attn_profile(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, k6_cycles, 96);
  const unsigned long long zero[12] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k6_cycles, zero, 96);
  return static_cast<int>(e);
}
#endif

const char* spatial_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
