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
// Design. A frame's (HW x HW/4) f32 logits are 1 MB at 32x32: no SM's 227 KB
// of shared memory holds them, so on this card K6a is query-tiled like K6b,
// and both entries run the same two launches:
//
//   attn_kv_kernel   grid (HW/4 / KT, N): pools KT kv tokens of a frame into
//                    shared memory and writes k^T (N, c8, HW/4) f32 and
//                    v^T (N, c2, HW/4) in the activation type to scratch:
//                    once per frame, not once per query tile (at C = 256 a
//                    frame's k and v cost twice a 64-query tile's own work).
//   attn_fwd_kernel  grid (HW / TQ, N): a CTA owns TQ queries of one frame
//                    (TQ = 64, 32 or 16, the largest whose tiles fit) and
//                    walks seven phases with a block barrier between them:
//                    stage the x tile (and, in bf16, Wq^T; v^T and a small
//                    Wo^T stay in flight); q = x Wq into shared memory; the
//                    f32 logits of the TQ x HW/4 tile into shared memory as
//                    f32 FMAs (the product's operands are f32 by the
//                    kernel's contract, so it cannot run on the bf16 tensor
//                    cores, and TF32 would lose bits: a thread keeps k for
//                    four keys in registers and takes four rows at a time,
//                    16 FMAs per 16-byte broadcast read of q); a warp per
//                    row takes the softmax, a row's values in registers from
//                    the one read to the one write at 32x32 and 64x64, and
//                    rounds attn into the front half of its own row;
//                    o = attn v; y = o Wo; the residual and the one rounding
//                    go into the x tile in place, which leaves in whole rows.
//                    The logits and attn never leave the SM.
//
// In bf16 the five products with bf16 operands (x Wq, kv Wk, kv Wv, attn v,
// o Wo) run on the tensor cores: mma.sync.m16n8k16, bf16 operands, f32
// accumulators, fragments read with ldmatrix from padded shared-memory
// tiles (row stride = 16 bytes mod 128, so a fragment load is conflict-free);
// the cp.async, ldmatrix and mma helpers are mma_bf16.cuh's (shared with K5).
// Every B operand is kept "n-major" ([N][K], K contiguous), which is why the
// wrapper hands over transposed weights and the first launch writes k and v
// transposed. In f32 (the parity mode, not the fast one) every product is
// f32 FMAs in the same structure, with the weights and v^T read from global
// memory.
//
// Shared memory of attn_fwd_kernel, bf16: the x tile, a region U that holds
// Wq^T and then the logits/attn tile S (and after that Wo^T where it is
// large), v^T, q, o and a small Wo^T. 103 KB at 32x32x64 (two CTAs an SM),
// 192 KB at 32x32x256, 206 KB at 64x64x64 (TQ = 32).
//
// What bounds it on the H100: bytes by the roofline (x read and out written
// once: 2 N HW C elements; the f32 logits' FMAs come close to that at
// 64x64), but this version is bound by latency: one or two CTAs of eight
// warps an SM, seven barriers, and phases whose chains (a fragment load, its
// mma, the epilogue) are short. Per-phase cycles: build with -DK6_PROFILE.
// The logits (f32 FMAs, a third of the cycles at C = 256) and the o Wo
// product are the largest phases left; wgmma, TMA, persistent CTAs that
// fetch the next tile under the current one, and a v^T shared across a
// cluster are left for later work.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using tc::copy_rows_async;
using tc::cp_async_wait;
using tc::ldmatrix_x2;
using tc::ldmatrix_x4;
using tc::mma_16816;

using bf16 = __nv_bfloat16;

constexpr int NT = 256;                // threads per CTA
constexpr int NWARPS = NT / 32;
constexpr int SMEM_MAX = 232448;       // 227 KB: a block's most on sm_90

// With -DK6_PROFILE attn_fwd_kernel adds the cycles thread 0 of every CTA
// spends in each of its phases to k6_cycles (read and zeroed through
// spatial_attn_profile); without it the marks compile to nothing.
#ifdef K6_PROFILE
__device__ unsigned long long k6_cycles[8];
#define K6_MARK_START() long long k6_mark = clock64()
#define K6_MARK(i)                                                         \
  do {                                                                     \
    __syncthreads();                                                       \
    if (threadIdx.x == 0) {                                                \
      const long long now = clock64();                                     \
      atomicAdd(&k6_cycles[i], (unsigned long long)(now - k6_mark));       \
      k6_mark = now;                                                       \
    }                                                                      \
  } while (0)
#else
#define K6_MARK_START()
#define K6_MARK(i)
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
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// ---- products --------------------------------------------------------------
//
// block_gemm(A, lda, Bt, ldb, M, N, K, epi): the CTA computes
// D (M x N) = A (M x K, row-major, row stride lda) * B, with B given n-major
// (Bt[n][k], row stride ldb), f32 sums, and hands every pair of neighbouring
// columns to epi(row, col, d[row][col], d[row][col + 1]) (col even), once.
// M is a multiple of 16, N of 8, K of 16. No synchronisation inside.

// One warp: rows [m0, m0 + 16) of D times the n-tiles (8 columns each)
// nt0 .. nt0 + NB - 1 (those below n_tiles). A and Bt lie in shared memory
// with 16-byte-aligned rows. The fragment layouts are the PTX ISA's for
// m16n8k16: with g = lane / 4 and t = lane % 4, A holds rows g and g + 8 at
// columns 2t, 2t + 1 (+ 8); B holds k = 2t, 2t + 1 (+ 8) of column g; the
// accumulator rows g and g + 8 at columns 2t, 2t + 1. One ldmatrix.x4 loads
// the A fragment (matrices: rows 0-7 | 8-15 at k 0-7, then at k 8-15), one
// the B fragments of two n-tiles (per tile: k 0-7, then k 8-15).
template <int NB, class Epi>
__device__ __forceinline__ void warp_mma(const bf16* A, int lda, const bf16* Bt,
                                         int ldb, int K, int m0, int nt0,
                                         int n_tiles, Epi& epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float acc[NB][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const bf16* ap = A + (size_t)(m0 + (lane & 15)) * lda + (lane >> 4) * 8;
  // this lane's row of B in each pair of n-tiles (a tile past the end reads
  // the last one again; its product is dropped)
  const bf16* bp[(NB + 1) / 2];
#pragma unroll
  for (int i = 0; i < NB; i += 2) {
    int nt = nt0 + i + (NB > 1 ? lane >> 4 : 0);
    if (nt >= n_tiles) nt = n_tiles - 1;
    bp[i / 2] = Bt + (size_t)(nt * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8;
  }
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, ap + k0);
    if constexpr (NB == 1) {
      uint32_t b[2];
      ldmatrix_x2(b, bp[0] + k0);
      mma_16816(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int i = 0; i < NB; i += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, bp[i / 2] + k0);
        mma_16816(acc[i], a, b[0], b[1]);
        mma_16816(acc[i + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NB; ++i)
    if (nt0 + i < n_tiles) {
      const int col = (nt0 + i) * 8 + 2 * t;
      epi(m0 + g, col, acc[i][0], acc[i][1]);
      epi(m0 + g + 8, col, acc[i][2], acc[i][3]);
    }
}

// bf16: tensor cores. A warp takes one 16-row tile and up to four n-tiles at
// a time (the A fragment is loaded once for them); fewer where that would
// leave warps without work.
template <class Epi>
__device__ __forceinline__ void block_gemm(const bf16* A, int lda,
                                           const bf16* Bt, int ldb, int M,
                                           int N, int K, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int m_tiles = M / 16, n_tiles = N / 8;
  int nb = 4;
  while (nb > 1 && m_tiles * ((n_tiles + nb - 1) / nb) < NWARPS) nb >>= 1;
  const int groups = (n_tiles + nb - 1) / nb;
  for (int u = warp; u < m_tiles * groups; u += NWARPS) {
    const int m0 = (u % m_tiles) * 16, nt0 = (u / m_tiles) * nb;
    if (nb == 4)
      warp_mma<4>(A, lda, Bt, ldb, K, m0, nt0, n_tiles, epi);
    else if (nb == 2)
      warp_mma<2>(A, lda, Bt, ldb, K, m0, nt0, n_tiles, epi);
    else
      warp_mma<1>(A, lda, Bt, ldb, K, m0, nt0, n_tiles, epi);
  }
}

// f32: FMAs on the CUDA cores, k ascending. A thread takes 8 rows x 2
// neighbouring columns; A and Bt are read as 16-byte vectors along k.
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

// ---- first launch: k^T and v^T of a frame ----------------------------------

template <typename T>
__host__ __device__ inline size_t kv_smem_bytes(int kt, int C, int c8, int c2) {
  const int ld = C + Traits<T>::kPad;
  const int rows = Traits<T>::kBf16 ? kt + c8 + c2 : kt;  // + Wk^T, Wv^T
  return (size_t)rows * ld * sizeof(T);
}

// x (N, H, W, C); wk_t (c8, C), wv_t (c2, C): the transposed projections;
// kT (N, c8, kvn) f32 and vT (N, c2, kvn) out. A CTA takes KT kv tokens.
template <typename T>
__global__ void __launch_bounds__(NT)
attn_kv_kernel(const T* __restrict__ x, const T* __restrict__ wk_t,
               const T* __restrict__ wv_t, float* __restrict__ kT,
               T* __restrict__ vT, int H, int W, int C, int c8, int c2, int KT) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = Traits<T>::kVec;
  const int ld = C + Traits<T>::kPad;
  T* kv = reinterpret_cast<T*>(smem);               // [KT][ld] pooled tokens
  const int n = blockIdx.y, tok0 = blockIdx.x * KT;
  const int W2 = W / 2, kvn = (H / 2) * W2;
  const T* xn = x + (size_t)n * H * W * C;

  const int cv = C / V;
  for (int u = threadIdx.x; u < KT * cv; u += NT) {
    const int tk = u / cv, c0 = (u % cv) * V;
    const int m = tok0 + tk, i = m / W2, j = m % W2;
    const T* p = xn + ((size_t)(2 * i) * W + 2 * j) * C + c0;
    const size_t row = (size_t)W * C;
    uint4 best = *reinterpret_cast<const uint4*>(p);
    best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + C));
    best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + row));
    best = vmax<T>(best, *reinterpret_cast<const uint4*>(p + row + C));
    *reinterpret_cast<uint4*>(kv + (size_t)tk * ld + c0) = best;
  }
  const T* bk = wk_t;
  const T* bv = wv_t;
  int ldw = C;
  if constexpr (Traits<T>::kBf16) {
    T* wk_s = kv + (size_t)KT * ld;                 // [c8][ld]
    T* wv_s = wk_s + (size_t)c8 * ld;               // [c2][ld]
    copy_rows_async<NT>(wk_s, ld, wk_t, C, c8, C);
    copy_rows_async<NT>(wv_s, ld, wv_t, C, c2, C);
    cp_async_wait();
    bk = wk_s;
    bv = wv_s;
    ldw = ld;
  }
  __syncthreads();

  // k (tokens x c8) = kv Wk, kept f32, stored transposed
  float* kTn = kT + (size_t)n * c8 * kvn + tok0;
  block_gemm(kv, ld, bk, ldw, KT, c8, C,
             [&](int r, int c, float v0, float v1) {
               kTn[(size_t)c * kvn + r] = v0;
               kTn[(size_t)(c + 1) * kvn + r] = v1;
             });
  // v^T (c2 x tokens) = Wv^T kv^T, rounded once
  T* vTn = vT + (size_t)n * c2 * kvn + tok0;
  block_gemm(bv, ldw, kv, ld, c2, KT, C,
             [&](int r, int c, float v0, float v1) {
               store2(vTn + (size_t)r * kvn + c, v0, v1);
             });
}

// ---- second launch: a tile of queries --------------------------------------

// Shared-memory layout of attn_fwd_kernel (bytes from the start): the x
// tile (kept for the residual); a region U that holds Wq^T, then the
// logits/attn tile S in its place and, where Wo^T is too large for a region
// of its own, Wo^T after that; in bf16 v^T; q; o; a small Wo^T.
struct Layout {
  int ldx, lds, ldv, ldo;         // row strides, in elements of their tiles
  bool wo_apart;                  // Wo^T in its own region, staged at once
  size_t u, v, q, o, wo, total;   // offsets; x starts at 0
};

template <typename T>
__host__ __device__ inline Layout make_layout(int tq, int kvn, int C, int c8,
                                              int c2) {
  constexpr bool B = Traits<T>::kBf16;
  constexpr int P = Traits<T>::kPad;
  Layout L;
  L.ldx = C + P;
  L.lds = kvn + 4;      // f32; as bf16 (attn in place) 2 * lds
  L.ldv = kvn + P;
  L.ldo = c2 + P;
  const size_t wq_b = B ? (size_t)c8 * L.ldx * sizeof(T) : 0;
  const size_t wo_b = B ? (size_t)C * L.ldo * sizeof(T) : 0;
  L.wo_apart = wo_b <= 16384;
  size_t u_b = (size_t)tq * L.lds * 4;
  if (wq_b > u_b) u_b = wq_b;
  if (!L.wo_apart && wo_b > u_b) u_b = wo_b;
  L.u = (size_t)tq * L.ldx * sizeof(T);
  L.v = L.u + u_b;
  L.q = L.v + (B ? (size_t)c2 * L.ldv * sizeof(T) : 0);
  L.o = L.q + (size_t)tq * c8 * 4;
  L.wo = L.wo_apart ? L.o + (size_t)tq * L.ldo * sizeof(T) : L.u;
  L.total = L.o + (size_t)tq * L.ldo * sizeof(T) + (L.wo_apart ? wo_b : 0);
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

// The softmax of rows r0 .. r0 + R - 1 of S over their kvn columns, f32, by
// one warp: the R rows' chains (max, exp and sum, scale) run side by side.
// attn = e * (1 / sum): one division per row. In bf16 attn is rounded into
// the front half of its own row: a step reads floats [32i, 32i + 32) and
// then writes bf16 [32i, 32i + 32) = floats [16i, 16i + 16), which every
// later step has left behind.
template <int R, bool kBf16>
__device__ __forceinline__ void softmax_rows(float* S, int lds, int kvn,
                                             int r0) {
  const int lane = threadIdx.x & 31;
  float* row[R];
  float mx[R], sum[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    row[j] = S + (size_t)(r0 + j) * lds;
    mx[j] = -INFINITY;
    sum[j] = 0.f;
  }
  for (int m = lane; m < kvn; m += 32)
#pragma unroll
    for (int j = 0; j < R; ++j) mx[j] = fmaxf(mx[j], row[j][m]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int j = 0; j < R; ++j)
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
  for (int m = lane; m < kvn; m += 32)
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
  if constexpr (kBf16) {
    for (int m0 = 0; m0 < kvn; m0 += 32) {      // every lane, every step
      const int m = m0 + lane;
      float p[R];
#pragma unroll
      for (int j = 0; j < R; ++j) p[j] = m < kvn ? row[j][m] * sum[j] : 0.f;
      __syncwarp();
      if (m < kvn) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          reinterpret_cast<bf16*>(row[j])[m] = __float2bfloat16_rn(p[j]);
      }
    }
  } else {
    for (int m = lane; m < kvn; m += 32)
#pragma unroll
      for (int j = 0; j < R; ++j) row[j][m] *= sum[j];
  }
}

// The same for rows of exactly 32 * EPL columns, each lane's EPL values of
// a row kept in registers from the one read to the one write.
template <int EPL, int R, bool kBf16>
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
    for (int i = 0; i < EPL; ++i) {
      if constexpr (kBf16)
        reinterpret_cast<bf16*>(row)[32 * i + lane] =
            __float2bfloat16_rn(v[j][i] * inv);
      else
        row[32 * i + lane] = v[j][i] * inv;
    }
  }
}

// x, out (N, HW, C); wq_t (c8, C), wo_t (C, c2); kT (N, c8, kvn) f32 and
// vT (N, c2, kvn) from attn_kv_kernel; gamma: one f32 on the device. DC:
// the channels of k a thread keeps in registers for the logits (8, or 16
// where c8 is a multiple of 16: a kernel of its own, with its own register
// count).
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ x, const T* __restrict__ wq_t,
                const T* __restrict__ wo_t, const float* __restrict__ kT,
                const T* __restrict__ vT, const float* __restrict__ gamma,
                T* __restrict__ out, int HW, int kvn, int C, int c8, int c2,
                int TQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool B = Traits<T>::kBf16;
  const Layout L = make_layout<T>(TQ, kvn, C, c8, c2);
  T* xs = reinterpret_cast<T*>(smem);                 // [TQ][ldx]
  float* S = reinterpret_cast<float*>(smem + L.u);    // [TQ][lds]
  float* qs = reinterpret_cast<float*>(smem + L.q);   // [TQ][c8]
  T* os = reinterpret_cast<T*>(smem + L.o);           // [TQ][ldo]
  const int n = blockIdx.y, q0 = blockIdx.x * TQ;
  const T* xq = x + ((size_t)n * HW + q0) * C;
  T* outq = out + ((size_t)n * HW + q0) * C;
  const T* vTn = vT + (size_t)n * c2 * kvn;

  const float gm = __ldg(gamma);
  // stage the x tile; in bf16 also Wq^T, then (in flight until attn v needs
  // them) the frame's v^T and a small Wo^T
  K6_MARK_START();
  copy_rows_async<NT>(xs, L.ldx, xq, C, TQ, C);
  const T* bq = wq_t;
  const T* bv = vTn;
  const T* bo = wo_t;
  int ldq = C, ldv = kvn, ldw = c2;
  if constexpr (B) {
    T* wq_s = reinterpret_cast<T*>(smem + L.u);
    T* v_s = reinterpret_cast<T*>(smem + L.v);
    T* wo_s = reinterpret_cast<T*>(smem + L.wo);
    copy_rows_async<NT>(wq_s, L.ldx, wq_t, C, c8, C);
    cp_async_wait();
    copy_rows_async<NT>(v_s, L.ldv, vTn, kvn, c2, kvn);
    if (L.wo_apart) copy_rows_async<NT>(wo_s, L.ldo, wo_t, c2, C, c2);
    bq = wq_s;
    bv = v_s;
    bo = wo_s;
    ldq = L.ldx;
    ldv = L.ldv;
    ldw = L.ldo;
  } else {
    cp_async_wait();
  }
  __syncthreads();
  K6_MARK(0);

  // q = x Wq, f32, not rounded
  block_gemm(xs, L.ldx, bq, ldq, TQ, c8, C,
             [&](int r, int c, float v0, float v1) {
               store2(qs + (size_t)r * c8 + c, v0, v1);
             });
  __syncthreads();          // Wq^T is dead: S takes its place
  K6_MARK(1);

  // logits = q k^T with f32 operands
  const float* kTn = kT + (size_t)n * c8 * kvn;
  logits_tile<DC>(kTn, qs, S, kvn, c8, L.lds, TQ);
  __syncthreads();
  K6_MARK(2);

  // softmax over the full rows: a warp takes TQ / 8 neighbouring rows
  {
    const int rpw = TQ / NWARPS, r_lo = (threadIdx.x >> 5) * rpw;
    if (kvn == 256 && rpw % 4 == 0)         // 32 x 32 maps
      for (int r = r_lo; r < r_lo + rpw; r += 4)
        softmax_rows_reg<8, 4, B>(S, L.lds, r);
    else if (kvn == 1024)                   // 64 x 64 maps
      for (int r = r_lo; r < r_lo + rpw; ++r)
        softmax_rows_reg<32, 1, B>(S, L.lds, r);
    else                                    // any other map
      for (int r = r_lo; r < r_lo + rpw; r += 2)
        softmax_rows<2, B>(S, L.lds, kvn, r);
  }
  K6_MARK(3);
  cp_async_wait();          // this thread's part of v^T (and Wo^T)
  __syncthreads();
  K6_MARK(4);

  // o = attn v, f32 sums, rounded once
  const T* P = reinterpret_cast<const T*>(S);
  block_gemm(P, B ? 2 * L.lds : L.lds, bv, ldv, TQ, c2, kvn,
             [&](int r, int c, float v0, float v1) {
               store2(os + (size_t)r * L.ldo + c, v0, v1);
             });
  __syncthreads();          // attn is dead: a large Wo^T takes its place
  K6_MARK(5);
  if constexpr (B) {
    if (!L.wo_apart) {
      copy_rows_async<NT>(const_cast<T*>(bo), L.ldo, wo_t, c2, C, c2);
      cp_async_wait();
      __syncthreads();
    }
  }
  K6_MARK(6);

  // y = o Wo (f32); out = f32(x) + gamma * y, rounded once, into the x tile
  // in place (an mma fragment's store covers 16 bytes of 8 rows), then to
  // global memory in whole rows. The product and the sum are rounded apart,
  // as the plain version's are.
  block_gemm(os, L.ldo, bo, ldw, TQ, C, c2,
             [&](int r, int c, float v0, float v1) {
               T* p = xs + (size_t)r * L.ldx + c;
               const float2 xr = load2(p);
               store2(p, __fadd_rn(xr.x, __fmul_rn(gm, v0)),
                      __fadd_rn(xr.y, __fmul_rn(gm, v1)));
             });
  __syncthreads();
  {
    constexpr int V = Traits<T>::kVec;
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < TQ; r += NWARPS)
      for (int c = lane * V; c < C; c += 32 * V)
        *reinterpret_cast<uint4*>(outq + (size_t)r * C + c) =
            *reinterpret_cast<const uint4*>(xs + (size_t)r * L.ldx + c);
  }
  K6_MARK(7);
}

// ---- plans and launches ----------------------------------------------------

bool bad_shape(int N, int H, int W, int C, int c8, int c2) {
  if (N < 1 || H < 2 || W < 2 || (H & 1) || (W & 1)) return true;
  const int kvn = (H / 2) * (W / 2);
  return C < 16 || C % 16 || c8 < 8 || c8 % 8 || c2 < 16 || c2 % 16 ||
         kvn % 16 || N > 65535;
}

// Queries per CTA: `force` if it is a multiple of 16 that divides HW and
// fits, else the largest of 64, 32, 16 that fits; 0 where nothing does.
template <typename T>
int plan_tq(int H, int W, int C, int c8, int c2, int force) {
  const int HW = H * W, kvn = HW / 4;
  if (force > 0) {
    if (force % 16 || HW % force) return 0;
    return make_layout<T>(force, kvn, C, c8, c2).total <= SMEM_MAX ? force : 0;
  }
  for (int tq = 64; tq >= 16; tq >>= 1)
    if (HW % tq == 0 && make_layout<T>(tq, kvn, C, c8, c2).total <= SMEM_MAX)
      return tq;
  return 0;
}

// kv tokens per CTA of the first launch; 0 where the weights do not fit.
template <typename T>
int plan_kt(int H, int W, int C, int c8, int c2) {
  const int kvn = (H / 2) * (W / 2);
  for (int kt = 64; kt >= 16; kt >>= 1)
    if (kvn % kt == 0 && kv_smem_bytes<T>(kt, C, c8, c2) <= SMEM_MAX) return kt;
  return 0;
}

template <typename T>
int kv_launch(const void* x, const void* wk_t, const void* wv_t, float* kT,
              void* vT, int N, int H, int W, int C, int c8, int c2,
              cudaStream_t stream) {
  const int kt = plan_kt<T>(H, W, C, c8, c2);
  if (kt == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = kv_smem_bytes<T>(kt, C, c8, c2);
  const cudaError_t e = cudaFuncSetAttribute(
      attn_kv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((H / 2) * (W / 2) / kt, N);
  attn_kv_kernel<T><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wk_t),
      static_cast<const T*>(wv_t), kT, static_cast<T*>(vT), H, W, C, c8, c2,
      kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_launch(const void* x, const void* wq_t, const void* wo_t,
               const float* kT, const void* vT, const float* gamma, void* out,
               int N, int H, int W, int C, int c8, int c2, int tq,
               cudaStream_t stream) {
  if (plan_tq<T>(H, W, C, c8, c2, tq) != tq)
    return static_cast<int>(cudaErrorInvalidValue);
  const int HW = H * W, kvn = HW / 4;
  const size_t bytes = make_layout<T>(tq, kvn, C, c8, c2).total;
  const auto kernel =
      c8 % 16 == 0 ? attn_fwd_kernel<T, 16> : attn_fwd_kernel<T, 8>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(HW / tq, N);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wq_t),
      static_cast<const T*>(wo_t), kT, static_cast<const T*>(vT), gamma,
      static_cast<T*>(out), HW, kvn, C, c8, c2, tq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Each launching function makes ONE launch on `stream` (a cudaStream_t) and
// returns cudaGetLastError() right after it (0 = launched).
extern "C" {

// Queries per CTA of the second launch for this shape (`force_tq` > 0: that
// many, if the kernel takes it); 0 where nothing fits, -1 for a shape the
// kernels do not take (odd H or W; C not a multiple of 16, c8 of 8, c2 of
// 16; HW/4 not a multiple of 16) or whose projections overflow the first
// launch's shared memory.
int spatial_attn_plan(int dtype, int H, int W, int C, int c8, int c2,
                      int force_tq) {
  if (bad_shape(1, H, W, C, c8, c2) || (dtype != 0 && dtype != 1)) return -1;
  if (dtype == 0)
    return plan_kt<float>(H, W, C, c8, c2) == 0
               ? -1
               : plan_tq<float>(H, W, C, c8, c2, force_tq);
  return plan_kt<bf16>(H, W, C, c8, c2) == 0
             ? -1
             : plan_tq<bf16>(H, W, C, c8, c2, force_tq);
}

// First launch: kT (N, c8, HW/4) f32 and vT (N, c2, HW/4) from x (N, H, W,
// C) and the transposed projections wk_t (c8, C), wv_t (c2, C).
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

// Second launch: out (N, H, W, C) from x, wq_t (c8, C), wo_t (C, c2), the
// first launch's kT and vT and gamma (one f32 on the device), `tq` queries
// per CTA (from spatial_attn_plan).
int spatial_attn_fwd(int dtype, int device, const void* x, const void* wq_t,
                     const void* wo_t, const float* kT, const void* vT,
                     const float* gamma, void* out, int N, int H, int W, int C,
                     int c8, int c2, int tq, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bad_shape(N, H, W, C, c8, c2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_launch<float>(x, wq_t, wo_t, kT, vT, gamma, out, N, H, W, C, c8,
                             c2, tq, s);
  if (dtype == 1)
    return fwd_launch<bf16>(x, wq_t, wo_t, kT, vT, gamma, out, N, H, W, C, c8,
                            c2, tq, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef K6_PROFILE
// Copies the eight phase counters (staging, q, logits, softmax, the wait for
// v^T, attn v, Wo^T staging, o Wo + store) to `out` and zeroes them.
int spatial_attn_profile(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, k6_cycles, 64);
  const unsigned long long zero[8] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(k6_cycles, zero, 64);
  return static_cast<int>(e);
}
#endif

const char* spatial_attn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
